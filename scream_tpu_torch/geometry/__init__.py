"""Geometry: pairwise distances, weighted Kabsch, metrics and batched ICP."""
