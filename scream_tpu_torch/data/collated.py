"""Pre-collated bucket-shard cache (port of ``scream_tpu/data/collated.py``):
evaluation at scale with no per-item host work.

A build pass routes every item through the bucket assignment and padding of
:class:`~scream_tpu_torch.data.loader.BucketedPairLoader` and writes the
padded batches into one contiguous ``.npy`` memmap per (bucket, key)
(``b<cap>_<key>.npy``) with a ``collated_meta.json`` (version 1). The
streaming :class:`CollatedPairLoader` then yields batches as slices of those
memmaps: no per-item reads, normalization or padding. Metrics equal the
bucketed loader's: the same items land in the same buckets with the same
padding, and every protocol accumulator is an order-free sum. The on-disk
format is the JAX package's, so a cache built by either package reads in
the other.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

_META = "collated_meta.json"
_VERSION = 1


def build_collated_cache(dataset, out_dir: str,
                         buckets: Sequence[int] = (1024, 2048, 4096, 8192, 16384),
                         num_workers: int = 4, verbose: bool = True) -> Dict:
    """Bucket-assign, pad and write every item of ``dataset`` into
    per-bucket memmap shards under ``out_dir``; returns the meta dict (also
    written to ``collated_meta.json``)."""
    from scream_tpu_torch.data.loader import BucketedPairLoader

    t0 = time.time()
    os.makedirs(out_dir, exist_ok=True)
    loader = BucketedPairLoader(dataset, batch_size=16, buckets=buckets,
                                shuffle=False, num_workers=num_workers)
    counts = {int(cap): len(items) for cap, items in loader._assignment.items()}

    mm: Dict[int, Dict[str, np.ndarray]] = {}
    fill: Dict[int, int] = {}
    for batch in loader:
        cap = batch["src"].shape[1]
        if cap not in mm:
            mm[cap] = {k: np.lib.format.open_memmap(
                os.path.join(out_dir, f"b{cap}_{k}.npy"), mode="w+", dtype=v.dtype,
                shape=(counts[cap],) + v.shape[1:]) for k, v in batch.items()}
            fill[cap] = 0
        o, b = fill[cap], len(batch["src"])
        for k, v in batch.items():
            mm[cap][k][o:o + b] = v
        fill[cap] = o + b

    assert fill == counts, (fill, counts)
    for arrs in mm.values():
        for a in arrs.values():
            a.flush()
    meta = {
        "version": _VERSION,
        "ladder": [int(b) for b in sorted(buckets)],
        "buckets": {str(cap): {"n": counts[cap], "keys": sorted(mm[cap].keys())}
                    for cap in sorted(mm)},
        "n_items": int(sum(counts.values())),
        "build_s": round(time.time() - t0, 1),
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    if verbose:
        print(f"[collate] {meta['n_items']} items -> {len(counts)} bucket shard(s) "
              f"in {meta['build_s']}s ({out_dir})", file=sys.stderr)
    return meta


def has_collated_cache(cache_dir: str) -> bool:
    return os.path.exists(os.path.join(cache_dir, _META))


class CollatedPairLoader:
    """Padded batches as slices of a built cache's memmap shards, bucket by
    bucket in ascending capacity: the bucketed loader's batch dicts (src,
    tgt, masks, pose, scale / center, optional info sidecars)."""

    def __init__(self, cache_dir: str, batch_size: int):
        if not has_collated_cache(cache_dir):
            raise FileNotFoundError(
                f"no collated cache at {cache_dir} (missing {_META}); "
                "build one with evaluate --cache-dir")
        with open(os.path.join(cache_dir, _META)) as f:
            self.meta = json.load(f)
        if self.meta.get("version") != _VERSION:
            raise ValueError(
                f"collated cache version {self.meta.get('version')} != "
                f"supported {_VERSION}; rebuild the cache")
        self.batch_size = batch_size
        self._parts = []
        for cap_s in sorted(self.meta["buckets"], key=int):
            info = self.meta["buckets"][cap_s]
            arrs = {k: np.load(os.path.join(cache_dir, f"b{cap_s}_{k}.npy"), mmap_mode="r")
                    for k in info["keys"]}
            self._parts.append((int(cap_s), info["n"], arrs))

    def __len__(self) -> int:
        return sum(-(-n // self.batch_size) for _, n, _ in self._parts)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for _cap, n, arrs in self._parts:
            for i in range(0, n, self.batch_size):
                yield {k: a[i:i + self.batch_size] for k, a in arrs.items()}


def collated_or_build(dataset, cache_dir: str, batch_size: int,
                      buckets: Optional[Sequence[int]] = None) -> CollatedPairLoader:
    """The cache at ``cache_dir``, built from ``dataset`` first if absent
    (``evaluate --cache-dir``); warns when it was built on another ladder."""
    if not has_collated_cache(cache_dir):
        build_collated_cache(dataset, cache_dir,
                             **({"buckets": tuple(buckets)} if buckets else {}))
    loader = CollatedPairLoader(cache_dir, batch_size)
    if buckets and loader.meta.get("ladder") != [int(b) for b in sorted(buckets)]:
        print(f"[collate] WARNING: cache at {cache_dir} was built with bucket ladder "
              f"{loader.meta.get('ladder')} != requested {sorted(buckets)}; delete the "
              "dir to rebuild", file=sys.stderr)
    return loader
