"""Hand-written Hopper kernels and their plain PyTorch versions.

* ``attn_cuda``: the fused attention block (stats + apply kernels; the
  head-generic pair's own counts beside the wrappers' at the cells it takes).
* ``nn_cuda``: exact NN (pose solve), batched bounded NN (batched ICP) and
  its unbatched launch (single-pair ICP).
* ``splat_cuda``: the depth renderer's two-channel Gaussian max-splat
  (``render`` is the renderer around it).
* ``tail_cuda``: the fused block tail, where the fused block does not
  apply; ``ffn`` holds its plain version.

Each kernel wrapper counts its launches in a plain integer attribute
(``wrapper.launches``); the bounded NN wrappers also count the device
kernels of their calls (``device_launches``). :func:`reset_launch_counts`
zeroes them all.
"""

from scream_tpu_torch.ops import attn_cuda, nn_cuda, splat_cuda, tail_cuda

WRAPPERS = (attn_cuda.attn_stats, attn_cuda.attn_apply, attn_cuda.attn_stats_heads,
            attn_cuda.attn_apply_heads,
            nn_cuda.nn_exact, nn_cuda.nn_bounded, nn_cuda.nn_bounded_single,
            nn_cuda.nn_tile_boxes, splat_cuda.max_splat, tail_cuda.block_tail)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
        if hasattr(w, "device_launches"):
            w.device_launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
