"""The weight packing of the tail and apply kernels' shared-memory ring
(``ops/tail_cuda.py:pack_weights``, consumed by ``csrc/tail_tile.cuh``).

The kernels read each ring stage through wgmma matrix descriptors, K-major
with no swizzle: in a k16 step, element (k, n) of a warpgroup's B operand
lies at ``start + (n // 8) * SBO + (k // 8) * LBO + (n % 8) * 16 +
(k % 8) * 2`` bytes, with LBO = 128 and SBO = 256 (the canonical layout
``((8, n), 2) : ((16 B, SBO), LBO)`` of the PTX ISA's matrix descriptor).
These tests walk the packed blob the way the kernels do (the same stage
order, stage size, k16 steps and per-warpgroup column offsets as
``Cfg``/``ring_mma``, written out again here) and rebuild every weight from
it, at every width the two kernels take; they check that the blob holds
each element once, that a forward computed from the rebuilt weights is the
JAX package's tail, that the packer refuses what the kernels do not take,
that it rounds fp32 weights as ``.to(torch.bfloat16)`` does, and that
the wrappers' blob is reused only while the weights are unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scream_tpu.ops import ffn_pallas
from scream_tpu_torch.ops import tail_cuda
from scream_tpu_torch.ops.ffn import tail_plain


def kernel_cfg(d):
    """The ring constants of ``csrc/tail_tile.cuh:Cfg<d>``."""
    cols = 2 if d > 256 else 1
    return dict(cols=cols, nw=d // cols, hc=64 * cols, ks_h=d // (2 * cols),
                s_d=d // 32, s_ch=2 * cols, stage=64 * d)


def b_offsets(stages, kstep, b_step, b_off, ncols):
    """Byte offsets, from the first of `stages` stages, of one warpgroup's B
    operand (ks = 16 kstep k-rows a stage, `ncols` columns) by the
    descriptor formula: shape (stages * ks, ncols)."""
    s, t, k, n = np.ix_(np.arange(stages), np.arange(kstep), np.arange(16),
                        np.arange(ncols))
    off = (t * b_step + b_off + (n // 8) * 256 + (k // 8) * 128 + (n % 8) * 16
           + (k % 8) * 2)
    return off, s  # stage index kept apart: the caller adds its stage base


def walk(blob, d, hid, with_wq):
    """Rebuild (Wq, Wm, W1, W2) from the blob as the kernels consume it."""
    c = kernel_cfg(d)
    flat = blob.float().numpy()
    counts = np.zeros(flat.size, dtype=np.int64)
    stage_el = c["stage"] // 2
    cursor = [0]  # next stage of the walk

    def product(stages, kstep, nstage, ncols_wg):
        """One product's stages, both column parts: (stages * 16 kstep, cols)."""
        parts = []
        for cp in range(c["cols"]):
            off, s = b_offsets(stages, kstep, 32 * nstage, 32 * cp * ncols_wg, ncols_wg)
            el = (cursor[0] + s) * stage_el + off // 2
            el = el.reshape(stages * kstep * 16, ncols_wg)
            np.add.at(counts, el.ravel(), 1)
            parts.append(flat[el])
        cursor[0] += stages
        return np.concatenate(parts, axis=1)

    Wq = product(c["s_d"], 2, d, c["nw"]) if with_wq else None
    Wm = product(c["s_d"], 2, d, c["nw"])
    W1 = np.zeros((d, hid), np.float32)
    W2 = np.zeros((hid, d), np.float32)
    hc = c["hc"]
    for ch in range(hid // hc):
        W1[:, ch * hc:(ch + 1) * hc] = product(c["s_ch"], c["ks_h"] // 16, hc, 64)
        W2[ch * hc:(ch + 1) * hc] = product(c["s_ch"], 2, d, c["nw"])
    assert cursor[0] * stage_el == flat.size  # stages(dd, hid) of Cfg
    return Wq, Wm, W1, W2, counts


def weights(d, hid, seed, with_wq=False):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(s).astype(np.float32)
          for s in ((d, d), (d, hid), (hid, d))]
    wq = rng.standard_normal((d, d)).astype(np.float32) if with_wq else None
    return [torch.from_numpy(w) for w in ws], (torch.from_numpy(wq) if with_wq else None)


CASES = [("tail", d) for d in tail_cuda.KERNEL_WIDTHS] + [("apply", d) for d in (128, 256, 384)]


@pytest.mark.parametrize("kind,d", CASES)
def test_blob_rebuilds_every_weight_once(kind, d):
    hid = 4 * d
    (Wm, W1, W2), Wq = weights(d, hid, d, with_wq=kind == "apply")
    blob = tail_cuda.pack_weights(Wm, W1, W2, Wq=Wq)
    assert blob.dtype == torch.bfloat16 and blob.dim() == 1
    got_q, got_m, got_1, got_2, counts = walk(blob, d, hid, Wq is not None)
    assert (counts == 1).all()  # each element read once: a permutation
    bf = lambda w: w.to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got_m, bf(Wm))
    np.testing.assert_array_equal(got_1, bf(W1))
    np.testing.assert_array_equal(got_2, bf(W2))
    if Wq is not None:
        np.testing.assert_array_equal(got_q, bf(Wq))


@pytest.mark.parametrize("d,hid", [(128, 256), (384, 768)])
def test_hidden_widths_in_chunks(d, hid):
    """A hidden width other than 4d (any multiple of 128)."""
    (Wm, W1, W2), _ = weights(d, hid, 7)
    _, got_m, got_1, got_2, counts = walk(tail_cuda.pack_weights(Wm, W1, W2), d, hid, False)
    assert (counts == 1).all()
    np.testing.assert_array_equal(got_1, W1.to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(got_2, W2.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("d", [128, 512])
def test_tail_from_the_walked_blob_is_the_jax_tail(d):
    """The tail computed from the weights as the kernel's walk reads them
    equals the JAX package's tail (its plain path, ``ffn_pallas``'s
    ``_tail_xla`` math) on the same inputs."""
    hid, R = 4 * d, 40
    rng = np.random.default_rng(d + 1)
    x, q = (rng.standard_normal((R, d)).astype(np.float32) for _ in range(2))
    Wm = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    W1 = (rng.standard_normal((d, hid)) / np.sqrt(d)).astype(np.float32)
    W2 = (rng.standard_normal((hid, d)) / np.sqrt(hid)).astype(np.float32)
    g1, g2 = (rng.uniform(0.5, 1.5, d).astype(np.float32) for _ in range(2))
    b1, b2 = ((rng.standard_normal(d) * 0.1).astype(np.float32) for _ in range(2))
    blob = tail_cuda.pack_weights(*(torch.from_numpy(w) for w in (Wm, W1, W2)))
    _, wm, w1, w2, _ = walk(blob, d, hid, False)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = tail_plain(t(x), t(q), t(wm), t(g1), t(b1), t(w1), t(w2), t(g2), t(b2),
                     cd=torch.float32, nd=torch.float32, eps=1e-5).numpy()
    bfr = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(ffn_pallas.block_tail(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(bfr(Wm)), jnp.asarray(g1),
        jnp.asarray(b1), jnp.asarray(bfr(W1)), jnp.asarray(bfr(W2)), jnp.asarray(g2),
        jnp.asarray(b2), dtype="float32", norm_dtype="float32", use_pallas=False))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shapes,wq", [
    (((192, 192), (192, 768), (768, 192)), None),      # width the kernels lack
    (((128, 128), (128, 200), (200, 128)), None),      # hidden not in 128s
    (((256, 256), (256, 1024), (1024, 128)), None),    # W2 does not match
    (((128, 256), (128, 512), (512, 128)), None),      # Wm not square
    (((512, 512), (512, 2048), (2048, 512)), (512, 512)),  # apply takes d <= 384
    (((256, 256), (256, 1024), (1024, 256)), (256, 128)),  # Wq not square
])
def test_packer_rejects_shapes_the_kernels_do_not_take(shapes, wq):
    ws = [torch.zeros(s) for s in shapes]
    with pytest.raises(ValueError):
        tail_cuda.pack_weights(*ws, Wq=None if wq is None else torch.zeros(wq))


def test_packer_rejects_integer_weights():
    ws = [torch.zeros(s, dtype=torch.int32) for s in ((128, 128), (128, 512), (512, 128))]
    with pytest.raises(ValueError):
        tail_cuda.pack_weights(*ws)


def test_packer_casts_as_to_bfloat16():
    """The tail wrapper packs the fp32 parameters directly: the cast inside
    the pack rounds as ``.to(torch.bfloat16)`` does, and the blob carries
    no autograd history."""
    (Wm, W1, W2), Wq = weights(256, 1024, 5, with_wq=True)
    ws = [w.requires_grad_() for w in (Wm, W1, W2, Wq)]
    blob = tail_cuda.pack_weights(*ws[:3], Wq=ws[3])
    bf = [w.detach().to(torch.bfloat16) for w in ws]
    assert torch.equal(blob, tail_cuda.pack_weights(*bf[:3], Wq=bf[3]))
    assert not blob.requires_grad
