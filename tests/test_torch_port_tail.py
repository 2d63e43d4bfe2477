"""The port's fused block tail (``ops/tail_cuda.py:block_tail``) and the
attention block's routing (``models/attention.py:route_block``) against the
JAX package on the CPU.

* ``block_tail`` on CPU tensors (its plain version) against the JAX
  ``block_tail``'s Pallas kernel in interpret mode: fp32 within 2e-5 at
  d 128 and d 512 over 300 rows (the kernel pads them to two 256-row
  tiles), bf16 within 3e-2 at d 128 (``tests/test_ffn_pallas.py``'s bars);
  its gradients through ``_FusedTail`` against the JAX ``custom_vjp``'s
  within 1e-4.
* The route of every block shape and flag against the one the JAX
  package's own rules give (``attn_pallas.fusable_block``,
  ``ffn_pallas.fusable``, the auto/True/False flags), a CUDA tensor standing
  for the TPU, and "raise" where the port has no kernel for the route (only
  ``fused_attention=True`` at a width the fused kernels do not take).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scream_tpu.ops import attn_pallas, ffn_pallas
from scream_tpu_torch.models import AttentionBlock
from scream_tpu_torch.ops import attn_cuda, tail_cuda
from scream_tpu_torch.ops.ffn import jax_fusable_tail


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel workers,
    and these small tensors gain nothing from more threads but contend
    with the other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand_args(seed, R, d, batch=1):
    rng = np.random.default_rng(seed)
    hid = 4 * d
    return (
        rng.standard_normal((batch, R, d)).astype(np.float32),
        rng.standard_normal((batch, R, d)).astype(np.float32),
        (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32),
        rng.uniform(0.5, 1.5, (d,)).astype(np.float32),
        (rng.standard_normal((d,)) * 0.1).astype(np.float32),
        (rng.standard_normal((d, hid)) / np.sqrt(d)).astype(np.float32),
        (rng.standard_normal((hid, d)) / np.sqrt(hid)).astype(np.float32),
        rng.uniform(0.5, 1.5, (d,)).astype(np.float32),
        (rng.standard_normal((d,)) * 0.1).astype(np.float32),
    )


def jax_kernel(dtype):
    """The JAX package's fused tail: Pallas kernel, interpret mode, with its
    custom_vjp."""
    return ffn_pallas._make_block_tail(dtype, "float32", 1e-5, True, True)


def port_tail(args, dtype):
    return tail_cuda.block_tail(*args, dtype=dtype, norm_dtype=torch.float32)


class TestBlockTail:
    @pytest.mark.parametrize("d", [128, 512])
    def test_fp32_matches_pallas_interpret(self, d):
        args = rand_args(d, 300, d)
        want = np.asarray(jax_kernel("float32")(*map(jnp.asarray, args)))
        tail_cuda.block_tail.launches = 0
        got = port_tail([torch.from_numpy(a) for a in args], torch.float32)
        assert got.dtype == torch.float32 and got.shape == (1, 300, d)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
        assert tail_cuda.block_tail.launches == 0  # CPU tensors: the plain version

    def test_bf16_matches_pallas_interpret(self):
        args = rand_args(3, 64, 128, batch=2)
        want = np.asarray(jax_kernel("bfloat16")(*map(jnp.asarray, args)), np.float32)
        got = port_tail([torch.from_numpy(a) for a in args], torch.bfloat16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=3e-2)

    def test_gradients_match_custom_vjp(self):
        """d(sum(out^2)) with respect to x, q and the seven weights, through
        ``_FusedTail`` (recompute the plain tail) and the JAX custom_vjp."""
        args = rand_args(4, 32, 128, batch=2)
        fused = jax_kernel("float32")
        want = jax.grad(lambda *a: jnp.sum(jnp.square(fused(*a))),
                        argnums=tuple(range(9)))(*map(jnp.asarray, args))
        ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
        out = port_tail(ins, torch.float32)
        assert out.grad_fn is not None and "FusedTail" in type(out.grad_fn).__name__
        got = torch.autograd.grad(torch.sum(out * out), ins)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)

    def test_kernel_widths_are_the_jax_rules_bf16_widths(self):
        """The kernels are written for every width at hidden 4d where the
        JAX tail rule admits its kernel, bf16 (``csrc/tail.cu``) and fp32
        (``csrc/tail_f32.cu``), and for no other; the port's copy of the rule
        is the JAX package's, in both dtypes."""
        widths = range(128, 1152, 128)
        for tdt, jdt, kernel_widths in ((torch.bfloat16, jnp.bfloat16, tail_cuda.KERNEL_WIDTHS),
                                        (torch.float32, jnp.float32,
                                         tail_cuda.KERNEL_WIDTHS_F32)):
            admitted = [d for d in widths if ffn_pallas.fusable(d, 4 * d, jdt)]
            assert admitted == list(kernel_widths)
            assert [d for d in widths if tail_cuda.kernel_takes(d, 4 * d, tdt)] == admitted
            for d in widths:
                assert jax_fusable_tail(d, 4 * d, tdt) == ffn_pallas.fusable(d, 4 * d, jdt)


# Every block shape and flag of the routing table: d_model (8 heads), compute
# dtype, fused_attention, fused_block_tail, k and v from one source or not.
ROUTES = list(itertools.product((128, 256, 384, 512, 640), ("bfloat16", "float32"),
                                (None, False, True), (None, False), (True, False)))
# The shapes the port's CUDA kernels are written for (8 heads, hidden 4d).
FUSED_KERNEL = {(d, dt) for d in (128, 256) for dt in ("bfloat16", "float32")} \
    | {(384, "bfloat16")}
TAIL_KERNEL = ({(d, "bfloat16") for d in (128, 256, 384, 512)}
               | {(d, "float32") for d in (128, 256, 384)})


def jax_route(d, dtype, fused_attn, fused_tail, shared_kv, heads=8):
    """The route the JAX package takes on the TPU
    (``models/attention.py:199-243``, ``ffn_pallas.block_tail``'s auto)."""
    hid, jdt = 4 * d, jnp.dtype(dtype)
    use_fa = fused_attn if fused_attn is not None else attn_pallas.fusable_block(
        d, hid, heads, jdt)
    if use_fa and shared_kv:
        return "fused"
    use_tail = fused_tail if fused_tail is not None else ffn_pallas.fusable(d, hid, jdt)
    return "tail" if use_tail else "plain"


@pytest.mark.parametrize("d,dtype,fused_attn,fused_tail,shared_kv", ROUTES)
def test_cuda_route_follows_the_jax_rules(monkeypatch, d, dtype, fused_attn, fused_tail,
                                          shared_kv):
    from scream_tpu_torch.utils import device as device_util

    want = jax_route(d, dtype, fused_attn, fused_tail, shared_kv)
    if (want == "fused" and (d, dtype) not in FUSED_KERNEL) or (
            want == "tail" and (d, dtype) not in TAIL_KERNEL):
        want = "raise"
    monkeypatch.setattr(device_util, "on_cuda", lambda x: True)
    calls = []
    monkeypatch.setattr(attn_cuda, "attention_block_fused",
                        lambda *a, **k: calls.append("fused") or a[0])
    monkeypatch.setattr(tail_cuda, "block_tail", lambda *a, **k: calls.append("tail") or a[1])
    blk = AttentionBlock(d, 8, 4, dtype=getattr(torch, dtype), fused_attn=fused_attn,
                         fused_tail=fused_tail)
    x = torch.zeros((1, 4, d))
    try:
        out = blk(x, x, x if shared_kv else x.clone())
        got = calls[0] if calls else "plain"
        assert out.shape == (1, 4, d) and len(calls) <= 1
    except NotImplementedError as e:
        assert "ROADMAP" in str(e)
        got = "raise"
    assert got == want


# The cells the JAX rules admit at 8 heads and no CUDA kernel takes, at
# FFN widths other than 4 x d_model: (dtype, d_model) -> the ffn_mult range
# as the refusal message names it.
MISSING = {"fused": {("bfloat16", 512): "1-2", ("float32", 384): "1-3"},
           "tail": {("bfloat16", 640): "1-3", ("bfloat16", 768): "1-2", ("bfloat16", 896): "1",
                    ("float32", 512): "1-2", ("float32", 640): "1"}}


def _mults(rng):
    lo, _, hi = rng.partition("-")
    return range(int(lo), int(hi or lo) + 1)


@pytest.mark.parametrize("ffn_mult", [1, 2, 3, 5, 6, 7, 8])
def test_cuda_route_follows_the_jax_rules_at_other_ffn_widths(ffn_mult):
    """``route_block`` at hidden = ffn_mult x d on CUDA, every width 128-1,024,
    both dtypes, every flag, against the route the JAX rules give; "raise"
    exactly where the JAX auto rules admit a kernel the port has not written,
    and the refusal names that cell."""
    from scream_tpu_torch.models.attention import route_block

    for d, dtype, fused_attn, fused_tail, shared_kv in itertools.product(
            range(128, 1152, 128), ("bfloat16", "float32"), (None, False, True),
            (None, False, True), (True, False)):
        hid, jdt, tdt = ffn_mult * d, jnp.dtype(dtype), getattr(torch, dtype)
        use_fa = fused_attn if fused_attn is not None else attn_pallas.fusable_block(
            d, hid, 8, jdt)
        if use_fa and shared_kv:
            want, kernel = "fused", (d, dtype) in FUSED_KERNEL
        else:
            use_tail = fused_tail if fused_tail is not None else ffn_pallas.fusable(
                d, hid, jdt)
            want, kernel = ("tail", (d, dtype) in TAIL_KERNEL) if use_tail else ("plain", True)
        cell = (d, dtype, fused_attn, fused_tail, shared_kv)
        try:
            got = route_block(d, hid, 8, tdt, fused_attn, fused_tail, True, shared_kv)
        except NotImplementedError as e:
            assert not kernel and "ROADMAP" in str(e), cell
            auto = fused_attn is None if want == "fused" else fused_tail is None
            if auto:
                rng = MISSING[want].get((dtype, d))
                assert rng is not None and ffn_mult in _mults(rng), cell
                assert f"{d} at {'ffn_mult ' if want == 'fused' else ''}" in str(e) \
                    and rng in str(e), (cell, str(e))
            continue
        assert kernel and got == want, (cell, got, want)


def test_refusal_messages_name_exactly_the_missing_cells():
    """Every cell of ``MISSING`` is admitted by the JAX auto rules at 8 heads
    and taken by no CUDA kernel, and no other cell at ffn_mult 1-8 is."""
    found = {"fused": set(), "tail": set()}
    for d, dtype, m in itertools.product(range(128, 1152, 128), ("bfloat16", "float32"),
                                         range(1, 9)):
        jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
        if attn_pallas.fusable_block(d, m * d, 8, jdt):
            if not attn_cuda.kernels_take(d, m * d, 8, tdt):
                found["fused"].add((dtype, d, m))
        if ffn_pallas.fusable(d, m * d, jdt) and not tail_cuda.kernel_takes(d, m * d, tdt):
            found["tail"].add((dtype, d, m))
    for kind, cells in MISSING.items():
        assert found[kind] == {(dt, d, m) for (dt, d), rng in cells.items()
                               for m in _mults(rng)}, kind
