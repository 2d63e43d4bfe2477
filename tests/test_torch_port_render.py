"""The port's depth renderer against the JAX package on the CPU.

* ``max_splat``: the port's splat (the kernel's plain version and its
  argmax backward) against ``splat_pallas.max_splat`` in interpret mode on
  the same points, with masked rows, pixels where every contribution is 0
  (ties) and N not a multiple of the TPU's 1,024-point tile, at the
  renderer's rho 24. Bars: images 5e-5 absolute in fp32 (JAX forms the
  cross term as a dot, the port elementwise as its kernel does; d^2 then
  differs by ~2 ulps, ~1.2e-7, which the weight's rho^2/2 = 288 turns into
  up to 3.4e-5 relative, measured 1.9e-5 absolute); argmax identical
  wherever the max is a normal fp32 number (XLA:CPU flushes subnormals to
  zero, so where every weight underflows to a subnormal JAX sees a tie at 0,
  won by point 0, and the port a subnormal winner; the card does not flush
  either, and there the kernel and its plain version agree bit for bit);
  the VJP with respect to xy and vals 1e-5 relative norm.
* ``view_matrices``, ``pixel_grid`` and ``render_depth_images`` against the
  JAX renderer (``use_pallas=False``): images within ``rho^2 * 1e-6``
  absolute (5.8e-4 at rho 24, 2.3e-3 at rho 48): d^2 = |p|^2 + |pix|^2 -
  2 p.pix of rotated points in [-1.7, 1.7] carries ~2 ulps of its ~4-sized
  terms (~1e-6) that the weight's rho^2/2 amplifies, and the image is
  2 * max - 1 (measured 1.6e-4 and 3.8e-4); gradients with respect to
  ``src_pred`` 1e-4 relative norm.
* Routing: on CUDA tensors the renderer reaches the splat wrapper unless
  ``use_pallas=False``; the wrapper raises for devices it has no version for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scream_tpu.ops import render as jrender
from scream_tpu.ops import splat_pallas
from scream_tpu_torch.config import RenderConfig, kitti_gan_render_config
from scream_tpu_torch.ops import render, splat_cuda
from scream_tpu_torch.utils import device as device_util

RHO, W = 24.0, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def splat_inputs(seed=0, images=3, n=300):
    """Points clustered in the middle of the grid, so the border pixels see
    only underflowed weights (ties at 0); every fifth row masked (vals 0)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.45, 0.45, (images, n, 2)).astype(np.float32)
    vals = rng.uniform(0.05, 1.0, (images, n, 2)).astype(np.float32)
    vals[:, ::5] = 0.0
    vals[1, :, 1] = 0.0  # one image with an empty tgt channel
    return xy, vals


@pytest.fixture(scope="module")
def jax_splat():
    """``splat_pallas`` in interpret mode over a batch of images: images,
    argmax, and the VJP of a weighted sum."""
    xy, vals = splat_inputs()
    fwd = jax.vmap(lambda a, b: splat_pallas._splat_forward(a, b, RHO, W, True))
    img, arg = fwd(jnp.asarray(xy), jnp.asarray(vals))
    cot = np.random.default_rng(1).standard_normal(img.shape).astype(np.float32)
    f = jax.vmap(lambda a, b: splat_pallas.max_splat(a, b, RHO, W, True))
    _, vjp = jax.vjp(f, jnp.asarray(xy), jnp.asarray(vals))
    g_xy, g_vals = vjp(jnp.asarray(cot))
    return dict(xy=xy, vals=vals, img=np.asarray(img), arg=np.asarray(arg), cot=cot,
                g_xy=np.asarray(g_xy), g_vals=np.asarray(g_vals))


class TestMaxSplat:
    def test_images_and_argmax_match_pallas(self, jax_splat):
        img, arg = splat_cuda.splat_forward(t(jax_splat["xy"]), t(jax_splat["vals"]), RHO, W)
        np.testing.assert_allclose(img.numpy(), jax_splat["img"], atol=5e-5, rtol=0)
        normal = jax_splat["img"] >= np.finfo(np.float32).tiny
        np.testing.assert_array_equal(arg.numpy()[normal], jax_splat["arg"][normal])
        # The inputs reach the cases the bars are about.
        assert (jax_splat["img"] == 0).mean() > 0.2  # tied pixels
        assert (arg.numpy()[img.numpy() == 0] == 0).all()  # won by point 0
        assert jax_splat["xy"].shape[1] % splat_pallas.TILE_P

    def test_vjp_matches_pallas(self, jax_splat):
        xy = t(jax_splat["xy"]).requires_grad_(True)
        vals = t(jax_splat["vals"]).requires_grad_(True)
        out = splat_cuda.max_splat(xy, vals, RHO, W)
        g_xy, g_vals = torch.autograd.grad(out, (xy, vals), t(jax_splat["cot"]))
        assert rel_norm(g_xy.numpy(), jax_splat["g_xy"]) <= 1e-5
        assert rel_norm(g_vals.numpy(), jax_splat["g_vals"]) <= 1e-5

    def test_plain_autograd_is_the_subgradient(self, jax_splat):
        """The plain version differentiated by autograd (ties split) gives
        the argmax VJP wherever the winner is unique: on these inputs the
        two agree to 1e-5 relative norm."""
        xy = t(jax_splat["xy"]).requires_grad_(True)
        vals = t(jax_splat["vals"]).requires_grad_(True)
        img, _ = splat_cuda.max_splat_plain(xy, vals, RHO, W, tile=128)
        g_xy, _ = torch.autograd.grad(img, (xy, vals), t(jax_splat["cot"]))
        assert rel_norm(g_xy.numpy(), jax_splat["g_xy"]) <= 1e-5

    def test_pixel_grid_matches_jax(self):
        for w in (16, 32, 64):
            np.testing.assert_array_equal(splat_cuda.pixel_grid(w).numpy(),
                                          np.asarray(jrender.pixel_grid(w)))


def clouds(seed, B=2, n=160, m=200):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (B, m, 3)).astype(np.float32)
    sm = rng.random((B, n)) > 0.15
    tm = rng.random((B, m)) > 0.15
    return src, tgt, sm, tm


class TestRenderer:
    @pytest.mark.parametrize("mode", ["multi", "identity", "back"])
    def test_view_matrices(self, mode):
        np.testing.assert_allclose(render.view_matrices(view_mode=mode).numpy(),
                                   np.asarray(jrender.view_matrices(view_mode=mode)),
                                   atol=1e-7)

    @pytest.mark.parametrize("mode,rho", [("multi", 24.0), ("back", 48.0)])
    def test_images_and_gradients_match_jax(self, mode, rho):
        src, tgt, sm, tm = clouds(3)
        cot = np.random.default_rng(4).standard_normal(
            (2, 6 if mode == "multi" else 1, 2, W, W)).astype(np.float32)
        kw = dict(rho=rho, width=W, view_mode=mode, use_pallas=False)

        def f(p):
            return jrender.render_depth_images(p, jnp.asarray(tgt), jnp.asarray(sm),
                                               jnp.asarray(tm), **kw)

        want, vjp = jax.vjp(f, jnp.asarray(src))
        (g_want,) = vjp(jnp.asarray(cot))
        p = t(src).requires_grad_(True)
        got = render.render_depth_images(p, t(tgt), t(sm), t(tm), **kw)
        (g_got,) = torch.autograd.grad(got, p, t(cot))
        bar = rho * rho * 1e-6
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=bar,
                                   rtol=0)
        assert rel_norm(g_got.numpy(), g_want) <= 1e-4
        # The kernel's route (its plain version here) renders the same images.
        kern = render.render_depth_images(t(src), t(tgt), t(sm), t(tm),
                                          **{**kw, "use_pallas": True})
        np.testing.assert_allclose(kern.numpy(), np.asarray(want), atol=bar, rtol=0)

    def test_render_from_config(self):
        src, tgt, sm, tm = clouds(5, n=64, m=64)
        cfg = kitti_gan_render_config()
        got = render.render_from_config(t(src), t(tgt), cfg, t(sm), t(tm))
        assert got.shape == (2, 1, 2, 64, 64)
        assert float(got.min()) >= -1.0 and float(got.max()) <= 1.0
        same = render.render_depth_images(t(src), t(tgt), t(sm), t(tm), rho=48.0,
                                          view_mode="back")
        assert torch.equal(got, same)


class TestSplatRouting:
    """On CUDA tensors (built here by patching the routing predicate) the
    renderer reaches the splat wrapper; only ``use_pallas=False`` reaches the
    plain renderer."""

    @pytest.fixture
    def cuda_like(self, monkeypatch):
        calls = []
        monkeypatch.setattr(device_util, "on_cuda", lambda x: True)
        monkeypatch.setattr(render, "max_splat", lambda xy, v, rho, w: calls.append(
            "kernel") or torch.zeros((xy.shape[0], 2, w * w)))
        plain = render.max_splat_plain
        monkeypatch.setattr(render, "max_splat_plain", lambda *a, **k: calls.append(
            "plain") or plain(*a, **k))
        return calls

    @pytest.mark.parametrize("cfg", [RenderConfig(width=W), kitti_gan_render_config(),
                                     RenderConfig(width=W, use_pallas=True)])
    def test_auto_and_true_reach_the_kernel(self, cuda_like, cfg):
        src, tgt, _, _ = clouds(6, n=32, m=32)
        render.render_from_config(t(src), t(tgt), cfg)
        assert cuda_like == ["kernel"]

    def test_false_reaches_the_plain_renderer(self, cuda_like):
        src, tgt, _, _ = clouds(6, n=32, m=32)
        render.render_from_config(t(src), t(tgt), RenderConfig(width=W, use_pallas=False))
        assert cuda_like == ["plain"]

    def test_cpu_auto_is_plain(self, monkeypatch):
        calls = []
        monkeypatch.setattr(render, "max_splat", lambda *a: calls.append("kernel"))
        src, tgt, _, _ = clouds(6, n=32, m=32)
        render.render_depth_images(t(src), t(tgt), width=W)
        assert not calls

    def test_wrapper_counts_only_kernel_launches(self):
        splat_cuda.max_splat.launches = 0
        xy, vals = splat_inputs(n=40)
        splat_cuda.max_splat(t(xy), t(vals), RHO, W)  # plain version on the CPU
        assert splat_cuda.max_splat.launches == 0
        with pytest.raises(ValueError):
            splat_cuda.splat_forward(torch.empty((1, 4, 2), device="meta"),
                                     torch.empty((1, 4, 2), device="meta"), RHO, W)
