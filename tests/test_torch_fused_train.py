"""The port's loss-fused training render and step against the JAX package's.

On the CPU the port's `fused_mse_render` runs its plain PyTorch version;
the JAX `fused_mse_render` runs its Pallas kernel in interpret mode, as
tests/test_fused_train.py runs it. Both get the same JAX-initialised
weights (params_from_numpy) and the same numpy rays, depths, noise and
ground truth; the JAX step's random draws are reproduced from
jax.random.split(key, 4) and injected on the torch side (TrainDraws).

Bars: out8 and weights at the JAX kernels' bars (rgb and opacity 1e-2,
depth 5e-2, weights 5e-3); each gradient leaf within a relative max error
(max |port - jax| / max |jax|) of 0.03, the bar of
tests/test_fused_train.py::TestGradientParity. Measured gaps at R 32,
S 16 (sigma head x10, +1): out8 1.6e-4, weights 1.8e-4, gradient leaves
up to 9.4e-3 (white background) and 1.6e-2 (black), all from bf16
roundings and ReLU masks of single activations that flip between the two
implementations' f32 summation orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.ops.fused_mlp import pack_params as jpack
from nerf_pl_tpu.ops.fused_mlp import unpack_grads as junpack
from nerf_pl_tpu.ops.fused_train import fused_mse_render as jmse
from nerf_pl_tpu.rendering import RenderConfig as JRenderConfig
from nerf_pl_tpu.rendering.render import fused_mse_train_step as jstep
from nerf_pl_tpu_torch.models import params_from_numpy
from nerf_pl_tpu_torch.ops import fused_mlp as tfm
from nerf_pl_tpu_torch.ops import fused_train as tft
from nerf_pl_tpu_torch.rendering import (RenderConfig, TrainDraws,
                                         fused_mse_train_step)

GRAD_TOL = 0.03


def _dense(key):
    """Amplified sigma head (tests/test_fused_train.py dense_params)."""
    p = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(key)))
    p["sigma"]["w"] = p["sigma"]["w"] * 10
    p["sigma"]["b"] = p["sigma"]["b"] + 1.0
    return p


def _inputs(R, S, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((R, 1), 2, np.float32),
                           np.full((R, 1), 6, np.float32)], 1)
    z = np.sort(rng.uniform(2, 6, (R, S)), -1).astype(np.float32)
    noise = (0.5 * rng.normal(size=(R, S))).astype(np.float32)
    gt = rng.random((R, 8)).astype(np.float32)
    return rays, z, noise, gt


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _assert_grads(ours, ref, tol=GRAD_TOL):
    for model in ref:
        for layer in ref[model]:
            for leaf in ("w", "b"):
                a = ours[model][layer][leaf].numpy()
                b = np.asarray(ref[model][layer][leaf])
                assert a.shape == b.shape, (model, layer, leaf)
                rel = _rel(a, b)
                assert rel <= tol, f"{model}/{layer}/{leaf}: {rel}"


@pytest.fixture(scope="module")
def params():
    return _dense(0)


@pytest.mark.parametrize("white_back", [True, False])
def test_mse_render_reference_matches_jax_kernel(params, white_back):
    R, S = 32, 16
    rays, z, noise, gt = _inputs(R, S)
    scale = 1.0 / (R * 3)
    o8_j, w_j, g_j = jmse(jpack(params), *map(jnp.asarray, (rays, z, noise,
                                                            gt)),
                          white_back, scale, 512)
    o8_t, w_t, g_t = tft.fused_mse_render(
        params_from_numpy(params), *map(torch.from_numpy, (rays, z, noise,
                                                           gt)),
        white_back, scale)
    o8_j = np.asarray(o8_j)
    for name, cols, tol in (("rgb", slice(0, 3), 1e-2),
                            ("depth", slice(3, 4), 5e-2),
                            ("opacity", slice(4, 5), 1e-2)):
        np.testing.assert_allclose(o8_t[:, cols].numpy(), o8_j[:, cols],
                                   atol=tol, err_msg=name)
    assert not o8_t[:, 5:].any()
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=5e-3)
    assert len(g_t) == len(g_j) == 17
    for i, (a, b) in enumerate(zip(g_t, g_j)):
        assert a.shape == b.shape, i
        assert _rel(a.numpy(), b) <= GRAD_TOL, (i, _rel(a.numpy(), b))
    _assert_grads({"m": tfm.unpack_grads(g_t)},
                  {"m": junpack(g_j, params)})


def test_quad_vjp_matches_autograd():
    """The analytic quadrature VJP against autograd through quad_forward,
    in float64 and away from saturation (atol 1e-9)."""
    rng = np.random.default_rng(3)
    R, S = 6, 40
    z = torch.from_numpy(np.sort(rng.uniform(2, 6, (R, S)), -1))
    dn = torch.from_numpy(rng.uniform(0.5, 1.5, (R, 1)))
    sig = torch.from_numpy(rng.normal(size=(R, S))).requires_grad_()
    noise = torch.from_numpy(0.3 * rng.normal(size=(R, S)))
    rgbs = torch.from_numpy(rng.random((R, S, 3))).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(R, 3)))
    for white in (True, False):
        q = tft.quad_forward(z, dn, sig, noise, rgbs, white)
        ref_sig, ref_rgb = torch.autograd.grad((q.rgb * g).sum(),
                                               [sig, rgbs])
        d_sig, d_rgb = tft.quad_vjp(q, rgbs.detach(), g, white)
        torch.testing.assert_close(d_sig, ref_sig, atol=1e-9, rtol=0)
        torch.testing.assert_close(d_rgb, ref_rgb, atol=1e-9, rtol=0)


def test_kernel_gradient_layout_round_trips(params):
    """The kernel's gradient buffer (kernel_layout blocks, 16-wide heads,
    biases last) maps onto the 17 pack_params buffers: a buffer assembled
    from known gradients comes back as exactly those."""
    rays, z, noise, gt = _inputs(8, 8, seed=1)
    _, _, grads = tft.fused_mse_render(
        params_from_numpy(params), *map(torch.from_numpy, (rays, z, noise,
                                                           gt)), True, 0.1)
    (gw0r, gw0e, gwskr, gwske, gwt, gbt, gwf, gbf, gwdf, gwddr, gwdde, gbd,
     gws, gbs, gwr, gbr, _) = grads
    gap = torch.zeros((8, 256))
    ws16 = torch.zeros((256, 16))
    ws16[:, 3] = gws[:, 0]
    wr16 = torch.zeros((128, 16))
    wr16[:, :3] = gwr[:, :3]
    buf = torch.cat([t.reshape(-1) for t in (
        torch.cat([gw0r, gap, gw0e]), gwt, torch.cat([gwskr, gap, gwske]),
        gwf, gwdf, torch.cat([gwddr, gap[:, :128], gwdde]), ws16, wr16,
        gbt, gbf, gbd, gbr[0, :3], gbs[0, :1])])
    assert buf.numel() == tft.GRAD_FLOATS
    for a, b in zip(tft._pack_layout_grads(buf), grads):
        assert torch.equal(a, b)


def _step_draws(key, R, cfg):
    """The JAX step's draws, as its split of the key makes them."""
    k_perturb, k_noise_c, k_importance, k_noise_f = jax.random.split(key, 4)
    n_all = cfg.N_samples + cfg.N_importance
    return TrainDraws(
        perturb=_t(jax.random.uniform(k_perturb, (R, cfg.N_samples))),
        noise_coarse=_t(jax.random.normal(k_noise_c, (R, cfg.N_samples))),
        u=_t(jax.random.uniform(k_importance, (R, cfg.N_importance))),
        noise_fine=_t(jax.random.normal(k_noise_f, (R, n_all))))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_fused_mse_train_step_matches_jax():
    """The whole loss-fused step, both passes, with JAX's draws injected.

    Loss within 1e-5 relative (measured 1.2e-6), rgb_fine within the rgb
    bar 1e-2 (measured 2e-5). Gradients per leaf: cosine >= 0.999 and
    relative L2 error <= 0.05 (measured >= 0.99941 and <= 0.034). Their
    max error is no bar here: with 32 rays a leaf's largest entries come
    from a few points, and one bf16 rounding or ReLU mask that flips
    between the two implementations' f32 summation orders (and the fine
    depths, which sample_pdf places up to 8e-6 apart from the coarse
    weights' cumsum) moves them by up to 11%."""
    R = 32
    params = {"nerf_coarse": _dense(0), "nerf_fine": _dense(1)}
    rays, _, _, gt = _inputs(R, 1, seed=2)
    rgbs = gt[:, :3].copy()
    base = dict(N_samples=16, N_importance=8, white_back=True, perturb=1.0,
                noise_std=1.0, fused_train=True, fused_loss=True)
    key = jax.random.PRNGKey(7)
    ls_j, out_j, g_j = jstep(params, jnp.asarray(rays), jnp.asarray(rgbs),
                             key, JRenderConfig(**base), R)
    cfg = RenderConfig(**base)
    ls_t, out_t, g_t = fused_mse_train_step(
        {k: params_from_numpy(v) for k, v in params.items()},
        torch.from_numpy(rays), torch.from_numpy(rgbs), cfg, R,
        draws=_step_draws(key, R, cfg))
    assert abs(float(ls_t) - float(ls_j)) <= 1e-5 * abs(float(ls_j))
    assert set(out_t) == set(out_j)
    np.testing.assert_allclose(out_t["rgb_fine"].numpy(),
                               np.asarray(out_j["rgb_fine"]), atol=1e-2)
    for model in g_j:
        for layer in g_j[model]:
            for leaf in ("w", "b"):
                a = g_t[model][layer][leaf].numpy().ravel()
                b = np.asarray(g_j[model][layer][leaf]).ravel()
                cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
                l2 = np.linalg.norm(a - b) / np.linalg.norm(b)
                assert cos >= 0.999 and l2 <= 0.05, (model, layer, leaf,
                                                     cos, l2)


def test_cpu_tensor_takes_plain_version(params, monkeypatch):
    """A CPU tensor never reaches the kernel path or its counter."""
    def no_kernel(*a, **k):
        raise AssertionError("kernel path taken for a CPU tensor")
    monkeypatch.setattr(tft, "_mse_render_cuda", no_kernel)
    before = tft.mse_render_launches
    rays, z, noise, gt = _inputs(4, 8)
    tft.fused_mse_render(params_from_numpy(params),
                         *map(torch.from_numpy, (rays, z, noise, gt)),
                         False, 1.0)
    assert tft.mse_render_launches == before


def test_other_devices_raise_without_fallback(params):
    t = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="no mse_render kernel"):
        tft.fused_mse_render(params_from_numpy(params), t, t, t, t, True,
                             1.0)
