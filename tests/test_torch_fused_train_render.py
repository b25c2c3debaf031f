"""The port's two-kernel fused training render (`fused_train_render`: a
forward and a backward, trained by autograd) against the JAX package's.

On the CPU the port's forward and backward run their plain PyTorch
versions; the JAX `fused_train_render` runs its Pallas kernels in
interpret mode, as tests/test_fused_train.py runs them, and `jax.grad`
differentiates it through its custom VJP. Both get the same JAX-initialised
weights (params_from_numpy, sigma head x10, +1 as that file's
dense_params) and the same numpy rays, depths and noise, at that file's
sizes: R = 32, S = 16, and R = 64 with 16 + 8 samples. The gradient tests
take test_torch_fused_train.py's inputs (depths sorted uniform per ray):
on that file's z linear in [2, 6] with sigma noise, the one-element sigma
bias gradient, a sum of cancelling terms, differs by 16% between the two
frameworks' bf16 products on both training paths alike (mse_render too),
while its size is ~1e-3 of the other leaves'.

Bars are tests/test_fused_train.py's: out8 rgb and opacity 1e-2, depth
2e-2, weights 5e-3 (TestForwardParity); each gradient leaf within a
relative max error (max |port - jax| / max |jax|) of 0.03
(TestGradientParity); the two plain backwards (given cotangent and MSE)
within 1e-3 relative (TestLossFused::test_grads_match_custom_vjp_path);
a whole render_rays within 2e-2 (TestRenderRaysIntegration).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_train import _dense, _inputs, _rel, _step_draws

from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.ops.fused_mlp import pack_params as jpack
from nerf_pl_tpu.ops.fused_train import fused_train_render as jftr
from nerf_pl_tpu.rendering import RenderConfig as JRenderConfig
from nerf_pl_tpu.rendering import render_rays as jrender
from nerf_pl_tpu.training import loss_dict as jloss
from nerf_pl_tpu_torch.models import params_from_numpy
from nerf_pl_tpu_torch.ops import fused_mlp as tfm
from nerf_pl_tpu_torch.ops import fused_train as tft
from nerf_pl_tpu_torch.parallel import Trainer
from nerf_pl_tpu_torch.rendering import (ModelConfig, RenderConfig,
                                         TrainDraws, render_rays)
from nerf_pl_tpu_torch.training import (get_lr_schedule, get_optimizer,
                                        loss_dict)
from nerf_pl_tpu_torch.training.optimizers import tree_leaves, \
    tree_unflatten

GRAD_TOL = 0.03


@pytest.fixture(scope="module")
def params():
    return _dense(0)


def _rays_lin(R, S, seed=0):
    """tests/test_fused_train.py make_rays: unit directions, z linear in
    [2, 6]."""
    rays, _, _, _ = _inputs(R, S, seed)
    z = np.broadcast_to(np.linspace(2.0, 6.0, S, dtype=np.float32),
                        (R, S)).copy()
    return rays, z


def _jax_render(params, rays, z, noise, white_back):
    return jftr(jpack(params), jnp.asarray(rays), jnp.asarray(z),
                jnp.asarray(noise), white_back, 512, 512)


@pytest.mark.parametrize("white_back", [True, False])
def test_forward_matches_jax(params, white_back):
    R, S = 32, 16
    rays, z = _rays_lin(R, S)
    noise = (0.7 * np.random.default_rng(9).normal(size=(R, S))).astype(
        np.float32)
    o8_j, w_j = map(np.asarray, _jax_render(params, rays, z, noise,
                                            white_back))
    with torch.no_grad():
        o8_t, w_t = tft.fused_train_render(
            tfm.pack_params(params_from_numpy(params)),
            *map(torch.from_numpy, (rays, z, noise)), white_back)
    for name, cols, tol in (("rgb", slice(0, 3), 1e-2),
                            ("depth", slice(3, 4), 2e-2),
                            ("opacity", slice(4, 5), 1e-2)):
        np.testing.assert_allclose(o8_t[:, cols].numpy(), o8_j[:, cols],
                                   atol=tol, err_msg=name)
    assert not o8_t[:, 5:].any()
    np.testing.assert_allclose(w_t.numpy(), w_j, atol=5e-3)


def _loss(kind, out8, weights, gt):
    if kind == "rgb_mse":
        return ((out8[:, 0:3] - gt) ** 2).mean()
    if kind == "depth_opacity":
        return (out8[:, 3] ** 2).mean() + 0.3 * out8[:, 4].mean()
    return (weights ** 2).mean()


@pytest.mark.parametrize("kind,white_back", [("rgb_mse", True),
                                             ("depth_opacity", False),
                                             ("weights", False)])
def test_gradients_match_jax(params, kind, white_back):
    """autograd through the port's Function against jax.grad through the
    JAX custom VJP, per leaf, for a loss on the rgb, on depth and opacity,
    and on the weights (measured worst leaves 1.08e-2, 1.76e-2, 1.44e-2)."""
    R, S = 32, 16
    rays, z, noise, gt = _inputs(R, S)
    gt = gt[:, :3].copy()
    if kind != "rgb_mse":
        noise[:] = 0.0

    def loss_j(p):
        out8, w = _jax_render(p, rays, z, noise, white_back)
        return _loss(kind, out8, w, jnp.asarray(gt))

    g_j = jax.grad(loss_j)(jax.tree_util.tree_map(jnp.asarray, params))
    tp = params_from_numpy(params)
    leaves = [v.requires_grad_() for v in tree_leaves(tp)]
    out8, w = tft.fused_train_render(tfm.pack_params(tp),
                                     *map(torch.from_numpy, (rays, z, noise)),
                                     white_back)
    g_t = tree_unflatten(tp, list(torch.autograd.grad(
        _loss(kind, out8, w, torch.from_numpy(gt)), leaves)))
    for layer in g_j:
        for leaf in ("w", "b"):
            a = g_t[layer][leaf]
            b = np.asarray(g_j[layer][leaf])
            assert a.dtype == torch.float32 and a.shape == b.shape
            rel = _rel(a.numpy(), b)
            assert rel <= GRAD_TOL, f"{layer}/{leaf}: {rel}"


def test_mse_cotangent_matches_mse_render(params):
    """The two training kernels' plain versions agree: the backward with
    g_rgb = 2 scale (rgb - gt) and nothing else gives fused_mse_render's
    gradients (within 1e-3 relative), and the forward its out8 and weights
    exactly."""
    R, S = 32, 16
    rays, z, noise, gt = map(torch.from_numpy, _inputs(R, S, seed=6))
    mlp = tfm.pack_mlp(params_from_numpy(params), "cpu")
    scale = 1.0 / (R * 3)
    ref8, ref_w, ref_g = tft.fused_mse_render_reference(mlp, rays, z, noise,
                                                        gt, True, scale)
    out8, w = tft.fused_train_render_reference(mlp, rays, z, noise, True)
    assert torch.equal(out8, ref8) and torch.equal(w, ref_w)
    g8 = torch.zeros((R, 8))
    g8[:, 0:3] = 2.0 * scale * (out8[:, 0:3] - gt[:, 0:3])
    grads = tft.fused_train_render_backward_reference(mlp, rays, z, noise,
                                                      True, g8, None)
    for i, (a, b) in enumerate(zip(grads, ref_g)):
        assert a.shape == b.shape, i
        assert _rel(a.numpy(), b.numpy()) <= 1e-3, (i, _rel(a, b))


def test_absent_weights_cotangent_reads_as_zero(params):
    """gw None (the usual case: the weights feed only the detached
    resampling) gives exactly the gradients of an explicit zero gw."""
    R, S = 8, 16
    rays, z, noise, _ = map(torch.from_numpy, _inputs(R, S, seed=7))
    mlp = tfm.pack_mlp(params_from_numpy(params), "cpu")
    g8 = torch.from_numpy(np.random.default_rng(8).normal(
        size=(R, 8)).astype(np.float32))
    a = tft.train_backward(mlp, rays, z, noise, False, g8, None)
    b = tft.train_backward(mlp, rays, z, noise, False, g8,
                           torch.zeros((R, S)))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_quad_vjp_full_cotangent_matches_autograd():
    """The analytic quadrature VJP with cotangents on rgb, depth, opacity
    and the weights against autograd through quad_forward, in float64 and
    away from saturation (atol 1e-9)."""
    rng = np.random.default_rng(3)
    R, S = 6, 40
    z = torch.from_numpy(np.sort(rng.uniform(2, 6, (R, S)), -1))
    dn = torch.from_numpy(rng.uniform(0.5, 1.5, (R, 1)))
    sig = torch.from_numpy(rng.normal(size=(R, S))).requires_grad_()
    noise = torch.from_numpy(0.3 * rng.normal(size=(R, S)))
    rgbs = torch.from_numpy(rng.random((R, S, 3))).requires_grad_()
    g8 = torch.from_numpy(rng.normal(size=(R, 8)))
    gw = torch.from_numpy(rng.normal(size=(R, S)))
    for white in (True, False):
        q = tft.quad_forward(z, dn, sig, noise, rgbs, white)
        loss = ((q.rgb * g8[:, 0:3]).sum() + (q.depth * g8[:, 3]).sum()
                + (q.opacity * g8[:, 4]).sum() + (q.weights * gw).sum())
        ref_sig, ref_rgb = torch.autograd.grad(loss, [sig, rgbs])
        d_sig, d_rgb = tft.quad_vjp(q, rgbs.detach(), g8[:, 0:3], white,
                                    tft.cotangent_base(z, g8, gw))
        torch.testing.assert_close(d_sig, ref_sig, atol=1e-9, rtol=0)
        torch.testing.assert_close(d_rgb, ref_rgb, atol=1e-9, rtol=0)


def test_render_rays_fused_train_matches_jax():
    """render_rays with fused_train (16 + 8 samples, perturb 1, noise 1,
    white background) against the JAX render_rays with the same config,
    JAX's draws injected: every key within 2e-2."""
    R = 64
    params = {"nerf_coarse": _dense(0), "nerf_fine": _dense(1)}
    rays, _ = _rays_lin(R, 1)
    base = dict(N_samples=16, N_importance=8, white_back=True, perturb=1.0,
                noise_std=1.0, fused_train=True)
    key = jax.random.PRNGKey(7)
    ref = jrender(params, jnp.asarray(rays), key, JRenderConfig(**base))
    cfg = RenderConfig(**base)
    with torch.no_grad():
        ours = render_rays({k: params_from_numpy(v)
                            for k, v in params.items()},
                           torch.from_numpy(rays), cfg,
                           draws=_step_draws(key, R, cfg))
    assert set(ours) == set(ref) and "rgb_coarse" in ours
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-2, err_msg=k)


def _trainer(rcfg, batch):
    sched = get_lr_schedule("steplr", 1e-3, 4, 10, decay_step=[100])
    return Trainer(ModelConfig(), rcfg, get_optimizer("adam", sched), sched,
                   loss_dict["mse"], batch, "cpu")


def test_trainer_step_matches_jax():
    """One Trainer step's loss and gradients on fused_train (autograd
    through fused_train_render, both passes, perturb and noise) against
    jax.value_and_grad over JAX's render_rays, JAX's draws injected, on
    JAX-initialised weights (as test_fused_autograd_step_matches_jax). Loss
    within 1e-4 relative; each leaf within the relative max error 0.03."""
    R = 32
    params = {m: jax.tree_util.tree_map(np.asarray,
                                        jinit(jax.random.PRNGKey(k)))
              for k, m in enumerate(("nerf_coarse", "nerf_fine"))}
    rays, _, _, gt = _inputs(R, 1, seed=2)
    rgbs = gt[:, :3].copy()
    base = dict(N_samples=16, N_importance=8, white_back=True, perturb=1.0,
                noise_std=1.0, fused_train=True)
    key = jax.random.PRNGKey(5)

    def loss_of(p):
        out = jrender(p, jnp.asarray(rays), key, JRenderConfig(**base))
        return jloss["mse"](out, jnp.asarray(rgbs))

    loss_j, g_j = jax.value_and_grad(loss_of)(params)
    cfg = RenderConfig(**base)
    loss_t, _, g_t = _trainer(cfg, R)._loss_and_grads(
        {k: params_from_numpy(v) for k, v in params.items()},
        torch.from_numpy(rays), torch.from_numpy(rgbs), None,
        draws=_step_draws(key, R, cfg))
    assert abs(float(loss_t) - float(loss_j)) <= 1e-4 * float(loss_j)
    for model in g_j:
        for layer in g_j[model]:
            for leaf in ("w", "b"):
                a = g_t[model][layer][leaf]
                b = np.asarray(g_j[model][layer][leaf])
                assert a.dtype == torch.float32
                rel = _rel(a.numpy(), b)
                assert rel <= GRAD_TOL, (model, layer, leaf, rel)


def test_trainer_descends_with_fused_train():
    """The Trainer on RenderConfig(fused_train=True) (autograd, not the
    loss-fused step) runs 20 steps at batch 128 and the loss falls (the
    JAX package's test_trainer_descends_with_fused_train)."""
    rng = np.random.default_rng(0)
    n = 2048
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 2.0, np.float32),
                           np.full((n, 1), 6.0, np.float32)], 1)
    rgbs = rng.random((n, 3)).astype(np.float32)
    tr = _trainer(RenderConfig(N_samples=16, N_importance=8, perturb=1.0,
                               noise_std=0.0, fused_train=True), 128)
    tr.set_data(rays, rgbs)
    state = tr.init_state(torch.Generator().manual_seed(0))
    state, m = tr.run_steps(state, 1, 20)
    losses = m["loss"].numpy()
    assert np.all(np.isfinite(losses))
    assert losses[-5:].mean() < losses[:5].mean()


def test_cpu_tensor_takes_plain_versions(params, monkeypatch):
    """A CPU tensor never reaches either kernel path or its counter."""
    def no_kernel(*a, **k):
        raise AssertionError("kernel path taken for a CPU tensor")
    monkeypatch.setattr(tft, "_train_fwd_cuda", no_kernel)
    monkeypatch.setattr(tft, "_train_bwd_cuda", no_kernel)
    before = (tft.train_fwd_launches, tft.train_bwd_launches)
    rays, z, noise, _ = map(torch.from_numpy, _inputs(4, 8))
    tp = params_from_numpy(params)
    leaves = [v.requires_grad_() for v in tree_leaves(tp)]
    out8, _ = tft.fused_train_render(tfm.pack_params(tp), rays, z, noise,
                                     False)
    torch.autograd.grad(out8[:, 0:3].sum(), leaves)
    assert (tft.train_fwd_launches, tft.train_bwd_launches) == before


@pytest.mark.parametrize("fn", ["train_forward", "train_backward"])
def test_other_devices_raise_without_fallback(params, fn):
    t = torch.empty((4, 8), device="meta")
    mlp = tfm.pack_mlp(params_from_numpy(params), "cpu")
    kernel = "train_fwd" if fn == "train_forward" else "train_bwd"
    with pytest.raises(ValueError, match=f"no {kernel} kernel"):
        if fn == "train_forward":
            tft.train_forward(mlp, t, t, t, True)
        else:
            tft.train_backward(mlp, t, t, t, True, t, None)


def test_draws_without_noise_give_zero_noise(params):
    """noise_std = 0: the kernels get zeros, and the render equals one with
    an explicit zero draw."""
    R = 8
    p = {"nerf_coarse": params_from_numpy(params)}
    rays = torch.from_numpy(_rays_lin(R, 1)[0])
    cfg = RenderConfig(N_samples=16, fused_train=True)
    with torch.no_grad():
        a = render_rays(p, rays, cfg)
        b = render_rays(p, rays, RenderConfig(N_samples=16, fused_train=True,
                                              noise_std=1.0),
                        draws=TrainDraws(noise_coarse=torch.zeros((R, 16))))
    for k in a:
        assert torch.equal(a[k], b[k]), k
