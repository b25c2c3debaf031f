"""The port's test-time render path against the JAX package's, on the same
numpy rays and JAX-initialised weights.

render_rays compares every output key at atol 2e-2, the bar of
tests/test_fused.py::test_render_rays_fused_test_time_path: the fused
branches run bf16 products, and the resampled fine depths follow the
coarse weights. The unfused f32 branch and volume_quadrature are held
tighter. With perturb or sigma noise the JAX render's draws are made from
its key, as it splits it, and injected on the torch side (TrainDraws)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_train import _step_draws

from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.rendering import RenderConfig as JRenderConfig
from nerf_pl_tpu.rendering import render_rays as jrender
from nerf_pl_tpu.rendering import volume_quadrature as jquad
from nerf_pl_tpu_torch.models import params_from_numpy
from nerf_pl_tpu_torch.parallel import make_render_fn
from nerf_pl_tpu_torch.rendering import (RenderConfig, render_rays,
                                         render_rays_chunked,
                                         volume_quadrature)


def _dense(key):
    p = jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(key)))
    p["sigma"]["w"] = p["sigma"]["w"] * 50
    p["sigma"]["b"] = p["sigma"]["b"] + 2.0
    return p


@pytest.fixture(scope="module")
def params():
    return {"nerf_coarse": _dense(0), "nerf_fine": _dense(1)}


def _torch_params(params):
    return {k: params_from_numpy(v) for k, v in params.items()}


def _rays(R, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((R, 1), 2, np.float32),
                           np.full((R, 1), 6, np.float32)], 1)


def test_volume_quadrature_matches_jax(rng):
    R, S = 9, 17
    sig = (rng.normal(size=(R, S)) * 5).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (R, S)), -1).astype(np.float32)
    dn = rng.uniform(0.5, 1.5, (R, 1)).astype(np.float32)
    rgbs = rng.random((R, S, 3)).astype(np.float32)
    ref = jquad(jnp.asarray(sig), jnp.asarray(z), jnp.asarray(dn), None,
                jnp.asarray(rgbs), True)
    ours = volume_quadrature(torch.from_numpy(sig), torch.from_numpy(z),
                             torch.from_numpy(dn), None,
                             torch.from_numpy(rgbs), True)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_render_rays_matches_jax(params, fused):
    rays = _rays(40)
    base = dict(N_samples=32, N_importance=16, test_time=True,
                white_back=True, fused=fused)
    ref = jrender(params, jnp.asarray(rays), jax.random.PRNGKey(0),
                  JRenderConfig(**base))
    ours = render_rays(_torch_params(params), torch.from_numpy(rays),
                       RenderConfig(**base))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-2, err_msg=k)


def test_render_rays_coarse_only_and_disparity(params):
    rays = _rays(16, seed=3)
    base = dict(N_samples=24, N_importance=0, test_time=True, use_disp=True)
    ref = jrender(params, jnp.asarray(rays), jax.random.PRNGKey(0),
                  JRenderConfig(**base))
    ours = render_rays(_torch_params(params), torch.from_numpy(rays),
                       RenderConfig(**base))
    assert set(ours) == set(ref) == {"opacity_coarse"}
    np.testing.assert_allclose(ours["opacity_coarse"].numpy(),
                               np.asarray(ref["opacity_coarse"]), atol=1e-4)


@pytest.mark.parametrize("fused,test_time", [(False, True), (True, True),
                                             (True, False)],
                         ids=["unfused", "fused", "fused_validation"])
def test_make_render_fn_matches_trainer(params, fused, test_time):
    """A ragged ray count, padded with far=1 zero rays, against the JAX
    Trainer.render_fn on a one-device mesh. test_time off with fused is
    the validation config: both passes through the point-MLP kernel."""
    from nerf_pl_tpu.parallel import Trainer, make_mesh
    from nerf_pl_tpu.rendering import ModelConfig as JModelConfig
    from nerf_pl_tpu.training import get_optimizer, loss_dict

    rays = _rays(101, seed=1)
    base = dict(N_samples=16, N_importance=8, test_time=test_time,
                white_back=True, fused=fused)
    rcfg = JRenderConfig(**base)
    mesh = make_mesh(num_data=1)
    tr = Trainer(mesh, JModelConfig(), rcfg, get_optimizer("adam", 1e-3),
                 lambda s: 1e-3, loss_dict["mse"], 1)
    ref = tr.render_fn(rcfg, chunk=32)(params, rays)
    ours = make_render_fn(RenderConfig(**base), 32, "cpu")(params, rays)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape
        np.testing.assert_allclose(ours[k], ref[k], atol=2e-2, err_msg=k)


def test_make_render_fn_device_out_and_chunked(params):
    rays = torch.from_numpy(_rays(50, seed=2))
    rcfg = RenderConfig(N_samples=8, N_importance=4, test_time=True)
    out = make_render_fn(rcfg, 16, "cpu", device_out=True)(params, rays)
    chunked = render_rays_chunked(_torch_params(params), rays, rcfg,
                                  chunk=16)
    assert all(isinstance(v, torch.Tensor) for v in out.values())
    for k in out:
        assert out[k].shape[0] == 50
        torch.testing.assert_close(out[k], chunked[k])


@pytest.mark.parametrize("perturb,noise_std", [(1.0, 1.0), (1.0, 0.0),
                                               (0.0, 1.0)])
def test_render_rays_fused_perturbed_test_time_matches_jax(params, perturb,
                                                           noise_std):
    """Test time with perturb or sigma noise leaves the render kernels:
    the coarse pass runs nerf_sigma_fused, the fine nerf_apply_fused, each
    followed by the plain volume_quadrature."""
    R = 40
    rays = _rays(R, seed=4)
    base = dict(N_samples=32, N_importance=16, test_time=True,
                white_back=True, fused=True, perturb=perturb,
                noise_std=noise_std)
    key = jax.random.PRNGKey(3)
    ref = jrender(params, jnp.asarray(rays), key, JRenderConfig(**base))
    cfg = RenderConfig(**base)
    ours = render_rays(_torch_params(params), torch.from_numpy(rays), cfg,
                       draws=_step_draws(key, R, cfg))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-2, err_msg=k)


def test_render_rays_fused_train_time_matches_jax(params):
    """Train time with fused (perturb 1, noise 1): both passes through
    nerf_apply_fused and the plain volume_quadrature."""
    R = 40
    rays = _rays(R, seed=5)
    base = dict(N_samples=32, N_importance=16, white_back=True, fused=True,
                perturb=1.0, noise_std=1.0)
    key = jax.random.PRNGKey(4)
    ref = jrender(params, jnp.asarray(rays), key, JRenderConfig(**base))
    cfg = RenderConfig(**base)
    ours = render_rays(_torch_params(params), torch.from_numpy(rays), cfg,
                       draws=_step_draws(key, R, cfg))
    assert set(ours) == set(ref) and "rgb_coarse" in ours
    for k in ref:
        np.testing.assert_allclose(ours[k].detach().numpy(),
                                   np.asarray(ref[k]), atol=2e-2, err_msg=k)
