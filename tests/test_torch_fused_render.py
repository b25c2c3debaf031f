"""The port's fused render functions against the JAX Pallas kernels.

On the CPU the port's `fused_sigma_render` / `fused_render_eval` run their
plain PyTorch versions; the JAX kernels run in Pallas interpret mode, as
tests/test_fused.py runs them. Both get the same JAX-initialised weights
(via params_from_numpy) and the same numpy rays. Tolerances are those of
the JAX kernels' own tests: weights 5e-3, rgb and opacity 1e-2, depth
5e-2 (bf16 products summed in another order; depth is in scene units,
up to 6). The CUDA kernels are held against the same plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu.models import init_nerf_params as jax_init
from nerf_pl_tpu.ops import fused_render as jfr
from nerf_pl_tpu.ops.fused_mlp import pack_params as jax_pack
from nerf_pl_tpu_torch.models import params_from_numpy
from nerf_pl_tpu_torch.ops import fused_mlp as tfm
from nerf_pl_tpu_torch.ops import fused_render as tfr


def _rays(R, S, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((R, 1), 2, np.float32),
                           np.full((R, 1), 6, np.float32)], 1)
    # sorted, unevenly spaced depths in [2, 6]
    z = np.sort(rng.uniform(2.0, 6.0, size=(R, S)).astype(np.float32), -1)
    return rays, z


def _dense_params(key=0):
    """JAX init with the sigma head scaled so the field is opaque in
    places (tests/test_fused.py _dense_params)."""
    p = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(key)))
    p["sigma"]["w"] = p["sigma"]["w"] * 50
    p["sigma"]["b"] = p["sigma"]["b"] + 2.0
    return p


@pytest.fixture(scope="module")
def params():
    return _dense_params(0)


@pytest.mark.parametrize("R", [40, 13])
def test_sigma_render_matches_jax_kernel(params, R):
    rays, z = _rays(R, 32)
    w_j, op_j = jfr.fused_sigma_render(params, jnp.asarray(rays),
                                       jnp.asarray(z), points_per_tile=256)
    w_t, op_t = tfr.fused_sigma_render(params_from_numpy(params),
                                       torch.from_numpy(rays),
                                       torch.from_numpy(z))
    assert w_t.shape == (R, 32) and op_t.shape == (R,)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=5e-3)
    np.testing.assert_allclose(op_t.numpy(), np.asarray(op_j), atol=1e-2)


@pytest.mark.parametrize("R,white_back", [(40, True), (13, False)])
def test_render_eval_matches_jax_kernel(params, R, white_back):
    rays, z = _rays(R, 32, seed=1)
    out_j = jfr.fused_render_eval(params, jnp.asarray(rays), jnp.asarray(z),
                                  white_back=white_back, points_per_tile=256)
    out_t = tfr.fused_render_eval(params_from_numpy(params),
                                  torch.from_numpy(rays), torch.from_numpy(z),
                                  white_back=white_back)
    assert out_t["rgb"].shape == (R, 3)
    for k, tol in (("rgb", 1e-2), ("opacity", 1e-2), ("depth", 5e-2)):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=tol, err_msg=k)


def test_pack_params_matches_jax(params):
    packed_j = jax_pack(params)
    packed_t = tfm.pack_params(params_from_numpy(params))
    assert len(packed_t) == tfm.N_PACKED == len(packed_j)
    for a, b in zip(packed_t, packed_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_kernel_layout_shapes(params):
    k = tfr.kernel_layout(tfm.precast(tfm.pack_params(
        params_from_numpy(params))))
    assert k["w0"].shape == (80, 256) and k["wsk"].shape == (80, 256)
    assert k["wdd"].shape == (48, 128) and k["wt"].shape == (7, 256, 256)
    assert k["w0"].dtype == torch.bfloat16 and k["bt"].dtype == torch.float32
    # rows 8..15 are the zero gap between the raw and sin/cos rows
    assert not k["w0"][8:16].any() and not k["wdd"][8:16].any()


def test_pad_rays_stay_finite(params):
    """Zero-direction pad rows (make_render_fn's) give weights 0."""
    rays = np.zeros((5, 8), np.float32)
    rays[:, 7] = 1.0
    z = np.tile(np.linspace(0, 1, 16, dtype=np.float32), (5, 1))
    w, op = tfr.fused_sigma_render(params_from_numpy(params),
                                   torch.from_numpy(rays), torch.from_numpy(z))
    assert torch.isfinite(w).all() and torch.count_nonzero(w) == 0
    out = tfr.fused_render_eval(params_from_numpy(params),
                                torch.from_numpy(rays), torch.from_numpy(z),
                                white_back=True)
    for v in out.values():
        assert torch.isfinite(v).all()


def test_cpu_tensor_takes_plain_version(params, monkeypatch):
    """A CPU tensor never reaches the kernel path or its counter."""
    def no_kernel(*a, **k):
        raise AssertionError("kernel path taken for a CPU tensor")
    monkeypatch.setattr(tfr, "_sigma_render_cuda", no_kernel)
    monkeypatch.setattr(tfr, "_render_eval_cuda", no_kernel)
    before = (tfr.sigma_render_launches, tfr.render_eval_launches)
    rays, z = _rays(4, 8)
    tp = params_from_numpy(params)
    tfr.fused_sigma_render(tp, torch.from_numpy(rays), torch.from_numpy(z))
    tfr.fused_render_eval(tp, torch.from_numpy(rays), torch.from_numpy(z),
                          white_back=False)
    assert (tfr.sigma_render_launches, tfr.render_eval_launches) == before


def test_missing_nvcc_raises(monkeypatch):
    from nerf_pl_tpu_torch.ops import _build
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_other_devices_raise_without_fallback(params):
    """Only a CPU tensor may take the plain version; any other device goes
    to the kernel path or raises."""
    rays = torch.empty((4, 8), device="meta")
    z = torch.empty((4, 8), device="meta")
    tp = params_from_numpy(params)
    with pytest.raises(ValueError, match="no sigma_render kernel"):
        tfr.fused_sigma_render(tp, rays, z)
    with pytest.raises(ValueError, match="no render_eval kernel"):
        tfr.fused_render_eval(tp, rays, z, white_back=True)
