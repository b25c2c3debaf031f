"""The port's fused point MLP (`nerf_apply_fused`, `nerf_sigma_fused`,
`fused_nerf_mlp`'s custom VJP) against the JAX package's.

On the CPU the port runs the plain versions of its kernels; the JAX
functions run their Pallas kernels in interpret mode, as
tests/test_fused.py runs them. Both get the same JAX-initialised weights
(params_from_numpy) and the same numpy points, 300 of them (the JAX tests'
size: the MLP is fixed at width 256). Bars are the JAX kernels' own:
forward rgb and sigma atol 5e-3 (`TestFusedForward`), weight gradients of
`TestFusedGradients`' loss within a relative max error of 0.02 per leaf,
and the gradient of duplicated points twice the gradient (rtol 1e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.ops.fused_mlp import nerf_apply_fused as jfused
from nerf_pl_tpu.ops.fused_mlp import nerf_sigma_fused as jsigma
from nerf_pl_tpu_torch.models import params_from_numpy
from nerf_pl_tpu_torch.ops import fused_mlp as tfm


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray, jinit(jax.random.PRNGKey(0)))


def _points(P, seed=1):
    rng = np.random.default_rng(seed)
    xyz = (2 * rng.normal(size=(P, 3))).astype(np.float32)
    d = rng.normal(size=(P, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return xyz, d


def _leaves(params):
    """The port's params as leaves that require grad."""
    return {m: {k: v.clone().requires_grad_() for k, v in leaves.items()}
            for m, leaves in params_from_numpy(params).items()}


@pytest.mark.parametrize("P", [300, 13])
def test_forward_matches_jax(params, P):
    """Ragged P: the JAX wrapper pads to its tile, the port masks."""
    xyz, d = _points(P)
    rgb_j, sig_j = jfused(params, jnp.asarray(xyz), jnp.asarray(d), tile=128)
    rgb_t, sig_t = tfm.nerf_apply_fused(params_from_numpy(params),
                                        torch.from_numpy(xyz),
                                        torch.from_numpy(d), tile=128)
    assert rgb_t.shape == (P, 3) and sig_t.shape == (P, 1)
    np.testing.assert_allclose(rgb_t.detach().numpy(), np.asarray(rgb_j),
                               atol=5e-3)
    np.testing.assert_allclose(sig_t.detach().numpy(), np.asarray(sig_j),
                               atol=5e-3)


def test_sigma_only_matches_jax(params):
    xyz, _ = _points(300)
    s_j = jsigma(params, jnp.asarray(xyz), tile=128)
    s_t = tfm.nerf_sigma_fused(params_from_numpy(params),
                               torch.from_numpy(xyz))
    assert s_t.shape == (300, 1) and s_t.grad_fn is None
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=5e-3)


def test_batch_shapes_and_dir_broadcast(params):
    """(3, 100) points with one direction per row of 100, as render_rays
    passes rays_d[:, None, :]."""
    xyz, d = _points(300)
    xyz3, d3 = xyz.reshape(3, 100, 3), d.reshape(3, 100, 3)[:, :1, :]
    rgb_j, sig_j = jfused(params, jnp.asarray(xyz3), jnp.asarray(d3),
                          tile=128)
    rgb_t, sig_t = tfm.nerf_apply_fused(params_from_numpy(params),
                                        torch.from_numpy(xyz3),
                                        torch.from_numpy(d3))
    assert rgb_t.shape == (3, 100, 3) and sig_t.shape == (3, 100, 1)
    np.testing.assert_allclose(rgb_t.detach().numpy(), np.asarray(rgb_j),
                               atol=5e-3)
    np.testing.assert_allclose(sig_t.detach().numpy(), np.asarray(sig_j),
                               atol=5e-3)


def test_packed_weights_give_the_same_forward(params):
    """A PackedMLP (how make_render_fn hands the weights over, once per
    call) and the dict give the same numbers."""
    xyz, d = _points(64, seed=2)
    x, dt = torch.from_numpy(xyz), torch.from_numpy(d)
    p = params_from_numpy(params)
    rgb_a, sig_a = tfm.nerf_apply_fused(p, x, dt)
    rgb_b, sig_b = tfm.nerf_apply_fused(tfm.pack_mlp(p, "cpu"), x, dt)
    torch.testing.assert_close(rgb_a, rgb_b, rtol=0, atol=0)
    torch.testing.assert_close(sig_a, sig_b, rtol=0, atol=0)
    s = tfm.nerf_sigma_fused(tfm.pack_mlp(p, "cpu"), x)
    torch.testing.assert_close(s, sig_a.detach(), rtol=0, atol=0)


def test_grads_match_jax(params):
    """TestFusedGradients' loss through torch.autograd against jax.grad
    through the JAX custom VJP (measured 4.5e-3 at most)."""
    xyz, d = _points(300)

    def loss_j(p):
        rgb, sig = jfused(p, jnp.asarray(xyz), jnp.asarray(d), tile=128)
        return jnp.mean(rgb ** 2) + jnp.mean(jax.nn.relu(sig))

    g_j = jax.grad(loss_j)(params)
    leaves = _leaves(params)
    rgb, sig = tfm.nerf_apply_fused(leaves, torch.from_numpy(xyz),
                                    torch.from_numpy(d))
    (torch.mean(rgb ** 2) + torch.mean(torch.relu(sig))).backward()
    for layer in g_j:
        for leaf in ("w", "b"):
            a = leaves[layer][leaf].grad.numpy()
            b = np.asarray(g_j[layer][leaf])
            rel = np.abs(a - b).max() / (np.abs(b).max() + 1e-8)
            assert rel < 0.02, f"{layer}/{leaf}: rel {rel}"


def test_grad_accumulates_across_tiles(params):
    """The same points twice give exactly twice the gradient."""
    xyz, d = _points(300)

    def grad_of(x, dd):
        leaves = _leaves(params)
        rgb, _ = tfm.nerf_apply_fused(leaves, torch.from_numpy(x),
                                      torch.from_numpy(dd))
        rgb.sum().backward()
        return leaves["xyz_3"]["w"].grad.numpy()

    g1 = grad_of(xyz, d)
    g2 = grad_of(np.concatenate([xyz, xyz]), np.concatenate([d, d]))
    np.testing.assert_allclose(g2, 2 * g1, rtol=1e-2, atol=1e-5)


def test_function_gradients_are_float32(params):
    """The Function's primal is the f32 pack: its 17 gradients come back
    f32 in the pack's shapes, and the points get none."""
    xyz, d = _points(40)
    packed = tuple(t.requires_grad_() for t in tfm.pack_params(
        params_from_numpy(params)))
    x8 = torch.cat([torch.from_numpy(xyz), torch.zeros((40, 5))], -1)
    d8 = torch.cat([torch.from_numpy(d), torch.zeros((40, 5))], -1)
    x8.requires_grad_()
    out = tfm.fused_nerf_mlp(packed, x8, d8)
    assert out.shape == (40, 8) and not out[:, 4:].any()
    out[:, :4].sum().backward()
    assert x8.grad is None
    for i, t in enumerate(packed):
        assert t.grad is not None and t.grad.dtype == torch.float32, i
        assert t.grad.shape == t.shape, i
    # bf16 rounding of the gradients would leave at most 8 mantissa bits
    g = packed[4].grad
    assert torch.any(g != g.to(torch.bfloat16).float())


def test_cpu_tensor_takes_plain_version(params, monkeypatch):
    """A CPU tensor never reaches a kernel path or its counter."""
    def no_kernel(*a, **k):
        raise AssertionError("kernel path taken for a CPU tensor")
    for name in ("_mlp_fwd_cuda", "_mlp_bwd_cuda", "_sigma_fwd_cuda"):
        monkeypatch.setattr(tfm, name, no_kernel)
    before = (tfm.mlp_fwd_launches, tfm.mlp_bwd_launches,
              tfm.sigma_fwd_launches)
    xyz, d = _points(16)
    leaves = _leaves(params)
    rgb, sig = tfm.nerf_apply_fused(leaves, torch.from_numpy(xyz),
                                    torch.from_numpy(d))
    (rgb.sum() + sig.sum()).backward()
    tfm.nerf_sigma_fused(leaves, torch.from_numpy(xyz))
    assert (tfm.mlp_fwd_launches, tfm.mlp_bwd_launches,
            tfm.sigma_fwd_launches) == before


@pytest.mark.parametrize("fn", ["forward", "sigma", "backward"])
def test_other_devices_raise_without_fallback(params, fn):
    mlp = tfm.pack_mlp(params_from_numpy(params), "cpu")
    t = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="no .* kernel for device meta"):
        if fn == "forward":
            tfm.mlp_forward(mlp, t, t)
        elif fn == "sigma":
            tfm.sigma_forward(mlp, t)
        else:
            tfm.mlp_backward(mlp, t, t, t)
