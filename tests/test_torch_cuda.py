"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. Run them there
with `python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest`.
This file imports no jax, and --noconftest skips tests/conftest.py, which
does: the machine with the card has no jax.

Tolerances are the JAX kernels' test bars: weights 5e-3, rgb and opacity
1e-2, depth 5e-2 (bf16 operands; the kernel and the plain version sum in
different orders, and a bf16 rounding of an activation can flip).
"""
import pytest
import torch

from nerf_pl_tpu_torch.models import init_nerf_params
from nerf_pl_tpu_torch.ops import fused_render as fr
from nerf_pl_tpu_torch.parallel import make_render_fn
from nerf_pl_tpu_torch.rendering import RenderConfig

pytestmark = pytest.mark.cuda

TOL = {"weights": 5e-3, "rgb": 1e-2, "opacity": 1e-2, "depth": 5e-2}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def dense_params(seed, dev):
    """Random init with the sigma head x50, +2 so the field is opaque in
    places (tests/test_fused.py's dense-sigma trick)."""
    p = init_nerf_params(torch.Generator().manual_seed(seed), device=dev)
    p["sigma"]["w"] = p["sigma"]["w"] * 50
    p["sigma"]["b"] = p["sigma"]["b"] + 2.0
    return p


def rays_z(R, S, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn((R, 3), generator=g)
    d = torch.nn.functional.normalize(torch.randn((R, 3), generator=g), dim=-1)
    rays = torch.cat([o, d, torch.full((R, 1), 2.0), torch.full((R, 1), 6.0)],
                     dim=-1)
    z = torch.sort(2.0 + 4.0 * torch.rand((R, S), generator=g), dim=-1).values
    return rays.to(dev), z.to(dev)


def max_err(a, b):
    return (a - b).abs().max().item()


@pytest.mark.parametrize("R,S,white_back", [(4099, 64, True),
                                            (4099, 192, True),
                                            (1, 24, False), (37, 24, True),
                                            (5, 300, False)])
def test_kernels_match_plain(dev, R, S, white_back):
    mlp = fr.pack_mlp(dense_params(0, dev), dev)
    rays, z = rays_z(R, S, dev)
    n0 = (fr.sigma_render_launches, fr.render_eval_launches)
    w_k, op_k = fr.fused_sigma_render(mlp, rays, z)
    out_k = fr.fused_render_eval(mlp, rays, z, white_back=white_back)
    assert (fr.sigma_render_launches, fr.render_eval_launches) == \
        (n0[0] + 1, n0[1] + 1)
    w_p, op_p = fr.fused_sigma_render_reference(mlp, rays, z)
    out_p = fr.fused_render_eval_reference(mlp, rays, z, white_back)
    torch.cuda.synchronize()
    assert max_err(w_k, w_p) <= TOL["weights"]
    assert max_err(op_k, op_p) <= TOL["opacity"]
    for k in ("rgb", "depth", "opacity"):
        assert torch.isfinite(out_k[k]).all(), k
        assert max_err(out_k[k], out_p[k]) <= TOL[k], k


def test_pad_rows_give_zero_weights(dev):
    mlp = fr.pack_mlp(dense_params(0, dev), dev)
    rays = torch.zeros((9, 8), device=dev)
    rays[:, 7] = 1.0
    z = torch.linspace(0, 1, 64, device=dev).expand(9, 64).contiguous()
    w, op = fr.fused_sigma_render(mlp, rays, z)
    out = fr.fused_render_eval(mlp, rays, z, white_back=True)
    torch.cuda.synchronize()
    assert torch.count_nonzero(w) == 0 and torch.count_nonzero(op) == 0
    assert torch.equal(out["rgb"], torch.ones_like(out["rgb"]))


def test_bad_inputs_raise(dev):
    mlp = fr.pack_mlp(dense_params(0, dev), dev)
    rays, z = rays_z(8, 32, dev)
    with pytest.raises(ValueError):
        fr.fused_sigma_render(mlp, rays, z.t().contiguous().t())
    with pytest.raises(ValueError):
        fr.fused_render_eval(mlp, rays.double(), z, white_back=False)
    with pytest.raises(ValueError):
        fr.fused_sigma_render(fr.pack_mlp(dense_params(0, "cpu"), "cpu"),
                              rays, z)


def test_render_fn_fused_matches_unfused(dev):
    """The fused path through make_render_fn against the plain unfused
    path on the card (the bar of test_render_rays_fused_test_time_path)."""
    params = {"nerf_coarse": dense_params(0, dev),
              "nerf_fine": dense_params(1, dev)}
    rays, _ = rays_z(1000, 1, dev)
    base = dict(N_samples=64, N_importance=64, test_time=True, white_back=True)
    fused = make_render_fn(RenderConfig(**base, fused=True), 256, dev,
                           device_out=True)(params, rays)
    plain = make_render_fn(RenderConfig(**base), 256, dev,
                           device_out=True)(params, rays)
    torch.cuda.synchronize()
    for k in plain:
        assert max_err(fused[k], plain[k]) <= 2e-2, k
