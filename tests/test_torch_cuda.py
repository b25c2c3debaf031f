"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. Run them there
with `python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest`.
This file imports no jax, and --noconftest skips tests/conftest.py, which
does: the machine with the card has no jax.

Tolerances are the JAX kernels' test bars: weights 5e-3, rgb and opacity
1e-2, depth 5e-2 (bf16 operands; the kernel and the plain version sum in
different orders, and a bf16 rounding of an activation can flip). The
training kernels' gradients (mse_render, train_bwd, mlp_bwd) are held
per leaf to a relative max error (max |kernel - plain| / max |plain|) of
GRAD_TOL = 0.03, the bar of
tests/test_fused_train.py::TestGradientParity: a flipped bf16 rounding or
ReLU mask of one activation moves every product downstream of it. The
point-MLP forward kernels hold rgb to 5e-3 (TestFusedForward's bar) and
raw sigma to 5e-3 x max(1, max |sigma|): the x50 sigma head of
dense_params scales raw sigma, and its rounding with it.
"""
import pytest
import torch

from nerf_pl_tpu_torch.models import init_nerf_params
from nerf_pl_tpu_torch.ops import fused_mlp as fm
from nerf_pl_tpu_torch.ops import fused_render as fr
from nerf_pl_tpu_torch.ops import fused_train as ft
from nerf_pl_tpu_torch.parallel import make_render_fn
from nerf_pl_tpu_torch.rendering import RenderConfig

pytestmark = pytest.mark.cuda

TOL = {"weights": 5e-3, "rgb": 1e-2, "opacity": 1e-2, "depth": 5e-2}
GRAD_TOL = 0.03


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
    mlp = fm.pack_mlp(dense_params(0, dev), dev)
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
    mlp = fm.pack_mlp(dense_params(0, dev), dev)
    rays = torch.zeros((9, 8), device=dev)
    rays[:, 7] = 1.0
    z = torch.linspace(0, 1, 64, device=dev).expand(9, 64).contiguous()
    w, op = fr.fused_sigma_render(mlp, rays, z)
    out = fr.fused_render_eval(mlp, rays, z, white_back=True)
    torch.cuda.synchronize()
    assert torch.count_nonzero(w) == 0 and torch.count_nonzero(op) == 0
    assert torch.equal(out["rgb"], torch.ones_like(out["rgb"]))


def test_bad_inputs_raise(dev):
    mlp = fm.pack_mlp(dense_params(0, dev), dev)
    rays, z = rays_z(8, 32, dev)
    with pytest.raises(ValueError):
        fr.fused_sigma_render(mlp, rays, z.t().contiguous().t())
    with pytest.raises(ValueError):
        fr.fused_render_eval(mlp, rays.double(), z, white_back=False)
    with pytest.raises(ValueError):
        fr.fused_sigma_render(fm.pack_mlp(dense_params(0, "cpu"), "cpu"),
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


def _mse_inputs(R, S, dev, seed=0):
    rays, z = rays_z(R, S, dev, seed)
    g = torch.Generator().manual_seed(seed + 1)
    noise = torch.randn((R, S), generator=g).to(dev)
    gt = torch.rand((R, 3), generator=g).to(dev)
    return rays, z, noise, gt


def _rel(a, b):
    return ((a - b).abs().max() / (b.abs().max() + 1e-12)).item()


@pytest.mark.parametrize("R,S,white_back", [(8, 24, True), (8, 64, False),
                                            (8, 192, True), (1032, 24, False),
                                            (1032, 64, True),
                                            (1032, 192, False),
                                            (5, 300, True)])
def test_mse_render_matches_plain(dev, R, S, white_back):
    mlp = fm.pack_mlp(dense_params(0, dev), dev)
    rays, z, noise, gt = _mse_inputs(R, S, dev)
    scale = 1.0 / (R * 3)
    n0 = ft.mse_render_launches
    out8, w, grads = ft.fused_mse_render(mlp, rays, z, noise, gt,
                                         white_back, scale)
    assert ft.mse_render_launches == n0 + 1
    ref8, ref_w, ref_g = ft.fused_mse_render_reference(
        mlp, rays, z, noise, gt, white_back, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(out8).all() and torch.isfinite(w).all()
    assert max_err(w, ref_w) <= TOL["weights"]
    for k, cols in (("rgb", slice(0, 3)), ("depth", slice(3, 4)),
                    ("opacity", slice(4, 5))):
        assert max_err(out8[:, cols], ref8[:, cols]) <= TOL[k], k
    assert not out8[:, 5:].any()
    assert len(grads) == len(ref_g) == 17
    for i, (a, b) in enumerate(zip(grads, ref_g)):
        assert a.shape == b.shape, i
        assert torch.isfinite(a).all(), i
        if b.abs().max() > 0:
            assert _rel(a, b) <= GRAD_TOL, (i, _rel(a, b))
        else:
            assert not a.any(), i


def test_mse_render_is_deterministic(dev):
    mlp = fm.pack_mlp(dense_params(1, dev), dev)
    rays, z, noise, gt = _mse_inputs(1032, 128, dev, seed=3)
    first = ft.fused_mse_render(mlp, rays, z, noise, gt, True, 1e-3)
    second = ft.fused_mse_render(mlp, rays, z, noise, gt, True, 1e-3)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])
    for a, b in zip(first[2], second[2]):
        assert torch.equal(a, b)


def _point_inputs(P, dev, seed):
    g = torch.Generator().manual_seed(seed)
    x8 = torch.zeros((P, 8))
    x8[:, :3] = 2 * torch.randn((P, 3), generator=g)
    d8 = torch.zeros((P, 8))
    d8[:, :3] = torch.nn.functional.normalize(torch.randn((P, 3),
                                                          generator=g), dim=-1)
    cot = torch.zeros((P, 8))
    cot[:, :4] = torch.randn((P, 4), generator=g) / P
    return x8.to(dev), d8.to(dev), cot.to(dev)


@pytest.mark.parametrize("P", [1, 300, 4099, 131075])
@pytest.mark.parametrize("weights", ["dense", "init"])
def test_point_mlp_kernels_match_plain(dev, P, weights):
    params = (dense_params(0, dev) if weights == "dense" else
              init_nerf_params(torch.Generator().manual_seed(5), device=dev))
    mlp = fm.pack_mlp(params, dev)
    x8, d8, cot = _point_inputs(P, dev, seed=P)
    n0 = (fm.mlp_fwd_launches, fm.sigma_fwd_launches, fm.mlp_bwd_launches)
    out = fm.mlp_forward(mlp, x8, d8)
    sigma = fm.sigma_forward(mlp, x8)
    grads = fm.mlp_backward(mlp, x8, d8, cot)
    assert (fm.mlp_fwd_launches, fm.sigma_fwd_launches,
            fm.mlp_bwd_launches) == (n0[0] + 1, n0[1] + 1, n0[2] + 1)
    ref = fm.mlp_forward_reference(mlp.packed, x8, d8)
    ref_sigma = fm.sigma_forward_reference(mlp.packed, x8)
    ref_g = fm.mlp_backward_reference(mlp.packed, x8, d8, cot)
    torch.cuda.synchronize()
    sig_tol = 5e-3 * max(1.0, ref[:, 3].abs().max().item())
    assert torch.isfinite(out).all() and not out[:, 4:].any()
    assert max_err(out[:, :3], ref[:, :3]) <= 5e-3
    assert max_err(out[:, 3], ref[:, 3]) <= sig_tol
    assert max_err(sigma, ref_sigma) <= sig_tol
    for i, (a, b) in enumerate(zip(grads, ref_g)):
        assert a.shape == b.shape and a.dtype == torch.float32, i
        if b.abs().max() > 0:
            assert _rel(a, b) <= GRAD_TOL, (i, _rel(a, b))
        else:
            assert not a.any(), i


def test_mlp_bwd_is_deterministic(dev):
    mlp = fm.pack_mlp(dense_params(1, dev), dev)
    x8, d8, cot = _point_inputs(65537, dev, seed=3)
    first = fm.mlp_backward(mlp, x8, d8, cot)
    second = fm.mlp_backward(mlp, x8, d8, cot)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["mlp_fwd", "sigma_fwd", "mlp_bwd",
                                    "train_fwd", "train_bwd"])
def test_failed_launch_raises_without_fallback(dev, kernel, monkeypatch):
    """A launch that returns a CUDA error raises; the plain version is
    never run in its place and the count does not move."""
    from nerf_pl_tpu_torch.ops import _build
    real = _build.load_library()

    class FailingLib:
        def __getattr__(self, name):
            if name in ("nerf_mlp_fwd", "nerf_sigma_fwd", "nerf_mlp_bwd",
                        "nerf_train_fwd", "nerf_train_bwd"):
                return lambda *a: 700          # cudaErrorIllegalAddress
            return getattr(real, name)

    def no_plain(*a, **k):
        raise AssertionError("plain version run for a CUDA tensor")

    monkeypatch.setattr(_build, "load_library", lambda: FailingLib())
    for mod in (fm, ft):
        monkeypatch.setattr(mod, "_checked_library", lambda: FailingLib())
    for mod, name in ((fm, "mlp_forward_reference"),
                      (fm, "sigma_forward_reference"),
                      (fm, "mlp_backward_reference"),
                      (ft, "fused_train_render_reference"),
                      (ft, "fused_train_render_backward_reference")):
        monkeypatch.setattr(mod, name, no_plain)
    mlp = fm.pack_mlp(dense_params(0, dev), dev)
    x8, d8, cot = _point_inputs(64, dev, seed=0)
    rays, z, noise, _ = _mse_inputs(8, 64, dev)
    mod = ft if kernel.startswith("train") else fm
    count = f"{kernel}_launches"
    before = getattr(mod, count)
    with pytest.raises(RuntimeError, match=f"{kernel} kernel launch failed"):
        if kernel == "mlp_fwd":
            fm.mlp_forward(mlp, x8, d8)
        elif kernel == "sigma_fwd":
            fm.sigma_forward(mlp, x8)
        elif kernel == "mlp_bwd":
            fm.mlp_backward(mlp, x8, d8, cot)
        elif kernel == "train_fwd":
            ft.train_forward(mlp, rays, z, noise, True)
        else:
            ft.train_backward(mlp, rays, z, noise, True,
                              torch.zeros((8, 8), device=dev), None)
    assert getattr(mod, count) == before


# (cotangent mix, white background), as chip_smoke.py's TRAIN_MIXES
_TRAIN_MIXES = (("rgb", True), ("depth_opacity", False), ("weights", False),
                ("all", True))


def _train_cotangent(mix, out8, w, gt):
    """(g8, gw) of a mean loss over the batch: the rgb MSE, depth^2 + 0.3
    opacity, mean(weights^2), or "all", their sum."""
    R, S = w.shape
    g8, gw = torch.zeros_like(out8), None
    if mix in ("rgb", "all"):
        g8[:, 0:3] = 2.0 * (out8[:, 0:3] - gt) / (R * 3)
    if mix in ("depth_opacity", "all"):
        g8[:, 3] = 2.0 * out8[:, 3] / R
        g8[:, 4] = 0.3 / R
    if mix in ("weights", "all"):
        gw = 2.0 * w / (R * S)
    return g8, gw


@pytest.mark.parametrize("R", [8, 37, 1024, 4104])
@pytest.mark.parametrize("S", [64, 128, 192])
@pytest.mark.parametrize("weights", ["dense", "init"])
def test_train_render_kernels_match_plain(dev, R, S, weights):
    """train_fwd and train_bwd against their plain versions, the backward
    under four cotangent mixes (rgb MSE on a white background, depth and
    opacity, the weights, those two on black, and all three terms together
    on white, so that a given depth, opacity and weights cotangent meets
    the white background's term of a_k)."""
    params = (dense_params(0, dev) if weights == "dense" else
              init_nerf_params(torch.Generator().manual_seed(5), device=dev))
    mlp = fm.pack_mlp(params, dev)
    rays, z, noise, gt = _mse_inputs(R, S, dev, seed=R + S)
    for mix, white in _TRAIN_MIXES:
        n0 = (ft.train_fwd_launches, ft.train_bwd_launches)
        out8, w = ft.train_forward(mlp, rays, z, noise, white)
        ref8, ref_w = ft.fused_train_render_reference(mlp, rays, z, noise,
                                                      white)
        g8, gw = _train_cotangent(mix, ref8, ref_w, gt)
        grads = ft.train_backward(mlp, rays, z, noise, white, g8, gw)
        assert (ft.train_fwd_launches, ft.train_bwd_launches) == \
            (n0[0] + 1, n0[1] + 1)
        ref_g = ft.fused_train_render_backward_reference(
            mlp, rays, z, noise, white, g8, gw)
        torch.cuda.synchronize()
        assert torch.isfinite(out8).all() and not out8[:, 5:].any()
        assert max_err(w, ref_w) <= TOL["weights"]
        for k, cols in (("rgb", slice(0, 3)), ("depth", slice(3, 4)),
                        ("opacity", slice(4, 5))):
            assert max_err(out8[:, cols], ref8[:, cols]) <= TOL[k], (mix, k)
        for i, (a, b) in enumerate(zip(grads, ref_g)):
            assert a.shape == b.shape and torch.isfinite(a).all(), (mix, i)
            if b.abs().max() > 0:
                assert _rel(a, b) <= GRAD_TOL, (mix, i, _rel(a, b))
            else:
                assert not a.any(), (mix, i)


def test_train_render_kernels_are_deterministic(dev):
    mlp = fm.pack_mlp(dense_params(1, dev), dev)
    rays, z, noise, gt = _mse_inputs(1032, 128, dev, seed=3)
    fwd = [ft.train_forward(mlp, rays, z, noise, False) for _ in range(2)]
    g8, gw = _train_cotangent("weights", *fwd[0], gt)
    g8[:, 3] = 1e-3
    bwd = [ft.train_backward(mlp, rays, z, noise, False, g8, gw)
           for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(fwd[0] + bwd[0], fwd[1] + bwd[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("R,S", [(8, 64), (1032, 128), (37, 192)])
def test_train_bwd_matches_mse_render(dev, R, S):
    """train_bwd with the MSE cotangent 2 scale (rgb - gt) gives
    mse_render's gradients within 1e-3 relative per leaf; train_fwd gives
    its out8 and weights."""
    mlp = fm.pack_mlp(dense_params(0, dev), dev)
    rays, z, noise, gt = _mse_inputs(R, S, dev, seed=S)
    scale = 1.0 / (R * 3)
    out8, w, ref_g = ft.fused_mse_render(mlp, rays, z, noise, gt, True,
                                         scale)
    f8, fw = ft.train_forward(mlp, rays, z, noise, True)
    g8 = torch.zeros_like(out8)
    g8[:, 0:3] = 2.0 * scale * (out8[:, 0:3] - gt)
    grads = ft.train_backward(mlp, rays, z, noise, True, g8, None)
    torch.cuda.synchronize()
    assert max_err(f8, out8) <= 1e-6 and max_err(fw, w) <= 1e-6
    for i, (a, b) in enumerate(zip(grads, ref_g)):
        if b.abs().max() > 0:
            assert _rel(a, b) <= 1e-3, (i, _rel(a, b))
        else:
            assert not a.any(), i
