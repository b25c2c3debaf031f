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
from nerf_pl_tpu_torch.parallel import Trainer, make_render_fn
from nerf_pl_tpu_torch.rendering import ModelConfig, RenderConfig, TrainDraws
from nerf_pl_tpu_torch.training import (get_lr_schedule, get_optimizer,
                                        loss_dict)
from nerf_pl_tpu_torch.training.optimizers import tree_leaves

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


# (R, S) of render_eval against train_fwd: the eval chunk's coarse and
# fine sample counts at a ragged R (S = 192: four rays fill six tiles),
# short rays many to a tile (S = 24: 32 rays a group), ray counts that
# leave the last group of rays short, rays longer than a tile, and the
# main path's chunk (eight rays a group).
EVAL_SHAPES = [(4099, 64), (4099, 192), (1, 24), (37, 24), (5, 300),
               (3, 1024), (32768, 128)]


def _render_eval_entry(mlp, rays, z, white_back, extra):
    """render_eval through its C entry into NaN-filled outputs of R +
    extra rows; returns (rgb, depth, opacity) of all R + extra rows."""
    from nerf_pl_tpu_torch.ops import _build
    R, S = z.shape
    dev = rays.device
    rgb = torch.full((R + extra, 3), float("nan"), device=dev)
    depth = torch.full((R + extra,), float("nan"), device=dev)
    opacity = torch.full((R + extra,), float("nan"), device=dev)
    err = _build.load_library().nerf_render_eval(
        rays.data_ptr(), z.data_ptr(), R, S,
        *(mlp.kernel[n].data_ptr() for n in fm._FULL), int(white_back),
        rgb.data_ptr(), depth.data_ptr(), opacity.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return rgb, depth, opacity


@pytest.mark.parametrize("R,S", EVAL_SHAPES)
@pytest.mark.parametrize("white_back", [True, False])
def test_render_eval_matches_train_fwd_bitwise(dev, R, S, white_back):
    """render_eval runs train_fwd's forward tile loop and quadrature with
    no sigma noise and on its own grid (a persistent grid over groups of
    rays that fill whole tiles): its rgb, depth and opacity equal
    train_fwd's out8[:, 0:5] on a zero noise tensor bit for bit. A second
    launch, through the C entry into NaN-filled outputs 5 rows longer than
    R, gives the same rows and writes no row past R."""
    for weights, seed in (("dense", 0), ("init", 5)):
        params = (dense_params(seed, dev) if weights == "dense" else
                  init_nerf_params(torch.Generator().manual_seed(seed),
                                   device=dev))
        mlp = fm.pack_mlp(params, dev)
        rays, z = rays_z(R, S, dev, seed=R + S)
        n0 = fr.render_eval_launches
        out = fr.fused_render_eval(mlp, rays, z, white_back=white_back)
        assert fr.render_eval_launches == n0 + 1
        f8, _ = ft.train_forward(mlp, rays, z, torch.zeros_like(z),
                                 white_back)
        again = _render_eval_entry(mlp, rays, z, white_back, 5)
        torch.cuda.synchronize()
        for k, cols in (("rgb", slice(0, 3)), ("depth", 3),
                        ("opacity", 4)):
            assert torch.isfinite(out[k]).all(), (weights, k)
            assert torch.equal(out[k], f8[:, cols]), \
                (weights, k, max_err(out[k], f8[:, cols]))
        for k, got in zip(("rgb", "depth", "opacity"), again):
            assert torch.equal(got[:R], out[k]), (weights, k)
            assert torch.isnan(got[R:]).all(), (weights, k)


@pytest.mark.parametrize("P", [1, 300, 4099, 131075])
def test_mlp_fwd_ragged_relaunches_and_writes_no_row_past_p(dev, P):
    """mlp_fwd's persistent grid over 128-point tiles at a ragged P (at P
    = 131,075 its 132 blocks take 7 or 8 of the 1025 tiles): two launches
    bit-identical, and a call of the C entry on an out8 of P + 128 rows
    filled with NaN gives the same rows and leaves the rows past P NaN."""
    from nerf_pl_tpu_torch.ops import _build
    mlp = fm.pack_mlp(dense_params(2, dev), dev)
    x8, d8, _ = _point_inputs(P, dev, seed=P + 2)
    first = fm.mlp_forward(mlp, x8, d8)
    second = fm.mlp_forward(mlp, x8, d8)
    out = torch.full((P + 128, 8), float("nan"), device=dev)
    err = _build.load_library().nerf_mlp_fwd(
        x8.data_ptr(), d8.data_ptr(), P,
        *(mlp.kernel[n].data_ptr() for n in fm._FULL), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.isfinite(first).all() and not first[:, 4:].any()
    assert torch.equal(first, second)
    assert torch.equal(out[:P], first)
    assert torch.isnan(out[P:]).all()


# (R, S) of sigma_render against train_fwd: the eval chunk's coarse pass
# (S = 64: 42 rays a group) at a ragged R and at the main path's R, the
# sample counts of compare_kernels, short rays many to a group, ray counts
# that leave the last group short, and rays longer than a tile.
SIGMA_SHAPES = [(4099, 64), (4099, 128), (4099, 192), (1, 24), (37, 24),
                (5, 300), (3, 1024), (32768, 64)]


def _sigma_render_entry(mlp, rays, z, extra):
    """sigma_render through its C entry into NaN-filled outputs of R +
    extra rows; returns (weights, opacity) of all R + extra rows."""
    from nerf_pl_tpu_torch.ops import _build
    R, S = z.shape
    weights = torch.full((R + extra, S), float("nan"), device=rays.device)
    opacity = torch.full((R + extra,), float("nan"), device=rays.device)
    err = _build.load_library().nerf_sigma_render(
        rays.data_ptr(), z.data_ptr(), R, S,
        *(mlp.kernel[n].data_ptr() for n in fm._FULL[:6]),
        weights.data_ptr(), opacity.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return weights, opacity


@pytest.mark.parametrize("R,S", SIGMA_SHAPES)
def test_sigma_render_matches_train_fwd_bitwise(dev, R, S):
    """sigma_render runs train_fwd's trunk (trunk_tile) and the weight part
    of its quadrature (quad_weights) with no sigma noise, on a persistent
    grid over groups of rays of its own: its weights and opacity equal
    train_fwd's weights and out8[:, 4] on a zero noise tensor bit for bit.
    A second launch, through the C entry into NaN-filled outputs 5 rows
    longer than R, gives the same rows and writes no row past R."""
    for weights, seed in (("dense", 0), ("init", 5)):
        params = (dense_params(seed, dev) if weights == "dense" else
                  init_nerf_params(torch.Generator().manual_seed(seed),
                                   device=dev))
        mlp = fm.pack_mlp(params, dev)
        rays, z = rays_z(R, S, dev, seed=R + S)
        n0 = fr.sigma_render_launches
        w, op = fr.fused_sigma_render(mlp, rays, z)
        assert fr.sigma_render_launches == n0 + 1
        f8, fw = ft.train_forward(mlp, rays, z, torch.zeros_like(z), False)
        w2, op2 = _sigma_render_entry(mlp, rays, z, 5)
        torch.cuda.synchronize()
        assert torch.isfinite(w).all() and torch.isfinite(op).all(), weights
        assert torch.equal(w, fw), (weights, max_err(w, fw))
        assert torch.equal(op, f8[:, 4]), (weights, max_err(op, f8[:, 4]))
        assert torch.equal(w2[:R], w) and torch.equal(op2[:R], op), weights
        assert torch.isnan(w2[R:]).all() and torch.isnan(op2[R:]).all()


@pytest.mark.parametrize("P", [1, 300, 4099, 131075])
@pytest.mark.parametrize("weights", ["dense", "init"])
def test_sigma_fwd_matches_mlp_fwd_bitwise(dev, P, weights):
    """sigma_fwd is mlp_fwd's persistent grid over 128-point tiles on the
    trunk alone (the same trunk_tile on the same gamma(x)): its sigma equals
    mlp_fwd's out8[:, 3] bit for bit, two launches are bit-identical, and a
    call of the C entry on a sigma of P + 128 rows filled with NaN gives
    the same rows and leaves the rows past P NaN."""
    from nerf_pl_tpu_torch.ops import _build
    params = (dense_params(2, dev) if weights == "dense" else
              init_nerf_params(torch.Generator().manual_seed(5), device=dev))
    mlp = fm.pack_mlp(params, dev)
    x8, d8, _ = _point_inputs(P, dev, seed=P + 3)
    n0 = fm.sigma_fwd_launches
    first = fm.sigma_forward(mlp, x8)
    second = fm.sigma_forward(mlp, x8)
    assert fm.sigma_fwd_launches == n0 + 2
    out8 = fm.mlp_forward(mlp, x8, d8)
    out = torch.full((P + 128,), float("nan"), device=dev)
    err = _build.load_library().nerf_sigma_fwd(
        x8.data_ptr(), P, *(mlp.kernel[n].data_ptr() for n in fm._FULL[:6]),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.isfinite(first).all()
    assert torch.equal(first, second)
    assert torch.equal(first, out8[:, 3]), max_err(first, out8[:, 3])
    assert torch.equal(out[:P], first)
    assert torch.isnan(out[P:]).all()


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
                                            (5, 300, True), (1024, 32, True),
                                            (1024, 96, True)])
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


@pytest.mark.parametrize("kernel", ["sigma_render", "mlp_fwd", "sigma_fwd",
                                    "mlp_bwd", "train_fwd", "train_bwd"])
def test_failed_launch_raises_without_fallback(dev, kernel, monkeypatch):
    """A launch that returns a CUDA error raises; the plain version is
    never run in its place and the count does not move."""
    from nerf_pl_tpu_torch.ops import _build
    real = _build.load_library()

    class FailingLib:
        def __getattr__(self, name):
            if name in ("nerf_sigma_render", "nerf_mlp_fwd", "nerf_sigma_fwd",
                        "nerf_mlp_bwd", "nerf_train_fwd", "nerf_train_bwd"):
                return lambda *a: 700          # cudaErrorIllegalAddress
            return getattr(real, name)

    def no_plain(*a, **k):
        raise AssertionError("plain version run for a CUDA tensor")

    monkeypatch.setattr(_build, "load_library", lambda: FailingLib())
    for mod in (fm, ft):
        monkeypatch.setattr(mod, "_checked_library", lambda: FailingLib())
    for mod, name in ((fr, "fused_sigma_render_reference"),
                      (fm, "mlp_forward_reference"),
                      (fm, "sigma_forward_reference"),
                      (fm, "mlp_backward_reference"),
                      (ft, "fused_train_render_reference"),
                      (ft, "fused_train_render_backward_reference")):
        monkeypatch.setattr(mod, name, no_plain)
    mlp = fm.pack_mlp(dense_params(0, dev), dev)
    x8, d8, cot = _point_inputs(64, dev, seed=0)
    rays, z, noise, _ = _mse_inputs(8, 64, dev)
    mod = (ft if kernel.startswith("train") else
           fr if kernel == "sigma_render" else fm)
    count = f"{kernel}_launches"
    before = getattr(mod, count)
    with pytest.raises(RuntimeError, match=f"{kernel} kernel launch failed"):
        if kernel == "sigma_render":
            fr.fused_sigma_render(mlp, rays, z)
        elif kernel == "mlp_fwd":
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


# (R, S) of the training kernels against their plain versions: the main
# path's batch at its coarse and fine sample counts, small and ragged
# batches, rays longer than ~390 samples, where launch A's ring drops to
# two stages (train_fwd's keeps three at S = 400), and the culled32
# recipe's passes: 32 coarse samples (4 rays a 128-point tile) and 32 + 64
# (one ray a tile, 25% of it padding).
TRAIN_SHAPES = [(R, S) for R in (8, 37, 1024, 4104) for S in (64, 128, 192)
                ] + [(5, 400)] + [(R, S) for R in (8, 1024) for S in (32, 96)]


@pytest.mark.parametrize("R,S", TRAIN_SHAPES)
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
    mse_render's gradients within 1e-3 relative per leaf (the same launch
    A); train_fwd gives its out8 and weights bit for bit (the same forward
    and quadrature)."""
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
    assert torch.equal(fw, w) and torch.equal(f8, out8)
    for i, (a, b) in enumerate(zip(grads, ref_g)):
        if b.abs().max() > 0:
            assert _rel(a, b) <= 1e-3, (i, _rel(a, b))
        else:
            assert not a.any(), i


@pytest.mark.parametrize("R,S", [(8, 64), (1024, 64), (1024, 128),
                                 (37, 192), (5, 400), (3, 1024)])
@pytest.mark.parametrize("white_back", [True, False])
def test_train_fwd_matches_mse_render_bitwise(dev, R, S, white_back):
    """train_fwd runs mse_render's forward and quadrature without the
    scratch, the mask bits and the backward: its out8 and weights equal
    mse_render's bit for bit, at the batch's shapes and on long rays (at S
    = 1024 both rings take two stages)."""
    for weights, seed in (("dense", 0), ("init", 5)):
        params = (dense_params(seed, dev) if weights == "dense" else
                  init_nerf_params(torch.Generator().manual_seed(seed),
                                   device=dev))
        mlp = fm.pack_mlp(params, dev)
        rays, z, noise, gt = _mse_inputs(R, S, dev, seed=R * S)
        out8, w, _ = ft.fused_mse_render(mlp, rays, z, noise, gt, white_back,
                                         1.0 / (R * 3))
        f8, fw = ft.train_forward(mlp, rays, z, noise, white_back)
        torch.cuda.synchronize()
        assert torch.isfinite(f8).all() and torch.isfinite(fw).all()
        assert torch.equal(fw, w), (weights, max_err(fw, w))
        assert torch.equal(f8, out8), (weights, max_err(f8, out8))


@pytest.mark.parametrize("R,S", [(37, 192)])
def test_backward_kernels_ragged_shapes(dev, R, S):
    """mse_render and train_bwd at a ragged R whose rays take two point
    tiles each (the second half full), against their plain versions, and
    relaunched bit-identically."""
    mlp = fm.pack_mlp(dense_params(0, dev), dev)
    rays, z, noise, gt = _mse_inputs(R, S, dev, seed=11)
    scale = 1.0 / (R * 3)
    m1 = ft.fused_mse_render(mlp, rays, z, noise, gt, True, scale)
    m2 = ft.fused_mse_render(mlp, rays, z, noise, gt, True, scale)
    ref8, ref_w, ref_g = ft.fused_mse_render_reference(
        mlp, rays, z, noise, gt, True, scale)
    g8, gw = _train_cotangent("all", ref8, ref_w, gt)
    b1 = ft.train_backward(mlp, rays, z, noise, True, g8, gw)
    b2 = ft.train_backward(mlp, rays, z, noise, True, g8, gw)
    ref_b = ft.fused_train_render_backward_reference(mlp, rays, z, noise,
                                                     True, g8, gw)
    torch.cuda.synchronize()
    assert torch.equal(m1[0], m2[0]) and torch.equal(m1[1], m2[1])
    for a, b in zip(m1[2] + b1, m2[2] + b2):
        assert torch.equal(a, b)
    assert max_err(m1[1], ref_w) <= TOL["weights"]
    for k, cols in (("rgb", slice(0, 3)), ("depth", slice(3, 4)),
                    ("opacity", slice(4, 5))):
        assert max_err(m1[0][:, cols], ref8[:, cols]) <= TOL[k], k
    for got, ref in ((m1[2], ref_g), (b1, ref_b)):
        for i, (a, b) in enumerate(zip(got, ref)):
            if b.abs().max() > 0:
                assert _rel(a, b) <= GRAD_TOL, (i, _rel(a, b))
            else:
                assert not a.any(), i


@pytest.mark.parametrize("P", [300, 4099, 131075])
def test_mlp_bwd_ragged_matches_plain_and_relaunches(dev, P):
    """mlp_bwd's launch A' on 128-point tiles and the shared launch B: a P
    that is not a multiple of the tile leaves the last tile's rows past P
    zero cotangents, and at P = 131,075 the persistent grid's 132 blocks
    take 7 or 8 tiles each (1025 tiles). Against the plain version, and two
    launches bit-identical."""
    mlp = fm.pack_mlp(dense_params(2, dev), dev)
    x8, d8, cot = _point_inputs(P, dev, seed=P + 1)
    g1 = fm.mlp_backward(mlp, x8, d8, cot)
    g2 = fm.mlp_backward(mlp, x8, d8, cot)
    ref = fm.mlp_backward_reference(mlp.packed, x8, d8, cot)
    torch.cuda.synchronize()
    for i, (a, b, r) in enumerate(zip(g1, g2, ref)):
        assert torch.equal(a, b), i
        if r.abs().max() > 0:
            assert _rel(a, r) <= GRAD_TOL, (i, _rel(a, r))
        else:
            assert not a.any(), i


def test_mlp_workspace_holds_the_mask_bits(dev):
    """mlp_bwd's workspace holds the scratch of whole 128-point tiles
    (10,016 bytes a point) and 36 KB of ReLU mask bits a tile (37.7 MB at P
    = 131,072), like mse_render's at the same points, less the bias rows:
    A' has two a block of at most 132, mse_render two a ray."""
    from nerf_pl_tpu_torch.ops import _build
    lib = _build.load_library()
    for P, tiles in ((131072, 1024), (300, 3), (4099, 33)):
        need = tiles * 128 * 10016 + tiles * 36864
        assert lib.nerf_mlp_workspace_bytes(P) >= need, P
    assert (lib.nerf_mlp_workspace_bytes(131072)
            <= lib.nerf_mse_workspace_bytes(1024, 128))



def _culled_trainer(rcfg, dev, n=20000, seed=0):
    """A Trainer at batch 1024 (Adam, steplr) on a random store of n rays
    (o ~ N(0, 1), unit directions with 5% of the components 0, near 2, far
    6), tightened as bench's culled recipes do: the box [-1.5, 1.5]^3 and
    two inner ones, margin 0.1, 32 segments, dilate 1, packed."""
    g = torch.Generator().manual_seed(seed)
    o = torch.randn((n, 3), generator=g)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                      dim=-1)
    d[torch.rand((n, 3), generator=g) < 0.05] = 0.0
    rays = torch.cat([o, d, torch.full((n, 1), 2.0), torch.full((n, 1), 6.0)],
                     dim=-1)
    sched = get_lr_schedule("steplr", 5e-4, 16, 1000, decay_step=[2, 4, 8],
                            decay_gamma=0.5)
    tr = Trainer(ModelConfig(), rcfg, get_optimizer("adam", sched), sched,
                 loss_dict["mse"], 1024, dev)
    tr.set_data(rays.numpy(), torch.rand((n, 3), generator=g).numpy())
    boxes = [[-1.5, -1.5, -1.5, 1.5, 1.5, 1.5],
             [-0.6, -0.6, -0.6, 0.2, 0.3, 0.4],
             [0.5, -0.2, -1.0, 1.2, 0.6, 0.9]]
    stats = tr.tighten_store(boxes, margin=0.1, n_seg=32, dilate=1,
                             pack=True)
    return tr, stats


def test_tighten_store_on_cuda_equals_cpu(dev):
    """The ray-box tests are elementwise ops in one order on both devices:
    the masks, hit flags, tightened near/far, partition order and
    statistics bit for bit."""
    rcfg = RenderConfig(N_samples=32, N_importance=64, white_back=True)
    gpu, st_gpu = _culled_trainer(rcfg, dev)
    cpu, st_cpu = _culled_trainer(rcfg, "cpu")
    assert st_gpu == st_cpu and 0.0 < st_cpu["hit_frac"] < 1.0
    for name in ("all_rays", "all_occm", "all_hit", "all_idx", "all_nf0"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), \
            name
    assert gpu.all_nsurv == cpu.all_nsurv
    gpu.reshuffle(5)
    cpu.reshuffle(5)
    assert torch.equal(gpu.all_idx.cpu(), cpu.all_idx)


def test_culled_loss_fused_step_matches_plain(dev):
    """A culled32 loss-fused step (32 + 64 samples, perturb 1, noise 1,
    white background, occupied-segment masks) launches mse_render twice,
    and its gradients point the way the plain autograd step's do on the
    same draws and masks: cosine >= 0.95 per leaf."""
    base = dict(N_samples=32, N_importance=64, perturb=1.0, noise_std=1.0,
                white_back=True)
    tr, _ = _culled_trainer(RenderConfig(**base, fused_train=True,
                                         fused_loss=True), dev)
    plain = Trainer(ModelConfig(), RenderConfig(**base), tr.optimizer,
                    tr.lr_schedule, loss_dict["mse"], 1024, dev)
    plain.occ_n_seg = tr.occ_n_seg
    params = {m: dense_params(i, dev)
              for i, m in enumerate(("nerf_coarse", "nerf_fine"))}
    rays, rgbs, occm = tr._sample_batch(0)
    g = torch.Generator(device=dev).manual_seed(3)
    draws = TrainDraws(
        perturb=torch.rand((1024, 32), generator=g, device=dev),
        noise_coarse=torch.randn((1024, 32), generator=g, device=dev),
        u=torch.rand((1024, 64), generator=g, device=dev),
        noise_fine=torch.randn((1024, 96), generator=g, device=dev))
    n0 = ft.mse_render_launches
    loss_f, _, g_f = tr._loss_and_grads(params, rays, rgbs, None, draws,
                                        occm=occm)
    assert ft.mse_render_launches == n0 + 2
    loss_p, _, g_p = plain._loss_and_grads(params, rays, rgbs, None, draws,
                                           occm=occm)
    assert torch.isfinite(loss_f) and torch.isfinite(loss_p)
    for a, b in zip(tree_leaves(g_f), tree_leaves(g_p, g_f)):
        cos = torch.nn.functional.cosine_similarity(a.reshape(-1),
                                                    b.reshape(-1), dim=0)
        assert cos.item() >= 0.95
