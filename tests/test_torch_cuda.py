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
# (4 rays in 3 tiles), with a ragged last block of 1 or 3 rays whose last
# tiles hold no point.
TRAIN_SHAPES = [(R, S) for R in (8, 37, 1024, 4104) for S in (64, 128, 192)
                ] + [(5, 400)] + [(R, S) for R in (8, 1024) for S in (32, 96)
                                  ] + [(1, 96), (37, 96), (4103, 96)]


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
                                 (37, 192), (5, 400), (3, 1024), (1, 96),
                                 (37, 96), (4103, 96)])
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


@pytest.mark.parametrize("R,S", [(37, 192), (1, 96), (37, 96), (4103, 96)])
def test_backward_kernels_ragged_shapes(dev, R, S):
    """mse_render and train_bwd at a ragged R (at S = 192, blocks of two
    rays in three tiles, the last block one ray; at S = 96, blocks of four
    rays in three tiles, the last block one or three rays), against their
    plain versions, and relaunched bit-identically."""
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


@pytest.mark.parametrize("R,S,rows", [(1024, 32, 32768), (1024, 64, 65536),
                                      (1024, 128, 131072), (1024, 96, 98304),
                                      (37, 96, 3840), (5, 400, 2560)])
def test_ray_blocks_fill_whole_tiles(dev, R, S, rows):
    """Launch A's blocks hold the fewest whole rays that fill whole
    128-point tiles where such a block fits shared memory: at R = 1024 and
    S = 32, 64, 96 and 128 its tile rows are R S, padding none; a ragged
    last block at (37, 96) holds one ray in three tiles; a ray of 400
    samples keeps a block of its own, 4 tiles with 112 padding rows.
    mse_render, train_fwd and train_bwd each add R S points and those rows
    to the counters."""
    assert ft._checked_library().nerf_ray_tile_rows(R, S) == rows
    mlp = fm.pack_mlp(dense_params(0, dev), dev)
    rays, z, noise, gt = _mse_inputs(R, S, dev, seed=S)
    p0, r0 = ft.ray_points, ft.ray_tile_rows
    out8, _, _ = ft.fused_mse_render(mlp, rays, z, noise, gt, True,
                                     1.0 / (R * 3))
    assert (ft.ray_points - p0, ft.ray_tile_rows - r0) == (R * S, rows)
    ft.train_forward(mlp, rays, z, noise, True)
    g8 = torch.zeros_like(out8)
    g8[:, 0:3] = out8[:, 0:3] - gt
    ft.train_backward(mlp, rays, z, noise, True, g8, None)
    torch.cuda.synchronize()
    assert (ft.ray_points - p0, ft.ray_tile_rows - r0) == (3 * R * S,
                                                           3 * rows)


@pytest.mark.parametrize("culled", [False, True], ids=["dense", "culled"])
def test_replayed_steps_count_their_tile_rows(dev, culled):
    """A replayed loss-fused step adds its capture's points and tile rows
    to the counters, as it adds its launches: 1024 rays at 64 + 128
    samples (dense) or 32 + 96 (culled32), none of their rows padding."""
    tr = _traced_trainer(dev, culled)
    state = tr.init_state(torch.Generator().manual_seed(0))
    state, _ = tr.run_steps(state, 5, 1)
    points = 1024 * ((32 + 96) if culled else (64 + 128))
    assert tr._graph.work == {"ray_points": points, "ray_tile_rows": points}
    p0, r0 = ft.ray_points, ft.ray_tile_rows
    tr.run_steps(state, 5, 7)
    assert (ft.ray_points - p0, ft.ray_tile_rows - r0) == (7 * points,
                                                           7 * points)


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
    plain.family.n_seg = tr.family.n_seg
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
    loss_f, _, g_f = tr.family.loss_and_grads(params, rays, rgbs, None,
                                              draws, occm=occm)
    assert ft.mse_render_launches == n0 + 2
    loss_p, _, g_p = plain.family.loss_and_grads(params, rays, rgbs, None,
                                                 draws, occm=occm)
    assert torch.isfinite(loss_f) and torch.isfinite(loss_p)
    for a, b in zip(tree_leaves(g_f), tree_leaves(g_p, g_f)):
        cos = torch.nn.functional.cosine_similarity(a.reshape(-1),
                                                    b.reshape(-1), dim=0)
        assert cos.item() >= 0.95


@pytest.mark.parametrize("cfg", [dict(), dict(tighten=True, budgets=True,
                                              segments=32)],
                         ids=["cull", "budgets_segments"])
def test_culled_renderer_kernels_match_plain(dev, cfg, monkeypatch):
    """CulledRenderer at 64 + 128 samples (eval's defaults) on 4096 rays of
    a 64x64 sphere-pose frame against three boxes, base tile 1024: with the
    render kernels, then with their plain versions on the card. Stats
    equal, one sigma_render and one render_eval launch a tile, outputs
    within the kernel bars, and rows no tile renders exactly white
    background."""
    import math
    from nerf_pl_tpu_torch.datasets.rays import frame_rays, sphere_pose
    from nerf_pl_tpu_torch.rendering import CulledRenderer, OccupancyGrid
    from nerf_pl_tpu_torch.rendering import render as rr

    boxes = torch.tensor([[-0.6, -0.6, -0.6, 0.2, 0.3, 0.4],
                          [0.5, -0.2, -1.0, 1.2, 0.6, 0.9],
                          [-1.2, 0.6, -0.2, -0.5, 1.1, 0.5]]).numpy()
    occ = OccupancyGrid(boxes=boxes, block_map=torch.ones(
        (2, 2, 2), dtype=torch.uint8).numpy(), lo=boxes[:, :3].min(0),
        hi=boxes[:, 3:].max(0))
    focal = 0.5 * 64 / math.tan(0.5 * 0.8575560450553894)
    rays = frame_rays(sphere_pose(0.3, math.pi / 5, 4.0), 64, 64, focal,
                      2.0, 6.0, dev)
    params = {"nerf_coarse": dense_params(10, dev),
              "nerf_fine": dense_params(11, dev)}
    cr = CulledRenderer(occ, RenderConfig(N_samples=64, N_importance=128,
                                          test_time=True, white_back=True,
                                          fused=True),
                        chunk=1024, device=dev, **cfg)
    n0 = (fr.sigma_render_launches, fr.render_eval_launches)
    out, stats = cr(params, rays, return_stats=True)
    tiles = sum(p[2] for p in cr._tile_plan(4096, stats.get(
        "bucket_counts", [stats["n_survivors"]])))
    assert (fr.sigma_render_launches - n0[0],
            fr.render_eval_launches - n0[1]) == (tiles, tiles)
    assert 0 < stats["n_survivors"] < 4096
    monkeypatch.setattr(rr, "fused_sigma_render",
                        fr.fused_sigma_render_reference)
    monkeypatch.setattr(rr, "fused_render_eval",
                        fr.fused_render_eval_reference)
    plain, plain_stats = cr(params, rays, return_stats=True)
    torch.cuda.synchronize()
    assert plain_stats == stats
    for k, bar in (("rgb_fine", TOL["rgb"]), ("depth_fine", TOL["depth"]),
                   ("opacity_fine", TOL["opacity"])):
        assert torch.isfinite(out[k]).all()
        assert max_err(out[k], plain[k]) <= bar, k
    cull = cr._cull(rays, 0)
    rendered = torch.zeros(4096, dtype=torch.bool, device=dev)
    n_rows = (stats["n_survivors"] if cr.budgets
              else min(stats["n_rendered"], 4096))
    rendered[cull.order[:n_rows]] = True
    assert (out["rgb_fine"][~rendered] == 1.0).all()
    assert not out["depth_fine"][~rendered].any()
    assert not out["opacity_fine"][~rendered].any()


@pytest.mark.parametrize("cfg", [dict(tighten=True), dict(
    tighten=True, fracs=(0.25, 0.5, 1.0), n_seg=32)],
    ids=["tighten", "budgets_segments"])
def test_cull_pass_on_cuda_equals_cpu(dev, cfg):
    """The cull pass is elementwise ops in one order, a stable sort and
    gathers: on 20,000 random rays (5% of the direction components 0)
    against the three boxes of _culled_trainer, padded by 1000 rows, the
    card's sorted rays, masks, order and counts equal the CPU's bit for
    bit."""
    from nerf_pl_tpu_torch.rendering.occupancy import cull_rays
    g = torch.Generator().manual_seed(4)
    o = torch.randn((20000, 3), generator=g)
    d = torch.nn.functional.normalize(torch.randn((20000, 3), generator=g),
                                      dim=-1)
    d[torch.rand((20000, 3), generator=g) < 0.05] = 0.0
    rays = torch.cat([o, d, torch.full((20000, 1), 2.0),
                      torch.full((20000, 1), 6.0)], dim=-1)
    boxes = torch.tensor([[-1.5, -1.5, -1.5, 1.5, 1.5, 1.5],
                          [-0.6, -0.6, -0.6, 0.2, 0.3, 0.4],
                          [0.5, -0.2, -1.0, 1.2, 0.6, 0.9]])
    cpu = cull_rays(boxes, rays, pad_rows=1000, **cfg)
    gpu = cull_rays(boxes.to(dev), rays.to(dev), pad_rows=1000, **cfg)
    assert 0 < cpu.counts.sum() < 20000
    for name, a, b in zip(cpu._fields, gpu, cpu):
        assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("route", ["loss_fused", "fused_mlp"])
def test_run_steps_graph_equals_eager(dev, route):
    """run_steps on the card replays one captured step: on the packed
    culled store (its offset wraps past the survivors), 6 replayed steps,
    the in-place reshuffle, 4 more give params and Adam state bit for bit
    those of the same steps launched eagerly, with one capture; a new store
    (tighten_store) captures the step anew."""
    extra = (dict(fused_train=True, fused_loss=True) if route == "loss_fused"
             else dict(fused=True))
    rcfg = RenderConfig(N_samples=32, N_importance=64, perturb=1.0,
                        noise_std=1.0, white_back=True, **extra)
    finals = []
    for eager in (True, False):
        tr, _ = _culled_trainer(rcfg, dev)
        assert tr.all_nsurv // 1024 < tr.steps_per_epoch
        state = tr.init_state(torch.Generator().manual_seed(0))
        for n in (6, 4):
            state, m = tr.run_steps(state, 5, n, eager=eager)
            tr.reshuffle(7 + state.step)
        finals.append((tr, state, m))
    (_, se, me), (tr, sg, mg) = finals
    assert tr.captures == 1
    for a, b in zip(tree_leaves(se.params) + tree_leaves(se.opt_state[0]),
                    tree_leaves(sg.params) + tree_leaves(sg.opt_state[0])):
        assert torch.equal(a, b)
    for k in ("loss", "psnr", "lr"):
        assert torch.equal(me[k], mg[k]), k
    tr.tighten_store([[-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]], n_seg=32,
                     pack=True)
    state, m = tr.run_steps(sg, 5, 2)
    assert tr.captures == 2 and torch.isfinite(m["loss"]).all()


def test_run_steps_graph_captures_the_plain_path(dev):
    """The unfused autograd step (embed + nerf_apply + the plain
    quadrature, the train CLI without --fused_train or --fused_mlp)
    captures too: nothing on it reads back to the host (the frequency
    bands are cached on the device; the cumprod's backward skips torch's
    test for zeros). 3 replayed steps against 3 eager ones: the loss
    finite and the params within 1e-5 of each leaf's largest value (cuBLAS
    may pick another algorithm under capture)."""
    rcfg = RenderConfig(N_samples=16, N_importance=16, perturb=1.0,
                        noise_std=1.0, white_back=True)
    finals = []
    for eager in (True, False):
        tr, _ = _culled_trainer(rcfg, dev)
        state = tr.init_state(torch.Generator().manual_seed(0))
        state, m = tr.run_steps(state, 5, 3, eager=eager)
        assert torch.isfinite(m["loss"]).all()
        finals.append((tr, state))
    (_, se), (tr, sg) = finals
    assert tr.captures == 1
    for a, b in zip(tree_leaves(se.params), tree_leaves(sg.params)):
        assert max_err(a, b) <= 1e-5 * a.abs().max().item()


# ------------------------------------------------------- data parallel

def test_cuda_event_ms_and_bench_kernels(dev, capsys):
    """The port's one device timer, and bench_kernels at a small size:
    every tile prints its ms and Mpts/s, for both kernels."""
    from nerf_pl_tpu_torch import bench_kernels
    from nerf_pl_tpu_torch.utils.profiling import cuda_event_ms
    x = torch.randn((1024, 1024), device=dev)
    times = cuda_event_ms(lambda: x @ x, reps=3, warmup=1)
    assert len(times) == 3 and all(t > 0 for t in times)
    bench_kernels.main(["--n_rays", "4096", "--s", "64", "--tiles", "1000",
                        "4096", "--reps", "2"])
    out = capsys.readouterr().out
    assert len([ln for ln in out.splitlines() if "Mpts/s" in ln]) == 4


def test_gloo_ranks_sharing_the_card_need_eager_steps(dev):
    """Two gloo ranks on one card: run_steps raises without eager=True (a
    gloo collective cannot be captured), and eager steps agree across the
    ranks."""
    import torch_dp_ranks as ranks

    from nerf_pl_tpu_torch import dist as pdist
    losses = pdist.launch(ranks.gloo_on_cuda, 2, device="cuda", timeout=300)
    assert torch.equal(losses[0], losses[1])
    assert torch.isfinite(losses[0]).all()


def test_nccl_one_rank_graph_equals_no_group(dev):
    """One rank in an NCCL group (the all-reduce captured in the step's
    graph) replays bit for bit as the trainer with no group, one capture
    each, across an epoch boundary."""
    import torch_dp_ranks as ranks

    from nerf_pl_tpu_torch import dist as pdist
    (grp, c_grp), (none, c_none) = pdist.launch(ranks.graph_with_group, 1,
                                                device="cuda",
                                                timeout=300)[0]
    assert c_grp == c_none == 1
    for k in none:
        assert (grp[k] == none[k]).all(), k


def test_dryrun_multichip_on_cuda(dev):
    """dryrun_multichip 2 --device cuda: two gloo ranks on the card, every
    phase's ok line."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m",
                           "nerf_pl_tpu_torch.dryrun_multichip", "2",
                           "--device", "cuda"], capture_output=True,
                          text=True, timeout=600, cwd=repo)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count(" ok\n") == 5, proc.stdout


# ------------------------------------------------------------- tracing

LOSS_FUSED = dict(N_samples=32, N_importance=64, perturb=1.0, noise_std=1.0,
                  white_back=True, fused_train=True, fused_loss=True)


def _traced_trainer(dev, culled):
    """The loss-fused Trainer at batch 1024 on _culled_trainer's store,
    tightened and packed (culled) or as set_data leaves it (dense)."""
    if culled:
        return _culled_trainer(RenderConfig(**LOSS_FUSED), dev)[0]
    g = torch.Generator().manual_seed(1)
    n = 20000
    o = torch.randn((n, 3), generator=g)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                      dim=-1)
    rays = torch.cat([o, d, torch.full((n, 1), 2.0), torch.full((n, 1), 6.0)],
                     dim=-1)
    sched = get_lr_schedule("steplr", 5e-4, 16, 1000, decay_step=[2, 4, 8],
                            decay_gamma=0.5)
    tr = Trainer(ModelConfig(), RenderConfig(**dict(LOSS_FUSED, N_samples=64)),
                 get_optimizer("adam", sched), sched, loss_dict["mse"], 1024,
                 dev)
    tr.set_data(rays.numpy(), torch.rand((n, 3), generator=g).numpy())
    return tr


def _profiled(fn):
    """fn() under torch.profiler on the card, synchronised: (what fn
    returned, the device spans, the host spans, the kineto events)."""
    from nerfbench import trace as T
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the window's first device events can go unrecorded: a kernel and
        # a sync before fn
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
    dev_spans, host = T._spans(prof)
    return out, dev_spans, host, list(prof.profiler.kineto_results.events())


def _step_marks(culled):
    return (["draws", "batch", "occupied_z" if culled else "coarse_z",
             "coarse", "fine_z", "fine", "optimizer", "tail", "end"])


def _by_phase(dev_spans):
    """{phase: [device op names]} of the non-mark device operations, each
    in the phase whose interval holds its start (nerfbench's reading)."""
    from nerfbench.metrics import _spans as S
    ph = S.phases(type("Tr", (), {"device": dev_spans})())
    out = {}
    for name, s, _ in dev_spans:
        if S.MARK.search(name):
            continue
        for p in ph:
            if p.start <= s < p.end:
                out.setdefault(p.name, []).append(name)
                break
    return out


@pytest.mark.parametrize("culled", [False, True], ids=["dense", "culled"])
def test_replayed_step_marks_in_order_and_its_kernels_phases(dev, culled):
    """Under a profiler, 3 replayed steps show their marks in the step's
    order (the capture having happened before the window: no capture
    inside it); the mse_render launches fall in coarse and fine, every
    sort in fine_z (searchsorted in fine_z or occupied_z); the optimizer
    phase holds exactly the kernels an eager step launches inside its
    `optimizer` host span (by the runtime's correlation ids): one
    adam_kernel and the schedule's and counts' scalar ops, no foreach
    pass (multi_tensor_apply), and the replayed tail copies no state
    back (Adam wrote it in place); no device event is a user annotation
    or carries a span's name."""
    from nerf_pl_tpu_torch.utils import profiling as P
    tr = _traced_trainer(dev, culled)
    state = tr.init_state(torch.Generator().manual_seed(0))
    state, _ = tr.run_steps(state, 5, 2)
    assert tr.captures == 1
    (state, m), dev_spans, host, events = _profiled(
        lambda: tr.run_steps(state, 5, 3))
    assert tr.captures == 1 and torch.isfinite(m["loss"]).all()
    from nerfbench.metrics import _spans as S
    seen = [p for p, _, _ in S.marks(type("Tr", (), {"device": dev_spans})())]
    assert seen == _step_marks(culled) * 3
    phases = _by_phase(dev_spans)
    for p, names in phases.items():
        for n in names:
            if "fwdbwd_kernel" in n or "wgrad_kernel" in n:
                assert p in ("coarse", "fine"), (p, n)
            if "sort" in n.lower() and "searchsorted" not in n:
                assert p == "fine_z", (p, n)
            if "searchsorted" in n:
                assert p in ("fine_z", "occupied_z"), (p, n)
    assert sum("fwdbwd_kernel" in n for n in phases["coarse"]) == 3
    assert sum("fwdbwd_kernel" in n for n in phases["fine"]) == 3
    span_names = set(P.MARKS) | {n.replace("_", ".", 1) for n in P.MARKS}
    for e in events:
        if str(e.device_type()).split(".")[-1] == "CUDA":
            assert not e.is_user_annotation(), e.name()
            assert e.name() not in span_names, e.name()
    # the same step eagerly: the kernels launched inside the optimizer's
    # host span are the optimizer phase's, there and in the replay
    (_, _), eager_dev, eager_host, eager_events = _profiled(
        lambda: tr.run_steps(state, 5, 1, eager=True))
    (_, a, b), = [h for h in eager_host if h[0] == "optimizer"]
    launched = {e.correlation_id() for e in eager_events
                if str(e.device_type()).split(".")[-1] == "CPU"
                and a <= e.start_ns() * 1e-9 <= b
                and e.name().startswith("cu")}
    opt_kernels = sorted(e.name() for e in eager_events
                         if str(e.device_type()).split(".")[-1] == "CUDA"
                         and e.correlation_id() in launched
                         and not S.MARK.search(e.name()))
    assert sum("adam_kernel" in n for n in opt_kernels) == 1
    assert not any("multi_tensor_apply" in n for n in opt_kernels)
    assert sorted(_by_phase(eager_dev)["optimizer"]) == opt_kernels
    assert sorted(phases["optimizer"]) == sorted(opt_kernels * 3)
    assert not any("multi_tensor_apply" in n for n in phases["tail"])


def test_replayed_states_equal_with_tracing_off_on_and_alternating(dev):
    """12 replayed steps in 3 segments, with tracing off, on, and on only
    for the middle segment, from the same state: params, Adam's state and
    the losses bit for bit, one capture."""
    tr = _traced_trainer(dev, True)
    runs = []
    for traced in ((False,) * 3, (True,) * 3, (False, True, False)):
        state = tr.init_state(torch.Generator().manual_seed(0))
        losses = []
        for on in traced:
            if on:
                (state, m), _, _, _ = _profiled(
                    lambda s=state: tr.run_steps(s, 9, 4))
            else:
                state, m = tr.run_steps(state, 9, 4)
            losses.append(m["loss"])
        runs.append((state, torch.cat(losses)))
    assert tr.captures == 1
    (s0, l0) = runs[0]
    for s, losses in runs[1:]:
        assert torch.equal(l0, losses)
        for a, b in zip(tree_leaves(s0.params) + tree_leaves(s0.opt_state[0]),
                        tree_leaves(s.params) + tree_leaves(s.opt_state[0])):
            assert torch.equal(a, b)


def test_no_mark_runs_outside_a_profiler(dev):
    """With the profiler's device tracing on but the program told that no
    profiler records (torch's flag cleared, as outside any profiler),
    replayed steps, eager steps and a frame launch no mark; told again
    that it records, the replay's marks run."""
    import torch.autograd.profiler as tap
    from nerfbench.metrics import _spans as S
    tr = _traced_trainer(dev, False)
    state = tr.init_state(torch.Generator().manual_seed(0))
    state, _ = tr.run_steps(state, 5, 2)
    render = make_render_fn(RenderConfig(N_samples=64, N_importance=64,
                                         white_back=True, test_time=True,
                                         fused=True), 4096, dev)
    rays, _ = rays_z(5000, 8, dev)

    def hidden():
        tap._set_is_profiler_enabled(False)
        try:
            out = tr.run_steps(state, 5, 3)
            tr.run_steps(out[0], 5, 1, eager=True)
            render(out[0].params, rays)
        finally:
            tap._set_is_profiler_enabled(True)
        return tr.run_steps(out[0], 5, 1)

    _, dev_spans, _, _ = _profiled(hidden)
    seen = [p for p, _, _ in S.marks(type("Tr", (), {"device": dev_spans})())]
    assert seen == _step_marks(False)
    assert tr.captures == 1


def test_frame_marks_in_order(dev):
    """A frame of 3 tiles through make_render_fn under a profiler: its
    marks in order, sort and searchsorted in fine_z, both render kernels
    in their passes."""
    from nerfbench.metrics import _spans as S
    render = make_render_fn(RenderConfig(N_samples=64, N_importance=64,
                                         white_back=True, test_time=True,
                                         fused=True), 4096, dev)
    params = {k: dense_params(i, dev) for i, k in
              enumerate(("nerf_coarse", "nerf_fine"))}
    rays, _ = rays_z(10000, 8, dev)
    render(params, rays)
    out, dev_spans, _, _ = _profiled(lambda: render(params, rays))
    assert out["rgb_fine"].shape == (10000, 3)
    seen = [p for p, _, _ in S.marks(type("Tr", (), {"device": dev_spans})())]
    assert seen == (["frame_pad", "frame_pack"]
                    + ["coarse_z", "coarse", "fine_z", "fine"] * 3
                    + ["frame_gather", "frame_to_host", "end"])
    phases = _by_phase(dev_spans)
    for kernel, phase in (("sigma_quad_kernel", "coarse"),
                          ("eval_quad_kernel", "fine"),
                          ("searchsorted", "fine_z"),
                          ("Memcpy DtoH", "frame_to_host")):
        found = {p: sum(kernel in n for n in names)
                 for p, names in phases.items()}
        assert found[phase] >= (3 if "kernel" in kernel else 1), found
        assert sum(found.values()) == found[phase], (kernel, found)


def test_culled_dispatch_marks_in_order(dev):
    """One culled dispatch (tighten, budgets, segments) under a profiler:
    `cull`, `frame.pack`, then each bucket's mark, its tiles' phases
    (occupied_z in place of coarse_z) and `frame.gather`, then `end`; the
    cull pass's kernels in `cull`."""
    import math
    from nerfbench.metrics import _spans as S
    from nerf_pl_tpu_torch.datasets.rays import frame_rays, sphere_pose
    from nerf_pl_tpu_torch.rendering import CulledRenderer, OccupancyGrid

    boxes = torch.tensor([[-0.6, -0.6, -0.6, 0.2, 0.3, 0.4],
                          [0.5, -0.2, -1.0, 1.2, 0.6, 0.9]]).numpy()
    occ = OccupancyGrid(boxes=boxes, block_map=torch.ones(
        (2, 2, 2), dtype=torch.uint8).numpy(), lo=boxes[:, :3].min(0),
        hi=boxes[:, 3:].max(0))
    focal = 0.5 * 64 / math.tan(0.5 * 0.8575560450553894)
    rays = frame_rays(sphere_pose(0.3, math.pi / 5, 4.0), 64, 64, focal,
                      2.0, 6.0, dev)
    params = {"nerf_coarse": dense_params(10, dev),
              "nerf_fine": dense_params(11, dev)}
    cr = CulledRenderer(occ, RenderConfig(N_samples=64, N_importance=128,
                                          test_time=True, white_back=True,
                                          fused=True),
                        chunk=1024, device=dev, tighten=True, budgets=True,
                        segments=32)
    _, stats = cr(params, rays, return_stats=True)
    _, dev_spans, host, _ = _profiled(lambda: cr(params, rays))
    seen = [p for p, _, _ in S.marks(type("Tr", (), {"device": dev_spans})())]
    want = ["cull", "frame_pack"]
    for frac, _, n_tiles, _, _ in cr._tile_plan(4096, stats["bucket_counts"]):
        want += (["bucket"] + ["occupied_z", "coarse", "fine_z", "fine"]
                 * n_tiles + ["frame_gather"])
    assert seen == want + ["end"]
    assert any("sort" in n.lower() for n in _by_phase(dev_spans)["cull"])
    assert [h[0] for h in sorted(host, key=lambda h: h[1])
            if h[0] in ("cull", "bucket")] == (
        ["cull"] + ["bucket"] * want.count("bucket"))


# ---------------------------------------------------------------- adam

def _dense_grads(dev, seed):
    """Both MLPs' gradients as the loss-fused step gives them: unpack_grads
    of a random packed buffer (strided views among them)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return {m: fm.unpack_grads(fm._pack_layout_grads(torch.randn(
        (fm.GRAD_FLOATS,), generator=g, device=dev) * 1e-3))
        for m in ("nerf_coarse", "nerf_fine")}


def _dense_params(dev):
    return {m: init_nerf_params(torch.Generator().manual_seed(i), device=dev)
            for i, m in enumerate(("nerf_coarse", "nerf_fine"))}


def _state_leaves(params, state):
    import torch.utils._pytree as pytree
    return pytree.tree_leaves((params, state))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("scheduled", [True, False])
def test_adam_kernel_equals_the_foreach_chain(dev, weight_decay, inplace,
                                              scheduled):
    """5 steps of the dense recipe's 48 leaves (steplr, or a constant lr)
    with unpack_grads' strided gradients: the kernel's params, moments and
    counts equal the foreach chain's (update + apply_updates) bit for bit,
    one launch a step; in place, the given tensors hold them."""
    from nerf_pl_tpu_torch.ops import adam as A
    from nerf_pl_tpu_torch.training.optimizers import (apply_updates,
                                                       optimizer_step)
    sched = get_lr_schedule("steplr", 5e-4, 16, 2, decay_step=[1, 2],
                            decay_gamma=0.5)
    opt = get_optimizer("adam", sched if scheduled else 5e-4,
                        weight_decay=weight_decay)
    params = _dense_params(dev)
    assert any(not g.is_contiguous()
               for g in tree_leaves(_dense_grads(dev, 0), params))
    pk = {m: {k: {n: t.clone() for n, t in d.items()} for k, d in v.items()}
          for m, v in params.items()}
    sk = opt.init(params)
    pc, sc = params, opt.init(params)
    for i in range(5):
        grads = _dense_grads(dev, i)
        n0 = A.adam_launches
        given = _state_leaves(pk, sk)
        pk, sk = optimizer_step(opt, grads, sk, pk, inplace)
        assert A.adam_launches == n0 + 1
        got = _state_leaves(pk, sk)
        assert [a is b for a, b in zip(given, got)] == [inplace] * len(got)
        upd, sc = opt.update(grads, sc, pc)
        pc = apply_updates(pc, upd)
        want = _state_leaves(pc, sc)
        assert len(got) == len(want) == 48 * 3 + 1 + scheduled
        for j, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and torch.equal(a, b), (i, j)
    n0 = A.adam_launches
    opt = get_optimizer("adam", sched, weight_decay=weight_decay)
    bf = {m: {k: {n: t.bfloat16() for n, t in d.items()}
              for k, d in v.items()} for m, v in params.items()}
    optimizer_step(opt, _dense_grads(dev, 9), opt.init(bf), bf, inplace)
    assert A.adam_launches == n0           # bf16 masters: the chain


def test_adam_bias_correction_at_every_count(dev):
    """The kernel's b1^t and b2^t (a double pow of the device count,
    rounded to float) are _decay_pow's: one leaf stepped from count t - 1
    for every t up to 20,000 and at larger t up to 2^31 - 1 gives the
    chain's bits."""
    from nerf_pl_tpu_torch.training.optimizers import (apply_updates,
                                                       optimizer_step)
    opt = get_optimizer("adam", 5e-4)
    g = torch.Generator(device=dev).manual_seed(3)
    params = {"w": torch.randn((4096,), generator=g, device=dev)}
    grads = {"w": torch.randn((4096,), generator=g, device=dev) * 1e-3}
    state = opt.init(params)
    state[0]["mu"]["w"].normal_(generator=g).mul_(1e-3)
    state[0]["nu"]["w"].uniform_(generator=g).mul_(1e-6)
    counts = list(range(1, 20001)) + [2 ** k - 1 for k in range(15, 32)]
    bad = []
    for t in counts:
        state[0]["count"].fill_(t - 1)
        pk, sk = optimizer_step(opt, grads, state, params)
        upd, sc = opt.update(grads, state, params)
        pc = apply_updates(params, upd)
        if not (torch.equal(pk["w"], pc["w"])
                and torch.equal(sk[0]["mu"]["w"], sc[0]["mu"]["w"])
                and torch.equal(sk[0]["nu"]["w"], sc[0]["nu"]["w"])):
            bad.append(t)
    assert not bad, bad[:20]


def test_adam_replayed_steps_equal_eager_and_launch_once(dev):
    """250 replayed graph steps of the loss-fused dense trainer (Adam in
    place in the static buffers) leave the state that 250 eager steps
    (Adam into new tensors) leave, bit for bit; the capture recorded one
    adam launch and two mse_render launches a step, and the counter gains
    one a replay."""
    from nerf_pl_tpu_torch.ops import adam as A
    finals = []
    for eager in (True, False):
        tr = _traced_trainer(dev, False)
        state = tr.init_state(torch.Generator().manual_seed(0))
        n0 = A.adam_launches
        state, m = tr.run_steps(state, 5, 250, eager=eager)
        finals.append((tr, state, m, A.adam_launches - n0))
    (_, se, me, ne), (tr, sg, mg, ng) = finals
    assert tr.captures == 1
    assert tr._graph.launches == {"mse_render": 2, "adam": 1}
    assert ne == 250 and ng == 250 + tr._graph.WARMUP_STEPS
    for a, b in zip(_state_leaves(se.params, se.opt_state),
                    _state_leaves(sg.params, sg.opt_state)):
        assert torch.equal(a, b)
    for k in ("loss", "psnr", "lr"):
        assert torch.equal(me[k], mg[k]), k
    n0 = A.adam_launches
    tr.run_steps(sg, 5, 7)
    assert A.adam_launches == n0 + 7



# ------------------------------------------------------------ mip-NeRF 360

def _mip_cell(n_rays, batch):
    """The benchmark's mipnerf360_outdoor.train16k at published widths,
    its store and batch cut."""
    import copy
    from nerfbench import run
    cell = copy.deepcopy(run.load_cell("mipnerf360_outdoor.train16k"))
    cell["config"]["store"]["n_rays"] = n_rays
    cell["traffic"]["batch_per_rank"] = batch
    return cell


def _mip_trainer(dev, cell, seed):
    from nerf_pl_tpu_torch.parallel.spmd import TrainState
    from nerfbench import inputs_mip360 as mi
    from nerfbench.runners import train_mip360 as runner
    tr = runner.trainer_with_store(cell, seed, dev)
    params = mi.make_params(cell["config"]["model"], seed, dev)
    return tr, TrainState(params, tr.optimizer.init(params), 0)


def test_mip360_replayed_steps_equal_eager_steps(dev):
    """20 replayed graph steps of mip-NeRF 360 at published widths (batch
    1024) leave the state, and give the metrics, that 20 eager steps do,
    bit for bit; one capture, one adam launch and 17 relu_bgrad launch
    pairs a step."""
    cell = _mip_cell(65536, 1024)
    finals = []
    for eager in (True, False):
        tr, state = _mip_trainer(dev, cell, 7)
        state, m = tr.run_steps(state, 7, 20, eager=eager)
        finals.append((tr, state, m))
    (_, se, me), (tr, sg, mg) = finals
    assert tr.captures == 1 and tr._graph.launches == {"adam": 1,
                                                       "relu_bgrad": 17}
    for a, b in zip(_state_leaves(se.params, se.opt_state),
                    _state_leaves(sg.params, sg.opt_state)):
        assert torch.equal(a, b)
    for k in ("loss", "psnr", "lr"):
        assert torch.equal(me[k], mg[k]), k
    assert torch.isfinite(mg["loss"]).all()


def test_mip360_step_at_published_widths_against_the_reference(dev):
    """The program's first three steps on 256 rays a step, at published
    widths in bf16 products, against the plain float32 reference: within
    the cell's limits (nerfbench/limits/...train16k.json)."""
    import json
    from pathlib import Path
    from nerfbench import check
    from nerfbench.runners import train_mip360 as runner
    cell = _mip_cell(65536, 256)
    res = runner.run(cell, 2718281828, 0.1, False, 0.0, device="cuda")
    limits = json.loads((Path(__file__).resolve().parents[1] / "nerfbench"
                         / "limits" / "mipnerf360_outdoor.train16k.json")
                        .read_text())["limits"]
    ok, checks = check.judge(res["numbers"], limits)
    print(res["numbers"])
    assert ok, checks


def test_mip360_replayed_step_marks_in_order(dev):
    """Under a profiler, 2 replayed steps show mip-NeRF 360's marks in its
    step's order, the clip's norm kernels in `clip` and one adam_kernel in
    `optimizer`."""
    cell = _mip_cell(65536, 1024)
    tr, state = _mip_trainer(dev, cell, 3)
    state, _ = tr.run_steps(state, 3, 2)
    (state, m), dev_spans, _, _ = _profiled(lambda: tr.run_steps(state, 3, 2))
    assert tr.captures == 1 and torch.isfinite(m["loss"]).all()
    from nerfbench.metrics import _spans as S
    seen = [p for p, _, _ in S.marks(type("Tr", (), {"device": dev_spans})())]
    assert seen == ["draws", "batch", "prop0", "resample1", "prop1",
                    "resample2", "nerf", "losses", "backward", "clip",
                    "optimizer", "tail", "end"] * 2
    phases = _by_phase(dev_spans)
    assert sum("adam_kernel" in n for n in phases["optimizer"]) == 2
    assert any("norm" in n.lower() for n in phases["clip"])
    assert not any("adam_kernel" in n for p, ns in phases.items()
                   if p != "optimizer" for n in ns)


# mip-NeRF 360's ReLU layers at the cell's shapes (16,384 rays: the NeRF
# trunk's 524,288 x 1024, layer 4's gradient a 1024-column view of 1096,
# the view layer's x 128, the proposal MLP's 1,048,576 x 256 a level and
# 2,097,152 x 256 both), and inputs that leave the 16-byte path: an odd
# width, a row stride of 1100 and a view one value past a 16-byte word
# ("off": the columns 1 .. 1024 of 1096-wide rows)
RELU_SHAPES = [(524288, 1024, None), (524288, 1024, 1096),
               (524288, 128, None), (1048576, 256, None),
               (2097152, 256, None), (4099, 100, None)]
RELU_ELEMENTWISE = [(4099, 100, None), (524288, 1024, 1100),
                    (524288, 1024, "off")]
RELU_DB_TOL = 1e-5       # |db - float64 sum| over the column's sum |g|


def _relu_inputs(P, N, width, dev, seed=0):
    """bf16 y (ReLU outputs with -0.0 and NaN planted) and grad [P, N] of
    mean 1, so that a column's |sum g| is near its sum |g| and db's
    rounding shows against the latter; grad a view of the first N columns
    of [P, width] where width is given, of the columns 1 .. N of [P, 1096]
    where it is "off"."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = torch.relu(torch.randn((P, N), generator=gen, device=dev)
                   ).to(torch.bfloat16)
    y[0::7, 1::3] = -0.0
    y[2::11, 2::5] = float("nan")
    cols = 1096 if width == "off" else width or N
    full = (torch.randn((P, cols), generator=gen, device=dev) + 1
            ).to(torch.bfloat16)
    if width == "off":
        return full[:, 1:N + 1], y
    return (full[:, :N] if width else full), y


def _db_err(db, want):
    """The largest |db - float64 column sum| over the column's sum |g|."""
    return ((db.double() - want.double().sum(0)).abs()
            / want.double().abs().sum(0).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("P,N,width", RELU_SHAPES + RELU_ELEMENTWISE[1:])
def test_relu_bgrad_matches_threshold_backward(dev, P, N, width):
    """g bit for bit threshold_backward's, db within 1e-5 x sum |g| of a
    float64 column sum, per column, a bar that db rounded to bf16 fails;
    the grad view read where it lies."""
    from nerf_pl_tpu_torch.ops import relu_bgrad as RB
    grad, y = _relu_inputs(P, N, width, dev)
    n0 = RB.relu_bgrad_launches
    g, db = RB.relu_bgrad(grad, y)
    torch.cuda.synchronize()
    assert RB.relu_bgrad_launches == n0 + 1
    want = torch.ops.aten.threshold_backward(grad, y, 0)
    assert g.is_contiguous() and db.dtype == torch.float32
    assert torch.equal(g.view(torch.int16), want.view(torch.int16))
    assert _db_err(db, want) <= RELU_DB_TOL, _db_err(db, want)
    assert _db_err(db.to(torch.bfloat16).float(), want) > RELU_DB_TOL


@pytest.mark.parametrize("P,N,width", RELU_SHAPES + RELU_ELEMENTWISE[1:])
def test_relu_bgrad_is_deterministic(dev, P, N, width):
    from nerf_pl_tpu_torch.ops import relu_bgrad as RB
    grad, y = _relu_inputs(P, N, width, dev, seed=1)
    g1, db1 = RB.relu_bgrad(grad, y)
    g2, db2 = RB.relu_bgrad(grad, y)
    assert torch.equal(g1.view(torch.int16), g2.view(torch.int16))
    assert torch.equal(db1.view(torch.int32), db2.view(torch.int32))


@pytest.mark.parametrize("P,N,width", RELU_ELEMENTWISE)
def test_relu_bgrad_refuses_the_vector_path_where_it_does_not_fit(
        dev, P, N, width):
    """An odd width, a row stride or an address that is not whole 16-byte
    words: the wrapper launches the element-wise kernel (relu_bgrad_kernel
    <1>) and never the 16-byte one, with g and db as the test above holds
    them."""
    from nerf_pl_tpu_torch.ops import relu_bgrad as RB
    grad, y = _relu_inputs(P, N, width, dev, seed=2)
    assert not RB.fits_vector(grad, y)
    (g, db), dev_spans, _, _ = _profiled(lambda: RB.relu_bgrad(grad, y))
    names = [n for n, _, _ in dev_spans if "relu_bgrad_kernel" in n]
    assert len(names) == 1 and "<1>" in names[0], names
    want = torch.ops.aten.threshold_backward(grad, y, 0)
    assert torch.equal(g.view(torch.int16), want.view(torch.int16))
    assert _db_err(db, want) <= RELU_DB_TOL


def test_mip360_eager_step_launches_relu_bgrad_17_times(dev):
    """One eager mip-NeRF 360 step at published widths: 17 relu_bgrad
    launch pairs (8 NeRF trunk layers, the view layer, 4 proposal layers
    at both levels), each running both kernels, and no
    threshold_backward."""
    from nerf_pl_tpu_torch.ops import relu_bgrad as RB
    cell = _mip_cell(65536, 1024)
    tr, state = _mip_trainer(dev, cell, 5)
    n0 = RB.relu_bgrad_launches
    (state, m), dev_spans, host, _ = _profiled(
        lambda: tr.run_steps(state, 5, 1, eager=True))
    assert RB.relu_bgrad_launches == n0 + 17
    assert torch.isfinite(m["loss"]).all()
    names = [n for n, _, _ in dev_spans]
    assert sum("relu_bgrad_kernel" in n for n in names) == 17
    assert sum("relu_bgrad_sum_kernel" in n for n in names) == 17
    assert not any("threshold_backward" in n for n, _, _ in host)


@pytest.mark.parametrize("inplace", [False, True])
def test_adam_kernel_with_clip_equals_the_clipped_chain(dev, inplace):
    """5 steps of the dense recipe's 48 leaves with a global-norm clip of
    1e-3 and eps 1e-6: the kernel (the clip's factor read from the device)
    gives the clipped foreach chain's params, moments and counts bit for
    bit, one launch a step; the factor is below 1 (the clip bites)."""
    from nerf_pl_tpu_torch.ops import adam as A
    from nerf_pl_tpu_torch.training.optimizers import (apply_updates,
                                                       clip_scale,
                                                       optimizer_step)
    sched = get_lr_schedule("steplr", 5e-4, 16, 2, decay_step=[1, 2],
                            decay_gamma=0.5)
    opt = get_optimizer("adam", sched, eps=1e-6, clip_norm=1e-3)
    params = _dense_params(dev)
    pk = {m: {k: {n: t.clone() for n, t in d.items()} for k, d in v.items()}
          for m, v in params.items()}
    sk, pc, sc = opt.init(params), params, opt.init(params)
    for i in range(5):
        grads = _dense_grads(dev, i)
        scale = clip_scale(tree_leaves(grads, params), 1e-3)
        assert float(scale) < 1
        n0 = A.adam_launches
        pk, sk = optimizer_step(opt, grads, sk, pk, inplace)
        assert A.adam_launches == n0 + 1
        upd, sc = opt.update(grads, sc, pc, scale)
        pc = apply_updates(pc, upd)
        for j, (a, b) in enumerate(zip(_state_leaves(pk, sk),
                                       _state_leaves(pc, sc))):
            assert a.dtype == b.dtype and torch.equal(a, b), (i, j)


def test_nerf_recipe_step_launches_no_clip(dev):
    """The loss-fused dense recipe (no clip asked for): the captured step
    launches what it did before the clip existed (two mse_render, one
    adam), its marks have no `clip`, and no phase of it runs a foreach
    pass (the clip's norm is one)."""
    tr = _traced_trainer(dev, False)
    assert tr.optimizer.clip_norm == 0
    state = tr.init_state(torch.Generator().manual_seed(0))
    state, _ = tr.run_steps(state, 5, 2)
    assert tr._graph.launches == {"mse_render": 2, "adam": 1}
    (_, _), dev_spans, _, _ = _profiled(lambda: tr.run_steps(state, 5, 2))
    from nerfbench.metrics import _spans as S
    seen = [p for p, _, _ in S.marks(type("Tr", (), {"device": dev_spans})())]
    assert "clip" not in seen and seen == _step_marks(False) * 2
    for p, names in _by_phase(dev_spans).items():
        assert not any("lpnorm" in n.lower() or "multi_tensor_apply" in n
                       for n in names), p
