"""mip-NeRF 360 on the port (models/mipnerf360.py, rendering/mip360.py,
the losses, the clipped Adam, the Trainer's step, the CLIs) against the
benchmark's plain reference, nerfbench/references/mipnerf360.py, on the
CPU.

The model runs at cut widths (proposal 32, NeRF 64, bottleneck 32, view
16; the CPU only) with the full depths and sample counts (64 + 64 + 32)
on 16-64 rays, weights from the benchmark's seeded init, the port's
products in float32. Tolerances: the port and the reference compute the
same float32 quantities in other orders (the contraction's covariance in
closed form against a Jacobian by jacfwd, searchsorted against
comparisons, the transmittance by exp(-cumsum) against a cumprod, the
distortion in O(N) against O(N^2)), so they agree to float32 rounding:
1e-4 on the step functions, colours and losses. The gradient is amplified
on its way down the NeRF MLP's trunk (the encoding's 2^11 frequencies at
its input, the quadrature's intervals up to 1e6 long at its density): the
heads' leaves agree to ~1e-5 of their norms, the trunk's first layers to
2e-3-6e-3 (two seeds), so a leaf is held to GRAD_TOL = 2e-2 of its norm and
the median leaf to 2e-3. An element of the parameters moves at most the
three steps' summed lr (7.8e-5); the two sides' may differ by 5% of that.
"""
import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_pl_tpu_torch.models import embedding as E
from nerf_pl_tpu_torch.models.mipnerf360 import MipConfig, init_mip_params
from nerf_pl_tpu_torch.parallel.spmd import Trainer, TrainState
from nerf_pl_tpu_torch.rendering import RenderConfig
from nerf_pl_tpu_torch.rendering import mip360 as M
from nerf_pl_tpu_torch.training import losses as L
from nerf_pl_tpu_torch.training.lr_schedule import get_loglinear_schedule
from nerf_pl_tpu_torch.training.optimizers import get_optimizer

from nerfbench import check
from nerfbench import inputs_mip360 as mi
from nerfbench.references import mipnerf360 as ref

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
GRAD_TOL = 2e-2
MEDIAN_TOL = 2e-3
PARAM_TOL = 4e-6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg():
    """The configuration's file at cut widths, 4096 rays in the store."""
    cfg = json.loads((ROOT / "nerfbench/configs/mipnerf360_outdoor.json")
                     .read_text())
    cfg = copy.deepcopy(cfg)
    cfg["model"]["prop"]["width"] = 32
    cfg["model"]["nerf"].update(width=64, bottleneck=32, view_width=16)
    cfg["precision"]["matmul"] = "float32"
    cfg["store"]["n_rays"] = 4096
    return cfg


def _port_cfg(cfg):
    from nerfbench.runners.train_mip360 import mip_config
    return mip_config(cfg)


def _batch(cfg, R, seed=7):
    rays, rgbs, radii = mi.make_store(cfg, R, seed, torch.device("cpu"))
    jitter = mi.step_draws(cfg, R, seed, 0, torch.device("cpu"))["jitter"]
    return rays, rgbs, radii, jitter


def test_forward_matches_the_reference():
    """Each level's endpoints and weights, the colour and the three losses
    of one training render, from the same weights and jitter."""
    cfg = _cfg()
    pc = _port_cfg(cfg)
    params = mi.make_params(cfg["model"], 11, torch.device("cpu"))
    rays, rgbs, radii, jitter = _batch(cfg, 16)
    ref.no_tf32()
    with torch.no_grad():
        got = M.render_levels(params, rays, radii, pc, jitter)
        want = ref.render(params, cfg["model"], cfg["render"], rays, radii,
                          ref.Matmul(), jitter)
        for level in range(3):
            for k in ("sdist", "weights"):
                torch.testing.assert_close(got[k][level], want[k][level],
                                           atol=TOL, rtol=0, msg=(k, level))
        torch.testing.assert_close(got["rgb"], want["rgb"], atol=TOL, rtol=0)
        _, parts = L.mip360_loss(got, rgbs, pc)
        data, inter, dist = ref.loss_sums(want, rgbs, cfg["loss"])
        R, n = rays.shape[0], cfg["render"]["num_nerf_samples"]
        for name, w in (("data", data / (R * 3)),
                        ("interlevel", inter / (R * n)),
                        ("distortion", dist / R)):
            assert abs(float(parts[name]) - float(w)) <= TOL * max(
                1.0, abs(float(w))), name
    assert [s.shape[1] for s in got["sdist"]] == [65, 65, 33]


def _trainer(cfg, batch):
    o = cfg["optimizer"]
    sched = get_loglinear_schedule(o["lr_init"], o["lr_final"],
                                   o["max_steps"], o["lr_delay_steps"],
                                   o["lr_delay_mult"])
    opt = get_optimizer("adam", sched, eps=o["eps"],
                        clip_norm=o["grad_max_norm"])
    return Trainer(_port_cfg(cfg), RenderConfig(), opt, sched, None, batch,
                   "cpu")


def test_gradients_and_three_clipped_adam_steps_match_the_reference():
    """The Trainer's first three steps (run_steps) over the store's
    shuffled rows and its draws: every leaf's first clipped gradient
    (Adam's first moment over 1 - b1) within GRAD_TOL of its norm (the
    median leaf MEDIAN_TOL), the losses and the parameters after three
    steps."""
    cfg = _cfg()
    seed, b = 5, 32
    cell = {"config": cfg, "traffic": {"batch_per_rank": b, "world": 1,
                                       "checked_steps": 3}}
    from nerfbench.runners import train_mip360 as runner
    tr = runner.trainer_with_store(cell, seed, torch.device("cpu"))
    params = mi.make_params(cfg["model"], seed, torch.device("cpu"))
    state = TrainState(params, tr.optimizer.init(params), 0)
    s1, m1 = tr.run_steps(state, seed, 1)
    s3, m2 = tr.run_steps(s1, seed, 2)
    r = runner.reference_steps(cell, seed, torch.device("cpu"))
    mu = check.flatten(s1.opt_state[-2]["mu"])
    errs = []
    for n, g in r["grads0"].items():
        got = mu[n] / (1 - cfg["optimizer"]["b1"])
        errs.append(float(torch.linalg.vector_norm(got - g))
                    / float(torch.linalg.vector_norm(g)))
        assert errs[-1] <= GRAD_TOL, n
    assert len(errs) == 34 and sorted(errs)[17] <= MEDIAN_TOL
    # the clip is active: the reference's clipped gradient has norm 1e-3
    total = math.sqrt(sum(float((g.double() ** 2).sum())
                          for g in r["grads0"].values()))
    assert abs(total - cfg["optimizer"]["grad_max_norm"]) < 1e-6
    losses = torch.cat([m1["loss"], m2["loss"]]).tolist()
    np.testing.assert_allclose(losses, r["losses"], rtol=TOL)
    got = check.flatten(s3.params)
    for n, p in r["params"].items():
        torch.testing.assert_close(got[n], p, atol=PARAM_TOL, rtol=0,
                                   msg=n)
    numbers = check.train_numbers({"losses": losses, "grads0": {
        n: t / (1 - cfg["optimizer"]["b1"]) for n, t in mu.items()},
        "params": got}, r, r["params0"])
    assert numbers["grad_gap"] < MEDIAN_TOL and numbers["loss_gap"] < TOL


def test_contraction_jacobian_matches_autograd():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((40, 3), generator=g, dtype=torch.float64) * 1.5
    jac = E.contract_jacobian(x)
    for i in range(x.shape[0]):
        want = torch.autograd.functional.jacobian(E.contract, x[i])
        torch.testing.assert_close(jac[i], want, atol=1e-12, rtol=1e-10)
    # the closed-form diagonal of J Sigma J^T against the matrices
    o = torch.randn((5, 3), generator=g, dtype=torch.float64)
    d = torch.randn((5, 3), generator=g, dtype=torch.float64)
    t0 = torch.rand((5, 7), generator=g, dtype=torch.float64) * 3 + 0.2
    t1 = t0 + torch.rand((5, 7), generator=g, dtype=torch.float64)
    radii = torch.full((5, 1), 0.01, dtype=torch.float64)
    t_mean, t_var, r_var = E.frustum_moments(t0, t1, radii)
    mean_c, var = E.contracted_gaussian(o, d, t_mean, t_var, r_var)
    mean = o[:, None] + d[:, None] * t_mean[..., None]
    dd = d[:, :, None] * d[:, None, :]
    null = torch.eye(3, dtype=d.dtype) - dd / (d * d).sum(-1)[:, None, None]
    cov = t_var[..., None, None] * dd[:, None] \
        + r_var[..., None, None] * null[:, None]
    J = E.contract_jacobian(mean)
    want = torch.diagonal(J @ cov @ J.transpose(-1, -2), dim1=-2, dim2=-1)
    torch.testing.assert_close(var, want, atol=1e-12, rtol=1e-9)
    torch.testing.assert_close(mean_c, E.contract(mean), atol=1e-12,
                               rtol=0)
    assert (mean.norm(dim=-1) > 1).any() and (mean.norm(dim=-1) < 1).any()


def test_frustum_moments_match_numerical_quadrature():
    """mu_t, sigma_t^2 and sigma_r^2 against the frustum's moments by
    quadrature: density proportional to t^2 on [t0, t1], the radial
    variance (r t)^2 / 4 averaged over it."""
    t0 = torch.tensor([0.5, 1.0, 3.0, 10.0], dtype=torch.float64)
    t1 = t0 + torch.tensor([0.1, 0.5, 2.0, 1.0], dtype=torch.float64)
    r = torch.tensor(0.02, dtype=torch.float64)
    t_mean, t_var, r_var = E.frustum_moments(t0, t1, r)
    for i in range(4):
        t = torch.linspace(float(t0[i]), float(t1[i]), 200001,
                           dtype=torch.float64)
        w = t * t / torch.trapz(t * t, t)
        m = torch.trapz(w * t, t)
        v = torch.trapz(w * (t - m) ** 2, t)
        rv = torch.trapz(w * (r * t) ** 2 / 4, t)
        assert abs(float(t_mean[i] - m)) < 1e-9
        assert abs(float(t_var[i] - v)) < 1e-9
        assert abs(float(r_var[i] - rv)) < 1e-12


def _step_fn(R, N, seed):
    g = torch.Generator().manual_seed(seed)
    s = torch.sort(torch.rand((R, N + 1), generator=g), -1).values
    s[:, 0], s[:, -1] = 0.0, 1.0
    w = torch.rand((R, N), generator=g)
    return s, w / w.sum(-1, keepdim=True)


def test_distortion_linear_form_equals_the_double_sum():
    s, w = _step_fn(9, 31, 1)
    m = 0.5 * (s[:, 1:] + s[:, :-1])
    pair = (w[:, :, None] * w[:, None, :]
            * (m[:, :, None] - m[:, None, :]).abs()).sum((1, 2))
    want = (pair + (w * w * (s[:, 1:] - s[:, :-1])).sum(-1) / 3).mean()
    torch.testing.assert_close(L.distortion_loss(s, w), want, atol=1e-7,
                               rtol=1e-6)


def test_interlevel_bound_equals_brute_force_overlap():
    s_env, w_env = _step_fn(6, 64, 3)
    s, _ = _step_fn(6, 30, 2)
    # two endpoints shared with the proposal's
    s = torch.sort(torch.cat([s, s_env[:, 10:11], s_env[:, 40:41]], -1),
                   -1).values
    got = L.interlevel_bound(s, s_env, w_env)
    want = torch.zeros_like(got)
    for r in range(s.shape[0]):
        for i in range(s.shape[1] - 1):
            for j in range(s_env.shape[1] - 1):
                if s_env[r, j + 1] > s[r, i] and s_env[r, j] <= s[r, i + 1]:
                    want[r, i] += w_env[r, j]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    torch.testing.assert_close(ref.overlap_bound(s, s_env, w_env), want,
                               atol=1e-6, rtol=0)


def test_resampler_endpoints_sorted_inside_the_unit_interval():
    s, w = _step_fn(12, 64, 4)
    w = w.clone().requires_grad_()
    jitter = torch.rand((12, 1), generator=torch.Generator().manual_seed(5))
    for j in (jitter, None, torch.zeros((12, 1)),
              torch.full((12, 1), 1 - 1e-7)):
        out = M.resample(s, w, 32, j)
        assert out.shape == (12, 33) and not out.requires_grad
        assert (out[:, 1:] >= out[:, :-1]).all()
        assert (out >= 0).all() and (out <= 1).all()
    # level 0: the single interval [0, 1] of weight 1 gives linspace-like
    # centres
    out = M.resample(torch.tensor([[0.0, 1.0]]), torch.ones((1, 1)), 4, None)
    torch.testing.assert_close(out, torch.tensor(
        [[0.0, 0.25, 0.5, 0.75, 1.0]]), atol=1e-6, rtol=0)


def test_loglinear_schedule_is_multinerfs():
    o = _cfg()["optimizer"]
    sched = get_loglinear_schedule(o["lr_init"], o["lr_final"],
                                   o["max_steps"], o["lr_delay_steps"],
                                   o["lr_delay_mult"])
    for step in (0, 1, 256, 511, 512, 513, 100000, 250000, 300000):
        assert abs(float(sched(step)) - ref.lr_at(o, step)) <= 1e-6 * \
            ref.lr_at(o, step), step
    assert abs(float(sched(0)) - 2e-5) < 1e-6 * 2e-5


def test_params_match_the_benchmarks_layout_and_the_leaf_limit():
    """The port's init and the benchmark's make_params give the same
    tree (names, shapes); at published widths, 34 leaves (under the Adam
    table's 56) and 8,012,165 parameters."""
    from nerf_pl_tpu_torch.ops.adam import MAX_LEAVES
    cfg = json.loads((ROOT / "nerfbench/configs/mipnerf360_outdoor.json")
                     .read_text())
    ours = init_mip_params(torch.Generator().manual_seed(0), MipConfig())
    bench = mi.make_params(cfg["model"], 1, torch.device("cpu"))
    shapes = {(m, l, k): tuple(t.shape) for m, ls in ours.items()
              for l, leaf in ls.items() for k, t in leaf.items()}
    assert shapes == {(m, l, k): tuple(t.shape) for m, ls in bench.items()
                      for l, leaf in ls.items() for k, t in leaf.items()}
    assert len(shapes) == 34 <= MAX_LEAVES
    assert sum(math.prod(s) for s in shapes.values()) == 8012165


def test_trainer_refuses_what_the_model_does_not_take():
    cfg = _cfg()
    tr = _trainer(cfg, 16)
    with pytest.raises(ValueError, match="radii"):
        tr.set_data(np.zeros((32, 8), np.float32),
                    np.zeros((32, 3), np.float32))
    with pytest.raises(ValueError, match="occupancy"):
        tr.tighten_store(np.zeros((1, 6), np.float32))
    with pytest.raises(ValueError, match="one device"):
        Trainer(_port_cfg(cfg), RenderConfig(), tr.optimizer,
                tr.lr_schedule, None, 16, "cpu", tensor_parallel=True)


@pytest.mark.parametrize("flags", [["--occ_train"], ["--fused_train"],
                                   ["--fused_mlp"], ["--num_gpus", "2"],
                                   ["--optimizer", "ranger"]])
def test_cli_refuses_the_paths_mipnerf360_does_not_take(flags):
    from nerf_pl_tpu_torch.config import get_opts
    with pytest.raises(ValueError, match="mipnerf360 does not take"):
        get_opts(["--model", "mipnerf360", "--dataset_name", "llff",
                  "--spheric_poses"] + flags)


@pytest.mark.parametrize("flags", [["--fused_mlp"], ["--occ_grid"],
                                   ["--num_chips", "2"],
                                   ["--dataset_name", "blender"]])
def test_eval_cli_refuses_the_paths_mipnerf360_does_not_take(flags):
    """The eval CLI refuses them at parse time, before any file is read."""
    from nerf_pl_tpu_torch.eval import get_opts
    with pytest.raises(ValueError, match="mipnerf360 does not take"):
        get_opts(["--model", "mipnerf360", "--root_dir", "scene",
                  "--ckpt_path", "c", "--dataset_name", "llff"] + flags)


def test_train_cli_checkpoint_and_eval(tmp_path, monkeypatch):
    """--model mipnerf360 at cut widths on a synthetic llff scene with
    --spheric_poses: a few steps through NeRFSystem.fit and run_steps, a
    finite loss, the checkpoint resumes the full state, and eval renders
    it (the held-out view scores what validation scored); mesh extraction
    refuses it."""
    from nerf_pl_tpu_torch import eval as ev
    from nerf_pl_tpu_torch import train
    from nerf_pl_tpu_torch.utils.synthetic import make_llff_scene
    monkeypatch.chdir(tmp_path)
    make_llff_scene("scene", n_images=4, wh=(16, 12))
    cut = ["--mip_prop_width", "16", "--mip_nerf_width", "32",
           "--mip_prop_samples", "8", "--mip_nerf_samples", "8"]
    args = ["--model", "mipnerf360", "--dataset_name", "llff",
            "--spheric_poses", "--root_dir", "scene", "--img_wh", "16", "12",
            "--batch_size", "64", "--scan_steps", "4", "--exp_name", "m",
            "--val_chunk", "96"] + cut
    final = train.main(args + ["--num_epochs", "1"], device="cpu")
    assert math.isfinite(final["val/psnr"]) and final["step"] == 9
    out = train.main(args + ["--num_epochs", "2", "--ckpt_path",
                             "ckpts/m/last.ckpt"], device="cpu")
    assert out["step"] == 18
    psnr = ev.main(["--model", "mipnerf360", "--dataset_name", "llff",
                    "--root_dir", "scene", "--img_wh", "16", "12",
                    "--ckpt_path", "ckpts/m/last.ckpt", "--split", "val",
                    "--chunk", "100"] + cut, device="cpu")
    assert abs(psnr - out["val/psnr"]) < 1e-3
    assert (tmp_path / "results/llff/test/000.png").is_file()
    with pytest.raises(ValueError, match="mipnerf360 does not take"):
        ev.get_opts(["--model", "mipnerf360", "--root_dir", "scene",
                     "--ckpt_path", "c", "--dataset_name", "llff",
                     "--fused_mlp"])
    from nerf_pl_tpu_torch import extract_color_mesh
    with pytest.raises(ValueError, match="mip-NeRF 360 checkpoint"):
        extract_color_mesh.main(["--root_dir", "scene", "--dataset_name",
                                 "llff", "--img_wh", "16", "12",
                                 "--ckpt_path", "ckpts/m/last.ckpt"],
                                device="cpu")
