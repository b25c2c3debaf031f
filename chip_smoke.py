#!/usr/bin/env python
"""Smoke run of the PyTorch port (nerf_pl_tpu_torch) on one NVIDIA GPU.

    python chip_smoke.py

1. Prints the card (torch and nvidia-smi); without a CUDA device it fails.
2. Builds the kernels from csrc/ (first use; one nvcc per source, all at
   once) and prints the seconds and ptxas's registers and spills.
3. Eval path. Holds each render kernel against its plain PyTorch version
   on the card, at ragged R = 4099 and S = 64, 128, 192, with the JAX
   kernels' test bars (weights 5e-3, rgb and opacity 1e-2, depth 5e-2),
   and render_eval against train_fwd on a zero noise tensor at the same
   shapes, white background on and off: rgb, depth and opacity bit for bit
   out8[:, 0:5] (render_eval is train_fwd's forward tile loop and
   quadrature with no noise); likewise sigma_render's weights and opacity
   bit for bit train_fwd's weights and out8[:, 4] (sigma_render is
   train_fwd's trunk and the weight part of its quadrature; the max
   difference is printed). Times both render kernels at the main
   path's tile (32768 rays) with CUDA events. Then drives the eval path:
   random weights from a torch.Generator seed are written as a checkpoint
   with the JAX package's keys, loaded back with load_ckpt, and 2 frames
   of 400x400 at 64 + 64 samples and 2 of 800x800 at 64 + 128 (eval.py's
   defaults; the first of each a warm-up) are rendered from sphere poses
   (radius 4, near 2, far 6) through make_render_fn, the renderer of the
   eval CLI, and the s/frame of both printed. Every output must be finite,
   opacity within [0, 1 + 1e-4], both kernels must have launched, and
   4096 rays of the first frame of each size must agree with the plain
   unfused path on the card within 2e-2.
4. Train path. Holds the training kernel (mse_render) against its plain
   version at TRAIN_SHAPES (R = 8, 1024, 4104 at S = 64, 128, 192 and at
   culled32's S = 32 and 96; R, S = 5, 400 and 3, 1024): out8 and
   weights at the same bars, each gradient leaf within a relative max
   error of GRAD_TOL = 0.03 (the bar of tests/test_fused_train.py::
   TestGradientParity: a flipped bf16 rounding or ReLU mask moves every
   product downstream of it), and two launches bit-identical. Times both
   at R = 1024, S = 32, 64, 96 and 128 (the coarse and fine passes of the
   dense and culled32 configs). Then a
   teacher (fixed random weights) renders 4 frames of 400x400 through the
   fused eval path, and a Trainer at the dense bench config (64 + 64,
   batch 1024, perturb 1, noise 1, white background, adam 5e-4, steplr
   decay [2, 4, 8] x 0.5) fits that 640,000-ray store: 50 warm-up steps,
   then three timed segments of 100 steps, each ending in a sync on a
   parameter. Requires finite metrics, a mean loss over the last 50 steps
   below the first 50, exactly 2 mse_render launches per step, and on one
   batch gradients of the fused step pointing the way the plain autograd
   step's do with the same draws (cosine >= 0.95 per leaf, the bar of
   test_grad_direction_vs_f32_reference, the cosine taken in float64)
   at the final parameters. Prints train rays/s.
   Occupancy: the grid build of --occ_train at occ_N 128 on the teacher's
   fine weights (auto ranges in the store's viewing volume), in sigma
   mode and in weight mode with the store as the visibility rays (boxes,
   occupied share, seconds), then tighten_store of the culled recipe with
   the weight-mode boxes on the card and on a CPU copy of the store: the
   masks, hit flags, tightened near/far and partition order must agree
   for every ray. Then culled32, bench's default recipe: a Trainer at 32 +
   64 samples (otherwise the dense config) on the store tightened as
   bench.py tightens it (the box [-1.5, 1.5]^3, margin 0.1, 32 segments,
   dilate 1, survivor-packed; hit, shrink and expand printed) trains the
   same 350 steps under the same checks, with the segment masks in the
   gradient comparison, which takes the parameters after the warm-up
   (by the end its loss is ~5e-6, and its coarse gradient is what bf16
   rounding leaves of terms that cancel). Prints rays/s and the effective
   rate.
5. Point-MLP path (`--fused_mlp` training). Holds the three point-MLP
   kernels against their plain versions at ragged P = 300, 4099 and
   131,075 with the weights of dense_params and of plain init: rgb within
   5e-3, raw sigma within 5e-3 x max(1, max |sigma|) (the x50 sigma head
   scales it), sigma_fwd's sigma bit for bit mlp_fwd's out8[:, 3] (the
   same trunk tile loop; the max difference is printed), each mlp_bwd
   gradient leaf within GRAD_TOL and two launches bit-identical. Times
   mlp_fwd and mlp_bwd at P = 65,536 and 131,072 (a dense step's coarse
   and fine pass) and sigma_fwd at 32768 x 64 points.
   Then a Trainer at the dense bench config with fused=True and no
   fused_train (autograd through fused_nerf_mlp) fits the same store as in
   4 for the same 350 steps: exactly 2 mlp_fwd and 2 mlp_bwd launches per
   step and no other kernel, the loss falling, and the gradient cosine >=
   0.95 per leaf against the plain autograd step. Prints train rays/s.
6. The validation config of --fused_mlp (make_render_fn with fused and
   test_time off, as NeRFSystem validates) renders one 400x400 frame at
   64 + 64 through mlp_fwd alone; rgb_coarse and rgb_fine finite and within
   2e-2 of the plain unfused path on 4096 of its rays. A test-time render
   with perturb 1 and sigma noise 1 (explicit draws) on those rays launches
   sigma_fwd (coarse) and mlp_fwd (fine) once each and agrees within 2e-2
   (depth 5e-2) with the unfused path on the same draws. Both are held at
   the 99.5th percentile over rays, with at most 4 of the 4096 rays past
   the bar and none past a loose cap (0.25, depth 1.0): a ray
   whose importance samples move past a sharp feature of the random dense
   field (or, with noise, past a coarse depth, which shifts the noise
   slots) can jump between two implementations that differ in one bf16
   rounding; the plain bf16 version on the CPU jumps on the same rays.
7. The train CLI with --fused_mlp alone, in a process of its own as a user
   runs it, on the 40x40 synthetic scene (12 views, 32 + 16 samples,
   batch 1024, lr 5e-4, 10 epochs, in a temporary directory): val/psnr past
   20 dB by epoch 10, `last.ckpt` written, and a second process resumes
   from it for one more epoch. Then the same recipe with --fused_train,
   dense and with the culled stack (--occ_train --occ_warmup_epochs 2
   --occ_refresh_epochs 2 --occ_segments 32 --occ_dilate 1 --occ_pack
   --occ_mode weight): the culled run's [occ] lines (a packed one among
   them) and val/psnr past 20 dB by epoch 10, beside the dense run's.
8. Two-kernel fused training render (`fused_train` without the loss-fused
   step: autograd through fused_train_render). Holds train_fwd and
   train_bwd against their plain versions at TRAIN_SHAPES (those of 4;
   at R, S = 5, 400 and 3, 1024 launch A's ring drops to two stages):
   out8 and weights at
   TOL, and every train_bwd gradient leaf within GRAD_TOL under four
   cotangent mixes (the rgb MSE on a white background, depth^2 + 0.3
   opacity and mean(weights^2) on black, and the sum of the three on
   white; mean(weights^2) at R, S = 1024, 32 is left out, TRAIN_LEFT_OUT),
   two launches of each bit-identical, train_fwd's out8 and
   weights bit for bit equal to mse_render's (the same forward and
   quadrature; the max difference is printed), and train_bwd on the MSE
   cotangent within 1e-3 relative of mse_render's gradients (the same
   launch A; printed whether bit for bit). Times both and their
   plain versions at R = 1024, S = 64 and 128. Then a Trainer at the dense
   bench config with RenderConfig(fused_train=True) fits the store of 4
   for the same 350 steps: exactly 2 train_fwd and 2 train_bwd launches
   per step and no other kernel, the loss falling, and the gradient cosine
   >= 0.95 per leaf against the plain autograd step. Prints train rays/s.
9. Prints one JSON line about the kernels (each with its launches on its
   path, its error, its ms and its plain version's at the main shape, its
   bound: the larger of the bytes it must move over 3.35 TB/s and its
   bf16 operations over 989 TFLOP/s (mlp_flops_per_point), and
   library_ms, null: no single
   PyTorch call computes a fused NeRF MLP with its quadrature or its
   gradients), mse_render's [bound] lines at culled32's (1024, 32) and
   (1024, 96), the nvidia-smi line, and last {"ok": true, "device": ...}.
Any failure raises, and the script exits non-zero without those lines.
"""
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nerf_pl_tpu_torch.datasets.rays import frame_rays, sphere_pose  # noqa: E402
from nerf_pl_tpu_torch.models import init_nerf_params  # noqa: E402
from nerf_pl_tpu_torch.ops import _build  # noqa: E402
from nerf_pl_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from nerf_pl_tpu_torch.ops import fused_render as fr  # noqa: E402
from nerf_pl_tpu_torch.ops import fused_train as ft  # noqa: E402
from nerf_pl_tpu_torch.parallel import Trainer, make_render_fn  # noqa: E402
from nerf_pl_tpu_torch.rendering import (ModelConfig, RenderConfig,  # noqa: E402
                                         TrainDraws, render_rays)
from nerf_pl_tpu_torch.rendering.occupancy import (  # noqa: E402
    build_occupancy_grid, pick_block, rays_aabb, resolve_ranges)
from nerf_pl_tpu_torch.training import (get_lr_schedule,  # noqa: E402
                                        get_optimizer, loss_dict)
from nerf_pl_tpu_torch.training.checkpoints import load_ckpt  # noqa: E402
from nerf_pl_tpu_torch.training.optimizers import tree_leaves  # noqa: E402

TOL = {"weights": 5e-3, "rgb": 1e-2, "opacity": 1e-2, "depth": 5e-2}
MAIN_PATH_TOL = 2e-2
RAYS_PAST_BAR = 4        # of the 4096 rays held at the 99.5th pct
RAY_CAP = {"rgb": 0.25, "depth": 1.0}   # no such ray may pass these
CHUNK = 32768            # eval.py's default --chunk: the kernels' main R
IMG = 400
N_SAMPLES, N_IMPORTANCE = 64, 64
BIG_IMG, BIG_IMPORTANCE = 800, 128     # eval.py's defaults
CAMERA_ANGLE_X = 0.8575560450553894   # blender scenes' field of view
KERNELS = {   # name: (TPU kernel it replaces, source of the port's)
    "sigma_render": ("nerf_pl_tpu/ops/fused_render.py:194",
                     "nerf_pl_tpu_torch/csrc/fused_render.cu"),
    "render_eval": ("nerf_pl_tpu/ops/fused_render.py:153",
                    "nerf_pl_tpu_torch/csrc/fused_render.cu"),
    "mse_render": ("nerf_pl_tpu/ops/fused_train.py:362",
                   "nerf_pl_tpu_torch/csrc/fused_train.cu"),
    "mlp_fwd": ("nerf_pl_tpu/ops/fused_mlp.py:351",
                "nerf_pl_tpu_torch/csrc/fused_mlp.cu"),
    "mlp_bwd": ("nerf_pl_tpu/ops/fused_mlp.py:382",
                "nerf_pl_tpu_torch/csrc/fused_mlp.cu"),
    "sigma_fwd": ("nerf_pl_tpu/ops/fused_mlp.py:465",
                  "nerf_pl_tpu_torch/csrc/fused_mlp.cu"),
    "train_fwd": ("nerf_pl_tpu/ops/fused_train.py:220",
                  "nerf_pl_tpu_torch/csrc/fused_train.cu"),
    "train_bwd": ("nerf_pl_tpu/ops/fused_train.py:250",
                  "nerf_pl_tpu_torch/csrc/fused_train.cu"),
}
COUNTERS = {   # kernel: (wrapper module, its launch count)
    "sigma_render": (fr, "sigma_render_launches"),
    "render_eval": (fr, "render_eval_launches"),
    "mse_render": (ft, "mse_render_launches"),
    "mlp_fwd": (fm, "mlp_fwd_launches"),
    "mlp_bwd": (fm, "mlp_bwd_launches"),
    "sigma_fwd": (fm, "sigma_fwd_launches"),
    "train_fwd": (ft, "train_fwd_launches"),
    "train_bwd": (ft, "train_bwd_launches"),
}
GRAD_TOL = 0.03
COS_BAR = 0.95
POINT_TOL = 5e-3         # point-MLP rgb; raw sigma x max(1, max |sigma|)
TRAIN_BATCH = 1024
TRAIN_SEED = 7
WARMUP_STEPS, SEGMENTS, SEGMENT_STEPS = 50, 3, 100
CLI_EPOCHS, CLI_PSNR_BAR = 10, 20.0
OCC_N = 128              # the train CLI's default --occ_N
TEACHER_SEEDS = (20, 21)   # dense_params seeds of the teacher's two MLPs
CULLED_SAMPLES = 32      # bench's culled32: 32 coarse + 64 fine samples
# bench.py's culled recipes tighten the store with one synthetic box
CULLED_TIGHTEN = dict(boxes=[[-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]], margin=0.1,
                      n_seg=32, dilate=1, pack=True)
MSE_VS_TRAIN_TOL = 1e-3  # train_bwd on the MSE cotangent vs mse_render
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor cores, same source


def reset_counts():
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}


def dense_params(seed, device):
    """Random weights with the sigma head x50, +2, so the field is opaque in
    places and the quadrature weights are not trivial."""
    p = init_nerf_params(torch.Generator().manual_seed(seed), device=device)
    p["sigma"]["w"] = p["sigma"]["w"] * 50
    p["sigma"]["b"] = p["sigma"]["b"] + 2.0
    return p


def rays_z(R, S, device, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((R, 1), 2, np.float32),
                           np.full((R, 1), 6, np.float32)], 1)
    z = np.sort(rng.uniform(2.0, 6.0, size=(R, S)), -1).astype(np.float32)
    return (torch.from_numpy(rays).to(device),
            torch.from_numpy(z).to(device))


def median_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b):
    return float((a - b).abs().max().item())


def rel_errs(got, ref):
    """Relative max error of each gradient leaf against its plain version
    (a zero plain leaf: 0 if the kernel's is zero too, else 1)."""
    return [((a - b).abs().max() / b.abs().max()).item()
            if b.abs().max() > 0 else float(a.abs().max() > 0)
            for a, b in zip(got, ref)]


def check_train_kernel(what, got, ref):
    """A training kernel's (out8, weights, gradients) against its plain
    version's: prints the errors and raises past TOL or GRAD_TOL. Returns
    (max abs errors of out8 and weights, max abs gradient error, relative
    gradient errors)."""
    (out8, w, grads), (ref8, ref_w, ref_g) = got, ref
    errs = {"rgb": max_err(out8[:, 0:3], ref8[:, 0:3]),
            "depth": max_err(out8[:, 3], ref8[:, 3]),
            "opacity": max_err(out8[:, 4], ref8[:, 4]),
            "weights": max_err(w, ref_w)}
    rels = rel_errs(grads, ref_g)
    e_g = max(max_err(a, b) for a, b in zip(grads, ref_g))
    print(f"[compare] {what}: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; grad abs {e_g:.3e}, rel max {max(rels):.3e} (tol "
          f"{GRAD_TOL}); bit-identical twice")
    if out8[:, 5:].any():
        raise AssertionError(f"{what}: out8 columns 5..7 not zero")
    for k, v in errs.items():
        if not v <= TOL[k]:
            raise AssertionError(f"{what} {k}: max abs error {v}")
    for i, v in enumerate(rels):
        if not v <= GRAD_TOL:
            raise AssertionError(f"{what} grad {i}: relative error {v}")
    return errs, e_g, rels


def compare_kernels(mlp, dev):
    """Kernel vs plain at R = 4099; returns {kernel: max abs error}."""
    errs = {"sigma_render": 0.0, "render_eval": 0.0}
    for S in (64, 128, 192):
        rays, z = rays_z(4099, S, dev, seed=S)
        w_k, op_k = fr.fused_sigma_render(mlp, rays, z)
        w_p, op_p = fr.fused_sigma_render_reference(mlp, rays, z)
        out_k = fr.fused_render_eval(mlp, rays, z, white_back=True)
        out_p = fr.fused_render_eval_reference(mlp, rays, z, True)
        torch.cuda.synchronize()
        got = {"sigma_render": {"weights": max_err(w_k, w_p),
                                "opacity": max_err(op_k, op_p)},
               "render_eval": {k: max_err(out_k[k], out_p[k])
                               for k in ("rgb", "depth", "opacity")}}
        for name, per in got.items():
            print(f"[compare] {name} R=4099 S={S}: "
                  + ", ".join(f"{k} {v:.3e} (tol {TOL[k]})"
                              for k, v in per.items()))
            for k, v in per.items():
                if not v <= TOL[k]:
                    raise AssertionError(f"{name} S={S} {k}: max abs error "
                                         f"{v} > {TOL[k]}")
            errs[name] = max(errs[name], *per.values())
    return errs


def compare_eval_to_train_fwd(mlp, dev):
    """render_eval and sigma_render against train_fwd with zero noise at
    compare_kernels' shapes, white background on and off: render_eval's
    rgb, depth and opacity must equal out8[:, 0:5], and sigma_render's
    weights and opacity train_fwd's weights and out8[:, 4], bit for bit."""
    for S in (64, 128, 192):
        rays, z = rays_z(4099, S, dev, seed=S)
        zero = torch.zeros_like(z)
        w, op = fr.fused_sigma_render(mlp, rays, z)
        for white in (True, False):
            out = fr.fused_render_eval(mlp, rays, z, white_back=white)
            f8, fw = ft.train_forward(mlp, rays, z, zero, white)
            torch.cuda.synchronize()
            pairs = {"render_eval": (torch.cat(
                [out["rgb"], out["depth"][:, None], out["opacity"][:, None]],
                1), f8[:, 0:5]),
                "sigma_render": (torch.cat([w, op[:, None]], 1),
                                 torch.cat([fw, f8[:, 4:5]], 1))}
            for name, (got, want) in pairs.items():
                diff = max_err(got, want)
                same = torch.equal(got, want)
                print(f"[compare] {name} vs train_fwd (zero noise) R=4099 "
                      f"S={S} white={white}: max difference {diff:.3e}, "
                      f"bit-identical: {same}")
                if not same:
                    raise AssertionError(f"{name} S={S} white={white}: "
                                         f"differs from train_fwd by {diff}")


def time_kernels(mlp, dev):
    """Median ms of kernel and plain version at R = CHUNK rays."""
    times = {}
    for S in (64, 128, 192):
        rays, z = rays_z(CHUNK, S, dev, seed=1000 + S)
        pairs = {
            "sigma_render": (lambda: fr.fused_sigma_render(mlp, rays, z),
                             lambda: fr.fused_sigma_render_reference(
                                 mlp, rays, z)),
            "render_eval": (lambda: fr.fused_render_eval(mlp, rays, z, True),
                            lambda: fr.fused_render_eval_reference(
                                mlp, rays, z, True)),
        }
        for name, (kern, plain) in pairs.items():
            t_k, t_p = median_ms(kern), median_ms(plain, reps=5, warmup=1)
            times[(name, S)] = (t_k, t_p)
            print(f"[time] {name} R={CHUNK} S={S}: kernel {t_k:.3f} ms, "
                  f"plain {t_p:.3f} ms ({t_p / t_k:.2f}x)")
        del rays, z
        torch.cuda.empty_cache()
    return times


def write_jax_keyed_ckpt(path, params):
    """np.savez with the JAX package's flattened train-state keys."""
    flat = {f"params/{m}/{layer}/{leaf}": v.detach().cpu().numpy()
            for m, mlp in params.items()
            for layer, leaves in mlp.items() for leaf, v in leaves.items()}
    with open(path, "wb") as f:
        np.savez(f, **flat)


def main_path(dev):
    params = {"nerf_coarse": dense_params(10, dev),
              "nerf_fine": dense_params(11, dev)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.ckpt")
        write_jax_keyed_ckpt(path, params)
        g = torch.Generator().manual_seed(0)
        loaded = {"nerf_coarse": init_nerf_params(g, device=dev),
                  "nerf_fine": init_nerf_params(g, device=dev)}
        for m in ("nerf_coarse", "nerf_fine"):
            loaded = load_ckpt(loaded, path, m)
    for m, mlp in params.items():
        for layer, leaves in mlp.items():
            for leaf, v in leaves.items():
                if not torch.equal(loaded[m][layer][leaf], v):
                    raise AssertionError(f"checkpoint round trip: {m}/{layer}")

    reset_counts()
    secs = {}
    for img, n_imp in ((IMG, N_IMPORTANCE), (BIG_IMG, BIG_IMPORTANCE)):
        secs[img] = eval_frames(dev, loaded, img, n_imp)
    launches = {"sigma_render": fr.sigma_render_launches,
                "render_eval": fr.render_eval_launches}
    print(f"[main] launches {launches}; {IMG}x{IMG} at {N_SAMPLES}+"
          f"{N_IMPORTANCE}: {secs[IMG][1]:.4f} s/frame; {BIG_IMG}x{BIG_IMG} "
          f"at {N_SAMPLES}+{BIG_IMPORTANCE}: {secs[BIG_IMG][1]:.4f} s/frame")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")
    return launches, secs


def eval_frames(dev, params, img, n_imp):
    """Two frames of img x img at N_SAMPLES + n_imp through the eval CLI's
    renderer, the first a warm-up; checks both and 4096 rays of the first
    against the plain unfused path. Returns the seconds of each."""
    focal = 0.5 * 800 / np.tan(0.5 * CAMERA_ANGLE_X) * img / 800
    frames = [frame_rays(sphere_pose(theta, np.pi / 5, 4.0), img, img, focal,
                         2.0, 6.0, dev) for theta in (0.3, 1.9)]
    base = dict(N_samples=N_SAMPLES, N_importance=n_imp, test_time=True,
                white_back=True)
    render = make_render_fn(RenderConfig(**base, fused=True), CHUNK, dev,
                            device_out=True)
    outs, secs = [], []
    for rays in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(render(params, rays))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    what = f"{img}x{img}, {N_SAMPLES}+{n_imp} samples, chunk {CHUNK}"
    print(f"[main] 2 frames {what}: frame 1 {secs[0]:.4f} s (first "
          f"dispatch), frame 2 {secs[1]:.4f} s/frame")
    for i, out in enumerate(outs):
        for k, v in out.items():
            if v.shape[0] != img * img or not torch.isfinite(v).all():
                raise AssertionError(f"{img}x{img} frame {i}: {k} not finite"
                                     f" or misshapen {tuple(v.shape)}")
        for k in ("opacity_coarse", "opacity_fine"):
            lo, hi = out[k].min().item(), out[k].max().item()
            if lo < 0.0 or hi > 1.0 + 1e-4:
                raise AssertionError(f"{img}x{img} frame {i}: {k} in "
                                     f"[{lo}, {hi}]")
    rgb = outs[0]["rgb_fine"]
    print(f"[main] {img}x{img} frame 1 rgb mean {rgb.mean().item():.4f} std "
          f"{rgb.std().item():.4f}, opacity_fine mean "
          f"{outs[0]['opacity_fine'].mean().item():.4f}")

    idx = torch.linspace(0, img * img - 1, 4096, device=dev).long()
    plain = make_render_fn(RenderConfig(**base), 4096, dev,
                           device_out=True)(params, frames[0][idx])
    errs = {k: max_err(outs[0][k][idx], v) for k, v in plain.items()}
    print(f"[main] {what}: fused vs plain unfused path, 4096 rays of frame "
          f"1: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {MAIN_PATH_TOL})")
    for k, v in errs.items():
        if not v <= MAIN_PATH_TOL:
            raise AssertionError(f"main path {img}x{img} {k}: {v} > "
                                 f"{MAIN_PATH_TOL}")
    return secs


def mse_inputs(R, S, dev, seed):
    rays, z = rays_z(R, S, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((R, S), generator=g, device=dev)
    gt = torch.rand((R, 3), generator=g, device=dev)
    return rays, z, noise, gt


def compare_mse(mlp, dev):
    """mse_render vs plain; returns (max abs error of out8 and weights,
    max relative gradient error)."""
    worst_abs, worst_rel = 0.0, 0.0
    for R, S in TRAIN_SHAPES:
        white = S != 128
        args = (*mse_inputs(R, S, dev, seed=R + S), white, 1.0 / (R * 3))
        k1 = ft.fused_mse_render(mlp, *args)
        k2 = ft.fused_mse_render(mlp, *args)
        ref8, ref_w, ref_g = ft.fused_mse_render_reference(mlp, *args)
        torch.cuda.synchronize()
        same = (torch.equal(k1[0], k2[0]) and torch.equal(k1[1], k2[1])
                and all(torch.equal(a, b) for a, b in zip(k1[2], k2[2])))
        if not same:
            raise AssertionError(f"mse_render R={R} S={S}: two launches "
                                 f"differ")
        errs, _, rels = check_train_kernel(
            f"mse_render R={R} S={S} white={white}", k1,
            (ref8, ref_w, ref_g))
        worst_abs = max(worst_abs, *errs.values())
        worst_rel = max(worst_rel, *rels)
        del k1, k2, ref8, ref_w, ref_g
        torch.cuda.empty_cache()
    return worst_abs, worst_rel


def time_mse(mlp, dev):
    """Median ms of mse_render and its plain version at the batch's R, at
    the dense passes' S (64, 128) and culled32's (32, 96)."""
    times = {}
    for S in (CULLED_SAMPLES, 64, CULLED_SAMPLES + N_IMPORTANCE, 128):
        args = (*mse_inputs(TRAIN_BATCH, S, dev, seed=2000 + S), True,
                1.0 / (TRAIN_BATCH * 3))
        t_k = median_ms(lambda: ft.fused_mse_render(mlp, *args))
        t_p = median_ms(lambda: ft.fused_mse_render_reference(mlp, *args),
                        reps=5, warmup=1)
        times[S] = (t_k, t_p)
        print(f"[time] mse_render R={TRAIN_BATCH} S={S}: kernel {t_k:.3f} "
              f"ms, plain {t_p:.3f} ms ({t_p / t_k:.2f}x)")
    return times


def teacher_store(dev):
    """A teacher (fixed random weights) renders 4 frames of 400x400 through
    the fused eval path: the ray store every training path fits."""
    teacher = {"nerf_coarse": dense_params(TEACHER_SEEDS[0], dev),
               "nerf_fine": dense_params(TEACHER_SEEDS[1], dev)}
    focal = 0.5 * 800 / np.tan(0.5 * CAMERA_ANGLE_X) * IMG / 800
    render = make_render_fn(RenderConfig(
        N_samples=N_SAMPLES, N_importance=N_IMPORTANCE, test_time=True,
        white_back=True, fused=True), CHUNK, dev, device_out=True)
    frames = [frame_rays(sphere_pose(theta, np.pi / 5, 4.0), IMG, IMG, focal,
                         2.0, 6.0, dev) for theta in (0.3, 1.9, 3.5, 5.1)]
    rgbs = torch.cat([render(teacher, f)["rgb_fine"] for f in frames])
    return torch.cat(frames), rgbs


def train_path(dev, store, name, rcfg, per_step, tighten=None,
               compare_after_warmup=False):
    """A Trainer at a bench config on `rcfg`'s kernel path fits the
    teacher's store, tightened first by tighten_store(**tighten) when it is
    given. per_step: the launches of each kernel per step; no other kernel
    may launch. The one-batch gradient comparison takes the parameters at
    the end, or after the warm-up steps with compare_after_warmup (where a
    fit that drives the loss to ~1e-6 still has a gradient that is more
    than the rounding left of terms that cancel). Returns (launch counts,
    rays/s per timed segment)."""
    rays, rgbs = store
    sched = get_lr_schedule("steplr", 5e-4, 16, 1000, decay_step=[2, 4, 8],
                            decay_gamma=0.5)
    tr = Trainer(ModelConfig(), rcfg, get_optimizer("adam", sched), sched,
                 loss_dict["mse"], TRAIN_BATCH, dev)
    tr.set_data(rays.cpu().numpy(), rgbs.cpu().numpy())
    if tighten:
        t0 = time.perf_counter()
        st = tr.tighten_store(**tighten)
        print(f"[train] {name}: tighten_store {tighten} in "
              f"{time.perf_counter() - t0:.3f} s: hit {st['hit_frac']:.4f}, "
              f"shrink {st['shrink']:.4f}, expand x{st['expand']:.4f}, "
              f"{tr.all_nsurv} of {tr.n_rays_local} rays survive")
    state = tr.init_state(torch.Generator().manual_seed(0))
    probe = state.params["nerf_coarse"]["xyz_0"]["w"]
    torch.cuda.synchronize()

    reset_counts()
    state, m = tr.run_steps(state, TRAIN_SEED, WARMUP_STEPS)
    warm = state   # the steps build new parameter tensors, never in place
    losses, rates = [m["loss"]], []
    for _ in range(SEGMENTS):
        float(state.params["nerf_coarse"]["xyz_0"]["w"][0, 0])
        t0 = time.perf_counter()
        state, m = tr.run_steps(state, TRAIN_SEED, SEGMENT_STEPS)
        float(state.params["nerf_coarse"]["xyz_0"]["w"][0, 0])  # sync
        rates.append(SEGMENT_STEPS * TRAIN_BATCH
                     / (time.perf_counter() - t0))
        losses.append(m["loss"])
        for k in ("loss", "psnr", "lr"):
            if not torch.isfinite(m[k]).all():
                raise AssertionError(f"train metric {k} not finite")
    launches = read_counts()
    n_steps = WARMUP_STEPS + SEGMENTS * SEGMENT_STEPS
    losses = torch.cat(losses).cpu()
    first, last = losses[:50].mean().item(), losses[-50:].mean().item()
    print(f"[train] {name}: {n_steps} steps at batch {TRAIN_BATCH}, "
          f"{rcfg.N_samples}+{rcfg.N_importance} samples, store of "
          f"{rays.shape[0]} rays: launches {launches}; mean loss first 50 "
          f"{first:.5f}, last 50 {last:.5f}; final psnr "
          f"{m['psnr'][-1].item():.2f}")
    eff = (f"; x{tr.pack_expand:.4f} packed = "
           f"{[round(r * tr.pack_expand, 1) for r in rates]} effective"
           if tr.all_nsurv is not None else "")
    print(f"[train] {name}: rays/s per segment "
          f"{[round(r, 1) for r in rates]}; best {max(rates):.1f}{eff}")
    for k, n in launches.items():
        if n != per_step.get(k, 0) * n_steps:
            raise AssertionError(f"{name}: {k} launched {n} times in "
                                 f"{n_steps} steps, not "
                                 f"{per_step.get(k, 0)} per step")
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    if torch.equal(probe, state.params["nerf_coarse"]["xyz_0"]["w"]):
        raise AssertionError("parameters did not change")

    # one batch, same draws (and segment masks): the kernel path's step
    # vs plain autograd
    if compare_after_warmup:
        state = warm
    rays_b, rgbs_b, *occm = tr._sample_batch(state.step)
    occm = occm[0] if occm else None
    g = torch.Generator(device=dev).manual_seed(11)
    R, S, S_imp = TRAIN_BATCH, rcfg.N_samples, rcfg.N_importance
    draws = TrainDraws(
        perturb=torch.rand((R, S), generator=g, device=dev),
        noise_coarse=torch.randn((R, S), generator=g, device=dev),
        u=torch.rand((R, S_imp), generator=g, device=dev),
        noise_fine=torch.randn((R, S + S_imp), generator=g, device=dev))
    plain_tr = Trainer(ModelConfig(), dataclasses.replace(
        rcfg, fused=False, fused_train=False, fused_loss=False),
        tr.optimizer, sched, loss_dict["mse"], TRAIN_BATCH, dev)
    plain_tr.occ_n_seg = tr.occ_n_seg
    loss_f, _, g_f = tr._loss_and_grads(state.params, rays_b, rgbs_b, None,
                                        draws, occm=occm)
    loss_p, _, g_p = plain_tr._loss_and_grads(state.params, rays_b, rgbs_b,
                                              None, draws, occm=occm)
    cos = [cosine(a, b) for a, b in zip(tree_leaves(g_f),
                                        tree_leaves(g_p, g_f))]
    print(f"[train] {name}: one batch at step {state.step} vs plain autograd"
          f" step: loss {loss_f.item():.6e} vs {loss_p.item():.6e}; "
          f"gradient cosine per leaf min {min(cos):.5f} (bar {COS_BAR})")
    if not min(cos) >= COS_BAR:
        raise AssertionError(f"gradient direction: cosine {min(cos)}")
    return launches, rates


def cosine(a, b):
    """Cosine of two gradient leaves in float64, unclamped (a leaf's norm
    can be far below cosine_similarity's eps of 1e-8 near a minimum)."""
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    na, nb = a.norm().item(), b.norm().item()
    if na == 0.0 or nb == 0.0:
        return 1.0 if na == nb else 0.0
    return (a @ b).item() / (na * nb)


def occ_path(dev, store):
    """The grid build of --occ_train at OCC_N on the teacher's fine weights
    (auto ranges in the store's viewing volume, as NeRFSystem._occ_tighten
    derives them), in sigma mode and in weight mode with the store as the
    visibility rays; then tighten_store of the culled recipe (margin 0.1,
    32 segments, dilate 1, packed) with the weight-mode boxes on the card
    and on a CPU copy of the store: the masks, hit flags and tightened
    near/far must agree bit for bit."""
    rays, rgbs = store
    rays_np, rgbs_np = rays.cpu().numpy(), rgbs.cpu().numpy()
    fine = dense_params(TEACHER_SEEDS[1], dev)
    aabb = rays_aabb(rays_np)
    t0 = time.perf_counter()
    ranges = resolve_ranges(None, fine, ModelConfig(), aabb)
    print(f"[occ] auto ranges {[r.tolist() for r in ranges]} within the "
          f"store's viewing volume, {time.perf_counter() - t0:.3f} s")
    grids = {}
    for mode in ("sigma", "weight"):
        t0 = time.perf_counter()
        grid = build_occupancy_grid(
            fine, ModelConfig(), N=OCC_N, block=pick_block(OCC_N),
            ranges=ranges, max_ranges=aabb, mode=mode,
            vis_rays=rays if mode == "weight" else None)
        secs = time.perf_counter() - t0
        print(f"[occ] {mode} grid at N={OCC_N} ({OCC_N ** 3} points, block "
              f"{pick_block(OCC_N)}): {grid.n_boxes} boxes, "
              f"{100 * grid.occupied_fraction:.2f}% of blocks occupied, "
              f"{secs:.3f} s")
        if not 0 < grid.n_boxes <= 512:
            raise AssertionError(f"{mode} grid: {grid.n_boxes} boxes")
        grids[mode] = grid
    tighten = dict(CULLED_TIGHTEN, boxes=grids["weight"].boxes)
    rcfg = RenderConfig(N_samples=CULLED_SAMPLES, N_importance=N_IMPORTANCE,
                        white_back=True)
    trainers = []
    for where in (dev, torch.device("cpu")):
        tr = Trainer(ModelConfig(), rcfg, None, None, None, TRAIN_BATCH,
                     where)
        tr.set_data(rays_np, rgbs_np)
        t0 = time.perf_counter()
        st = tr.tighten_store(**tighten)
        print(f"[occ] tighten_store on {where}, {tr.n_rays_local} rays x "
              f"{grids['weight'].n_boxes} boxes: "
              f"{time.perf_counter() - t0:.3f} s; hit {st['hit_frac']:.4f}, "
              f"shrink {st['shrink']:.4f}, expand x{st['expand']:.4f}")
        trainers.append(tr)
    gpu, cpu = trainers
    differ = ((gpu.all_occm.cpu() != cpu.all_occm)
              | (gpu.all_hit.cpu() != cpu.all_hit)
              | (gpu.all_rays[:, 6:8].cpu() != cpu.all_rays[:, 6:8]).any(1)
              | (gpu.all_idx.cpu() != cpu.all_idx))
    n_diff = int(differ.sum())
    print(f"[occ] card vs CPU: {n_diff} of {differ.numel()} rays differ in "
          f"mask, hit flag, near/far or partition order")
    if n_diff:
        raise AssertionError(f"tighten_store: {n_diff} rays differ between "
                             f"the card and the CPU")


def ray_errors(out, plain, keys):
    """{key: (99.5th percentile, max, rays past the bar, bar, cap)} of the
    per-ray max abs error of out against plain. Rays whose importance
    samples move past a sharp feature of the fine field can jump between
    two implementations that differ in a bf16 rounding (the plain bf16
    version on the CPU shows the same rays), so a path is held at the
    99.5th percentile over rays, at most RAYS_PAST_BAR rays past the bar,
    and every ray within a loose cap that a wrong tile would break. Depth
    (scene units, up to 6) takes the kernels' depth bar."""
    errs = {}
    for k in keys:
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"{k} not finite")
        kind = "depth" if k.startswith("depth") else "rgb"
        bar = TOL["depth"] if kind == "depth" else MAIN_PATH_TOL
        e = (out[k] - plain[k]).abs().reshape(out[k].shape[0], -1)
        e = e.max(dim=-1).values
        errs[k] = (torch.quantile(e, 0.995).item(), e.max().item(),
                   int((e > bar).sum()), bar, RAY_CAP[kind])
    return errs


def check_ray_errors(what, errs):
    print(f"[{what}] vs plain unfused path (99.5th pct, max, rays past "
          f"the bar, bar, cap; at most {RAYS_PAST_BAR} rays past): "
          + ", ".join(f"{k} {q:.3e} {m:.3e} {n} {b} {c}"
                      for k, (q, m, n, b, c) in errs.items()))
    for k, (q, m, n, bar, cap) in errs.items():
        if not (q <= bar and n <= RAYS_PAST_BAR and m <= cap):
            raise AssertionError(f"{what} {k}: 99.5th pct {q} (bar {bar}), "
                                 f"{n} rays past the bar, max {m} (cap "
                                 f"{cap})")


def point_inputs(P, dev, seed):
    """(P, 8) raw points and unit directions, and a cotangent on
    [rgb, sigma] of size ~1 / P (a mean over points)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x8 = torch.zeros((P, 8), device=dev)
    x8[:, :3] = 2 * torch.randn((P, 3), generator=g, device=dev)
    d8 = torch.zeros((P, 8), device=dev)
    d8[:, :3] = torch.nn.functional.normalize(
        torch.randn((P, 3), generator=g, device=dev), dim=-1)
    cot = torch.zeros((P, 8), device=dev)
    cot[:, :4] = torch.randn((P, 4), generator=g, device=dev) / P
    return x8, d8, cot


def compare_point_mlp(dev):
    """The point-MLP kernels vs their plain versions; returns {kernel: max
    abs error} (for mlp_bwd over the gradient leaves) and prints the
    gradients' worst relative error."""
    errs = {"mlp_fwd": 0.0, "sigma_fwd": 0.0, "mlp_bwd": 0.0}
    worst_rel = 0.0
    for weights in ("dense", "init"):
        params = (dense_params(0, dev) if weights == "dense" else
                  init_nerf_params(torch.Generator().manual_seed(5),
                                   device=dev))
        mlp = fm.pack_mlp(params, dev)
        for P in (300, 4099, 131075):
            x8, d8, cot = point_inputs(P, dev, seed=P)
            out = fm.mlp_forward(mlp, x8, d8)
            sigma = fm.sigma_forward(mlp, x8)
            g1 = fm.mlp_backward(mlp, x8, d8, cot)
            g2 = fm.mlp_backward(mlp, x8, d8, cot)
            ref = fm.mlp_forward_reference(mlp.packed, x8, d8)
            ref_sigma = fm.sigma_forward_reference(mlp.packed, x8)
            ref_g = fm.mlp_backward_reference(mlp.packed, x8, d8, cot)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(g1, g2)):
                raise AssertionError(f"mlp_bwd P={P}: two launches differ")
            if not (torch.isfinite(out).all() and not out[:, 4:].any()):
                raise AssertionError(f"mlp_fwd P={P}: bad output")
            sig_tol = POINT_TOL * max(1.0, ref[:, 3].abs().max().item())
            e_rgb = max_err(out[:, :3], ref[:, :3])
            e_sig = max_err(out[:, 3], ref[:, 3])
            e_sfwd = max_err(sigma, ref_sigma)
            e_g = max(max_err(a, b) for a, b in zip(g1, ref_g))
            rels = rel_errs(g1, ref_g)
            same = torch.equal(sigma, out[:, 3])
            print(f"[compare] point MLP {weights} P={P}: mlp_fwd rgb "
                  f"{e_rgb:.3e} (tol {POINT_TOL}), sigma {e_sig:.3e}; "
                  f"sigma_fwd {e_sfwd:.3e} (tol {sig_tol:.3e}), against "
                  f"mlp_fwd's sigma max difference "
                  f"{max_err(sigma, out[:, 3]):.3e}, bit-identical: {same}; "
                  f"mlp_bwd grad abs {e_g:.3e}, rel max {max(rels):.3e} "
                  f"(tol {GRAD_TOL}); bit-identical twice")
            if not same:
                raise AssertionError(f"sigma_fwd {weights} P={P}: differs "
                                     f"from mlp_fwd's sigma")
            if not (e_rgb <= POINT_TOL and e_sig <= sig_tol
                    and e_sfwd <= sig_tol):
                raise AssertionError(f"point MLP {weights} P={P}: forward "
                                     f"error {e_rgb}, {e_sig}, {e_sfwd}")
            for i, v in enumerate(rels):
                if not v <= GRAD_TOL:
                    raise AssertionError(f"mlp_bwd {weights} P={P} grad {i}:"
                                         f" relative error {v}")
            errs["mlp_fwd"] = max(errs["mlp_fwd"], e_rgb, e_sig)
            errs["sigma_fwd"] = max(errs["sigma_fwd"], e_sfwd)
            errs["mlp_bwd"] = max(errs["mlp_bwd"], e_g)
            worst_rel = max(worst_rel, *rels)
            del out, sigma, g1, g2, ref, ref_sigma, ref_g
            torch.cuda.empty_cache()
    print(f"[compare] mlp_bwd worst gradient relative error {worst_rel:.3e}")
    return errs


def time_point_mlp(mlp, dev):
    """Median ms of the point-MLP kernels and their plain versions at the
    main path's point counts."""
    times = {}
    for P in (65536, 131072):
        x8, d8, cot = point_inputs(P, dev, seed=3000 + P)
        pairs = {
            "mlp_fwd": (lambda: fm.mlp_forward(mlp, x8, d8),
                        lambda: fm.mlp_forward_reference(mlp.packed, x8,
                                                         d8)),
            "mlp_bwd": (lambda: fm.mlp_backward(mlp, x8, d8, cot),
                        lambda: fm.mlp_backward_reference(mlp.packed, x8,
                                                          d8, cot)),
        }
        for name, (kern, plain) in pairs.items():
            t_k, t_p = median_ms(kern), median_ms(plain, reps=5, warmup=1)
            times[(name, P)] = (t_k, t_p)
            print(f"[time] {name} P={P}: kernel {t_k:.3f} ms, plain "
                  f"{t_p:.3f} ms ({t_p / t_k:.2f}x)")
    P = CHUNK * N_SAMPLES
    x8, _, _ = point_inputs(P, dev, seed=4000)
    t_k = median_ms(lambda: fm.sigma_forward(mlp, x8))
    t_p = median_ms(lambda: fm.sigma_forward_reference(mlp.packed, x8),
                    reps=3, warmup=1)
    times[("sigma_fwd", P)] = (t_k, t_p)
    print(f"[time] sigma_fwd P={P}: kernel {t_k:.3f} ms, plain {t_p:.3f} ms "
          f"({t_p / t_k:.2f}x)")
    return times


# (cotangent mix, white background): the last puts every term of a_k, the
# white background's among them, into one backward
TRAIN_MIXES = (("rgb", True), ("depth_opacity", False), ("weights", False),
               ("all", True))
# (R, S) of the training kernels' checks: small, main and large batches at
# the coarse and fine sample counts, rays longer than ~390 samples (launch
# A's ring takes two stages; train_fwd's at S = 1024 too), and culled32's
# passes: 32 coarse samples (4 rays a 128-point tile) and 32 + 64 (one ray
# a tile, a quarter of it padding)
TRAIN_SHAPES = ([(R, S) for R in (8, 1024, 4104) for S in (64, 128, 192)]
                + [(5, 400), (3, 1024)]
                + [(R, S) for S in (32, 96) for R in (8, 1024, 4104)])
# (R, S, mix) left out of compare_train: at (1024, 32) the weights
# cotangent's leaf 1 came out 0.0338 from the plain version on the card,
# past GRAD_TOL (ROADMAP Queue C, open). tests/test_torch_cuda.py holds the
# shape at GRAD_TOL on its own inputs; mse_render is held here at it.
TRAIN_LEFT_OUT = {(1024, 32, "weights")}


def train_cotangent(mix, out8, w, gt):
    """(g8, gw) of a mean loss over the batch: the rgb MSE, depth^2 + 0.3
    opacity, mean(weights^2), or "all", their sum (gw None where the loss
    has no weights term, as autograd gives it)."""
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


def compare_train(mlp, dev):
    """train_fwd and train_bwd vs their plain versions, relaunches, and
    train_bwd vs mse_render; returns {kernel: max abs error} (train_bwd's
    over the gradient leaves)."""
    errs = {"train_fwd": 0.0, "train_bwd": 0.0}
    worst_rel = worst_fwd = 0.0
    for R, S in TRAIN_SHAPES:
        rays, z, noise, gt = mse_inputs(R, S, dev, seed=7 * R + S)
        for mix, white in TRAIN_MIXES:
            if (R, S, mix) in TRAIN_LEFT_OUT:
                print(f"[compare] train_fwd + train_bwd R={R} S={S} {mix}: "
                      f"left out (ROADMAP Queue C)")
                continue
            f1 = ft.train_forward(mlp, rays, z, noise, white)
            f2 = ft.train_forward(mlp, rays, z, noise, white)
            ref8, ref_w = ft.fused_train_render_reference(
                mlp, rays, z, noise, white)
            g8, gw = train_cotangent(mix, ref8, ref_w, gt)
            b1 = ft.train_backward(mlp, rays, z, noise, white, g8, gw)
            b2 = ft.train_backward(mlp, rays, z, noise, white, g8, gw)
            ref_g = ft.fused_train_render_backward_reference(
                mlp, rays, z, noise, white, g8, gw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(f1 + b1,
                                                         f2 + b2)):
                raise AssertionError(f"train kernels R={R} S={S} {mix}:"
                                     f" two launches differ")
            fe, e_g, rels = check_train_kernel(
                f"train_fwd + train_bwd R={R} S={S} {mix} white={white}",
                (*f1, b1), (ref8, ref_w, ref_g))
            errs["train_fwd"] = max(errs["train_fwd"], *fe.values())
            errs["train_bwd"] = max(errs["train_bwd"], e_g)
            worst_rel = max(worst_rel, *rels)
        scale = 1.0 / (R * 3)
        m8, m_w, m_g = ft.fused_mse_render(mlp, rays, z, noise, gt, True,
                                           scale)
        f8, f_w = ft.train_forward(mlp, rays, z, noise, True)
        g8 = torch.zeros_like(m8)
        g8[:, 0:3] = 2.0 * scale * (m8[:, 0:3] - gt)
        t_g = ft.train_backward(mlp, rays, z, noise, True, g8, None)
        torch.cuda.synchronize()
        rel = max(rel_errs(t_g, m_g))
        bitwise = all(torch.equal(a, b) for a, b in zip(t_g, m_g))
        # train_fwd runs mse_render's forward and quadrature: bit for
        # bit the same out8 and weights
        fwd_same = torch.equal(f8, m8) and torch.equal(f_w, m_w)
        fwd_diff = max(max_err(f8, m8), max_err(f_w, m_w))
        worst_fwd = max(worst_fwd, fwd_diff)
        print(f"[compare] train_bwd vs mse_render R={R} S={S}: grad rel "
              f"max {rel:.3e} (tol {MSE_VS_TRAIN_TOL}), bit-identical: "
              f"{bitwise}; train_fwd vs mse_render's out8 and weights: "
              f"max difference {fwd_diff:.3e}, bit-identical: {fwd_same}")
        if not rel <= MSE_VS_TRAIN_TOL:
            raise AssertionError(f"train_bwd vs mse_render R={R} S={S}:"
                                 f" {rel}")
        if not fwd_same:
            raise AssertionError(f"train_fwd R={R} S={S}: out8 or "
                                 f"weights differ from mse_render's by "
                                 f"{fwd_diff}")
        del rays, z, noise, gt, f1, f2, b1, b2, ref_g, m_g, t_g
        torch.cuda.empty_cache()
    print(f"[compare] train_bwd worst gradient relative error "
          f"{worst_rel:.3e}; train_fwd vs mse_render max difference "
          f"{worst_fwd:.3e} over {len(TRAIN_SHAPES)} shapes")
    return errs


def time_train(mlp, dev):
    """Median ms of train_fwd and train_bwd (the rgb MSE cotangent, no
    weights cotangent, as on the main path) and their plain versions at
    the batch's R."""
    times = {}
    for S in (64, 128):
        rays, z, noise, gt = mse_inputs(TRAIN_BATCH, S, dev, seed=5000 + S)
        g8, _ = train_cotangent("rgb", *ft.fused_train_render_reference(
            mlp, rays, z, noise, True), gt)
        pairs = {
            "train_fwd": (lambda: ft.train_forward(mlp, rays, z, noise, True),
                          lambda: ft.fused_train_render_reference(
                              mlp, rays, z, noise, True)),
            "train_bwd": (lambda: ft.train_backward(mlp, rays, z, noise, True,
                                                    g8, None),
                          lambda: ft.fused_train_render_backward_reference(
                              mlp, rays, z, noise, True, g8, None)),
        }
        for name, (kern, plain) in pairs.items():
            t_k, t_p = median_ms(kern), median_ms(plain, reps=5, warmup=1)
            times[(name, S)] = (t_k, t_p)
            print(f"[time] {name} R={TRAIN_BATCH} S={S}: kernel {t_k:.3f} "
                  f"ms, plain {t_p:.3f} ms ({t_p / t_k:.2f}x)")
    return times


def mlp_layers(full):
    """(fan_in, fan_out, input is an embedding) of each product of one
    point through the MLP, at the function's own widths: gamma(x) is 3 +
    6 FX = 63 wide and gamma(d) 3 + 6 FD = 27 (the kernels' zero padding
    of K is not work). The trunk with its skip (its x part a product of
    its own) and the sigma head, and with `full` the feature, view (its
    direction part apart) and rgb layers."""
    kx, kd = 3 + 6 * fm.FX, 3 + 6 * fm.FD
    layers = ([(kx, fm.W, True), (kx, fm.W, True)]
              + [(fm.W, fm.W, False)] * (fm.D - 1) + [(fm.W, 1, False)])
    if full:
        layers += [(fm.W, fm.W, False), (fm.W, fm.WD, False),
                   (kd, fm.WD, True), (fm.WD, 3, False)]
    return layers


def mlp_flops_per_point(full, backward=False):
    """2 x the multiply-adds of one point through the MLP. A backward
    recomputes the forward, forms every weight gradient, and forms the data
    gradient of every product's input except the embeddings (layer 0's,
    the skip's x part and the view layer's direction part need none)."""
    layers = mlp_layers(full)
    fwd = sum(k * n for k, n, _ in layers)
    if not backward:
        return 2 * fwd
    data = sum(k * n for k, n, embedding in layers if not embedding)
    return 2 * (fwd + data + fwd)


def bound(name, shape, mlp):
    """(least ms, what bounds it) of one call at `shape` ((R, S) rays and
    samples, or P points): the larger of the bytes it must move (each
    input read once, each output written once) over the HBM rate and its
    bf16 operations over the tensor cores' dense peak
    (mlp_flops_per_point). The element-wise work (bias adds, ReLUs, the
    embeddings' sin/cos, the quadrature: a few thousand f32 operations a
    point) runs beside the tensor cores, at under a tenth of this time at
    the 67 TFLOP/s f32 rate."""
    def wbytes(names):
        return sum(mlp.kernel[n].numel() * mlp.kernel[n].element_size()
                   for n in names)
    full, trunk = wbytes(fm._FULL), wbytes(fm._FULL[:6])
    grads = 4 * fm.GRAD_FLOATS
    f_full, f_sig = mlp_flops_per_point(True), mlp_flops_per_point(False)
    f_bwd = mlp_flops_per_point(True, backward=True)
    if isinstance(shape, tuple):            # (R, S): rays and samples
        R, S = shape
        P, rays, ps = R * S, 32 * R, 4 * R * S
        ops, nbytes = {   # inputs: rays, z (, noise, gt or g8); outputs
            "sigma_render": (P * f_sig, rays + ps + trunk + ps + 4 * R),
            "render_eval": (P * f_full, rays + ps + full + 20 * R),
            "mse_render": (P * f_bwd, rays + 2 * ps + 12 * R + full
                           + 32 * R + ps + grads),
            "train_fwd": (P * f_full, rays + 2 * ps + full + 32 * R + ps),
            "train_bwd": (P * f_bwd, rays + 2 * ps + 32 * R + full
                          + grads),
        }[name]
    else:                                   # P points of 8 floats
        P = shape
        ops, nbytes = {
            "mlp_fwd": (P * f_full, 64 * P + full + 32 * P),
            "mlp_bwd": (P * f_bwd, 96 * P + full + grads),
            "sigma_fwd": (P * f_sig, 32 * P + trunk + 4 * P),
        }[name]
    t_ops, t_bytes = ops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def validation_path(dev):
    """The --fused_mlp validation config through make_render_fn; returns
    the 4096 compared rays and the params for the perturbed path."""
    params = {"nerf_coarse": dense_params(30, dev),
              "nerf_fine": dense_params(31, dev)}
    focal = 0.5 * 800 / np.tan(0.5 * CAMERA_ANGLE_X) * IMG / 800
    frame = frame_rays(sphere_pose(0.7, np.pi / 5, 4.0), IMG, IMG, focal,
                       2.0, 6.0, dev)
    base = dict(N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
                white_back=True)
    render = make_render_fn(RenderConfig(**base, fused=True), CHUNK, dev,
                            device_out=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = render(params, frame)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    n_chunks = -(-IMG * IMG // CHUNK)
    print(f"[val] validation config (fused, test_time off), 1 frame "
          f"{IMG}x{IMG}, {N_SAMPLES}+{N_IMPORTANCE}: launches {launches}; "
          f"{secs:.4f} s")
    want = {k: 2 * n_chunks if k == "mlp_fwd" else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"validation launched {launches}, not {want}")
    for k, v in out.items():
        if v.shape[0] != IMG * IMG or not torch.isfinite(v).all():
            raise AssertionError(f"validation: {k} not finite or misshapen")
    idx = torch.linspace(0, IMG * IMG - 1, 4096, device=dev).long()
    plain = make_render_fn(RenderConfig(**base), 4096, dev,
                           device_out=True)(params, frame[idx])
    check_ray_errors("val", ray_errors({k: v[idx] for k, v in out.items()},
                                       plain, ("rgb_coarse", "rgb_fine")))
    return params, frame[idx].contiguous(), secs


def perturbed_path(dev, params, rays):
    """Test time with perturb and sigma noise: sigma_fwd on the coarse
    pass, mlp_fwd on the fine, against the unfused path on the same
    draws."""
    R = rays.shape[0]
    g = torch.Generator(device=dev).manual_seed(12)
    draws = TrainDraws(
        perturb=torch.rand((R, N_SAMPLES), generator=g, device=dev),
        noise_coarse=torch.randn((R, N_SAMPLES), generator=g, device=dev),
        u=torch.rand((R, N_IMPORTANCE), generator=g, device=dev),
        noise_fine=torch.randn((R, N_SAMPLES + N_IMPORTANCE), generator=g,
                               device=dev))
    cfg = RenderConfig(N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
                       test_time=True, white_back=True, fused=True,
                       perturb=1.0, noise_std=1.0)
    with torch.no_grad():
        reset_counts()
        out = render_rays(params, rays, cfg, draws=draws)
        torch.cuda.synchronize()
        launches = read_counts()
        plain = render_rays(params, rays, dataclasses.replace(cfg,
                                                              fused=False),
                            draws=draws)
    print(f"[test-time] perturb 1, noise 1, {R} rays: launches {launches}")
    want = {k: 1 if k in ("sigma_fwd", "mlp_fwd") else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"perturbed test time launched {launches}")
    # the sigma noise is added by sorted sample position: a ray whose
    # importance samples move past a coarse depth also moves its noise
    check_ray_errors("test-time", ray_errors(out, plain, plain.keys()))
    return launches


CLI_FLAGS = ["--dataset_name", "blender", "--root_dir", "scene",
             "--img_wh", "40", "40", "--N_samples", "32",
             "--N_importance", "16", "--batch_size", "1024", "--lr", "5e-4",
             "--decay_step", "20", "--decay_gamma", "0.5",
             "--scan_steps", "90", "--val_chunk", "1600"]
OCC_CLI_FLAGS = ["--occ_train", "--occ_warmup_epochs", "2",
                 "--occ_refresh_epochs", "2", "--occ_segments", "32",
                 "--occ_dilate", "1", "--occ_pack", "--occ_mode", "weight"]


def run_cli(args, what, cwd):
    """python args in a process of its own in cwd; returns (stdout,
    seconds) and raises on a non-zero exit."""
    env = {**os.environ,
           "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return proc.stdout, time.perf_counter() - t0


def val_psnr(out):
    return {int(e): float(p) for e, p in re.findall(
        r"^\[val\] epoch (\d+) loss=\S+ psnr=(\S+)", out, re.M)}


def train_cli_path():
    """The train CLI with --fused_mlp alone and its resume, each in a
    process of its own; returns val/psnr by epoch."""
    flags = CLI_FLAGS + ["--exp_name", "v1", "--fused_mlp"]

    with tempfile.TemporaryDirectory() as tmp:
        run_cli(["-m", "nerf_pl_tpu_torch.datasets.synthetic", "scene"],
                "scene", tmp)
        out, secs = run_cli(["-m", "nerf_pl_tpu_torch.train", *flags,
                             "--num_epochs", str(CLI_EPOCHS)], "train CLI",
                            tmp)
        psnr = val_psnr(out)
        print(f"[cli] train --fused_mlp, {CLI_EPOCHS} epochs, {secs:.1f} s: "
              f"val/psnr by epoch {psnr}")
        if not psnr.get(CLI_EPOCHS, 0.0) > CLI_PSNR_BAR:
            raise AssertionError(f"train CLI: val/psnr {psnr} not past "
                                 f"{CLI_PSNR_BAR} dB by epoch {CLI_EPOCHS}")
        ckpt = os.path.join(tmp, "ckpts", "v1", "last.ckpt")
        if not os.path.isfile(ckpt):
            raise AssertionError("train CLI wrote no last.ckpt")
        out, secs = run_cli(["-m", "nerf_pl_tpu_torch.train", *flags,
                             "--num_epochs", str(CLI_EPOCHS + 1),
                             "--ckpt_path", ckpt], "train CLI resume", tmp)
        resumed = re.search(r"^\[resume\] full train state .*$", out, re.M)
        last = re.search(rf"^\[val\] epoch {CLI_EPOCHS + 1} .*$", out, re.M)
        if not (resumed and last):
            raise AssertionError(f"train CLI resume:\n{out[-3000:]}")
        print(f"[cli] resume, {secs:.1f} s: {resumed.group(0)}; "
              f"{last.group(0)}")
    return psnr


def culled_cli_path():
    """The train CLI with --fused_train and the culled training stack
    (OCC_CLI_FLAGS), beside the same run without --occ_*, each in a
    process of its own: the culled run's [occ] lines, its packing, and
    val/psnr past CLI_PSNR_BAR by epoch CLI_EPOCHS. Returns both runs'
    val/psnr by epoch."""
    psnr = {}
    with tempfile.TemporaryDirectory() as tmp:
        run_cli(["-m", "nerf_pl_tpu_torch.datasets.synthetic", "scene"],
                "scene", tmp)
        for name, extra in (("dense", []), ("culled", OCC_CLI_FLAGS)):
            out, secs = run_cli(
                ["-m", "nerf_pl_tpu_torch.train", *CLI_FLAGS, "--exp_name",
                 name, "--fused_train", "--num_epochs", str(CLI_EPOCHS),
                 *extra], f"train CLI {name}", tmp)
            psnr[name] = val_psnr(out)
            rates = re.findall(r"^\[train\] step \S+ .*\((.*)\)$", out,
                               re.M)
            print(f"[cli] train --fused_train {' '.join(extra)}, "
                  f"{CLI_EPOCHS} epochs, {secs:.1f} s: val/psnr by epoch "
                  f"{psnr[name]}; last rate: {rates[-1] if rates else None}")
            occ = [ln for ln in out.splitlines() if ln.startswith("[occ]")]
            for ln in occ:
                print(f"[cli] {name}: {ln}")
        if not any("packed: x" in ln for ln in occ):
            raise AssertionError("culled train CLI: no packed [occ] line:\n"
                                 + "\n".join(occ))
    print(f"[cli] val/psnr at epoch {CLI_EPOCHS}: culled "
          f"{psnr['culled'].get(CLI_EPOCHS)}, dense "
          f"{psnr['dense'].get(CLI_EPOCHS)} (bar {CLI_PSNR_BAR})")
    if not psnr["culled"].get(CLI_EPOCHS, 0.0) > CLI_PSNR_BAR:
        raise AssertionError(f"culled train CLI: val/psnr {psnr['culled']} "
                             f"not past {CLI_PSNR_BAR} dB by epoch "
                             f"{CLI_EPOCHS}")
    return psnr


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; TF32 off")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    mlp = fm.pack_mlp(dense_params(0, dev), dev)
    errs = compare_kernels(mlp, dev)
    compare_eval_to_train_fwd(mlp, dev)
    times = time_kernels(mlp, dev)
    launches, _ = main_path(dev)

    errs["mse_render"], _ = compare_mse(mlp, dev)
    mse_times = time_mse(mlp, dev)
    store = teacher_store(dev)
    base = dict(N_samples=N_SAMPLES, N_importance=N_IMPORTANCE, perturb=1.0,
                noise_std=1.0, white_back=True)
    counts, _ = train_path(dev, store, "loss-fused", RenderConfig(
        **base, fused_train=True, fused_loss=True), {"mse_render": 2})
    launches["mse_render"] = counts["mse_render"]
    occ_path(dev, store)
    train_path(dev, store, "culled32", RenderConfig(
        **dict(base, N_samples=CULLED_SAMPLES), fused_train=True,
        fused_loss=True), {"mse_render": 2}, tighten=CULLED_TIGHTEN,
        compare_after_warmup=True)

    errs.update(compare_point_mlp(dev))
    times.update(time_point_mlp(mlp, dev))
    counts, _ = train_path(dev, store, "fused_mlp",
                           RenderConfig(**base, fused=True),
                           {"mlp_fwd": 2, "mlp_bwd": 2})
    launches["mlp_fwd"], launches["mlp_bwd"] = (counts["mlp_fwd"],
                                                counts["mlp_bwd"])

    errs.update(compare_train(mlp, dev))
    times.update(time_train(mlp, dev))
    counts, _ = train_path(dev, store, "fused_train",
                           RenderConfig(**base, fused_train=True),
                           {"train_fwd": 2, "train_bwd": 2})
    launches["train_fwd"], launches["train_bwd"] = (counts["train_fwd"],
                                                    counts["train_bwd"])
    del store
    torch.cuda.empty_cache()
    params, rays, _ = validation_path(dev)
    launches["sigma_fwd"] = perturbed_path(dev, params, rays)["sigma_fwd"]
    train_cli_path()
    culled_cli_path()

    fine_S = N_SAMPLES + N_IMPORTANCE
    times[("mse_render", fine_S)] = mse_times[fine_S]
    for S in (CULLED_SAMPLES, CULLED_SAMPLES + N_IMPORTANCE):
        ms = mse_times[S][0]
        bound_ms, bound_by = bound("mse_render", (TRAIN_BATCH, S), mlp)
        print(f"[bound] mse_render at culled32's {(TRAIN_BATCH, S)}: "
              f"{ms:.3f} ms against a bound of {bound_ms:.4f} ms "
              f"({bound_by}), {100 * bound_ms / ms:.1f}% of the bound's "
              f"rate")
    main_shape = {"sigma_render": (CHUNK, N_SAMPLES),
                  "render_eval": (CHUNK, fine_S),
                  "mse_render": (TRAIN_BATCH, fine_S),
                  "mlp_fwd": TRAIN_BATCH * fine_S,
                  "mlp_bwd": TRAIN_BATCH * fine_S,
                  "sigma_fwd": CHUNK * N_SAMPLES,
                  "train_fwd": (TRAIN_BATCH, fine_S),
                  "train_bwd": (TRAIN_BATCH, fine_S)}
    # the timings are keyed by S for a ray batch and by P for points
    time_key = {k: v[1] if isinstance(v, tuple) else v
                for k, v in main_shape.items()}
    kernels = []
    for k, (tpu, src) in KERNELS.items():
        ms, plain_ms = times[(k, time_key[k])]
        bound_ms, bound_by = bound(k, main_shape[k], mlp)
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": tpu, "launches": launches[k],
                        "max_abs_err": errs[k], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
        print(f"[bound] {k} at {main_shape[k]}: {ms:.3f} ms against a "
              f"bound of {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of the bound's rate")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
