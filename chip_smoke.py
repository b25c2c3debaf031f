#!/usr/bin/env python
"""Smoke run of the PyTorch port (nerf_pl_tpu_torch) on one NVIDIA GPU.

    python chip_smoke.py

1. Prints the card (torch and nvidia-smi); without a CUDA device it fails.
2. Builds the render kernels from csrc/ (first use) and prints the seconds.
3. Holds each kernel against its plain PyTorch version on the card, at
   ragged R = 4099 and S = 64, 128, 192, with the JAX kernels' test bars
   (weights 5e-3, rgb and opacity 1e-2, depth 5e-2), and times both at the
   main path's tile (32768 rays) with CUDA events.
4. Drives the eval path: random weights from a torch.Generator seed are
   written as a checkpoint with the JAX package's keys, loaded back with
   load_ckpt, and 2 frames of 400x400 at 64 + 64 samples are rendered from
   sphere poses (radius 4, near 2, far 6) through make_render_fn, the
   renderer of the eval CLI. Every output must be finite, opacity within
   [0, 1 + 1e-4], both kernels must have launched, and 4096 rays of frame 0
   must agree with the plain unfused path on the card within 2e-2.
5. Prints one JSON line about the kernels, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.
Any failure raises, and the script exits non-zero without those lines.
"""
import json
import os
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
from nerf_pl_tpu_torch.ops import fused_render as fr  # noqa: E402
from nerf_pl_tpu_torch.parallel import make_render_fn  # noqa: E402
from nerf_pl_tpu_torch.rendering import RenderConfig  # noqa: E402
from nerf_pl_tpu_torch.training.checkpoints import load_ckpt  # noqa: E402

TOL = {"weights": 5e-3, "rgb": 1e-2, "opacity": 1e-2, "depth": 5e-2}
MAIN_PATH_TOL = 2e-2
CHUNK = 32768            # eval.py's default --chunk: the kernels' main R
IMG = 400
N_SAMPLES, N_IMPORTANCE = 64, 64
CAMERA_ANGLE_X = 0.8575560450553894   # blender scenes' field of view
KERNELS = {
    "sigma_render": "nerf_pl_tpu/ops/fused_render.py:194",
    "render_eval": "nerf_pl_tpu/ops/fused_render.py:153",
}
SOURCE = "nerf_pl_tpu_torch/csrc/fused_render.cu"


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

    focal = 0.5 * 800 / np.tan(0.5 * CAMERA_ANGLE_X) * IMG / 800
    frames = [frame_rays(sphere_pose(theta, np.pi / 5, 4.0), IMG, IMG, focal,
                         2.0, 6.0, dev) for theta in (0.3, 1.9)]
    base = dict(N_samples=N_SAMPLES, N_importance=N_IMPORTANCE,
                test_time=True, white_back=True)
    render = make_render_fn(RenderConfig(**base, fused=True), CHUNK, dev,
                            device_out=True)

    fr.sigma_render_launches = 0
    fr.render_eval_launches = 0
    outs, secs = [], []
    for rays in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(render(loaded, rays))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = {"sigma_render": fr.sigma_render_launches,
                "render_eval": fr.render_eval_launches}
    print(f"[main] 2 frames {IMG}x{IMG}, {N_SAMPLES}+{N_IMPORTANCE} samples, "
          f"chunk {CHUNK}: launches {launches}; frame 1 {secs[0]:.4f} s "
          f"(first dispatch), frame 2 {secs[1]:.4f} s/frame")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")

    for i, out in enumerate(outs):
        for k, v in out.items():
            if v.shape[0] != IMG * IMG or not torch.isfinite(v).all():
                raise AssertionError(f"frame {i}: {k} not finite or "
                                     f"misshapen {tuple(v.shape)}")
        for k in ("opacity_coarse", "opacity_fine"):
            lo, hi = out[k].min().item(), out[k].max().item()
            if lo < 0.0 or hi > 1.0 + 1e-4:
                raise AssertionError(f"frame {i}: {k} in [{lo}, {hi}]")
    rgb = outs[0]["rgb_fine"]
    print(f"[main] frame 1 rgb mean {rgb.mean().item():.4f} std "
          f"{rgb.std().item():.4f}, opacity_fine mean "
          f"{outs[0]['opacity_fine'].mean().item():.4f}")

    idx = torch.linspace(0, IMG * IMG - 1, 4096, device=dev).long()
    plain = make_render_fn(RenderConfig(**base), 4096, dev,
                           device_out=True)(loaded, frames[0][idx])
    errs = {k: max_err(outs[0][k][idx], v) for k, v in plain.items()}
    print("[main] fused vs plain unfused path, 4096 rays of frame 1: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {MAIN_PATH_TOL})")
    for k, v in errs.items():
        if not v <= MAIN_PATH_TOL:
            raise AssertionError(f"main path {k}: {v} > {MAIN_PATH_TOL}")
    return launches, secs


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

    mlp = fr.pack_mlp(dense_params(0, dev), dev)
    errs = compare_kernels(mlp, dev)
    times = time_kernels(mlp, dev)
    launches, _ = main_path(dev)

    main_S = {"sigma_render": N_SAMPLES, "render_eval": N_SAMPLES + N_IMPORTANCE}
    kernels = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": KERNELS[k], "launches": launches[k],
                "max_abs_err": errs[k], "ms": times[(k, main_S[k])][0],
                "plain_ms": times[(k, main_S[k])][1]} for k in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
