#!/usr/bin/env python
"""Where the device time of an eval frame goes, on one NVIDIA GPU:

    python tools/profile_eval_frame.py [N]

The eval CLI's renderer (make_render_fn, test time, fused kernels, chunk
32768, white background) on random dense weights (torch.Generator seeds
10 and 11, sigma head x50, +2, as chip_smoke.py's eval path) at 400x400
with 64 + 64 samples and at 800x800 with 64 + 128 (eval.py's defaults),
from a sphere pose (radius 4, near 2, far 6). For each size: one warm-up
frame, then N frames (default 3) each timed on the host clock between two
syncs (s/frame, their median), then torch.profiler over one frame:
device time summed over device-side events only, the share of each
kernel (by name) and of everything else, and the device's idle share of
the median unprofiled frame, 1 - device / wall. The frames' rays are
moved by 1e-6 per repeat, so no two renders see the same input.
"""
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nerf_pl_tpu_torch.datasets.rays import frame_rays, sphere_pose  # noqa: E402
from nerf_pl_tpu_torch.models import init_nerf_params  # noqa: E402
from nerf_pl_tpu_torch.parallel import make_render_fn  # noqa: E402
from nerf_pl_tpu_torch.rendering import RenderConfig  # noqa: E402

CHUNK = 32768
CAMERA_ANGLE_X = 0.8575560450553894   # blender scenes' field of view
SIZES = ((400, 64, 64), (800, 64, 128))   # (pixels a side, coarse, fine)


def dense_params(seed, dev):
    p = init_nerf_params(torch.Generator().manual_seed(seed), device=dev)
    p["sigma"]["w"] = p["sigma"]["w"] * 50
    p["sigma"]["b"] = p["sigma"]["b"] + 2.0
    return p


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 3
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    params = {"nerf_coarse": dense_params(10, dev),
              "nerf_fine": dense_params(11, dev)}
    for img, n_c, n_f in SIZES:
        focal = 0.5 * 800 / np.tan(0.5 * CAMERA_ANGLE_X) * img / 800
        rays = frame_rays(sphere_pose(0.3, np.pi / 5, 4.0), img, img, focal,
                          2.0, 6.0, dev)
        render = make_render_fn(RenderConfig(
            N_samples=n_c, N_importance=n_f, test_time=True, white_back=True,
            fused=True), CHUNK, dev, device_out=True)
        what = f"{img}x{img} {n_c}+{n_f}"
        render(params, rays)                        # warm-up
        torch.cuda.synchronize()
        secs = []
        for i in range(n):
            moved = rays.clone()
            moved[:, :3] += (i + 1) * 1e-6
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(params, moved)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        wall = statistics.median(secs)
        print(f"[time] {what}: s/frame {[round(s, 4) for s in secs]}, "
              f"median {wall:.4f}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            render(params, rays)
            torch.cuda.synchronize()
        ka = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
        total = sum(e.self_device_time_total for e in ka) / 1e3
        print(f"[prof] {what}: device time {total:.3f} ms a frame, "
              f"{sum(e.count for e in ka)} device events; idle share of "
              f"the median frame {1 - total / 1e3 / wall:.4f}")
        rest = total
        for e in sorted(ka, key=lambda e: -e.self_device_time_total)[:4]:
            t = e.self_device_time_total / 1e3
            rest -= t
            print(f"[prof] {what}: {t:9.3f} ms {100 * t / total:6.2f}% "
                  f"calls {e.count:4d}  {e.key[:70]}")
        print(f"[prof] {what}: {rest:9.3f} ms {100 * rest / total:6.2f}% "
              f"everything else")


if __name__ == "__main__":
    main()
