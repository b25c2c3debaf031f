"""Time the fused test-time render kernels across ray counts per launch.

    python -m nerf_pl_tpu_torch.bench_kernels [--n_rays 163840] [--s 128] \
        [--tiles 1024 4096 8192 16384 32768] [--reps 4]

Port of scripts/bench_kernels.py. It times `render_eval` (the full MLP and
its quadrature, fused_render.py) and `sigma_render` (the σ trunk and the
weights) on --n_rays random rays of --s sorted samples, with fresh inputs
each rep (the same seeds as the script), and prints the best ms, the
points a second (Mpts/s) and every rep's ms.

--tiles means something else here. The TPU kernels take their tile at
compile time (`points_per_tile`), so the script compiles one program per
tile size. The CUDA kernels' block tile is fixed when they are built, so
here a tile is the rays of one launch: the rays are rendered in launches
of that many rays each, and the time is that of all the launches. A small
tile then shows the cost of a launch and of a ragged last wave of blocks.

Each rep is timed with CUDA events (`utils.profiling.cuda_event_ms`, the
timer chip_smoke.py uses). It runs on cuda:0 and raises without CUDA.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .device import resolve_device
from .utils.profiling import cuda_event_ms


def make_inputs(R: int, S: int, seed: int, device: torch.device):
    """scripts/bench_kernels.py's rays (near 2, far 6) and sorted depths."""
    r = np.random.default_rng(seed)
    o = r.normal(size=(R, 3)).astype(np.float32)
    d = r.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((R, 1), 2.0, np.float32),
                           np.full((R, 1), 6.0, np.float32)], 1)
    z = np.sort(r.uniform(2.0, 6.0, (R, S)).astype(np.float32), -1)
    return (torch.from_numpy(rays).to(device),
            torch.from_numpy(z).to(device))


def time_tiles(kernel, inputs, tile: int):
    """Each rep's ms for kernel over all rays in launches of `tile` rays,
    one rep a fresh input (a warm-up call first, on the first input)."""
    reps = iter(inputs)

    def call():
        rays, z = next(reps)
        for lo in range(0, rays.shape[0], tile):
            kernel(rays[lo:lo + tile], z[lo:lo + tile])

    def first():
        rays, z = inputs[0]
        kernel(rays[:tile], z[:tile])

    first()
    return cuda_event_ms(call, reps=len(inputs), warmup=0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_rays", type=int, default=163840)
    ap.add_argument("--s", type=int, default=128)
    ap.add_argument("--tiles", type=int, nargs="+",
                    default=[1024, 4096, 8192, 16384, 32768],
                    help="rays per launch")
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)

    from .models import init_nerf_params
    from .ops import fused_mlp as fm
    from .ops import fused_render as fr

    device = resolve_device()
    mlp = fm.pack_mlp(init_nerf_params(torch.Generator().manual_seed(0),
                                       device=device), device)
    R, S = args.n_rays, args.s
    inputs = [make_inputs(R, S, seed, device) for seed in range(args.reps)]
    kernels = (("full", lambda r, z: fr.fused_render_eval(mlp, r, z, True)),
               ("sig ", lambda r, z: fr.fused_sigma_render(mlp, r, z)))
    print(f"[bench_kernels] {torch.cuda.get_device_name(device)}: R={R} "
          f"S={S}, {args.reps} reps of fresh inputs, ms per rep (CUDA "
          "events)", flush=True)
    for name, kernel in kernels:
        for tile in args.tiles:
            times = time_tiles(kernel, inputs, tile)
            best = min(times)
            print(f"{name} tile={tile:6d}: {best:8.2f} ms  "
                  f"{R * S / best / 1e3:7.1f} Mpts/s  "
                  f"spread={['%.2f' % t for t in sorted(times)]}",
                  flush=True)


if __name__ == "__main__":
    main()
