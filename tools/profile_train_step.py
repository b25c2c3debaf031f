#!/usr/bin/env python
"""Where the device time of a training step goes, on one NVIDIA GPU:

    python tools/profile_train_step.py [K]

Three Trainers at the dense bench config (64 + 64 samples, batch 1024,
perturb 1, noise 1, white background, Adam 5e-4, steplr [2, 4, 8] x 0.5)
on a random 1 M-ray store, one per training path: loss-fused
(`--fused_train`: mse_render), `--fused_mlp` alone (autograd through
mlp_fwd and mlp_bwd) and fused_train without the loss-fused step (autograd
through fused_train_render: train_fwd and train_bwd); and a fourth at
bench's culled32 config (loss-fused, 32 + 64 samples, the store tightened
as bench.py tightens it: the box [-1.5, 1.5]^3, margin 0.1, 32 segments,
dilate 1, survivor-packed). After 30 warm-up steps each, 100 unprofiled
steps per path in the order loss-fused, culled32, fused_mlp, fused_train,
fused_train, fused_mlp, culled32, loss-fused, each timed on the host clock
between two syncs on a parameter (ms/step, rays/s). Then
torch.profiler over K steps (default 20) of each path: device time per
step summed over device-side events only (a kernel also appears under the
aten op that launched it, which is not counted), device events per step,
peak memory, the share of each kernel launch and of the plain ops, and
the device's idle share of each unprofiled run, 1 - device / wall.
"""
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nerf_pl_tpu_torch.parallel import Trainer  # noqa: E402
from nerf_pl_tpu_torch.rendering import ModelConfig, RenderConfig  # noqa: E402
from nerf_pl_tpu_torch.training import (get_lr_schedule,  # noqa: E402
                                        get_optimizer, loss_dict)

BATCH, STEPS = 1024, 100
GROUPS = (   # substring of the kernel's name: the launch it belongs to
    ("mlp_fwd_kernel", "mlp_fwd (mlp_fwd_kernel)"),
    ("point_fwdbwd_kernel", "mlp_bwd A' (point_fwdbwd_kernel)"),
    ("fwdbwd_kernel<false>", "mse_render A (fwdbwd_kernel<false>)"),
    ("fwdbwd_kernel<true>", "train_bwd A (fwdbwd_kernel<true>)"),
    ("fwd_quad_kernel", "train_fwd (fwd_quad_kernel)"),
    ("wgrad_kernel", "B (wgrad_kernel)"),
    ("sum_slots", "C (sum_slots, sum_rows)"),
    ("sum_rows", "C (sum_slots, sum_rows)"),
)


def group(key):
    return next((g for s, g in GROUPS if s in key), "plain ops")


def make_trainers(dev):
    base = dict(N_samples=64, N_importance=64, perturb=1.0, noise_std=1.0,
                white_back=True)
    cfgs = {"loss-fused": RenderConfig(**base, fused_train=True,
                                       fused_loss=True),
            "culled32": RenderConfig(**dict(base, N_samples=32),
                                     fused_train=True, fused_loss=True),
            "fused_mlp": RenderConfig(**base, fused=True),
            "fused_train": RenderConfig(**base, fused_train=True)}
    rng = np.random.default_rng(0)
    n = 1 << 20
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 2.0, np.float32),
                           np.full((n, 1), 6.0, np.float32)], 1)
    rgbs = rng.random((n, 3)).astype(np.float32)
    trainers = {}
    for name, rcfg in cfgs.items():
        sched = get_lr_schedule("steplr", 5e-4, 16, 1000,
                                decay_step=[2, 4, 8], decay_gamma=0.5)
        tr = Trainer(ModelConfig(), rcfg, get_optimizer("adam", sched),
                     sched, loss_dict["mse"], BATCH, dev)
        tr.set_data(rays, rgbs)
        if name == "culled32":
            st = tr.tighten_store([[-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]],
                                  margin=0.1, n_seg=32, dilate=1, pack=True)
            print(f"[store] culled32: hit {st['hit_frac']:.4f}, shrink "
                  f"{st['shrink']:.4f}, expand x{st['expand']:.4f}")
        state = tr.init_state(torch.Generator().manual_seed(0))
        state, _ = tr.run_steps(state, 1, 30)
        trainers[name] = [tr, state]
    torch.cuda.synchronize()
    return trainers


def sync(state):
    float(state.params["nerf_coarse"]["xyz_0"]["w"][0, 0])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    K = int(argv[0]) if argv else 20
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    trainers = make_trainers(dev)

    wall = {name: [] for name in trainers}
    for name in ("loss-fused", "culled32", "fused_mlp", "fused_train",
                 "fused_train", "fused_mlp", "culled32", "loss-fused"):
        tr, state = trainers[name]
        sync(state)
        t0 = time.perf_counter()
        state, _ = tr.run_steps(state, 1, STEPS)
        sync(state)
        dt = time.perf_counter() - t0
        trainers[name][1] = state
        wall[name].append(dt / STEPS * 1e3)
        print(f"[time] {name}: {STEPS} steps {dt:.4f} s = "
              f"{dt / STEPS * 1e3:.3f} ms/step, {STEPS * BATCH / dt:.1f} "
              f"rays/s")

    for name, (tr, state) in trainers.items():
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = tr.run_steps(state, 1, K)
            torch.cuda.synchronize()
        trainers[name][1] = state
        ka = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
        total = sum(e.self_device_time_total for e in ka) / 1e3
        per_step = total / K
        idle = ", ".join(f"{1 - per_step / w:.4f}" for w in wall[name])
        print(f"[prof] {name}: {K} steps, device time {total:.3f} ms "
              f"({per_step:.3f} ms/step), "
              f"{sum(e.count for e in ka) / K:.1f} device events per step, "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB; idle share of the unprofiled runs {idle}")
        groups = {}
        for e in ka:
            groups[group(e.key)] = (groups.get(group(e.key), 0.0)
                                    + e.self_device_time_total / 1e3)
        for g, t in sorted(groups.items(), key=lambda x: -x[1]):
            print(f"[prof] {name}: {t / K:8.4f} ms/step "
                  f"{100 * t / total:6.2f}%  {g}")
        for e in sorted(ka, key=lambda e: -e.self_device_time_total)[:16]:
            t = e.self_device_time_total / 1e3
            print(f"[prof] {name}: {t / K:8.4f} ms/step "
                  f"{100 * t / total:6.2f}% calls/step {e.count / K:6.1f}  "
                  f"{e.key[:80]}")


if __name__ == "__main__":
    main()
