"""Benchmark: steady-state training throughput of one card.

    python -m nerf_pl_tpu_torch.bench [--config dense|culled48|culled32] \
        [--precision float32|bfloat16]

Port of the repository's bench.py, step for step. It measures rays/s of
the headline Blender recipe (batch 1024, 64 fine samples, the full 8x256
MLPs, perturb and sigma noise, white background, the loss-fused step
with Adam and steplr), the per-step work of the reference's lego
benchmark (0.12 s a step at batch 1024 on an RTX 2080 Ti: 8,533 rays/s,
the vs_baseline denominator). `--config dense` takes 64 uniform coarse
samples; culledN (the default culled32) places N coarse samples in
occupied segments of a store tightened with one synthetic box.

The store is bench.py's synthetic one, N_RAYS rays shaped like lego
400x400 (100 views), from numpy's default_rng(0). A warm-up segment of
STEPS steps (on the card: the capture of the step's CUDA graph) is
followed by three timed segments of STEPS steps, each ending in a sync
on a parameter leaf; the best segment gives the rate, and every
segment's rate goes to stderr with the card's name.

Prints ONE JSON line on stdout: {"metric", "value", "unit",
"vs_baseline"}. It runs on cuda:0 and raises without CUDA; only
main(argv, device="cpu") runs it on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

REFERENCE_RAYS_PER_SEC = 1024 / 0.12  # nerf_pl on an RTX 2080 Ti
N_RAYS = 100 * 400 * 400     # the store: lego's 100 views of 400x400
STEPS = 400                  # steps a segment
SEGMENTS = 3                 # timed segments after the warm-up one
BATCH = 1024
BOX = [[-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]]   # the culled configs' grid


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="culled32",
                    choices=["dense", "culled48", "culled32"],
                    help="dense = the reference's recipe (64+64); culledN "
                         "= the occupancy-tightened step (N coarse "
                         "samples in occupied segments + 64 fine)")
    ap.add_argument("--precision", default="float32",
                    choices=["float32", "bfloat16"],
                    help="master-weight and moment dtype (the kernels "
                         "compute bf16 products either way)")
    return ap


def synthetic_store(n: int, seed: int = 0):
    """bench.py's ray store: normal origins, unit normal directions, near
    2, far 6, uniform colours."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 2.0, np.float32),
                           np.full((n, 1), 6.0, np.float32)], 1)
    return rays, rng.random((n, 3)).astype(np.float32)


def main(argv=None, device=None):
    """Run the benchmark; prints the JSON line and returns it as a dict
    with the segments' rates ("spread", best first), the steps run, the
    step's captures and the timed segments' losses."""
    from .device import resolve_device
    from .parallel import Trainer
    from .rendering import ModelConfig, RenderConfig
    from .training import get_lr_schedule, get_optimizer, loss_dict
    from .training.optimizers import tree_leaves

    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    culled = args.config.startswith("culled")
    n_coarse = int(args.config[len("culled"):]) if culled else 64

    rcfg = RenderConfig(N_samples=n_coarse, N_importance=64, perturb=1.0,
                        noise_std=1.0, white_back=True, fused_train=True,
                        fused_loss=True)
    sched = get_lr_schedule("steplr", 5e-4, 16, 1000, decay_step=[2, 4, 8],
                            decay_gamma=0.5)
    tr = Trainer(ModelConfig(), rcfg, get_optimizer("adam", sched), sched,
                 loss_dict["mse"], BATCH, device)
    tr.set_data(*synthetic_store(N_RAYS))
    if culled:
        st = tr.tighten_store(np.asarray(BOX, np.float32), margin=0.1,
                              n_seg=32, dilate=1, pack=True)
        print(f"[bench] culled store: hit {st['hit_frac']!r}, shrink "
              f"{st['shrink']!r}, expand x{st['expand']!r}", file=sys.stderr)
    master = torch.bfloat16 if args.precision == "bfloat16" else None
    state = tr.init_state(torch.Generator().manual_seed(0),
                          master_dtype=master)

    def sync(state):
        float(tree_leaves(state.params)[0].reshape(-1)[0])

    state, _ = tr.run_steps(state, 1, STEPS)    # warm-up (and capture)
    sync(state)
    dts, losses = [], []
    for _ in range(SEGMENTS):
        t0 = time.perf_counter()
        state, m = tr.run_steps(state, 1, STEPS)
        sync(state)     # a parameter: the update ends the step
        dts.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    if not all(bool(torch.isfinite(loss).all()) for loss in losses):
        raise RuntimeError(f"[bench] non-finite loss: {losses}")

    rays_per_sec = STEPS * BATCH / min(dts)
    spread = [STEPS * BATCH / dt for dt in sorted(dts)]
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[bench] config={args.config} precision={args.precision} on "
          f"{name}: segment spread (rays/s): {[round(v, 1) for v in spread]}",
          file=sys.stderr)
    result = {"metric": "train_rays_per_sec_per_chip",
              "value": round(rays_per_sec, 1), "unit": "rays/s",
              "vs_baseline": round(rays_per_sec / REFERENCE_RAYS_PER_SEC, 2)}
    print(json.dumps(result), flush=True)
    return dict(result, spread=spread, steps=(SEGMENTS + 1) * STEPS,
                captures=tr.captures,
                losses=torch.cat(losses).cpu().numpy())


if __name__ == "__main__":
    main()
