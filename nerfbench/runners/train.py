"""The training runner: the program's Trainer over the seeded store, on
one device or over `world` ranks (the program's `dist.launch`, one card a
rank over NCCL).

Set-up builds one Trainer, hands it the store and the weights from the
seed, and drives it through its first `checked_steps` steps with the
window's own call (`run_steps`: the first call captures the step as a
CUDA graph), keeping what the check reads. The window then drives the
same object on: segments of `segment_steps` replayed steps, each ended by
a sync on a parameter leaf, until `seconds` have passed. A row is a
global batch row (after packing, in the culled configuration, a surviving
ray). With `trace` the window is `trace_steps` steps under the profiler.

After the window the program's state is freed and the reference follows
the checked steps from the same weights, rows and draws.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from nerfbench import check, faults, inputs
from nerfbench.nojax import banned_modules
from nerfbench import trace as T
from nerfbench.references import nerf as ref
from nerfbench.work import train_step_work


def _trainer(cfg: Dict, batch: int, steps_per_epoch: int, device, group):
    from nerf_pl_tpu_torch.parallel import Trainer
    from nerf_pl_tpu_torch.rendering import ModelConfig, RenderConfig
    from nerf_pl_tpu_torch.training import (get_lr_schedule, get_optimizer,
                                            loss_dict)
    r, o = cfg["render"], cfg["optimizer"]
    rcfg = RenderConfig(N_samples=r["N_samples"],
                        N_importance=r["N_importance"], perturb=r["perturb"],
                        noise_std=r["noise_std"], white_back=r["white_back"],
                        fused_train=True, fused_loss=True)
    sched = get_lr_schedule(o["lr_scheduler"], o["lr"], o["num_epochs"],
                            steps_per_epoch, decay_step=o["decay_step"],
                            decay_gamma=o["decay_gamma"])
    return Trainer(ModelConfig(), rcfg,
                   get_optimizer(o["name"], sched, eps=o["eps"]), sched,
                   loss_dict["mse"], batch, device, group=group)


def _adam_mu(opt_state):
    """The first moment in the optimizer's state tree."""
    for part in opt_state:
        if isinstance(part, dict) and "mu" in part:
            return part["mu"]
    raise ValueError("no Adam first moment in the optimizer state")


def _sync(state) -> None:
    """A parameter leaf read back: the update ends the step."""
    leaf = state.params["nerf_coarse"]["xyz_0"]["w"]
    float(leaf.reshape(-1)[0])


def _stop_agreed(stop: bool, group, device) -> bool:
    """Rank 0's decision on every rank (the window's steps stay in
    lockstep across the group)."""
    if group is None:
        return stop
    import torch.distributed as dist
    flag = torch.tensor([1.0 if stop else 0.0], device=device)
    dist.broadcast(flag, 0, group=group)
    return bool(flag.item())


def rank_run(group, device, cell: Dict, seed: int, seconds: float,
             trace: bool, start_wall: float, fault: Optional[str]):
    """One rank's set-up, checked steps and window. Returns what the
    parent reports and checks (tensors on the CPU), and the modules of
    jax or the JAX package loaded in this rank once its window closed."""
    with faults.planted(fault):
        out = _rank_run(group, device, cell, seed, seconds, trace,
                        start_wall)
        out["banned"] = banned_modules()
    return out


def trainer_with_store(cell: Dict, seed: int, device: torch.device,
                       group):
    """This rank's Trainer with the store from the seed: set_data's
    shuffle and shard, and in the culled configuration tighten_store."""
    cfg, mix = cell["config"], cell["traffic"]
    world, b_local = mix["world"], mix["batch_per_rank"]
    n = cfg["store"]["n_rays"]
    n_local = inputs.shard_rows(n, b_local * world, world)
    tr = _trainer(cfg, b_local * world, max(1, n_local // b_local), device,
                  group)
    rays, rgbs = inputs.make_store(n, seed, device)
    rays, rgbs = rays.cpu().numpy(), rgbs.cpu().numpy()
    tr.set_data(rays, rgbs, shuffle_seed=seed)
    del rays, rgbs
    if cfg.get("culled"):
        c = cfg["culled"]
        tr.tighten_store(np.asarray(c["boxes"], np.float32),
                         margin=c["margin"], n_seg=c["n_seg"],
                         dilate=c["dilate"], pack=c["pack"])
    return tr


def _rank_run(group, device, cell, seed, seconds, trace, start_wall):
    from nerf_pl_tpu_torch.parallel.spmd import TrainState
    device = torch.device(device)
    cfg, mix = cell["config"], cell["traffic"]
    tr = trainer_with_store(cell, seed, device, group)
    params = inputs.make_params(cfg["model"], seed, device)
    state = TrainState(params, tr.optimizer.init(params), 0)

    # the checked steps, through the window's own call
    k = mix["checked_steps"]
    state1, m1 = tr.run_steps(state, seed, 1)
    state, m2 = tr.run_steps(state1, seed, k - 1)
    snap = {"losses": torch.cat([m1["loss"], m2["loss"]]).tolist(),
            "grads0": check.flatten(
                {m: {l: {w: t / (1 - cfg["optimizer"]["b1"])
                         for w, t in leaf.items()}
                     for l, leaf in layers.items()}
                 for m, layers in _adam_mu(state1.opt_state).items()}),
            "params": check.flatten(state.params)}
    del state1
    _sync(state)
    t_window = time.time()

    seg = mix["segment_steps"]
    losses = []

    def window(limit_s: Optional[float], n_steps: Optional[int]) -> int:
        nonlocal state
        steps, t0 = 0, time.perf_counter()
        while True:
            state, m = tr.run_steps(state, seed, seg)
            losses.append(m["loss"])
            _sync(state)
            steps += seg
            done = (steps >= n_steps if n_steps is not None else
                    time.perf_counter() - t0 >= limit_s)
            if _stop_agreed(done, group, device):
                return steps

    out = {"setup_wall": t_window - start_wall}
    if trace:
        tr_ = T.traced(lambda: window(None, mix["trace_steps"]),
                       device.type == "cuda")
        out["trace"] = tr_
        out["window_s"], out["steps"] = tr_.window_s, tr_.units
    else:
        t0 = time.perf_counter()
        out["steps"] = window(seconds, None)
        out["window_s"] = time.perf_counter() - t0
    out["failed"] = int((~torch.isfinite(torch.cat(losses))).sum())
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    out["snap"] = snap
    del tr, state, losses, m1, m2
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def reference_batches(cell: Dict, seed: int, device) -> list:
    """The checked steps' global batches as the reference works them out:
    the store from the seed, the program's set_data order, each rank's
    contiguous rows (in the culled configuration, its shard's survivors
    in order, tightened, with their segment bits) and each rank's draws."""
    cfg, mix = cell["config"], cell["traffic"]
    world, b = mix["world"], mix["batch_per_rank"]
    n, k = cfg["store"]["n_rays"], mix["checked_steps"]
    rays, rgbs = inputs.make_store(n, seed, device)
    order, n_local = inputs.store_order(n, seed, b * world, world)
    c = cfg.get("culled")
    per_rank = []
    for d in range(world):
        shard = order[d * n_local:(d + 1) * n_local]
        if not c:
            rows = torch.as_tensor(shard[:k * b], device=device)
            per_rank.append((rays[rows], rgbs[rows], None))
            continue
        boxes = torch.tensor(c["boxes"], dtype=torch.float32, device=device)
        found, start, chunk = [], 0, 1 << 16
        while sum(len(f) for f in found) < k * b and start < n_local:
            rows = torch.as_tensor(shard[start:start + chunk], device=device)
            hit, _, _ = ref.box_overlap(boxes, rays[rows])
            found.append(rows[hit])
            start += chunk
        rows = torch.cat(found)[:k * b]
        hit, lo, hi = ref.box_overlap(boxes, rays[rows])
        tight = ref.tighten(rays[rows], hit, lo, hi, c["margin"])
        bits = ref.segment_bits(boxes, tight, c["n_seg"], c["dilate"])
        per_rank.append((tight, rgbs[rows], bits))
    batches = []
    for i in range(k):
        sl = slice(i * b, (i + 1) * b)
        draws = [inputs.step_draws(cfg["render"], b, seed, i, d, device)
                 for d in range(world)]
        batch = {"rays": torch.cat([p[0][sl] for p in per_rank]),
                 "rgbs": torch.cat([p[1][sl] for p in per_rank]),
                 "draws": {name: torch.cat([dr[name] for dr in draws])
                           for name in draws[0]}}
        if c:
            batch["bits"] = torch.cat([p[2][sl] for p in per_rank])
        batches.append(batch)
    return batches


def reference_steps(cell: Dict, seed: int, device, precision="float32",
                    keep=None) -> Dict:
    """The reference's checked steps (or the control's, in a lower
    precision, or with a fault's rows left out)."""
    cfg, mix = cell["config"], cell["traffic"]
    ref.no_tf32()
    n_local = inputs.shard_rows(cfg["store"]["n_rays"],
                                mix["batch_per_rank"] * mix["world"],
                                mix["world"])
    params0 = inputs.make_params(cfg["model"], seed, device)
    out = ref.train_steps(params0, cfg["model"], cfg["render"],
                          cfg["optimizer"], reference_batches(cell, seed,
                                                              device),
                          max(1, n_local // mix["batch_per_rank"]),
                          ref.Matmul(precision), keep=keep)
    out["params0"] = check.flatten(params0)
    return out


def run(cell: Dict, seed: int, seconds: float, trace: bool,
        start_wall: float, device="cuda", fault: Optional[str] = None
        ) -> Dict:
    """One run of a training cell: the ranks' measurements, merged, and
    the check's numbers."""
    mix = cell["traffic"]
    world = mix["world"]
    device = torch.device(device)
    if world == 1:
        ranks = [rank_run(None, device, cell, seed, seconds, trace,
                          start_wall, fault)]
    else:
        from nerf_pl_tpu_torch import dist as pdist
        ranks = pdist.launch(rank_run, world, cell, seed, seconds, trace,
                             start_wall, fault, device=device.type)
    r0 = ranks[0]
    rows = r0["steps"] * mix["batch_per_rank"] * world
    out = {
        "e2e": {"train_rays_per_s": rows / r0["window_s"],
                "setup_s": r0["setup_wall"]},
        "attempted": r0["steps"],
        "failed": max(r["failed"] for r in ranks),
        "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks),
        "traces": [r["trace"] for r in ranks if "trace" in r],
        "banned": {f"rank {i}": r["banned"] for i, r in enumerate(ranks)},
        "ctx": {"kind": "train", "model": cell["config"]["model"],
                "world": world,
                "unit": train_step_work(cell["config"],
                                        mix["batch_per_rank"])},
    }
    t0 = time.perf_counter()
    r = reference_steps(cell, seed, device)
    out["numbers"] = check.worst(
        check.train_numbers(rk["snap"], r, r["params0"]) for rk in ranks)
    out["check_s"] = time.perf_counter() - t0
    return out
