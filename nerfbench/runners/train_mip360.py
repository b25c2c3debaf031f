"""The mip-NeRF 360 training runner: the program's Trainer with a
`MipConfig` model over the seeded store, on one device.

Set-up builds the Trainer, hands it the store (rays, colours and pixel
radii) and the weights from the seed, and drives it through its first
`checked_steps` steps with the window's own call (`run_steps`: the first
call captures the step as a CUDA graph), keeping what the check reads.
The window then drives the same object on: segments of `segment_steps`
replayed steps, each ended by a sync on a parameter leaf, until `seconds`
have passed; with `trace` it is `trace_steps` steps under the profiler.

After the window the program's state is freed and the reference
(references/mipnerf360.py) follows the checked steps from the same
weights, rows and draws. `reference_steps` also gives the control (float8
operands) and the half-batch fault their readings (calibrate_mip360.py).

Beside check.train_numbers the check reads `grad_dir_gap`: how far the
program's first gradient points from the reference's, a leaf each, in
units of how far the gradients of the batch's two halves point from each
other. Both reference gradients take the weights as the configuration's
products read them (rounded to its matmul precision, bf16; the
reference's arithmetic stays float32). The recipe clips the gradients'
global norm, which scales every leaf by one factor, so check's norms see
a fault that moves every leaf alike (half of the batch left out) only as
the sampling noise of one factor; and the program's first gradient lies
off the float32 reference's from the unrounded weights by as much as half
a batch does on some seeds, nearly all of it from the weights' rounding
(PERF.md, section 2). A direction sees no common factor; from the rounded
weights the program's bf16 products leave a small part of the halves'
spread, while half a batch reads about half of it on every seed, however
noisy the seed's rays make the gradient.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, Optional, Tuple

import torch

from nerfbench import check, faults, inputs
from nerfbench import inputs_mip360 as mi
from nerfbench import trace as T
from nerfbench.references import mipnerf360 as ref
from nerfbench.work_mip360 import train_step_work


def mip_config(cfg: Dict):
    """The program's MipConfig of the configuration's file."""
    from nerf_pl_tpu_torch.models.mipnerf360 import MipConfig
    m, r, lo = cfg["model"], cfg["render"], cfg["loss"]
    return MipConfig(
        prop_depth=m["prop"]["depth"], prop_width=m["prop"]["width"],
        nerf_depth=m["nerf"]["depth"], nerf_width=m["nerf"]["width"],
        skip_layer=m["nerf"]["skip"],
        bottleneck_width=m["nerf"]["bottleneck"],
        view_width=m["nerf"]["view_width"],
        min_deg_point=m["min_deg_point"], max_deg_point=m["max_deg_point"],
        deg_view=m["deg_view"], density_bias=m["density_bias"],
        rgb_padding=m["rgb_padding"],
        num_prop_samples=tuple(r["num_prop_samples"]),
        num_nerf_samples=r["num_nerf_samples"],
        charb_padding=lo["charb_padding"],
        interlevel_mult=lo["interlevel_mult"],
        distortion_mult=lo["distortion_mult"],
        precision=cfg["precision"]["matmul"])


def _trainer(cfg: Dict, batch: int, device):
    from nerf_pl_tpu_torch.parallel import Trainer
    from nerf_pl_tpu_torch.rendering import RenderConfig
    from nerf_pl_tpu_torch.training.lr_schedule import \
        get_loglinear_schedule
    from nerf_pl_tpu_torch.training.optimizers import get_optimizer
    o = cfg["optimizer"]
    sched = get_loglinear_schedule(o["lr_init"], o["lr_final"],
                                   o["max_steps"], o["lr_delay_steps"],
                                   o["lr_delay_mult"])
    opt = get_optimizer(o["name"], sched, eps=o["eps"],
                        clip_norm=o["grad_max_norm"])
    return Trainer(mip_config(cfg), RenderConfig(), opt, sched, None, batch,
                   device)


def _sync(state) -> None:
    """A parameter leaf read back: the update ends the step."""
    float(state.params["nerf_mlp"]["layer_0"]["w"].reshape(-1)[0])


def trainer_with_store(cell: Dict, seed: int, device: torch.device):
    """The Trainer with the store from the seed (set_data's shuffle)."""
    cfg, mix = cell["config"], cell["traffic"]
    tr = _trainer(cfg, mix["batch_per_rank"], device)
    rays, rgbs, radii = mi.make_store(cfg, cfg["store"]["n_rays"], seed,
                                      device)
    rays, rgbs, radii = (t.cpu().numpy() for t in (rays, rgbs, radii))
    tr.set_data(rays, rgbs, shuffle_seed=seed, all_radii=radii)
    return tr


def _run(cell, seed, seconds, trace, start_wall, device):
    from nerf_pl_tpu_torch.parallel.spmd import TrainState
    cfg, mix = cell["config"], cell["traffic"]
    tr = trainer_with_store(cell, seed, device)
    params = mi.make_params(cfg["model"], seed, device)
    state = TrainState(params, tr.optimizer.init(params), 0)

    k = mix["checked_steps"]
    state1, m1 = tr.run_steps(state, seed, 1)
    state, m2 = tr.run_steps(state1, seed, k - 1)
    b1 = cfg["optimizer"]["b1"]
    mu = state1.opt_state[-2]["mu"]
    snap = {"losses": torch.cat([m1["loss"], m2["loss"]]).tolist(),
            "grads0": check.flatten(
                {m: {l: {w: t / (1 - b1) for w, t in leaf.items()}
                     for l, leaf in layers.items()}
                 for m, layers in mu.items()}),
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
            if (steps >= n_steps if n_steps is not None else
                    time.perf_counter() - t0 >= limit_s):
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


def direction_gap(prog: check.Leaves, ref: check.Leaves) -> float:
    """The median leaf's |g / |g| - r / |r||, g a leaf of prog and r of
    ref: 0 for the same direction, 2 for the opposite one, whatever
    either's norm."""
    def unit(t):
        t = t.detach().double().cpu().reshape(-1)
        return t / max(float(torch.linalg.vector_norm(t)), 1e-300)
    return statistics.median(
        float(torch.linalg.vector_norm(unit(prog[n]) - unit(r)))
        for n, r in ref.items())


def numbers(snap: Dict, ref: Dict, params0: check.Leaves,
            halves: Tuple[check.Leaves, check.Leaves]) -> Dict:
    """check.train_numbers of the program's (or a stand-in's) checked
    steps against the reference's; grad_dir_gap: the direction gap of the
    first gradient to the sum of the halves' (operand_half_gradients),
    over the halves' own gap."""
    out = check.train_numbers(snap, ref, params0)
    h1, h2 = halves
    out["grad_dir_gap"] = (
        direction_gap(snap["grads0"], {n: h1[n] + h2[n] for n in h1})
        / max(direction_gap(h1, h2), 1e-30))
    return out


def reference_batches(cell: Dict, seed: int, device) -> list:
    """The checked steps' batches as the reference works them out: the
    store from the seed, the program's set_data order, contiguous rows,
    and the step's draws."""
    cfg, mix = cell["config"], cell["traffic"]
    b, k = mix["batch_per_rank"], mix["checked_steps"]
    rays, rgbs, radii = mi.make_store(cfg, cfg["store"]["n_rays"], seed,
                                      device)
    order, _ = inputs.store_order(cfg["store"]["n_rays"], seed, b, 1)
    batches = []
    for i in range(k):
        rows = torch.as_tensor(order[i * b:(i + 1) * b], device=device)
        batches.append({"rays": rays[rows], "rgbs": rgbs[rows],
                        "radii": radii[rows],
                        "draws": mi.step_draws(cfg, b, seed, i, device)})
    return batches


def reference_steps(cell: Dict, seed: int, device, precision="float32",
                    keep=None) -> Dict:
    """The reference's checked steps (or the control's, in a lower
    precision, or with a fault's rows left out)."""
    cfg = cell["config"]
    ref.no_tf32()
    params0 = mi.make_params(cfg["model"], seed, device)
    out = ref.train_steps(params0, cfg["model"], cfg["render"], cfg["loss"],
                          cfg["optimizer"],
                          reference_batches(cell, seed, device),
                          ref.Matmul(precision), keep=keep)
    out["params0"] = check.flatten(params0)
    return out


def operand_half_gradients(cell: Dict, seed: int, device
                           ) -> Tuple[check.Leaves, check.Leaves]:
    """The reference's unclipped first gradients of the first checked
    batch's first and second halves of rows (each its half's mean), from
    the seed's weights rounded to the configuration's matmul precision as
    the program's products read them, in float32. Their sum points where
    the whole batch's gradient does."""
    cfg = cell["config"]
    dtype = getattr(torch, cfg["precision"]["matmul"])
    ref.no_tf32()
    w = mi.make_params(cfg["model"], seed, device)
    w = {m: {l: {k: t.to(dtype).float() for k, t in leaf.items()}
             for l, leaf in layers.items()} for m, layers in w.items()}
    batch = reference_batches(cell, seed, device)[:1]
    h = cell["traffic"]["batch_per_rank"] // 2
    out = []
    for keep in (slice(0, h), slice(h, 2 * h)):
        r = ref.train_steps(w, cfg["model"], cfg["render"], cfg["loss"],
                            cfg["optimizer"], batch, ref.Matmul(), keep=keep)
        out.append({n: t / r["clip0"] for n, t in r["grads0"].items()})
    return out[0], out[1]


def run(cell: Dict, seed: int, seconds: float, trace: bool,
        start_wall: float, device="cuda", fault: Optional[str] = None
        ) -> Dict:
    """One run of the cell: the measurement and the check's numbers."""
    mix = cell["traffic"]
    if mix["world"] != 1:
        raise ValueError("the mip-NeRF 360 runner trains on one device")
    device = torch.device(device)
    with faults.planted(fault):
        r0 = _run(cell, seed, seconds, trace, start_wall, device)
    rows = r0["steps"] * mix["batch_per_rank"]
    out = {
        "e2e": {"train_rays_per_s": rows / r0["window_s"],
                "setup_s": r0["setup_wall"]},
        "attempted": r0["steps"],
        "failed": r0["failed"],
        "memory_peak_bytes": r0["memory_peak_bytes"],
        "traces": [r0["trace"]] if "trace" in r0 else [],
        "ctx": {"kind": "train_mip360", "model": cell["config"]["model"],
                "world": 1,
                "unit": train_step_work(cell["config"],
                                        mix["batch_per_rank"])},
    }
    t0 = time.perf_counter()
    r = reference_steps(cell, seed, device)
    out["numbers"] = numbers(r0["snap"], r, r["params0"],
                             operand_half_gradients(cell, seed, device))
    out["check_s"] = time.perf_counter() - t0
    return out
