"""The readings that `mipnerf360_outdoor.train16k`'s limits are set
from, on the card at the cell's own size, in one process (calibrate.py's
method; its train branch is the NeRF runner's). Each seed's numbers are
taken against one float32 reference of that seed:

  * program: a whole run of the cell with a short window (its set-up and
    checked steps), as the runner checks it;
  * half_batch: the same run with faults.half_batch planted in the
    program (each batch's second half of rows replaced by its first);
  * half_batch_ref: the reference put in the program's place, training
    on half of each batch's rows;
  * and on the first `--control_seeds` seeds and each `--extra` seed:
    control, the reference in the program's place with float8 e4m3
    operands (per-tensor scaled), the precision below the configuration's
    bf16 products; bf16_weights, the float32 reference from the weights
    rounded to bf16 (what the program's products read of them).

Beside the check's numbers (grad_dir_gap: the direction gap to the
reference's first gradient from the weights rounded to bf16 over the gap
between its batch halves' gradients, runner.operand_half_gradients) each
reading gives its numerator and denominator (`grad_dir_gap_operand`,
`halves_dir_gap`); the median, over each MLP's leaves, of |first
gradient| / |the float32 reference's| (`prop_norm_ratio`,
`nerf_norm_ratio`): a factor common to one MLP's leaves shows there; the
direction gap against the float32 reference from the unrounded weights
(`grad_dir_gap_f32`); the largest leaf's direction gap to the rounded
weights' (`grad_dir_gap_worst`); and every leaf's direction gap and norm
ratio (`dir_leaves`, `norm_leaves`). A state left unchanged reads 1 by
the norms' measure and needs no run.

    python3 nerfbench/calibrate_mip360.py --seeds 20 [--control_seeds 3] \\
        [--extra 1737353820 ...] [--out calib.json]

Writes every reading to --out and prints one summary line a number.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from nerfbench import check, faults, run  # noqa: E402
from nerfbench.calibrate import _seeds  # noqa: E402

CELL = "mipnerf360_outdoor.train16k"


def _unit(t):
    t = t.detach().double().cpu().reshape(-1)
    return t / max(float(t.norm()), 1e-300)


def _diagnostics(grads: check.Leaves, ref: check.Leaves,
                 operand: check.Leaves) -> dict:
    from nerfbench.runners import train_mip360 as runner
    leaves = [float((_unit(grads[n]) - _unit(r)).norm())
              for n, r in operand.items()]
    out = {"grad_dir_gap_f32": runner.direction_gap(grads, ref),
           "grad_dir_gap_operand": runner.direction_gap(grads, operand),
           "grad_dir_gap_worst": max(leaves), "dir_leaves": leaves,
           "norm_leaves": [float(grads[n].double().norm()
                                 / r.double().cpu().norm())
                           for n, r in ref.items()]}
    for mlp in ("prop_mlp", "nerf_mlp"):
        out[f"{mlp.split('_')[0]}_norm_ratio"] = statistics.median(
            float(grads[n].double().norm() / ref[n].double().cpu().norm())
            for n in ref if n[0] == mlp)
    return out


def _as_prog(r) -> dict:
    return {"losses": r["losses"],
            "grads0": {n: t.float().cpu() for n, t in r["grads0"].items()},
            "params": {n: t.float().cpu() for n, t in r["params"].items()}}


def readings(cell, seed, device, full: bool) -> dict:
    """{program, half_batch, half_batch_ref[, control, bf16_weights]:
    numbers} of one seed."""
    import torch
    from nerfbench import inputs_mip360 as mi
    from nerfbench.references import mipnerf360 as ref
    from nerfbench.runners import train_mip360 as runner
    base = runner.reference_steps(cell, seed, device)
    p0 = base["params0"]
    halves = runner.operand_half_gradients(cell, seed, device)
    operand = {n: t + halves[1][n] for n, t in halves[0].items()}
    spread = runner.direction_gap(*halves)

    def read(snap):
        out = runner.numbers(snap, base, p0, halves)
        out.update(_diagnostics(snap["grads0"], base["grads0"], operand))
        out["halves_dir_gap"] = spread
        return out
    rec = {}
    for name, fault in (("program", None), ("half_batch", "half_batch")):
        with faults.planted(fault):
            r0 = runner._run(cell, seed, 0.5, False, time.time(),
                             torch.device(device))
        rec[name] = read(r0["snap"])
        del r0
        torch.cuda.empty_cache()
    b = cell["traffic"]["batch_per_rank"]
    rec["half_batch_ref"] = read(_as_prog(runner.reference_steps(
        cell, seed, device, keep=slice(0, b // 2))))
    if full:
        rec["control"] = read(_as_prog(runner.reference_steps(
            cell, seed, device, "float8_e4m3fn")))
        cfg = cell["config"]
        w = mi.make_params(cfg["model"], seed, device)
        w = {m: {l: {k: t.bfloat16().float() for k, t in leaf.items()}
                 for l, leaf in layers.items()} for m, layers in w.items()}
        rec["bf16_weights"] = read(_as_prog(ref.train_steps(
            w, cfg["model"], cfg["render"], cfg["loss"], cfg["optimizer"],
            runner.reference_batches(cell, seed, device), ref.Matmul())))
    torch.cuda.empty_cache()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--control_seeds", type=int, default=3)
    ap.add_argument("--extra", type=int, nargs="*", default=[])
    ap.add_argument("--base", type=int, default=20261019)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = run.load_cell(CELL)
    seeds = _seeds(args.seeds, args.base)
    rec = {"workload": CELL, "seeds": {}}
    for s in list(args.extra) + seeds:
        t0 = time.perf_counter()
        full = s in args.extra or seeds.index(s) < args.control_seeds
        rec["seeds"][s] = readings(cell, s, "cuda", full)
        brief = {k: {n: x for n, x in v.items() if not n.endswith("_leaves")}
                 for k, v in rec["seeds"][s].items()}
        print(f"[calib] seed {s} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(brief)}", flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(rec, indent=1))
    kinds = sorted({k for v in rec["seeds"].values() for k in v})
    names = sorted(k for k in next(iter(rec["seeds"].values()))["program"]
                   if not k.endswith("_leaves"))
    for name in names:
        parts = []
        for kind in kinds:
            vals = sorted(v[kind][name] for v in rec["seeds"].values()
                          if kind in v)
            parts.append(f"{kind} min {vals[0]!r} median "
                         f"{vals[len(vals) // 2]!r} max {vals[-1]!r} "
                         f"({len(vals)})")
        print(f"[calib] {name}: " + "; ".join(parts), flush=True)


if __name__ == "__main__":
    main()
