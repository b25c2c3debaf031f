"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process:

  * the program's numbers over many seeds: a whole run of the cell with
    a short window (its set-up, checked steps or frames, the reference);
  * the control's: the reference put in the program's place in the
    nearest precision below the configuration's bf16 products (float8
    e4m3 operands, per-tensor scaled), against the float32 reference;
  * the faults' that a cell can have (training: half of the batch left
    out, planted in the reference put in the program's place; a state
    left unchanged reads 1 by the measure and needs no run).

    python3 nerfbench/calibrate.py --workload <cell> --seeds 12 \
        [--control_seeds 3] [--out calib.json]

Writes every reading to --out and prints one summary line a number.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from nerfbench import check, inputs, run  # noqa: E402


def _seeds(n: int, base: int):
    return [inputs.stream_seed(base, i) % (2 ** 31 + 12345) for i in range(n)]


def program_numbers(cell, seed, device, fault=None):
    import importlib
    runner = importlib.import_module(
        f"nerfbench.runners.{cell['traffic']['runner']}")
    res = runner.run(cell, seed, 0.5, False, time.time(), device=device,
                     fault=fault)
    return res["numbers"]


def control_numbers(cell, seed, device):
    """{control: numbers, faults...} of the reference in the program's
    place."""
    import torch
    kind = cell["traffic"]["runner"]
    out = {}
    if kind == "train":
        from nerfbench.runners import train
        base = train.reference_steps(cell, seed, device)
        p0 = base["params0"]

        def as_prog(r):
            return {"losses": r["losses"],
                    "grads0": {n: t.float().cpu() for n, t in
                               r["grads0"].items()},
                    "params": {n: t.float().cpu() for n, t in
                               r["params"].items()}}
        out["control"] = check.train_numbers(as_prog(train.reference_steps(
            cell, seed, device, "float8_e4m3fn")), base, p0)
        b = cell["traffic"]["batch_per_rank"] * cell["traffic"]["world"]
        out["half_batch"] = check.train_numbers(as_prog(train.reference_steps(
            cell, seed, device, keep=slice(0, b // 2))), base, p0)
    else:
        from nerfbench.runners import render
        frames = [0, 1]
        ref = render.reference_frames(cell, seed, frames, device)
        ctl = render.reference_frames(cell, seed, frames, device,
                                      "float8_e4m3fn")
        out["control"] = check.worst(check.render_numbers(ctl[k], ref[k])
                                     for k in frames)
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control_seeds", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=[],
                    help="faults of nerfbench/faults.py planted in the "
                         "program, each read on --control_seeds seeds")
    ap.add_argument("--base", type=int, default=20261017)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    device = "cuda"
    rec = {"workload": args.workload, "program": {}, "control": {}}
    for s in _seeds(args.seeds, args.base):
        rec["program"][s] = program_numbers(cell, s, device)
        print(f"[calib] program seed {s}: {rec['program'][s]}", flush=True)
    for s in _seeds(args.control_seeds, args.base + 1):
        rec["control"][s] = {} if args.faults else control_numbers(
            cell, s, device)
        for f in args.faults:
            rec["control"][s][f] = program_numbers(cell, s, device, f)
        print(f"[calib] control seed {s}: {rec['control'][s]}", flush=True)
    names = sorted({k for d in list(rec["program"].values()) + [
        x for v in rec["control"].values() for x in v.values()] for k in d})
    for name in names:
        lo = [v[name] for v in rec["program"].values()]
        ups = {k: min(v[k][name] for v in rec["control"].values())
               for k in (next(iter(rec["control"].values()))
                         if rec["control"] else [])}
        print(f"[calib] {name}: program max {max(lo, default=None)!r} "
              f"median {sorted(lo)[len(lo) // 2] if lo else None!r}; "
              f"least of {ups}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
