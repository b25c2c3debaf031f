#!/usr/bin/env python
"""The busy and idle device us a step of each phase of a train cell's
replayed step, and its unprofiled wall ms a step, on one NVIDIA GPU:

    python tools/phase_split.py <cell> <seed> [segments]

The cell's Trainer, store and weights are the benchmark's
(`nerfbench/runners/train.py::trainer_with_store`, `nerfbench/inputs.py`).
After a 250-step warm-up segment, four unprofiled segments of 250 steps
are timed on the host clock between syncs on a parameter; then `segments`
(default 4) segments of 250 run under torch.profiler with no sync between
them, and `nerfbench/metrics/_spans.py::split` divides the window by the
program's marks. Prints one JSON line. Run from the root of a checkout:
run in a parent's checkout, it measures the parent's program.
"""
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from nerfbench import inputs  # noqa: E402
from nerfbench import trace as T  # noqa: E402
from nerfbench.metrics import _spans as S  # noqa: E402
from nerfbench.run import load_cell  # noqa: E402
from nerfbench.runners.train import _sync, trainer_with_store  # noqa: E402
from nerf_pl_tpu_torch.parallel.spmd import TrainState  # noqa: E402

SEGMENT = 250


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cell, seed = argv[0], int(argv[1])
    segments = int(argv[2]) if len(argv) > 2 else 4
    c = load_cell(cell)
    dev = torch.device("cuda")
    tr = trainer_with_store(c, seed, dev, None)
    params = inputs.make_params(c["config"]["model"], seed, dev)
    state = TrainState(params, tr.optimizer.init(params), 0)
    state, _ = tr.run_steps(state, seed, SEGMENT)
    _sync(state)
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        state, _ = tr.run_steps(state, seed, SEGMENT)
        _sync(state)
        walls.append((time.perf_counter() - t0) / SEGMENT * 1e3)

    def window():
        nonlocal state
        # the window's first device events can go unrecorded
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
        for _ in range(segments):
            state, _ = tr.run_steps(state, seed, SEGMENT)
        _sync(state)
        return segments * SEGMENT

    t = T.traced(window, True)
    split = {k: [round(1e3 * v["busy_ms"], 1), round(1e3 * v["idle_ms"], 1)]
             for k, v in S.split(t).items()}
    print(json.dumps({"cell": cell, "seed": seed,
                      "wall_ms_step": [round(w, 4) for w in walls],
                      "phases_us_busy_idle": split,
                      "launches": tr._graph.launches,
                      "traced_ms_step": 1e3 * t.window_s / t.units}))


if __name__ == "__main__":
    main()
