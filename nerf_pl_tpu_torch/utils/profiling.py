"""Wall time per named phase of a training run, and the port's one
device timer.

`PhaseTimer` is the port's own copy of the one in
nerf_pl_tpu/utils/profiling.py, unchanged. (Its `trace()` wraps
jax.profiler; the port traces with torch.profiler,
`NeRFSystem._profiled_segment`.) `cuda_event_ms` times a call on the card
with CUDA events; chip_smoke.py and `bench_kernels` both time with it.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List


def cuda_event_ms(fn: Callable[[], object], reps: int = 10,
                  warmup: int = 2) -> List[float]:
    """The device time of each of `reps` calls of fn(), in ms, between two
    CUDA events on the current stream, after `warmup` calls and a sync.
    fn takes no argument: a caller that wants fresh inputs a call draws
    them from its own iterator."""
    import torch

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
    return times


class PhaseTimer:
    """Accumulate wall-clock time per phase; render a summary table."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        if not self.totals:
            return "(no phases recorded)"
        width = max(len(k) for k in self.totals)
        lines = [f"{'phase'.ljust(width)} |    total |    count |     mean",
                 "-" * (width + 36)]
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name.ljust(width)} | {total:7.2f}s | "
                         f"{n:8d} | {total / n:7.3f}s")
        return "\n".join(lines)
