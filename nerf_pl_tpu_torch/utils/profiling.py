"""Wall time per named phase of a training run.

The port's own copy of `PhaseTimer` from nerf_pl_tpu/utils/profiling.py,
unchanged. (Its `trace()` wraps jax.profiler; the port traces with
torch.profiler, `NeRFSystem._profiled_segment`.)
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


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
