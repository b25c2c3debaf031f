"""One torch.profiler window over the steady state, reduced to what the
per-layer metrics read: the device's operations (name, start, end), the
host's operations, the window's length on the host clock, and the units
of work (steps or frames) it held.

Device and host timestamps come from the profiler's one clock, so a gap
between device operations can be named by the host operation that was
running across it.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# The program's hand-written kernels: its csrc's __global__ functions
HANDWRITTEN = re.compile(
    r"\b(fwdbwd_kernel|fwd_quad_kernel|eval_quad_kernel|sigma_quad_kernel|"
    r"mlp_fwd_kernel|point_fwdbwd_kernel|sigma_fwd_kernel|wgrad_kernel|"
    r"sum_slots|sum_rows)\b")
COLLECTIVE = re.compile(r"nccl", re.IGNORECASE)

Span = Tuple[str, float, float]     # name, start s, end s


@dataclass
class Trace:
    device: List[Span] = field(default_factory=list)
    host: List[Span] = field(default_factory=list)
    window_s: float = 0.0
    units: int = 0          # steps or frames in the window


def union_s(spans: List[Span]) -> float:
    """Seconds covered by at least one span."""
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_s(spans: List[Span], pattern: Optional[re.Pattern] = None,
             exclude: Tuple[re.Pattern, ...] = ()) -> float:
    """Summed duration of the device spans whose name matches `pattern`
    (all when None) and none of `exclude`."""
    return sum(e - s for n, s, e in spans
               if (pattern is None or pattern.search(n))
               and not any(x.search(n) for x in exclude))


def _ns(ev, what: str) -> float:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return float(fn())
    return 1e3 * float(getattr(ev, f"{what}_us")())


def _spans(prof) -> Tuple[List[Span], List[Span]]:
    """(device spans, host spans) of a finished profile, in seconds."""
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        end = start + float(ev.duration_ns()) if hasattr(
            ev, "duration_ns") else _ns(ev, "end")
        kind = str(ev.device_type()).split(".")[-1].upper()
        span = (ev.name(), start * 1e-9, end * 1e-9)
        (dev if kind == "CUDA" else host).append(span)
    return dev, host


def traced(fn: Callable[[], int], cuda: bool) -> Trace:
    """Run fn() (which syncs the device at its end and returns the units
    of work it did) under torch.profiler; the window is fn's length on the
    host clock, taken inside the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        units = fn()
        window = time.perf_counter() - t0
    dev, host = _spans(prof)
    return Trace(device=dev, host=host, window_s=window, units=units)


def breakdown(tr: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, by name, and the
    longest idle gaps between device operations, each named by the
    innermost host operation running across the gap's middle."""
    by_name: Dict[str, float] = {}
    for n, s, e in tr.device:
        by_name[n[:160]] = by_name.get(n[:160], 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    end = None
    for _, s, e in sorted(tr.device, key=lambda x: x[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        inside = [(he - hs, n) for n, hs, he in tr.host if hs <= mid <= he]
        named.append([min(inside)[1][:160] if inside else "host: no op",
                      e - s])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
