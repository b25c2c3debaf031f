"""The program's own phases in a traced window: its device marks and its
host spans (nerf_pl_tpu_torch/utils/profiling.py), read from the trace by
name, with no table from the program.

A mark is an empty kernel, `nerf::mark<nerf::span::<phase>>`, that the
program launches at the start of a phase of a training step or a frame.
Marks are flat: on the device a phase runs from its mark's start to the
next mark's start, and the mark `end` closes a step or a frame, so time
from an `end` to the next mark belongs to no phase (nor does a phase left
open when the window closed). Within its interval a phase has
  busy: the union of the device operations other than marks,
  idle: the interval less the union of all device operations (a mark's
        own time is neither),
and a unit (a step or a frame) is one `end` mark. A trace with no marks
(a program that has none) gives None throughout.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

from nerfbench import trace as T

MARK = re.compile(r"\bnerf::mark<nerf::span::(\w+)>")

# the training step's phases inside its replayed graph: from `batch` to
# the step's `end` (`draws` runs before it, outside the graph)
STEP_GRAPH = ("batch", "coarse_z", "occupied_z", "coarse", "fine_z", "fine",
              "backward", "allreduce", "optimizer", "tail")


@dataclass
class Phase:
    name: str
    start: float
    end: float
    busy: float = 0.0
    idle: float = 0.0


def marks(tr: T.Trace) -> List[T.Span]:
    """(phase, start, end) of each mark in the window, by start."""
    found = []
    for n, s, e in tr.device:
        m = MARK.search(n)
        if m:
            found.append((m.group(1), s, e))
    return sorted(found, key=lambda x: x[1])


def host_spans(tr: T.Trace, name: str) -> List[T.Span]:
    """The host spans named `name` (the program's span names: `frame.pack`,
    `draws`, `fit.setup`, ...), by start."""
    return sorted((sp for sp in tr.host if sp[0] == name),
                  key=lambda x: x[1])


def _merged(spans: Iterable[T.Span]) -> List[List[float]]:
    out: List[List[float]] = []
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(merged: List[List[float]], starts: List[float], a: float,
             b: float) -> float:
    """Seconds of [a, b) that the disjoint, sorted intervals cover."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < b:
        total += max(0.0, min(merged[i][1], b) - max(merged[i][0], a))
        i += 1
    return total


def phases(tr: T.Trace) -> List[Phase]:
    """Every closed phase of the window, in device order."""
    ms = marks(tr)
    if not ms:
        return []
    work = _merged(sp for sp in tr.device if not MARK.search(sp[0]))
    every = _merged(tr.device)
    w_starts = [s for s, _ in work]
    e_starts = [s for s, _ in every]
    out = []
    for (name, a, _), (_, b, _) in zip(ms, ms[1:]):
        if name == "end":
            continue
        busy = _covered(work, w_starts, a, b)
        out.append(Phase(name, a, b, busy,
                         (b - a) - _covered(every, e_starts, a, b)))
    return out


def units(tr: T.Trace) -> int:
    """Steps or frames the marks closed: the `end` marks."""
    return sum(1 for name, _, _ in marks(tr) if name == "end")


def per_unit_ms(tr: T.Trace, names: Iterable[str], what: str = "busy"
                ) -> Optional[float]:
    """ms a unit of the phases named (`what`: busy, idle, or the whole
    interval), or None if the window holds none of them or no unit."""
    names = set(names)
    picked = [p for p in phases(tr) if p.name in names]
    n = units(tr)
    if not picked or not n:
        return None
    if what == "interval":
        total = sum(p.end - p.start for p in picked)
    else:
        total = sum(getattr(p, what) for p in picked)
    return 1e3 * total / n


def split(tr: T.Trace) -> Dict[str, Dict[str, float]]:
    """{phase: {busy_ms, idle_ms, interval_ms, count}} a unit, each phase
    of the window, in the order they first appear."""
    n = max(units(tr), 1)
    out: Dict[str, Dict[str, float]] = {}
    for p in phases(tr):
        d = out.setdefault(p.name, {"busy_ms": 0.0, "idle_ms": 0.0,
                                    "interval_ms": 0.0, "count": 0})
        d["busy_ms"] += 1e3 * p.busy / n
        d["idle_ms"] += 1e3 * p.idle / n
        d["interval_ms"] += 1e3 * (p.end - p.start) / n
        d["count"] += 1
    return out
