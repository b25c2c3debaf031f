"""The port's tracing, and its one device timer.

Spans and marks are on while a torch.profiler records in this process
(`tracing()`): the benchmark's traced window, the train CLI's
--profile_dir segment, chip_smoke's profiles. With no profiler recording,
a span or a mark costs a check.

  * `span(name)`: a host range on the profiler's clock, recorded as a
    `cpu_op` (torch's `_RecordFunctionFast`). Not `record_function`: on
    CUDA the profiler gives a user annotation a device-typed twin
    (`gpu_user_annotation`) that spans the kernels launched inside it, and
    a reader of the trace's device operations would count it as device
    work.
  * `mark(name, device)`: on CUDA, an empty kernel on the current stream
    whose symbol names the phase, `nerf::mark<nerf::span::<name>>`
    (csrc/marks.cu; a dot in the name is an underscore there). Marks are
    flat: on the device a phase runs from its mark to the next mark, and
    `end` closes a training step or a frame. They launch while tracing,
    outside a graph capture, and always inside `recording_marks()`, which
    gathers the nodes a capture made of them.
  * `MarkedGraph(graph, nodes)`: of a graph captured with its marks, an
    executable with them (replayed while a profiler records), after which
    the graph holds none (torch instantiates and replays it otherwise). So
    the training step is captured once, at set-up, and a replay with no
    profiler recording runs no mark.
  * `phase(name, device)`: a span whose mark launches at its start.
  * `timed(name, totals)`: a span whose host wall time also adds into
    `totals` (NeRFSystem.fit's phases; no sync is added), and
    `summary(totals)`, their table.

`cuda_event_ms` times a call on the card with CUDA events; chip_smoke.py
and `bench_kernels` both time with it.
"""
from __future__ import annotations

import contextlib
import ctypes
import time
import weakref
from typing import Callable, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

from ..ops import _build

# The phases a mark can name, in csrc/marks.cu's order (MARK_FNS): the
# training step's (`draws` outside its graph, `batch` to `tail` inside,
# `backward` on the autograd routes, `allreduce` with a data group), a
# frame's (`frame_*`, the per-tile `coarse_z` to `fine`), the culled
# renderer's `cull` and `bucket`, and `end`; then mip-NeRF 360's step
# (`batch`, `prop0`, `resample1`, `prop1`, `resample2`, `nerf`, `losses`,
# `backward`, `clip`, `optimizer`, `tail`, `end`).
MARKS = ("draws", "batch", "coarse_z", "occupied_z", "coarse", "fine_z",
         "fine", "backward", "allreduce", "optimizer", "tail", "end",
         "frame_pack", "frame_pad", "frame_gather", "frame_to_host", "cull",
         "bucket", "prop0", "resample1", "prop1", "resample2", "nerf",
         "losses", "clip")

_OFF = contextlib.nullcontext()
_recorded: Optional[List[int]] = None   # inside recording_marks()


def tracing() -> bool:
    """Whether a torch.profiler records in this process."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A host range named `name` while a profiler records (a `cpu_op`),
    else a context that does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def mark(name: str, device: torch.device) -> None:
    """Launch phase `name`'s mark on the current stream of `device`: on
    CUDA, while tracing and no graph captures, or inside
    `recording_marks()`."""
    if device.type != "cuda":
        return
    nodes = _recorded
    if nodes is None and (not _profiler._is_profiler_enabled
                          or torch.cuda.is_current_stream_capturing()):
        return
    stream = torch.cuda.current_stream(device).cuda_stream
    node = ctypes.c_void_p()
    err = _build.load_library().nerf_mark(
        MARKS.index(name.replace(".", "_")), ctypes.c_void_p(stream),
        None if nodes is None else ctypes.byref(node))
    if err:
        raise RuntimeError(f"mark {name!r}: CUDA error {err}")
    if nodes is not None and node.value:
        nodes.append(node.value)


@contextlib.contextmanager
def recording_marks():
    """Within it, every mark launches; yields the list of the graph nodes
    that a capture made of them."""
    global _recorded
    _recorded = nodes = []
    try:
        yield nodes
    finally:
        _recorded = None


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


class MarkedGraph:
    """The executable of `graph` (a torch.cuda.CUDAGraph captured with
    keep_graph=True, not yet instantiated) with its mark nodes `nodes`;
    the marks are then taken out of the graph, for torch to instantiate.
    Lives as long as `graph`'s memory pool must."""

    def __init__(self, graph: torch.cuda.CUDAGraph, nodes: List[int]):
        lib = _build.load_library()
        exe = ctypes.c_void_p()
        _check(lib.nerf_graph_split(
            ctypes.c_void_p(int(graph.raw_cuda_graph())),
            (ctypes.c_void_p * len(nodes))(*nodes), len(nodes),
            ctypes.byref(exe)), "nerf_graph_split")
        self._exe, self._graph = exe, graph
        weakref.finalize(self, lib.nerf_graph_free, exe)

    def replay(self, device: torch.device) -> None:
        """Launch the executable on the current stream of `device`."""
        _check(_build.load_library().nerf_graph_launch(
            self._exe, ctypes.c_void_p(
                torch.cuda.current_stream(device).cuda_stream)),
            "nerf_graph_launch")


class _Phase:
    __slots__ = ("name", "device", "span")

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device

    def __enter__(self):
        self.span = span(self.name)
        self.span.__enter__()
        try:
            mark(self.name, self.device)
        except BaseException:
            self.span.__exit__(None, None, None)
            raise

    def __exit__(self, *exc):
        return self.span.__exit__(*exc)


def phase(name: str, device: torch.device) -> _Phase:
    """`span(name)` with `mark(name, device)` launched at its start."""
    return _Phase(name, device)


@contextlib.contextmanager
def timed(name: str, totals: Dict[str, List]):
    """`span(name)`, whose host wall seconds and count add into
    totals[name] = [seconds, count]."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        tot = totals.setdefault(name, [0.0, 0])
        tot[0] += time.perf_counter() - t0
        tot[1] += 1


def summary(totals: Dict[str, List]) -> str:
    """The table of `timed` totals, the longest first."""
    if not totals:
        return "(no phases recorded)"
    width = max(len(k) for k in totals)
    lines = [f"{'phase'.ljust(width)} |    total |    count |     mean",
             "-" * (width + 36)]
    for name, (total, n) in sorted(totals.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{name.ljust(width)} | {total:7.2f}s | "
                     f"{n:8d} | {total / n:7.3f}s")
    return "\n".join(lines)


def cuda_event_ms(fn: Callable[[], object], reps: int = 10,
                  warmup: int = 2) -> List[float]:
    """The device time of each of `reps` calls of fn(), in ms, between two
    CUDA events on the current stream, after `warmup` calls and a sync.
    fn takes no argument: a caller that wants fresh inputs a call draws
    them from its own iterator."""
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
