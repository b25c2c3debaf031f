"""The readers of the program's phases (nerfbench/metrics/_spans.py and
the six metrics on it) on synthetic traces: marks, kernels and gaps with
known busy and idle times give the expected ms a unit; a trace without
marks gives None."""
import pytest

from nerfbench import run
from nerfbench import trace as T
from nerfbench.metrics import _spans as S

US = 1e-6


def mark(phase):
    return f"void nerf::mark<nerf::span::{phase}>()"


def op(name):
    return f"void at::native::{name}<float>(float*, int)"


# One training step on a packed store, in us from its first mark: each
# phase's mark, then its operations, as (name, start, end).
STEP = [
    (mark("draws"), 0, 1), (op("uniform"), 2, 6),
    (mark("batch"), 10, 11), (op("index_select"), 11, 14),
    (mark("occupied_z"), 20, 21), (op("searchsorted"), 21, 31),
    (mark("coarse"), 32, 33), (op("fwdbwd_kernel"), 33, 100),
    (mark("fine_z"), 101, 102), (op("sort"), 102, 110), (op("cat"), 110, 112),
    (mark("fine"), 115, 116), (op("fwdbwd_kernel"), 116, 200),
    (mark("optimizer"), 200, 201), (op("multi_tensor_apply"), 201, 230),
    (op("multi_tensor_apply"), 240, 250),
    (mark("tail"), 252, 253), (op("log10"), 253, 256),
    (mark("end"), 260, 261),
]
# busy and idle us of each phase of STEP
STEP_BUSY = {"draws": 4, "batch": 3, "occupied_z": 10, "coarse": 67,
             "fine_z": 10, "fine": 84, "optimizer": 39, "tail": 3}
STEP_IDLE = {"draws": 5, "batch": 6, "occupied_z": 1, "coarse": 1,
             "fine_z": 3, "fine": 0, "optimizer": 12, "tail": 4}

FRAME = [
    (mark("frame_pad"), 0, 1), (op("fill"), 1, 3),
    (mark("frame_pack"), 5, 6), (op("copy"), 6, 10),
    (mark("coarse_z"), 10, 11), (op("arange"), 11, 12),
    (mark("coarse"), 12, 13), (op("sigma_quad_kernel"), 13, 50),
    (mark("fine_z"), 50, 51), (op("sort"), 51, 60),
    (mark("fine"), 60, 61), (op("eval_quad_kernel"), 61, 150),
    (mark("frame_gather"), 150, 151), (op("cat"), 151, 155),
    (mark("frame_to_host"), 155, 156), ("Memcpy DtoH (Device -> Pageable)",
                                        156, 160),
    ("Memcpy DtoH (Device -> Pageable)", 170, 175),
    (mark("end"), 180, 181),
]


def trace_of(unit, n, period_us, ops_only=False):
    dev = []
    for k in range(n):
        for name, s, e in unit:
            if ops_only and "nerf::mark" in name:
                continue
            dev.append((name, (k * period_us + s) * US,
                        (k * period_us + e) * US))
    host = [("draws", k * period_us * US, (k * period_us + 3) * US)
            for k in range(n)]
    return T.Trace(device=dev, host=host, window_s=n * period_us * US,
                   units=n)


TRAIN = {"kind": "train"}
RENDER = {"kind": "render"}


def read(metric, tr, ctx):
    return run.reader(metric)(tr, ctx)


def test_phases_of_a_step_busy_idle_and_tiling():
    tr = trace_of(STEP, 3, 300)
    ph = S.phases(tr)
    assert [p.name for p in ph[:8]] == list(STEP_BUSY)
    assert len(ph) == 3 * 8 and S.units(tr) == 3
    for p in ph:
        assert p.busy == pytest.approx(STEP_BUSY[p.name] * US)
        assert p.idle == pytest.approx(STEP_IDLE[p.name] * US)
    # the phases from batch to end tile the step's graph interval
    for k in range(3):
        graph = [p for p in ph[8 * k:8 * k + 8] if p.name != "draws"]
        assert graph[0].start == pytest.approx((300 * k + 10) * US)
        for a, b in zip(graph, graph[1:]):
            assert a.end == b.start
        assert graph[-1].end == pytest.approx((300 * k + 260) * US)
    split = S.split(tr)
    assert split["optimizer"]["busy_ms"] == pytest.approx(0.039)
    assert split["optimizer"]["interval_ms"] == pytest.approx(0.052)
    assert split["tail"]["count"] == 3
    assert S.host_spans(tr, "draws")[1][1] == pytest.approx(300 * US)


@pytest.mark.parametrize("metric,want", [
    ("optimizer_ms.train", 0.039),
    ("sampling_ms.train", (4 + 3 + 10 + 10) * 1e-3),
    ("occupancy_ms.train", 0.010),
    ("graph_idle_ms.train", (6 + 1 + 1 + 3 + 0 + 12 + 4) * 1e-3),
])
def test_train_readers(metric, want):
    assert read(metric, trace_of(STEP, 4, 300), TRAIN) == pytest.approx(want)
    assert read(metric, trace_of(STEP, 4, 300), RENDER) is None


def test_occupancy_needs_its_phase():
    """A dense step (coarse_z in place of occupied_z) has no occupancy
    phase; its sampling counts coarse_z instead."""
    dense = [(n.replace("occupied_z", "coarse_z"), s, e) for n, s, e in STEP]
    tr = trace_of(dense, 2, 300)
    assert read("occupancy_ms.train", tr, TRAIN) is None
    assert read("sampling_ms.train", tr, TRAIN) == pytest.approx(0.027)


@pytest.mark.parametrize("metric,want", [
    ("sampling_ms.render", (1 + 9) * 1e-3),
    ("to_host_ms.render", (180 - 155) * 1e-3),
])
def test_render_readers(metric, want):
    assert read(metric, trace_of(FRAME, 3, 400), RENDER) == pytest.approx(
        want)
    assert read(metric, trace_of(FRAME, 3, 400), TRAIN) is None


@pytest.mark.parametrize("metric,ctx", [
    ("optimizer_ms.train", TRAIN), ("sampling_ms.train", TRAIN),
    ("occupancy_ms.train", TRAIN), ("graph_idle_ms.train", TRAIN),
    ("sampling_ms.render", RENDER), ("to_host_ms.render", RENDER)])
def test_no_marks_give_none(metric, ctx):
    unit = STEP if ctx is TRAIN else FRAME
    assert read(metric, trace_of(unit, 3, 400, ops_only=True), ctx) is None
    assert read(metric, T.Trace(), ctx) is None


def test_an_open_phase_and_the_time_after_end_count_for_nothing():
    """A window that closes inside a step leaves its last phase open: it
    is not counted, nor is the gap between one step's end and the next
    step's first mark."""
    tr = trace_of(STEP, 2, 1000)
    tr.device = [sp for sp in tr.device if sp[1] < (1000 + 205) * US]
    ph = S.phases(tr)
    assert [p.name for p in ph][8:] == ["draws", "batch", "occupied_z",
                                        "coarse", "fine_z", "fine"]
    assert S.units(tr) == 1
    assert sum(p.end - p.start for p in ph) == pytest.approx(
        2 * 260 * US - (260 - 200) * US)
