"""The port's tracing (nerf_pl_tpu_torch/utils/profiling.py) on the CPU:

  * a span reaches torch.profiler as a `cpu_op`, not as a user annotation
    (which on CUDA gains a device-typed twin a trace reader would count as
    device work); outside a profiler it records nothing;
  * a mark launches only on CUDA, and there only while a profiler records
    outside a graph capture, or inside recording_marks(), which gathers
    the nodes a capture made of them; MarkedGraph hands those to the
    library's split (the library's entries are stand-ins here);
  * the training step's phases, eager on the CPU under a profiler, appear
    as host spans in the step's order, on the loss-fused and the packed
    culled routes;
  * the frame's phases through make_render_fn;
  * NeRFSystem.fit's exit summary is built from its `fit.*` spans, and
    its --profile_dir trace holds the step's spans.

This file imports no jax.
"""
import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nerf_pl_tpu_torch.config import get_opts
from nerf_pl_tpu_torch.parallel import Trainer, make_render_fn
from nerf_pl_tpu_torch.rendering import ModelConfig, RenderConfig
from nerf_pl_tpu_torch.training import (get_lr_schedule, get_optimizer,
                                        loss_dict)
from nerf_pl_tpu_torch.training.system import NeRFSystem
from nerf_pl_tpu_torch.utils import profiling as P
from nerf_pl_tpu_torch.utils.synthetic import make_blender_scene

CUDA = torch.device("cuda")
STEP = ["draws", "batch", "coarse_z", "coarse", "fine_z", "fine",
        "optimizer", "tail"]


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _events(prof):
    return list(prof.profiler.kineto_results.events())


def test_span_is_a_cpu_op_not_a_user_annotation():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert P.tracing()
        with P.span("frame.to_host"):
            torch.ones(4).sum()
    assert not P.tracing()
    found = [e for e in _events(prof) if e.name() == "frame.to_host"]
    assert len(found) == 1
    ev = found[0]
    assert str(ev.device_type()).split(".")[-1] == "CPU"
    assert not ev.is_user_annotation()
    assert ev.duration_ns() > 0
    # the same range through record_function is a user annotation
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("frame.to_host"):
            pass
    assert [e.is_user_annotation() for e in _events(prof)
            if e.name() == "frame.to_host"] == [True]


def test_span_outside_a_profiler_records_nothing():
    assert not P.tracing()
    off = P.span("draws")
    assert P.span("batch") is off
    with off:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pass
    assert not any(e.name() == "draws" for e in _events(prof))


class FakeLib:
    """The kernel library's mark and graph entries: record their calls. A
    mark on a stream being captured (`capturing`) gives node 1000 + its
    phase."""

    def __init__(self):
        self.calls = []
        self.capturing = False
        self.freed = []

    def nerf_mark(self, phase, stream, node):
        self.calls.append((P.MARKS[phase], stream.value))
        if node is not None and self.capturing:
            node._obj.value = 1000 + phase
        return 0

    def nerf_graph_split(self, graph, nodes, n, exe):
        self.calls.append(("split", graph.value, list(nodes)[:n]))
        exe._obj.value = 4242
        return 0

    def nerf_graph_launch(self, exe, stream):
        self.calls.append(("launch", exe.value, stream.value))
        return 0

    def nerf_graph_free(self, exe):
        self.freed.append(exe.value)
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(P._build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=77))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    return lib


def test_mark_launches_only_while_tracing_or_capturing_marks(fake_lib,
                                                             monkeypatch):
    """No mark outside a profiler; one while tracing, but not into a graph
    being captured; inside recording_marks() (the step's one capture)
    always, with the nodes the capture made of them gathered; never on
    the CPU."""
    P.mark("batch", CUDA)
    with P.phase("frame.to_host", CUDA):
        pass
    assert fake_lib.calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        P.mark("batch", CUDA)
        with P.phase("frame.to_host", CUDA):
            pass
        P.mark("end", torch.device("cpu"))
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        P.mark("tail", CUDA)
    assert fake_lib.calls == [("batch", 77), ("frame_to_host", 77)]
    with P.recording_marks() as nodes:
        P.mark("end", CUDA)             # not captured: no node
        fake_lib.capturing = True
        P.mark("optimizer", CUDA)
        P.mark("end", torch.device("cpu"))
    P.mark("optimizer", CUDA)
    assert fake_lib.calls[2:] == [("end", 77), ("optimizer", 77)]
    assert nodes == [1000 + P.MARKS.index("optimizer")]
    with pytest.raises(ValueError), P.recording_marks():
        P.mark("no_such_phase", CUDA)
    assert P._recorded is None


def test_marked_graph_splits_launches_and_frees(fake_lib):
    """MarkedGraph gives the raw graph and the recorded nodes to the
    library's split, launches the executable it got on the current
    stream, and frees it with the MarkedGraph."""
    import gc
    graph = types.SimpleNamespace(raw_cuda_graph=lambda: 9090)
    g = P.MarkedGraph(graph, [1001, 1011])
    g.replay(CUDA)
    assert fake_lib.calls == [("split", 9090, [1001, 1011]),
                              ("launch", 4242, 77)]
    assert fake_lib.freed == []
    del g
    gc.collect()
    assert fake_lib.freed == [4242]


def test_mark_raises_on_a_failed_launch(fake_lib, monkeypatch):
    monkeypatch.setattr(fake_lib, "nerf_mark",
                        lambda phase, stream, node: 700)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            P.mark("tail", CUDA)
    monkeypatch.setattr(fake_lib, "nerf_graph_split",
                        lambda graph, nodes, n, exe: 900)
    with pytest.raises(RuntimeError, match="nerf_graph_split: CUDA error"):
        P.MarkedGraph(types.SimpleNamespace(raw_cuda_graph=lambda: 1), [])


def test_timed_and_summary():
    totals = {}
    for _ in range(3):
        with P.timed("fit.segment", totals):
            pass
    with pytest.raises(KeyError):
        with P.timed("fit.validate", totals):
            raise KeyError("the phase raised")
    assert totals["fit.segment"][1] == 3 and totals["fit.validate"][1] == 1
    table = P.summary(totals).splitlines()
    assert table[0].split("|")[0].strip() == "phase"
    assert {ln.split("|")[0].strip() for ln in table[2:]} == {
        "fit.segment", "fit.validate"}
    assert P.summary({}) == "(no phases recorded)"


def _store(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o *= 4.0 / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-1.5, 1.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 2.0), np.full((n, 1), 6.0)],
                          1).astype(np.float32)
    return rays, rng.random((n, 3)).astype(np.float32)


def _host_spans(prof, names):
    evs = [e for e in _events(prof) if e.name() in names]
    for e in evs:
        assert str(e.device_type()).split(".")[-1] == "CPU"
        assert not e.is_user_annotation()
    return [e.name() for e in sorted(evs, key=lambda e: e.start_ns())]


@pytest.mark.parametrize("route", ["loss_fused", "culled_packed"])
def test_step_phases_are_spans_in_order(route):
    """Two eager steps on the CPU under a profiler: each step's phases as
    host spans, in the order the step runs them (occupied_z in place of
    coarse_z on the culled store); no mark runs on the CPU."""
    sched = get_lr_schedule("steplr", 1e-3, 2, 4, decay_step=[1],
                            decay_gamma=0.5)
    rcfg = RenderConfig(N_samples=8, N_importance=4, perturb=1.0,
                        noise_std=1.0, white_back=True, fused_train=True,
                        fused_loss=True)
    tr = Trainer(ModelConfig(), rcfg, get_optimizer("adam", sched), sched,
                 loss_dict["mse"], 32, "cpu")
    tr.set_data(*_store(128, 0))
    step = list(STEP)
    if route == "culled_packed":
        tr.tighten_store(np.asarray([[-1.0] * 3 + [1.0] * 3], np.float32),
                         n_seg=16, dilate=1, pack=True)
        step[2] = "occupied_z"
    state = tr.init_state(torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, m = tr.run_steps(state, 3, 2)
    assert torch.isfinite(m["loss"]).all()
    assert _host_spans(prof, set(P.MARKS)) == step * 2


def test_frame_phases_are_spans_in_order():
    rcfg = RenderConfig(N_samples=8, N_importance=8, white_back=True,
                        test_time=True)
    render = make_render_fn(rcfg, 96, "cpu")
    sched = get_lr_schedule("steplr", 1e-3, 2, 4, decay_step=[1],
                            decay_gamma=0.5)
    tr = Trainer(ModelConfig(), rcfg, get_optimizer("adam", sched), sched,
                 loss_dict["mse"], 32, "cpu")
    params = tr.init_state(torch.Generator().manual_seed(0)).params
    rays = _store(150, 1)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = render(params, rays)
    assert out["rgb_fine"].shape == (150, 3)
    tile = ["coarse_z", "coarse", "fine_z", "fine"]
    assert _host_spans(prof, {"frame.pad", "frame.pack", "frame.gather",
                              "frame.to_host", *tile}) == (
        ["frame.pad", "frame.pack"] + tile * 2
        + ["frame.gather", "frame.to_host"])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_blender_scene(str(tmp_path_factory.mktemp("scene")),
                              n_train=2, n_val=1, n_test=1, wh=(40, 40))


def _flags(scene, tmp_path, extra=()):
    return get_opts(["--dataset_name", "blender", "--root_dir", scene,
                     "--img_wh", "40", "40", "--N_samples", "8",
                     "--N_importance", "4", "--batch_size", "512",
                     "--num_epochs", "1", "--fused_train", "--scan_steps",
                     "4", "--val_chunk", "1600", "--exp_name", "p",
                     "--decay_step", "1", *extra])


def test_fit_summary_is_built_from_its_spans(scene, tmp_path, capsys):
    """A one-epoch fit under a profiler: every `fit.*` span the trace
    holds is a row of the exit summary, with its count."""
    system = NeRFSystem(_flags(scene, tmp_path), enable_tb=False,
                        log_dir=str(tmp_path / "logs"),
                        ckpt_root=str(tmp_path / "ckpts"), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        system.fit()
    spans = {}
    for e in _events(prof):
        if e.name().startswith("fit."):
            assert not e.is_user_annotation()
            spans[e.name()] = spans.get(e.name(), 0) + 1
    assert spans == {"fit.prepare_data": 1, "fit.setup": 1,
                     "fit.segment": 2, "fit.validate": 1,
                     "fit.checkpoint": 1}
    assert {k: v[1] for k, v in system.phase_totals.items()} == spans
    out = capsys.readouterr().out
    table = out.split("[profiler]\n")[1].splitlines()
    rows = {ln.split("|")[0].strip(): int(ln.split("|")[2])
            for ln in table[2:2 + len(spans)]}
    assert rows == spans


def test_profile_dir_trace_holds_the_step_spans(scene, tmp_path):
    """--profile_dir: the chrome trace of the profiled segment (the
    second) holds each of its steps' phases as CPU ops."""
    system = NeRFSystem(_flags(scene, tmp_path, (
        "--profile_dir", str(tmp_path / "prof"))), enable_tb=False,
        log_dir=str(tmp_path / "logs"), ckpt_root=str(tmp_path / "ckpts"),
        device="cpu")
    system.fit()
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("name") in STEP]
    cats = {e.get("cat") for e in events if e.get("name") in STEP}
    assert names.count("draws") == 3 and names.count("optimizer") == 3
    assert cats == {"cpu_op"}
