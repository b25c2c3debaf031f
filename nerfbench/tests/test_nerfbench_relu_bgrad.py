"""The reader of `relu_bgrad_roofline.mip360`: a step's ReLU-backward bytes
at the cell's configuration, the share it reads from a trace, and None
where there is nothing to read (no launch count, no launch, another
runner, no such kernel in the trace)."""
import importlib.util
import sys
import types

import pytest

from nerfbench import run
from nerfbench import trace as T
from nerfbench.work_mip360 import train_step_work

CELL = "mipnerf360_outdoor.train16k"
METRIC = "relu_bgrad_roofline.mip360"


def _module():
    path = run.ROOT / "nerfbench" / "metrics" / f"{METRIC}.py"
    spec = importlib.util.spec_from_file_location("relu_bgrad_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(kind="train_mip360"):
    cell = run.load_cell(CELL)
    return {"kind": kind, "model": cell["config"]["model"], "world": 1,
            "unit": train_step_work(cell["config"],
                                    cell["traffic"]["batch_per_rank"])}


def test_the_cells_step_moves_39_gb():
    """8 NeRF layers x 1024 and the view layer's 128 at 524,288 points, 4
    proposal layers x 256 at 2,097,152: 6,509,559,808 values, 6 bytes
    each."""
    mod, ctx = _module(), _ctx()
    assert ctx["unit"]["prop_points"] == 2_097_152
    assert ctx["unit"]["nerf_points"] == 524_288
    assert mod.relu_values(ctx["model"], ctx["unit"]) == 6_509_559_808
    assert mod.least_s(ctx["model"], ctx["unit"]) * 3.35e12 == \
        pytest.approx(39_057_358_848)
    assert METRIC in {m["name"] for m in run.load_cell(CELL)["per_layer"]}


@pytest.fixture
def launched(monkeypatch):
    monkeypatch.setitem(sys.modules, "nerf_pl_tpu_torch.ops.relu_bgrad",
                        types.SimpleNamespace(relu_bgrad_launches=17))


def _trace(units, seconds_a_step):
    """relu_bgrad's two kernels taking seconds_a_step a step, between
    products that do not count."""
    dev = []
    for i in range(units):
        t = float(i)
        dev += [("void nerf::relu_bgrad::relu_bgrad_kernel<8>(...)", t,
                 t + 0.9 * seconds_a_step),
                ("void nerf::relu_bgrad::relu_bgrad_sum_kernel(...)", t + 0.5,
                 t + 0.5 + 0.1 * seconds_a_step),
                ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", t + 0.6,
                 t + 0.7)]
    return T.Trace(device=dev, host=[], window_s=float(units), units=units)


@pytest.mark.parametrize("units", [1, 40])
def test_share_of_the_least_time(launched, units):
    mod, ctx = _module(), _ctx()
    least = mod.least_s(ctx["model"], ctx["unit"])
    read = run.reader(METRIC)
    assert read(_trace(units, least / 0.8), ctx) == pytest.approx(80.0)
    assert read(_trace(units, least), ctx) == pytest.approx(100.0)


@pytest.mark.parametrize("case", ["no module", "no counter", "no launch",
                                  "another runner", "no kernel",
                                  "no units"])
def test_nothing_to_read_gives_none(monkeypatch, case):
    name = "nerf_pl_tpu_torch.ops.relu_bgrad"
    mod = {"no module": None, "no counter": types.SimpleNamespace(),
           "no launch": types.SimpleNamespace(relu_bgrad_launches=0)
           }.get(case, types.SimpleNamespace(relu_bgrad_launches=17))
    if mod is None:
        monkeypatch.delitem(sys.modules, name, raising=False)
    else:
        monkeypatch.setitem(sys.modules, name, mod)
    tr = _trace(2, 0.01)
    if case == "no kernel":
        tr.device = [s for s in tr.device if "relu_bgrad" not in s[0]]
    if case == "no units":
        tr.units = 0
    ctx = _ctx("train" if case == "another runner" else "train_mip360")
    assert run.reader(METRIC)(tr, ctx) is None
