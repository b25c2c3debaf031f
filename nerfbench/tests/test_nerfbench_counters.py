"""The reader of the program's counters, `ray_tile_padding.train`: the
share of the training kernels' tile rows that held no point, from the
counters of nerf_pl_tpu_torch/ops/fused_train.py; None where there are none
to read."""
import sys
import types

import pytest

from nerfbench import run
from nerfbench import trace as T

MODULE = "nerf_pl_tpu_torch.ops.fused_train"
TR = T.Trace(device=[], host=[], window_s=1.0, units=1)


def read(ctx):
    return run.reader("ray_tile_padding.train")(TR, ctx)


@pytest.mark.parametrize("points,rows,pct", [
    (1024 * 128, 1024 * 160, 20.0),     # 32 + 96 samples, a ray a fine tile
    (1024 * 128, 1024 * 128, 0.0),      # whole rays in whole tiles
])
def test_padding_share_from_the_counters(monkeypatch, points, rows, pct):
    ft = types.SimpleNamespace(ray_points=points, ray_tile_rows=rows)
    monkeypatch.setitem(sys.modules, MODULE, ft)
    assert read({"kind": "train"}) == pytest.approx(pct)
    assert read({"kind": "render"}) is None


@pytest.mark.parametrize("ft", [None, types.SimpleNamespace(),
                                types.SimpleNamespace(ray_points=0,
                                                      ray_tile_rows=0)],
                         ids=["no module", "no counters", "no launch"])
def test_nothing_to_read_gives_none(monkeypatch, ft):
    if ft is None:
        monkeypatch.delitem(sys.modules, MODULE, raising=False)
    else:
        monkeypatch.setitem(sys.modules, MODULE, ft)
    assert read({"kind": "train"}) is None
