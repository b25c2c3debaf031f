"""On the card, at each cell's own size: the control (the reference put
in the program's place with float8 e4m3 operands, the precision below the
configuration's bf16 products) and the half-batch fault come out not
correct under the cell's limits; a sound short run of each one-card cell
comes out correct. Marked `cuda`; each test skips without a card.

    python -m pytest nerfbench/tests -q -m cuda
"""
import time

import pytest

from nerfbench import check, run

pytestmark = pytest.mark.cuda


def _need_cards(n=1):
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA card(s)")


@pytest.mark.parametrize("cell", ["blender_dense.train",
                                  "blender_culled32.train",
                                  "blender_dense.train_dp4",
                                  "blender_dense.render400"])
def test_control_and_faults_fail_the_limits(cell):
    _need_cards()
    from nerfbench import calibrate
    c = run.load_cell(cell)
    readings = calibrate.control_numbers(c, 2147483659, "cuda")
    for name, numbers in readings.items():
        ok, _ = check.judge(numbers, c["limits"])
        assert not ok, (name, numbers)


@pytest.mark.parametrize("cell", ["blender_dense.train",
                                  "blender_culled32.train",
                                  "blender_dense.render400"])
def test_a_sound_short_run_is_correct(cell):
    _need_cards()
    import importlib
    c = run.load_cell(cell)
    runner = importlib.import_module(
        f"nerfbench.runners.{c['traffic']['runner']}")
    res = runner.run(c, 2147483671, 0.5, False, time.time(), device="cuda")
    ok, checks = check.judge(res["numbers"], c["limits"])
    assert ok and res["failed"] == 0, checks
