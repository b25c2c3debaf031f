"""`mipnerf360_outdoor.train16k`'s check: on the CPU, through run.py at a
cut size (the published widths, 32 rays, 16 + 16 + 8 samples, float32
products, which the CPU's products are), a sound run is correct and a
broken timed path (a state left unchanged, half of each batch left out)
is not; the direction number's own properties. On the card (`cuda`), at
the cell's own size, a sound run passes the limits and the half-batch
fault (planted in the program, and in the reference put in its place)
and the control (float8 operands) fail them.

    python -m pytest nerfbench/tests/test_nerfbench_mip360.py -q [-m cuda]
"""
import copy
import statistics

import pytest
import torch

from nerfbench import check, run
from nerfbench.runners import train_mip360 as runner
from nerfbench.tests.cut import run_cut

CELL = "mipnerf360_outdoor.train16k"


def cut_cell():
    cell = copy.deepcopy(run.load_cell(CELL))
    cfg, mix = cell["config"], cell["traffic"]
    cfg["store"]["n_rays"] = 4096
    cfg["render"].update(num_prop_samples=[16, 16], num_nerf_samples=8)
    cfg["precision"]["matmul"] = "float32"
    mix.update(batch_per_rank=32, segment_steps=2, trace_steps=2)
    return cell


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_a_broken_timed_path_is_not_correct(fault):
    line = run_cut(CELL, fault=fault, cell=cut_cell())
    assert line["correct"] is False, line["checks"]


def test_a_sound_run_is_correct_and_reads_the_direction():
    line = run_cut(CELL, cell=cut_cell())
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == set(run.load_cell(CELL)["limits"])
    assert "grad_dir_gap" in line["checks"]


def test_direction_gap_sees_directions_not_norms():
    g = torch.Generator().manual_seed(5)
    ref = {("m", f"l{i}", "w"): torch.randn(7, 5, generator=g)
           for i in range(5)}
    scaled = {n: t * (3.0 + i) for i, (n, t) in enumerate(ref.items())}
    assert runner.direction_gap(scaled, ref) < 1e-6   # f32 rounding
    assert abs(runner.direction_gap({n: -t for n, t in ref.items()}, ref)
               - 2.0) < 1e-12
    noisy = {n: t + 0.1 * torch.randn(t.shape, generator=g)
             for n, t in ref.items()}
    gap = runner.direction_gap(noisy, ref)
    assert 0.01 < gap < 0.2
    # the norms' measure sees the scale and hardly the noise
    assert (statistics.median(check.leaf_gaps(scaled, ref, ref)) > 1.0
            > statistics.median(check.leaf_gaps(noisy, ref, ref)))


@pytest.mark.cuda
def test_sound_run_passes_and_control_and_half_batch_fail_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nerfbench import calibrate_mip360 as calib
    c = run.load_cell(CELL)
    rec = calib.readings(c, 2147483659, "cuda", full=True)
    ok, checks = check.judge(rec["program"], c["limits"])
    assert ok, checks
    for name in ("half_batch", "half_batch_ref", "control"):
        ok, checks = check.judge(rec[name], c["limits"])
        assert not ok, (name, checks)
