"""The harness on the CPU at a cut size: the last line's keys, the checks
last; a configuration, a traffic mix and a per-layer metric added as new
files and entries only; the look for jax and the JAX package by whole
top-level names; each fault a cell can have comes out not correct."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from nerfbench import run
from nerfbench.tests.cut import cut_cell, run_cut

ROOT = Path(__file__).resolve().parents[2]


def test_last_line_has_the_five_keys_and_the_checks_last(capsys):
    line = run_cut("blender_dense.train")
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(line))
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True
    assert set(last["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        last["device"])
    # the numbers compared, each beside its limit, end stderr
    tail = out.err.strip().splitlines()[-3:]
    assert [t.split()[1] for t in tail] == list(last["checks"])


def test_traced_run_reports_busy_and_window():
    line = run_cut("blender_dense.render400", trace=1)
    assert "busy_s" in line["device"] and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["correct"] is True


def test_new_config_traffic_and_metric_are_new_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a limits file
    and a per-layer metric by new files and BENCHMARK.json entries; the
    harness finds and runs them with no other edit."""
    shutil.copytree(ROOT / "nerfbench", tmp_path / "nerfbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "nerfbench/configs/nerf_blender_dense.json")
                     .read_text())
    cfg["name"] = "nerf_blender_dense48"
    cfg["render"]["N_samples"] = 48
    (tmp_path / "nerfbench/configs/nerf_blender_dense48.json").write_text(
        json.dumps(cfg))
    mix = json.loads((ROOT / "nerfbench/traffic/train.json").read_text())
    mix["segment_steps"] = 3
    (tmp_path / "nerfbench/traffic/train_short.json").write_text(
        json.dumps(mix))
    (tmp_path / "nerfbench/limits/dense48.train_short.json").write_text(
        (ROOT / "nerfbench/limits/blender_dense.train.json").read_text())
    (tmp_path / "nerfbench/metrics/window_steps.train.py").write_text(
        "def read(tr, ctx):\n    return float(tr.units)\n")
    bench["configs"].append({"name": "nerf_blender_dense48",
                             "source": "https://github.com/kwea123/nerf_pl",
                             "file": "nerfbench/configs/"
                                     "nerf_blender_dense48.json",
                             "reduced": ["N_samples"], "why": "a test"})
    bench["workloads"].append({"name": "dense48.train_short",
                               "config": "nerf_blender_dense48",
                               "traffic": "train_short", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append("dense48.train_short")
    bench["per_layer"].append({"name": "window_steps.train", "unit": "1",
                               "better": "higher", "source": "device_trace",
                               "layer": "trainer",
                               "moves": "train_rays_per_s",
                               "workloads": ["dense48.train_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cut_cell("dense48.train_short", root=tmp_path)
    assert cell["config"]["name"] == "nerf_blender_dense48"
    assert cell["traffic"]["segment_steps"] == 2   # cut_cell's
    assert [m["name"] for m in cell["per_layer"]][-1] == "window_steps.train"
    line = run_cut("dense48.train_short", trace=1, cell=cell)
    assert line["metrics"]["window_steps.train"]["value"] == 2.0
    assert line["correct"] is True


def test_banned_modules_compare_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
            "nerf_pl_tpu", "nerf_pl_tpu.ops", "nerf_pl_tpu_torch",
            "nerf_pl_tpu_torch.ops", "jaxtyping", "flaxen", "nerfbench"]
    assert run.banned_modules(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "nerf_pl_tpu", "nerf_pl_tpu.ops"]


def test_a_run_loads_no_jax_in_a_fresh_interpreter():
    code = ("import sys\n"
            "from nerfbench.tests.cut import run_cut\n"
            "from nerfbench import run\n"
            "run_cut('blender_dense.train')\n"
            "run_cut('blender_dense.render400')\n"
            "print('BAD', run.banned_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BAD []" in proc.stdout


def test_a_rank_that_loads_jax_fails_the_run(capsys):
    """A data-parallel run's window runs in its ranks, each an interpreter
    of its own: a module of jax loaded there, which this process's look
    cannot see, ends the run with no result."""
    with pytest.raises(SystemExit) as e:
        run_cut("blender_dense.train_dp4", fault="jax_loaded")
    said = str(e.value.code)
    assert "in rank 0: ['jax']" in said and "in rank 1: ['jax']" in said
    assert "this process" not in said
    assert capsys.readouterr().out.strip() == ""


def test_run_exits_nonzero_without_cuda_or_the_program(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA exit; this machine has a card")
    argv = [sys.executable, "nerfbench/run.py", "--workload",
            "blender_dense.train", "--seed", "1", "--seconds", "1",
            "--trace", "0"]
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    # a directory with only BENCHMARK.json and the benchmark's files
    shutil.copytree(ROOT / "nerfbench", tmp_path / "nerfbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(argv, cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("cell,fault", [
    ("blender_dense.train", "frozen_state"),
    ("blender_dense.train", "half_batch"),
    ("blender_culled32.train", "frozen_state"),
    ("blender_culled32.train", "half_batch"),
    ("blender_dense.train_dp4", "frozen_state"),
    ("blender_dense.train_dp4", "half_batch"),
    ("blender_dense.train_dp4", "no_allreduce"),
    ("blender_dense.render400", "altered_answer"),
    ("blender_dense.render400", "stale_frame"),
])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    assert run_cut(cell, fault=fault)["correct"] is False


@pytest.mark.parametrize("cell", ["blender_culled32.train",
                                  "blender_dense.train_dp4"])
def test_sound_runs_are_correct(cell):
    assert run_cut(cell)["correct"] is True
