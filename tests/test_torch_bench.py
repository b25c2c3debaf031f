"""The port's bench (`python -m nerf_pl_tpu_torch.bench`) on the CPU, its
store, segments and batch shrunk (module constants; on the card it runs
the repository bench.py's full 16,000,000-ray store, 400-step segments
and batch 1024): one JSON line with bench.py's four keys for each config;
culled32's tightened store against the JAX Trainer's on the same store
and box; the flags against bench.py's; no CUDA, no run."""
import importlib.util
import json
import math
import os
import re

import numpy as np
import pytest
import torch
from test_torch_host_copies import _parser_built_by

from nerf_pl_tpu.parallel import Trainer as JTrainer
from nerf_pl_tpu.parallel import make_mesh
from nerf_pl_tpu.rendering import ModelConfig as JModelConfig
from nerf_pl_tpu.rendering import RenderConfig as JRenderConfig
from nerf_pl_tpu.training import get_lr_schedule as jsched
from nerf_pl_tpu.training import get_optimizer as jopt
from nerf_pl_tpu.training import loss_dict as jloss
from nerf_pl_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(N_RAYS=3000, STEPS=2, BATCH=64)
KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.fixture(autouse=True)
def small_bench(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(bench, k, v)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", ["dense", "culled48", "culled32"])
def test_bench_prints_one_json_line(config, capsys):
    """main(["--config", c], device="cpu") prints one JSON line on stdout
    with bench.py's keys, a positive finite rate, and the spread of the
    three timed segments on stderr; 4 segments of STEPS steps ran, every
    loss finite."""
    out = bench.main(["--config", config], device="cpu")
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == KEYS
    assert line["metric"] == "train_rays_per_sec_per_chip"
    assert line["unit"] == "rays/s"
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] == round(
        line["value"] / bench.REFERENCE_RAYS_PER_SEC, 2)
    assert out["steps"] == 4 * SMALL["STEPS"] and out["captures"] == 0
    assert len(out["spread"]) == bench.SEGMENTS
    assert len(out["losses"]) == bench.SEGMENTS * SMALL["STEPS"]
    assert np.isfinite(out["losses"]).all()
    assert f"config={config} precision=float32 on cpu: segment spread" \
        in captured.err
    assert ("culled store" in captured.err) == config.startswith("culled")


def test_culled_store_matches_jax(capsys):
    """culled32's stderr hit, shrink and expand equal the JAX Trainer's
    tighten_store on the same seeded store (bench.py's) and box, within
    1e-6."""
    bench.main(["--config", "culled32", "--precision", "bfloat16"],
               device="cpu")
    err = capsys.readouterr().err
    m = re.search(r"hit ([\d.e-]+), shrink ([\d.e-]+), expand x([\d.e-]+)",
                  err)
    assert m, err
    sched = jsched("steplr", 5e-4, 16, 1000, decay_step=[2, 4, 8],
                   decay_gamma=0.5)
    jt = JTrainer(make_mesh(num_data=1), JModelConfig(),
                  JRenderConfig(N_samples=32, N_importance=64, perturb=1.0,
                                noise_std=1.0, white_back=True,
                                fused_train=True, fused_loss=True),
                  jopt("adam", sched), sched, jloss["mse"], SMALL["BATCH"])
    jt.set_data(*bench.synthetic_store(SMALL["N_RAYS"]))
    st = jt.tighten_store(np.asarray(bench.BOX, np.float32), margin=0.1,
                          n_seg=32, dilate=1, pack=True)
    got = [float(v) for v in m.groups()]
    ref = [st["hit_frac"], st["shrink"], st["expand"]]
    assert 0 < ref[0] < 1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_bench_flags_match_bench_py(monkeypatch):
    """The same flags, dests, defaults and choices as the repository's
    bench.py."""
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(REPO, "bench.py"))
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    ours = _parser_built_by(lambda: bench.main([]), monkeypatch)._actions
    ref = _parser_built_by(root.main, monkeypatch)._actions
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert (a.option_strings, a.dest, a.default, a.nargs, a.type,
                a.choices) == (b.option_strings, b.dest, b.default, b.nargs,
                               b.type, b.choices), b.dest
    assert root.REFERENCE_RAYS_PER_SEC == bench.REFERENCE_RAYS_PER_SEC


def test_bench_needs_cuda(monkeypatch):
    """Without device="cpu" the bench runs on cuda:0, and with no CUDA
    device it raises before building a store."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "synthetic_store", lambda n: pytest.fail(
        "built a store without CUDA"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--config", "dense"])
