"""The port's render_image and bench_render entry points on the CPU, on a
20x20 synthetic scene and a JAX-written checkpoint whose sigma heads are
x50 (raw sigma about +-0.3 in [-1.5, 1.5]^3, so a threshold of 0.3
occupies part of the grid): bench_render's dense, cull and segments rows
against the JAX package's script on the same frame and grid (counts
equal, PSNR against dense and against the ground truth within 0.05 dB),
and the outputs written."""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.parallel.spmd import TrainState
from nerf_pl_tpu.training.checkpoints import save_checkpoint
from nerf_pl_tpu.utils.synthetic import make_blender_scene
from nerf_pl_tpu_torch import bench_kernels, bench_render, render_image

GRID = ["--occ_threshold=0.3", "--occ_range", "-1.5", "1.5", "--occ_N",
        "32"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_blender_scene(str(tmp_path_factory.mktemp("scene")),
                              n_train=2, n_val=1, n_test=1, wh=(20, 20))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    kc, kf = jax.random.split(jax.random.PRNGKey(0))
    params = {"nerf_coarse": jinit(kc), "nerf_fine": jinit(kf)}
    params = jax.tree_util.tree_map(np.asarray, params)
    for mlp in params.values():
        mlp["sigma"]["w"] = mlp["sigma"]["w"] * 50
    path = str(tmp_path_factory.mktemp("ck") / "x50.ckpt")
    save_checkpoint(path, TrainState(params, {"mu": params},
                                     jnp.zeros([], jnp.int32)))
    return path


def test_bench_render_counts_match_jax(scene, ckpt, tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    import bench_render as jbench
    flags = ["--root_dir", scene, "--ckpt_path", ckpt, "--img_wh", "20",
             "20", "--N_samples", "8", "--N_importance", "4", "--chunk",
             "256", "--culled_chunk", "64", "--occ_mode", "sigma",
             "--repeats", "1", "--configs", "dense", "cull",
             "segments"] + GRID
    ref = jbench.main(flags)
    out = bench_render.main(flags + ["--json_out", str(tmp_path / "m.json")],
                            device="cpu")
    with open(tmp_path / "m.json") as f:
        assert json.load(f) == out
    assert [r["config"] for r in out["rows"]] == ["dense", "cull",
                                                  "segments"]
    assert out["grid_boxes"] == ref["grid_boxes"]
    for row, jrow in zip(out["rows"], ref["rows"]):
        for k in ("n_survivors", "n_rendered", "bucket_counts"):
            assert row.get(k) == jrow.get(k), (row["config"], k)
        assert row["secs_frame_best"] > 0
        for k in ("psnr_vs_dense", "psnr_vs_gt"):
            assert abs(row.get(k, 0.0) - jrow.get(k, 0.0)) <= 0.05, k
    assert 0 < out["rows"][1]["n_survivors"] < 400


def test_render_image_culled(scene, ckpt, tmp_path, capsys):
    flags = ["--root_dir", scene, "--ckpt_path", ckpt, "--img_wh", "20",
             "20", "--N_samples", "8", "--N_importance", "4", "--fused_mlp",
             "--occ_grid", "--occ_budgets", "--occ_segments", "8",
             "--culled_chunk", "64", "--out_dir", str(tmp_path)] + GRID
    dt = render_image.main(flags, device="cpu")
    printed = capsys.readouterr().out
    assert dt > 0 and "culled " in printed and "buckets [" in printed
    assert "PSNR: " in printed
    for name in ("render_000.png", "depth_000.png"):
        assert (tmp_path / name).exists()


def test_bench_kernels_needs_cuda(monkeypatch):
    """bench_kernels times the CUDA kernels on cuda:0 and raises without
    CUDA, rather than timing the plain versions on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_kernels.main(["--n_rays", "64", "--s", "8"])

