"""The port's eval CLI, checkpoint loading and metrics against the JAX
package's: one checkpoint written by the JAX package renders the same
images through both CLIs."""
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.parallel.spmd import TrainState
from nerf_pl_tpu.training.checkpoints import (save_checkpoint,
                                              save_weights_only)
from nerf_pl_tpu.utils.synthetic import make_blender_scene
from nerf_pl_tpu_torch import eval as teval
from nerf_pl_tpu_torch.models import init_nerf_params
from nerf_pl_tpu_torch.training.checkpoints import load_ckpt
from nerf_pl_tpu_torch.training.metrics import psnr, ssim
from test_metrics_golden import _pair, torch_ssim_reference


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_blender_scene(
        str(tmp_path_factory.mktemp("scene")), n_train=3, n_val=1,
        n_test=2, wh=(20, 20))


@pytest.fixture(scope="module")
def jax_params():
    kc, kf = jax.random.split(jax.random.PRNGKey(0))
    return {"nerf_coarse": jinit(kc), "nerf_fine": jinit(kf)}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, jax_params):
    """A full train-state checkpoint written by the JAX package."""
    import jax.numpy as jnp
    path = str(tmp_path_factory.mktemp("ck") / "full.ckpt")
    save_checkpoint(path, TrainState(jax_params, {"mu": jax_params},
                                     jnp.zeros([], jnp.int32)))
    return path


def _template():
    g = torch.Generator().manual_seed(1)
    return {"nerf_coarse": init_nerf_params(g), "nerf_fine": init_nerf_params(g)}


def _assert_loaded(params, jax_params, model):
    for layer, leaves in jax_params[model].items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(params[model][layer][leaf].numpy(),
                                          np.asarray(v))


def test_load_ckpt_reads_jax_checkpoints(ckpt, jax_params, tmp_path):
    params = load_ckpt(_template(), ckpt, "nerf_coarse")
    params = load_ckpt(params, ckpt, "nerf_fine")
    for model in ("nerf_coarse", "nerf_fine"):
        _assert_loaded(params, jax_params, model)
    # a weights-only export ("{model}/..." keys) loads the same way
    slim = str(tmp_path / "slim.ckpt")
    save_weights_only(ckpt, slim)
    _assert_loaded(load_ckpt(_template(), slim, "nerf_fine"), jax_params,
                   "nerf_fine")


def test_load_ckpt_partial_and_errors(ckpt, jax_params):
    tmpl = _template()
    params = load_ckpt(tmpl, ckpt, "nerf_coarse", prefixes_to_ignore=("rgb",))
    assert torch.equal(params["nerf_coarse"]["rgb"]["w"],
                       tmpl["nerf_coarse"]["rgb"]["w"])
    np.testing.assert_array_equal(params["nerf_coarse"]["dir"]["w"].numpy(),
                                  np.asarray(jax_params["nerf_coarse"]["dir"]
                                             ["w"]))
    with pytest.raises(KeyError):
        load_ckpt(tmpl, ckpt, "nerf_missing")
    bad = _template()
    bad["nerf_coarse"]["xyz_0"]["w"] = torch.zeros(5, 5)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_ckpt(bad, ckpt, "nerf_coarse")


def test_eval_cli_matches_jax_cli(scene, ckpt, tmp_path):
    import eval as jeval
    flags = ["--root_dir", scene, "--dataset_name", "blender",
             "--img_wh", "20", "20", "--N_samples", "8",
             "--N_importance", "4", "--chunk", "256", "--ckpt_path", ckpt,
             "--fused_mlp", "--save_depth", "--save_gt"]
    psnr_j = jeval.main(flags + ["--scene_name", "s",
                                 "--out_dir", str(tmp_path / "jax")])
    psnr_t = teval.main(flags + ["--scene_name", "s",
                                 "--out_dir", str(tmp_path / "torch"),
                                 "--metrics_out", str(tmp_path / "m.json")],
                        device="cpu")
    assert np.isfinite(psnr_t) and abs(psnr_t - psnr_j) <= 0.05
    dj = tmp_path / "jax" / "blender" / "s"
    dt = tmp_path / "torch" / "blender" / "s"
    for name in ("000.png", "001.png", "gt_000.png"):
        a = np.asarray(Image.open(dj / name), np.int16)
        b = np.asarray(Image.open(dt / name), np.int16)
        assert np.abs(a - b).max() <= 3, name
    assert (dt / "s.gif").exists() and (dt / "depth_001.pfm").exists()
    with open(tmp_path / "m.json") as f:
        m = json.load(f)
    assert len(m["per_view"]) == m["n_views"] == 2
    assert abs(m["mean_psnr"] - psnr_t) < 1e-3
    assert m["flags"]["fused_mlp"] is True


def test_main_needs_cuda_unless_given_a_device(scene, ckpt, tmp_path,
                                              monkeypatch):
    """No device argument means cuda:0: without CUDA, main raises instead
    of rendering on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = ["--root_dir", scene, "--img_wh", "20", "20", "--N_samples",
             "8", "--N_importance", "4", "--ckpt_path", ckpt,
             "--out_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(flags)
    assert not (tmp_path / "blender").exists()


# the port's eval flags after every eval.py flag: mip-NeRF 360's model
EVAL_PORT_FLAGS = ("model", "mip_prop_width", "mip_nerf_width",
                   "mip_prop_samples", "mip_nerf_samples")


def test_parsers_share_flags_and_defaults():
    """Every eval.py flag with its default, then exactly the port's own
    (EVAL_PORT_FLAGS)."""
    import eval as jeval
    argv = ["--root_dir", "r", "--ckpt_path", "c"]
    ours, want = vars(teval.get_opts(argv)), vars(jeval.get_opts(argv))
    assert {k: ours[k] for k in want} == want
    assert tuple(k for k in ours if k not in want) == EVAL_PORT_FLAGS


@pytest.fixture(scope="module")
def scene3(tmp_path_factory):
    """Three test views: with --frames_per_dispatch 2 the last group is
    padded."""
    return make_blender_scene(
        str(tmp_path_factory.mktemp("scene3")), n_train=3, n_val=1,
        n_test=3, wh=(20, 20))


@pytest.fixture(scope="module")
def occ_ckpt(tmp_path_factory, jax_params):
    """jax_params with both sigma heads x50: raw sigma in about +-0.3
    over [-1.5, 1.5]^3, so a threshold of 0.3 occupies part of the grid."""
    import jax.numpy as jnp
    params = jax.tree_util.tree_map(np.asarray, jax_params)
    for mlp in params.values():
        mlp["sigma"]["w"] = mlp["sigma"]["w"] * 50
    path = str(tmp_path_factory.mktemp("occ") / "occ.ckpt")
    save_checkpoint(path, TrainState(params, {"mu": params},
                                     jnp.zeros([], jnp.int32)))
    return path


def test_culled_eval_cli_matches_jax_cli(scene3, occ_ckpt, tmp_path, capsys,
                                         monkeypatch):
    """--occ_grid with tighten, budgets and 8 segments through both CLIs on
    one checkpoint: the same grid (boxes, occupied share strictly between 0
    and 1), PSNR within 0.05 dB, PNGs within 3 levels; the last dispatch
    is padded to 2 frames, as eval.py pads it. Unfused: with the x50 sigma
    heads the fused bf16 paths of the two packages part on a ray whose
    last fine sample has sigma +0.0021 in f32 (the infinite last interval
    turns its sign into opacity 1 or 0.04); tests/test_torch_culled.py
    holds the fused culled render against JAX's."""
    import eval as jeval
    from nerf_pl_tpu_torch.rendering import occupancy as tocc
    flags = ["--root_dir", scene3, "--dataset_name", "blender",
             "--img_wh", "20", "20", "--N_samples", "8",
             "--N_importance", "4", "--chunk", "256", "--ckpt_path",
             occ_ckpt, "--occ_grid", "--occ_tighten",
             "--occ_budgets", "--occ_segments", "8", "--occ_threshold=0.3",
             "--occ_range", "-1.5", "1.5", "--occ_N", "32",
             "--frames_per_dispatch", "2", "--culled_chunk", "64",
             "--scene_name", "s"]
    psnr_j = jeval.main(flags + ["--out_dir", str(tmp_path / "jax")])
    out_j = capsys.readouterr().out
    seen = []
    call = tocc.CulledRenderer.__call__

    def counting(self, params, rays, **kw):
        seen.append(len(rays))
        return call(self, params, rays, **kw)

    monkeypatch.setattr(tocc.CulledRenderer, "__call__", counting)
    psnr_t = teval.main(flags + ["--out_dir", str(tmp_path / "torch")],
                        device="cpu")
    out_t = capsys.readouterr().out
    grid = [re.search(r"^\[occ\] (\d+) boxes, ([\d.]+)% blocks occupied",
                      out, re.M).groups() for out in (out_j, out_t)]
    assert grid[0] == grid[1] and 0 < float(grid[1][1]) < 100, grid
    assert "cached to" in out_t and ".torch_occ." in out_t
    assert seen == [800, 800]
    assert np.isfinite(psnr_t) and abs(psnr_t - psnr_j) <= 0.05
    dj = tmp_path / "jax" / "blender" / "s"
    dt = tmp_path / "torch" / "blender" / "s"
    for name in ("000.png", "001.png", "002.png"):
        a = np.asarray(Image.open(dj / name), np.int16)
        b = np.asarray(Image.open(dt / name), np.int16)
        assert np.abs(a - b).max() <= 3, name


@pytest.mark.parametrize("seed,noise", [(0, 0.0), (1, 0.02), (2, 0.1),
                                        (3, 0.5), (4, 1.0)])
def test_ssim_matches_golden(seed, noise):
    pred, gt = _pair(seed, noise=noise)
    ours = float(ssim(torch.from_numpy(pred), torch.from_numpy(gt)))
    golden = torch_ssim_reference(torch.from_numpy(pred),
                                  torch.from_numpy(gt))
    assert abs(ours - golden) < 1e-5, (ours, golden)
    assert float(ssim(torch.from_numpy(pred[0]), torch.from_numpy(gt[0]))) \
        == pytest.approx(ours, abs=1e-7)


def test_psnr_matches_jax():
    from nerf_pl_tpu.training.metrics import psnr as jpsnr
    pred, gt = _pair(5, noise=0.1)
    assert float(psnr(torch.from_numpy(pred), torch.from_numpy(gt))) == \
        pytest.approx(float(jpsnr(pred, gt)), abs=1e-5)
