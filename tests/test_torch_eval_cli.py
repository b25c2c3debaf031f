"""The port's eval CLI, checkpoint loading and metrics against the JAX
package's: one checkpoint written by the JAX package renders the same
images through both CLIs."""
import json
import os
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
                                 "--metrics_out", str(tmp_path / "m.json")])
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


def test_parsers_share_flags_and_defaults():
    import eval as jeval
    argv = ["--root_dir", "r", "--ckpt_path", "c"]
    assert vars(teval.get_opts(argv)) == vars(jeval.get_opts(argv))


@pytest.mark.parametrize("extra", [["--occ_grid"], ["--occ_budgets"],
                                   ["--occ_segments", "8"],
                                   ["--num_chips", "2"]])
def test_unported_flags_rejected(extra, capsys):
    with pytest.raises(SystemExit):
        teval.main(["--root_dir", "r", "--ckpt_path", "c"] + extra)
    assert "ROADMAP" in capsys.readouterr().err


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
