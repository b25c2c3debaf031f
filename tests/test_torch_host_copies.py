"""The port's copies of the JAX package's host code agree with the originals.

  * the train parser: every option string, dest and default equal, and
    validate_hparams raising or warning on the same flag sets;
  * the synthetic scenes: the port's make_blender_scene (40x40) and
    make_llff_scene (40x30) write the same files, byte for byte;
  * BlenderDataset and LLFFDataset on those scenes: all_rays and all_rgbs
    of the train split, and every val item's rays and rgbs, bit-identical;
  * the ray, pose and depth utilities, visualize_depth and PhaseTimer on
    seeded inputs.
"""
import argparse
import os
import warnings

import numpy as np
import pytest

from nerf_pl_tpu import config as jconfig
from nerf_pl_tpu.datasets import dataset_dict as jdatasets
from nerf_pl_tpu.datasets import depth_utils as jdepth
from nerf_pl_tpu.datasets import pose_utils as jpose
from nerf_pl_tpu.datasets import ray_utils as jray
from nerf_pl_tpu.utils import synthetic as jsyn
from nerf_pl_tpu.utils.profiling import PhaseTimer as JPhaseTimer
from nerf_pl_tpu.utils.visualization import visualize_depth as jvis
from nerf_pl_tpu_torch import config as tconfig
from nerf_pl_tpu_torch.datasets import dataset_dict as tdatasets
from nerf_pl_tpu_torch.datasets import depth_utils as tdepth
from nerf_pl_tpu_torch.datasets import pose_utils as tpose
from nerf_pl_tpu_torch.datasets import ray_utils as tray
from nerf_pl_tpu_torch.utils import synthetic as tsyn
from nerf_pl_tpu_torch.utils.profiling import PhaseTimer as TPhaseTimer
from nerf_pl_tpu_torch.utils.visualization import visualize_depth as tvis


class _Parsed(Exception):
    pass


def _parser_of(get_opts, monkeypatch):
    """The ArgumentParser that get_opts builds, caught at parse_args."""
    def catch(self, *a, **k):
        raise _Parsed(self)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed) as e:
            get_opts([])
    return e.value.args[0]


def test_parser_flags_and_defaults_match(monkeypatch):
    ours = _parser_of(tconfig.get_opts, monkeypatch)._actions
    ref = _parser_of(jconfig.get_opts, monkeypatch)._actions
    assert len(ours) == len(ref) > 50
    for a, b in zip(ours, ref):
        assert (a.option_strings, a.dest, a.default, a.nargs, a.type,
                a.choices) == (b.option_strings, b.dest, b.default, b.nargs,
                               b.type, b.choices), b.dest
    assert (tconfig.Hparams().__dict__ == jconfig.Hparams().__dict__)
    argv = ["--fused_train", "--img_wh", "40", "40", "--decay_step", "2", "4",
            "--num_chips", "1", "--occ_range", "-1", "1"]
    assert vars(tconfig.get_opts(argv)) == vars(jconfig.get_opts(argv))


VALIDATE_CASES = {
    "default": {},
    "batch_not_divisible": dict(batch_size=1000, num_gpus=3),
    "fused_train_ragged": dict(fused_train=True, batch_size=1020),
    "fused_train_bf16": dict(fused_train=True, precision="bfloat16"),
    "fused_train_other_loss": dict(fused_train=True, loss_type="l1"),
    "occ_never_active": dict(occ_train=True, occ_warmup_epochs=20),
    "occ_range": dict(occ_train=True, occ_range=(1.0, 2.0, 3.0)),
    "occ_segments": dict(occ_train=True, occ_segments=33),
    "occ_disp": dict(occ_train=True, use_disp=True),
    "occ_dilate": dict(occ_train=True, occ_dilate=-1),
    "occ_keepalive": dict(occ_train=True, occ_keepalive=1.0),
    "occ_keepalive_no_segments": dict(occ_train=True, occ_keepalive=0.1,
                                      occ_segments=0),
    "occ_mode": dict(occ_train=True, occ_mode="grid"),
    "occ_pack_alone": dict(occ_pack=True),
    "val_every_negative": dict(val_every_steps=-1),
}


def _validate(mod, kwargs):
    """(the ValueError's message or None, the warning messages)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            mod.validate_hparams(mod.Hparams(**kwargs))
            err = None
        except ValueError as e:
            err = str(e)
    return err, [str(w.message) for w in caught]


@pytest.mark.parametrize("case", list(VALIDATE_CASES))
def test_validate_hparams_matches(case):
    kwargs = VALIDATE_CASES[case]
    ours, ref = _validate(tconfig, kwargs), _validate(jconfig, kwargs)
    assert ours == ref
    if case != "default":
        assert ref[0] or ref[1], "the case must raise or warn"


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same two scenes written by the JAX package and by the port."""
    root = tmp_path_factory.mktemp("scenes")
    out = {}
    for tag, syn in (("jax", jsyn), ("port", tsyn)):
        out[tag] = {
            "blender": syn.make_blender_scene(str(root / tag / "blender"),
                                              n_train=3, n_val=2, n_test=1,
                                              wh=(40, 40)),
            "llff": syn.make_llff_scene(str(root / tag / "llff"),
                                        n_images=4, wh=(40, 30))}
    return out


@pytest.mark.parametrize("kind", ["blender", "llff"])
def test_synthetic_scenes_are_byte_identical(scenes, kind):
    a, b = scenes["port"][kind], scenes["jax"][kind]
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files and files == sorted(os.path.relpath(os.path.join(d, f), b)
                                     for d, _, fs in os.walk(b) for f in fs)
    for f in files:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


def _dataset_kwargs(kind):
    if kind == "blender":
        return {"img_wh": (40, 40)}
    return {"img_wh": (40, 30), "spheric_poses": False, "val_num": 2}


@pytest.mark.parametrize("kind", ["blender", "llff"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_datasets_are_bit_identical(scenes, kind, split):
    root = scenes["port"][kind]
    ours = tdatasets[kind](root, split=split, **_dataset_kwargs(kind))
    ref = jdatasets[kind](root, split=split, **_dataset_kwargs(kind))
    assert ours.white_back == ref.white_back
    assert len(ours) == len(ref) > 0
    if split == "train":
        pairs = [(ours.all_rays, ref.all_rays), (ours.all_rgbs, ref.all_rgbs)]
    else:
        pairs = [(ours[i][k], ref[i][k]) for i in range(len(ref))
                 for k in ("rays", "rgbs")]
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_ray_and_pose_utils_match(rng):
    dirs = jray.get_ray_directions(6, 8, 7.5)
    assert np.array_equal(tray.get_ray_directions(6, 8, 7.5), dirs)
    c2w = jsyn.look_at_pose(rng.normal(size=3) * 4)
    assert np.array_equal(tsyn.look_at_pose(c2w[:, 3]), c2w)
    o, d = jray.get_rays(dirs, c2w)
    for a, b in zip(tray.get_rays(dirs, c2w), (o, d)):
        assert np.array_equal(a, b)
    o[:, 2] -= 5.0
    for a, b in zip(tray.get_ndc_rays(6, 8, 7.5, 1.0, o, d),
                    jray.get_ndc_rays(6, 8, 7.5, 1.0, o, d)):
        assert np.array_equal(a, b)
    poses = np.stack([jsyn.look_at_pose(rng.normal(size=3) + [0, 0, 4])
                      for _ in range(5)])
    for a, b in zip(tpose.center_poses(poses), jpose.center_poses(poses)):
        assert np.array_equal(a, b)
    assert np.array_equal(tpose.create_spiral_poses(np.ones(3), 3.5),
                          jpose.create_spiral_poses(np.ones(3), 3.5))
    assert np.array_equal(tpose.create_spheric_poses(1.5),
                          jpose.create_spheric_poses(1.5))


def test_depth_io_visualization_and_timer_match(rng, tmp_path):
    depth = rng.uniform(2, 6, (7, 9)).astype(np.float32)
    tdepth.save_pfm(str(tmp_path / "t.pfm"), depth)
    jdepth.save_pfm(str(tmp_path / "j.pfm"), depth)
    assert ((tmp_path / "t.pfm").read_bytes()
            == (tmp_path / "j.pfm").read_bytes())
    data, scale = tdepth.read_pfm(str(tmp_path / "j.pfm"))
    assert np.array_equal(data, depth) and scale == 1.0
    assert np.array_equal(tvis(depth), jvis(depth))
    timers = (TPhaseTimer(), JPhaseTimer())
    for t in timers:
        with t.phase("a"):
            pass
    assert [dict(t.counts) for t in timers] == [{"a": 1}, {"a": 1}]
