"""The port's mesh CLI and its other script modules against the JAX
package's scripts, on the same inputs:

  * extract_color_mesh on one checkpoint (tests/test_system_extra.py's
    TestVertexNormalMesh weights: the JAX init with the sigma head x50,
    +2), N_grid 24, on a 16x16 scene, with the default fusion and
    --export_vol, and with --use_vertex_normal --mesh_format dae: the same
    triangles, vertices within 1e-4 (f32 sigma summed in another order
    moves a marching-cubes vertex by its share of the edge), colours
    within 1 of 255, and the .vol's voxels the same with each byte
    within 1;
  * save_weights_only writes the same keys and arrays;
  * preview_bounds prints the same bounds and writes identical PNGs;
  * render_hard_scene_rgba is byte-identical, and make_hard_datasets writes
    the same files at small sizes;
  * northstar uses the same regexes, launches the port's train CLI by
    default, and on SIGTERM kills its child and writes the partial JSON.
"""
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import extract_color_mesh as jmesh_cli  # noqa: E402
from nerf_pl_tpu.mesh.dae import read_dae as jread_dae  # noqa: E402
from nerf_pl_tpu.mesh.ply import read_ply as jread_ply  # noqa: E402
from nerf_pl_tpu.models import init_nerf_params as jinit  # noqa: E402
from nerf_pl_tpu.parallel.spmd import TrainState  # noqa: E402
from nerf_pl_tpu.training.checkpoints import (  # noqa: E402
    save_checkpoint, save_weights_only)
from nerf_pl_tpu.utils import synthetic as jsyn  # noqa: E402
from nerf_pl_tpu_torch import extract_color_mesh as tmesh_cli  # noqa: E402
from nerf_pl_tpu_torch import make_hard_datasets as tmake_hard  # noqa: E402
from nerf_pl_tpu_torch import northstar as tnorthstar  # noqa: E402
from nerf_pl_tpu_torch import preview_bounds as tpreview  # noqa: E402
from nerf_pl_tpu_torch import save_weights_only as tsave  # noqa: E402
from nerf_pl_tpu_torch.mesh.dae import read_dae  # noqa: E402
from nerf_pl_tpu_torch.mesh.ply import read_ply  # noqa: E402
from nerf_pl_tpu_torch.utils import synthetic as tsyn  # noqa: E402


def _script(name):
    """A module of scripts/ (not a package), loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return jsyn.make_blender_scene(str(tmp_path_factory.mktemp("scene")),
                                   n_train=3, n_val=1, n_test=1,
                                   wh=(16, 16))


@pytest.fixture(scope="module")
def jax_params():
    kc, kf = jax.random.split(jax.random.PRNGKey(0))
    params = {"nerf_coarse": jinit(kc), "nerf_fine": jinit(kf)}
    # shift sigma to ~2 +- noise so the threshold-2 level set exists
    for m in params.values():
        m["sigma"]["w"] = m["sigma"]["w"] * 50
        m["sigma"]["b"] = m["sigma"]["b"] + 2.0
    return params


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, jax_params):
    path = str(tmp_path_factory.mktemp("ck") / "w.ckpt")
    save_checkpoint(path, {"params": jax_params})
    return path


MESH_RUNS = {"fusion_vol": (["--export_vol"], "ply"),
             "vertex_normal_dae": (["--use_vertex_normal", "--mesh_format",
                                    "dae"], "dae")}


@pytest.mark.parametrize("run", list(MESH_RUNS))
def test_mesh_cli_matches_jax_cli(run, scene, ckpt, tmp_path):
    extra, fmt = MESH_RUNS[run]
    dirs = {k: tmp_path / k for k in ("jax", "torch")}
    for d in dirs.values():
        d.mkdir()
    base = ["--root_dir", scene, "--dataset_name", "blender",
            "--scene_name", "m", "--img_wh", "16", "16", "--N_grid", "24",
            "--sigma_threshold", "2.0", "--N_samples", "8",
            "--N_importance", "4", "--chunk", "4096", "--ckpt_path", ckpt,
            "--compile_cache", "", *extra]
    jmesh_cli.main(base + ["--out_dir", str(dirs["jax"])])
    tmesh_cli.main(base + ["--out_dir", str(dirs["torch"])], device="cpu")
    if fmt == "ply":
        v, t, c = read_ply(str(dirs["torch"] / "m.ply"))
        jv, jt, jc = jread_ply(str(dirs["jax"] / "m.ply"))
        c, jc = c.astype(np.float64), jc.astype(np.float64)
    else:
        v, t, c = read_dae(str(dirs["torch"] / "m.dae"))
        jv, jt, jc = jread_dae(str(dirs["jax"] / "m.dae"))
        c, jc = 255 * c, 255 * jc
    assert len(t) > 100 and c is not None
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(v, jv, atol=1e-4)
    assert np.isfinite(v).all()
    assert np.abs(c - jc).max() <= 1 + 1e-3
    if "--export_vol" in extra:
        vol = np.fromfile(dirs["torch"] / "m.vol", np.uint32).reshape(-1, 2)
        jvol = np.fromfile(dirs["jax"] / "m.vol", np.uint32).reshape(-1, 2)
        assert len(vol) > 0
        np.testing.assert_array_equal(vol[:, 0], jvol[:, 0])
        for shift in (24, 16, 8, 0):
            byte = (vol[:, 1] >> shift) & 0xFF
            jbyte = (jvol[:, 1] >> shift) & 0xFF
            assert np.abs(byte.astype(int) - jbyte.astype(int)).max() <= 1


def test_mesh_cli_raises_without_a_surface(scene, ckpt, tmp_path):
    with pytest.raises(SystemExit, match="no surface found"):
        tmesh_cli.main(["--root_dir", scene, "--img_wh", "16", "16",
                        "--N_grid", "8", "--sigma_threshold", "1e6",
                        "--ckpt_path", ckpt, "--out_dir", str(tmp_path)],
                       device="cpu")


def test_save_weights_only_matches_jax(jax_params, tmp_path):
    import jax.numpy as jnp
    full = str(tmp_path / "full.ckpt")
    save_checkpoint(full, TrainState(jax_params, {"mu": jax_params},
                                     jnp.zeros([], jnp.int32)))
    ours, ref = str(tmp_path / "t.ckpt"), str(tmp_path / "j.ckpt")
    tsave.main(["--ckpt_path", full, "--out", ours])
    save_weights_only(full, ref)
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        assert len(a.files) == 2 * 2 * 12
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])
    # the default output name is the JAX script's
    tsave.main(["--ckpt_path", full])
    assert os.path.isfile(str(tmp_path / "full_weights.ckpt"))


def test_preview_bounds_matches_jax_script(ckpt, tmp_path):
    args = ["--ckpt_path", ckpt, "--N_grid", "24", "--sigma_threshold",
            "2.0", "--n_slices", "4"]
    ref = _script("preview_bounds").main(
        args + ["--out_dir", str(tmp_path / "jax"), "--preview_mesh",
                str(tmp_path / "j.ply")])
    ours = tpreview.main(
        args + ["--out_dir", str(tmp_path / "torch"), "--preview_mesh",
                str(tmp_path / "t.ply")], device="cpu")
    assert ours == ref
    for axis in "xyz":
        png = f"slices_{axis}.png"
        assert ((tmp_path / "torch" / png).read_bytes()
                == (tmp_path / "jax" / png).read_bytes())
    _, t, _ = read_ply(str(tmp_path / "t.ply"))
    _, jt, _ = jread_ply(str(tmp_path / "j.ply"))
    assert len(t) > 0
    np.testing.assert_array_equal(t, jt)


def test_hard_scene_is_byte_identical():
    c2w = tsyn.look_at_pose([2.5, -3.0, 1.5])
    ours = tsyn.render_hard_scene_rgba(c2w, 12, 10, 14.0)
    ref = jsyn.render_hard_scene_rgba(c2w, 12, 10, 14.0)
    assert ours.shape == (12, 10, 4) and ours[..., 3].max() == 1.0
    assert ours.tobytes() == ref.tobytes()


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_make_hard_datasets_matches_jax_script(tmp_path, monkeypatch):
    small = ["--blender_wh", "8", "8", "--llff_wh", "8", "6", "--n_train",
             "2", "--n_sph", "4"]
    tmake_hard.main(["--out", str(tmp_path / "torch"), *small])
    monkeypatch.setattr(sys, "argv", ["make_hard_datasets.py", "--out",
                                      str(tmp_path / "jax"), *small])
    _script("make_hard_datasets").main()
    ours, ref = _files(tmp_path / "torch"), _files(tmp_path / "jax")
    # blender: 2 + 8 + 25 PNGs and 3 transforms; llff: 30 and 4 images and
    # a poses_bounds.npy each
    assert len(ref) == 38 + 31 + 5
    assert ours == ref


def test_northstar_regexes_match_jax_script():
    ref = _script("northstar")
    for name in ("VAL_RE", "VAL_STEP_RE"):
        assert getattr(tnorthstar, name).pattern == getattr(ref,
                                                            name).pattern


def _env():
    return {**os.environ, "PYTHONPATH": REPO}


def test_northstar_launches_the_ports_train_cli(tmp_path):
    out = tmp_path / "ns.json"
    proc = subprocess.run(
        [sys.executable, "-m", "nerf_pl_tpu_torch.northstar", "--json_out",
         str(out), "--", "--help"], cwd=str(tmp_path), env=_env(),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "--fused_train" in proc.stdout      # the train CLI's help
    data = json.loads(out.read_text())
    assert data["cmd"] == ["-m", "nerf_pl_tpu_torch.train", "--help"]
    assert data["returncode"] == 0 and data["epochs"] == []


def test_northstar_sigterm_kills_child_and_writes_partial(tmp_path):
    """tests/test_cli.py::TestNorthstarHarness on the port's module: the
    harness, not the child, gets SIGTERM; it must kill the child and still
    write the partial JSON with the crossings collected so far."""
    stub = tmp_path / "stub_train.py"
    stub.write_text(
        "import os, sys, time\n"
        f"open({str(tmp_path / 'child.pid')!r}, 'w')"
        ".write(str(os.getpid()))\n"
        "print('[val] epoch 1 loss=0.0100 psnr=26.00 ssim=0.900',"
        " flush=True)\n"
        "time.sleep(300)\n")
    out = tmp_path / "ns.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "nerf_pl_tpu_torch.northstar", "--json_out",
         str(out), "--thresholds", "25.0", "40.0", "--train_script",
         str(stub)], cwd=str(tmp_path), env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for line in proc.stdout:
        if "crossed 25.0" in line:
            break
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=30)

    data = json.loads(out.read_text())
    assert data["returncode"] is None
    assert data["thresholds_wall_s"].keys() == {"25.0"}
    assert data["epochs"][0]["val_psnr"] == 26.00
    child = int((tmp_path / "child.pid").read_text())
    for _ in range(50):
        try:
            os.kill(child, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        os.kill(child, signal.SIGKILL)
        pytest.fail("train child survived northstar SIGTERM")
