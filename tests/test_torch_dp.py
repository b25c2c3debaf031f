"""The port's data parallel training and rendering (two gloo ranks on the
CPU, `dist.py`) against the JAX package's 2-device mesh
(tests/conftest.py gives the process 8 virtual CPU devices) and against
one process of the port.

The ranks run in one spawn for the whole module (`ranks`, the work in
tests/torch_dp_ranks.py, which imports no jax); the JAX side and the
one-process port run here. Bit for bit: set_data's shards and labels,
tighten_store's shards (rays, masks, hit flags, partition order) and
survivor counts; the 2-rank gradients against the sum of the two shards'
one-process gradients (a sum of two is the same in either order); params
across ranks after K steps; a one-rank gloo group against no group; the
resumed loss stream; the sharded dense render against one process's.
Against JAX: tighten's stats within 1e-6 relative; the loss-fused and
autograd steps at the bars of test_torch_fused_train.py and
test_torch_train.py::test_autograd_step_matches_jax (JAX's draws
injected: per shard fold_in(key, r) on the fused route, the global draws
sliced by rank on the autograd route); the culled renderer's stats
exactly, its outputs within test_torch_culled.py's 2e-2. Then the CLIs
with --num_gpus 2 / --num_chips 2, the dry run and the launcher's failures.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dp_ranks as ranks_mod
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_culled import SLAB_BOXES, _grid, _mcfgs, _slab_rays
from test_torch_fused_train import _dense, _inputs, _step_draws
from test_torch_occupancy import _rays as _probe_rays
from test_torch_train import _jax_state
from test_torch_train_occ import BOXES, _store

from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.parallel import Trainer as JTrainer
from nerf_pl_tpu.parallel import make_mesh
from nerf_pl_tpu.parallel.spmd import TrainState
from nerf_pl_tpu.rendering import CulledRenderer as JCulledRenderer
from nerf_pl_tpu.rendering import ModelConfig as JModelConfig
from nerf_pl_tpu.rendering import RenderConfig as JRenderConfig
from nerf_pl_tpu.rendering import occupancy as jocc
from nerf_pl_tpu.training import get_lr_schedule as jsched
from nerf_pl_tpu.training import get_optimizer as jopt
from nerf_pl_tpu.training import loss_dict as jloss
from nerf_pl_tpu.training.checkpoints import load_checkpoint as jload
from nerf_pl_tpu.training.checkpoints import save_checkpoint
from nerf_pl_tpu.utils.synthetic import make_blender_scene
from nerf_pl_tpu_torch import dist as pdist
from nerf_pl_tpu_torch import eval as teval
from nerf_pl_tpu_torch import train as ttrain
from nerf_pl_tpu_torch.models import params_from_numpy
from nerf_pl_tpu_torch.parallel import make_render_fn
from nerf_pl_tpu_torch.rendering import RenderConfig, fused_mse_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
SPAWN_TIMEOUT = 240.0
OUT_TOL = 2e-2               # test_torch_culled.py
STORE_BATCH = 256
TIGHTEN = dict(margin=0.1, n_seg=32, dilate=1, pack=True)
STEP_BATCH = 128
FUSED = dict(N_samples=16, N_importance=8, white_back=True, perturb=1.0,
             noise_std=1.0, fused_train=True, fused_loss=True)
PLAIN = dict(N_samples=16, N_importance=8, white_back=True, perturb=1.0,
             noise_std=1.0)
STEP_ROUTES = {"fused": (FUSED, 7), "plain": (PLAIN, 5)}   # (rcfg, key)
K_ROUTES = {"fused": dict(FUSED, N_samples=8, N_importance=8),
            "plain": dict(PLAIN, N_samples=8, N_importance=4)}
K_STEPS = 3
CULLED = {"cull": {},
          "budgets_segments": dict(tighten=True, budgets=True, segments=32)}
CULLED_RCFG = dict(N_samples=64, N_importance=32, test_time=True)
RENDER_RCFG = dict(N_samples=8, N_importance=4, test_time=True,
                   white_back=True)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """The ranks' thread count (dist.RANK_THREADS): the one-process
    results here are then summed in the ranks' order, bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(pdist.RANK_THREADS)
    yield
    torch.set_num_threads(n)


def _mesh():
    return make_mesh(num_data=WORLD)


def _jtrainer(rcfg_kw, batch):
    sched = jsched(**ranks_mod.SCHED)
    return JTrainer(_mesh(), JModelConfig(), JRenderConfig(**rcfg_kw),
                    jopt("adam", sched), sched, jloss["mse"], batch)


def _sharded(x, mesh, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def _draws_np(d):
    return {f.name: getattr(d, f.name).numpy()
            for f in dataclasses.fields(d)}


def _jax_params(seeds=(0, 1), dense=False):
    return {m: (_dense(k) if dense else
                jax.tree_util.tree_map(np.asarray,
                                       jinit(jax.random.PRNGKey(k))))
            for m, k in zip(("nerf_coarse", "nerf_fine"), seeds)}


def _step_spec(route):
    rcfg, k = STEP_ROUTES[route]
    params = _jax_params(dense=route == "fused")
    rays, _, _, gt = _inputs(STEP_BATCH, 1, seed=2)
    rgbs = gt[:, :3].copy()
    key = jax.random.PRNGKey(k)
    b = STEP_BATCH // WORLD
    cfg = RenderConfig(**rcfg)
    if route == "fused":       # a draw per shard, fold_in(key, r)
        per_rank = [_draws_np(_step_draws(jax.random.fold_in(key, r), b,
                                          cfg)) for r in range(WORLD)]
    else:                      # one global draw over the sharded batch
        full = _draws_np(_step_draws(key, STEP_BATCH, cfg))
        per_rank = [{n: v[r * b:(r + 1) * b] for n, v in full.items()}
                    for r in range(WORLD)]
    draws = {n: np.stack([d[n] for d in per_rank]) for n in per_rank[0]}
    return dict(rcfg=rcfg, batch=STEP_BATCH, params=params, rays=rays,
                rgbs=rgbs, draws=draws, key=key)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("dp_ckpt")


@pytest.fixture(scope="module")
def specs(ckpt_dir):
    rays, rgbs = _store(3000, seed=1)
    k_rays, k_rgbs = _store(512, seed=3)
    tm = _mcfgs()[1]
    p_small = jax.tree_util.tree_map(
        np.asarray, jinit(jax.random.PRNGKey(2), _mcfgs()[0].nerf))
    steps = {r: _step_spec(r) for r in STEP_ROUTES}
    return {
        "store": dict(rcfg=dict(N_samples=8, white_back=True),
                      batch=STORE_BATCH, rays=rays, rgbs=rgbs,
                      shuffle_seed=4, boxes=BOXES, tighten=TIGHTEN),
        **{f"step_{r}": s for r, s in steps.items()},
        "steps": dict(routes=K_ROUTES, batch=STEP_BATCH, rays=k_rays,
                      rgbs=k_rgbs, seed=9, k=K_STEPS),
        "resume": dict(rcfg=K_ROUTES["plain"], batch=STEP_BATCH, rays=k_rays,
                       rgbs=k_rgbs, seed=8,
                       ckpt=str(ckpt_dir / "mid.ckpt")),
        "render": dict(rcfg=RENDER_RCFG, chunk=64,
                       mcfg=ranks_mod.ModelConfig(),
                       params=_jax_params((3, 4)),
                       rays=_probe_rays(300, seed=6)),
        "culled": dict(rcfg=CULLED_RCFG, chunk=100, mcfg=tm,
                       params={"nerf_coarse": p_small,
                               "nerf_fine": p_small},
                       rays=_slab_rays(), grid=_grid(SLAB_BOXES),
                       configs=CULLED),
    }


@pytest.fixture(scope="module")
def ranks(specs):
    """Every part of tests/torch_dp_ranks.py in one spawn of 2 ranks: a
    list of each rank's {entry: result}."""
    spec = {name: ("step" if name.startswith("step_") else name,
                   {k: v for k, v in s.items() if k != "key"})
            for name, s in specs.items()}
    out = pdist.launch(ranks_mod.probe, WORLD, spec, timeout=SPAWN_TIMEOUT)
    assert out[0]["pid"] != out[1]["pid"]
    return out


# ------------------------------------------------------------------ store

def test_store_shards_and_tighten_match_jax(ranks, specs):
    """set_data's shards and labels, then tighten_store(pack, 32 segments,
    dilate 1): each rank's rows equal the JAX array's block of that rank
    (P("data")), bit for bit, with its survivor count; the stats, reduced
    across the ranks, within 1e-6 relative of JAX's psums."""
    s = specs["store"]
    jt = _jtrainer(s["rcfg"], STORE_BATCH)
    jt.set_data(s["rays"], s["rgbs"], shuffle_seed=s["shuffle_seed"])
    before = {"all_rays": np.asarray(jt.all_rays),
              "all_rgbs": np.asarray(jt.all_rgbs),
              "all_idx": np.asarray(jt.all_idx)}
    st_j = jt.tighten_store(BOXES, **TIGHTEN)
    after = {"all_rays": jt.all_rays, "all_rgbs": jt.all_rgbs,
             "all_nf0": jt.all_nf0, "all_occm": jt.all_occm,
             "all_hit": jt.all_hit, "all_idx": jt.all_idx}
    after = {k: np.asarray(v) for k, v in after.items()}
    after["all_hit"] = after["all_hit"] > 0.5
    nsurv = np.asarray(jt.all_nsurv)
    n_local = jt.n_rays_local
    for r, res in enumerate(ranks):
        got = res["store"]
        rows = slice(r * n_local, (r + 1) * n_local)
        assert got["steps_per_epoch"] == jt.steps_per_epoch_local
        assert set(got["set_data"]) == set(before)
        for k, v in before.items():
            np.testing.assert_array_equal(got["set_data"][k], v[rows],
                                          err_msg=k)
        assert set(got["tightened"]) == set(after)
        for k, v in after.items():
            a = got["tightened"][k]
            if k == "all_occm":
                a = a.astype(np.uint32)
            np.testing.assert_array_equal(a, v[rows], err_msg=k)
        assert got["nsurv"] == int(nsurv[r])
        assert set(got["stats"]) == set(st_j)
        for k in st_j:
            assert abs(got["stats"][k] - st_j[k]) <= 1e-6 * abs(st_j[k]), k
        assert got["stats"] == ranks[0]["store"]["stats"]
    assert 0 < nsurv.sum() < WORLD * n_local


# ------------------------------------------------------------------- step

def _leaves(tree):
    return {f"{m}/{layer}/{leaf}": np.asarray(tree[m][layer][leaf])
            for m in tree for layer in tree[m] for leaf in tree[m][layer]}


@pytest.mark.parametrize("route", list(STEP_ROUTES))
def test_step_matches_jax_mesh(ranks, specs, route):
    """One step of the 2-device JAX Trainer's _loss_and_grads against the
    2-rank port's, JAX's draws injected. Fused: loss within 1e-5
    relative, every leaf at cosine >= 0.999 and relative L2 <= 0.05.
    Autograd: loss within 1e-6 relative, the same per-leaf bars, and the
    coarse leaves within a relative max error of 1e-2.

    The global batch is 128, 64 rays a rank. The bars were measured on
    one device at 32 rays; with 16 or 32 rays a shard the fused step's
    fine trunk leaves fell to cosine 0.9977 and 0.9990 (relative L2 0.069
    and 0.046), as far as the port is from JAX on one device on the same
    shard (0.9975 for shard 0 at 16 rays): one flipped ReLU mask or bf16
    rounding behind sample_pdf's placement weighs more in fewer rays.
    JAX's own 2-device step is 6.4% and 13.4% (relative max error) from
    the sum of its two one-device shard steps at those sizes, and 4.7% at
    64 rays a shard."""
    s = specs[f"step_{route}"]
    mesh = _mesh()
    jt = _jtrainer(s["rcfg"], STEP_BATCH)
    loss_j, _, g_j = jax.jit(jt._loss_and_grads)(
        jax.device_put(s["params"], NamedSharding(mesh, P())),
        _sharded(s["rays"], mesh, P("data")),
        _sharded(s["rgbs"], mesh, P("data")), s["key"])
    loss_j = float(loss_j)
    g_j = _leaves(g_j)
    for res in ranks:
        got = res[f"step_{route}"]
        bar = 1e-5 if route == "fused" else 1e-6
        assert abs(got["loss"] - loss_j) <= bar * abs(loss_j)
        for name, b in g_j.items():
            a = got["grads"][name].ravel()
            b = b.ravel()
            cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
            l2 = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert cos >= 0.999 and l2 <= 0.05, (name, cos, l2)
            if route == "plain" and name.startswith("nerf_coarse"):
                rel = np.abs(a - b).max() / np.abs(b).max()
                assert rel <= 1e-2, (name, rel)


@pytest.mark.parametrize("route", list(STEP_ROUTES))
def test_step_is_the_sum_of_one_process_shards(ranks, specs, route):
    """The 2-rank gradients and loss, bit for bit: the sum of the two
    shards' one-process gradients (the fused step at the global batch's
    scale; the autograd step's local mean times batch_local / batch)."""
    s = specs[f"step_{route}"]
    b = STEP_BATCH // WORLD
    params = {k: params_from_numpy(v) for k, v in s["params"].items()}
    grads, losses = [], []
    for r in range(WORLD):
        rows = slice(r * b, (r + 1) * b)
        rays, rgbs = (torch.from_numpy(x[rows]) for x in (s["rays"],
                                                          s["rgbs"]))
        draws = ranks_mod.TrainDraws(**{k: torch.from_numpy(v[r])
                                        for k, v in s["draws"].items()})
        if route == "fused":
            ls, _, g = fused_mse_train_step(params, rays, rgbs,
                                            RenderConfig(**s["rcfg"]),
                                            STEP_BATCH, draws=draws)
            losses.append(ls)
            grads.append(ranks_mod._np(g))
        else:
            tr = ranks_mod.trainer(s["rcfg"], b, None)
            loss, _, g = tr.family.loss_and_grads(params, rays, rgbs, None,
                                                  draws=draws)
            losses.append(loss * (b / STEP_BATCH))
            grads.append({k: v * np.float32(b / STEP_BATCH)
                          for k, v in ranks_mod._np(g).items()})
    loss = losses[0] + losses[1]
    if route == "fused":
        loss = loss / STEP_BATCH
    for res in ranks:
        got = res[f"step_{route}"]
        assert got["loss"] == float(loss)
        assert set(got["grads"]) == set(grads[0])
        for k in grads[0]:
            np.testing.assert_array_equal(got["grads"][k],
                                          grads[0][k] + grads[1][k],
                                          err_msg=k)


# ------------------------------------------------------------------ steps

@pytest.mark.parametrize("route", list(K_ROUTES))
def test_k_steps_agree_across_ranks(ranks, route):
    """After K adam steps the two ranks hold the same params and Adam
    state, bit for bit, with the same (global) losses."""
    a, b = (res["steps"][route] for res in ranks)
    assert a["losses"] == b["losses"] and len(a["losses"]) == K_STEPS
    assert np.isfinite(a["losses"]).all()
    assert set(a["state"]) == set(b["state"])
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k],
                                      err_msg=k)


@pytest.mark.parametrize("route", list(K_ROUTES))
def test_one_rank_group_is_the_one_device_trainer(ranks, route):
    """A one-rank gloo group (its all-reduces included) steps bit for bit
    as the Trainer with no group, on each rank."""
    for res in ranks:
        got = res["steps"][route]
        for k in got["no_group"]:
            np.testing.assert_array_equal(got["one_rank_group"][k],
                                          got["no_group"][k], err_msg=k)


# ----------------------------------------------------------------- resume

def test_resume_continues_the_stream_and_jax_reads_it(ranks, specs):
    """2 steps, a checkpoint rank 0 writes, 2 steps from it: the loss
    stream of 4 uninterrupted steps, bit for bit; JAX load_checkpoint
    reads the file at step 2."""
    for res in ranks:
        got = res["resume"]
        assert got["head"] + got["tail"] == got["full"]
        assert got["step"] == 4
    restored, meta = jload(specs["resume"]["ckpt"], _jax_state(0))
    assert int(restored.step) == 2 and meta == {"step": 2}


# ----------------------------------------------------------------- render

def test_sharded_render_equals_one_process(ranks, specs):
    """make_render_fn over 2 ranks (each its block of 64-ray tiles, the
    rays padded to whole groups of 128) against one process's, bit for
    bit, on every rank."""
    s = specs["render"]
    ref = make_render_fn(RenderConfig(**s["rcfg"]), s["chunk"], "cpu",
                         s["mcfg"])(s["params"], s["rays"])
    for res in ranks:
        got = res["render"]
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("name", list(CULLED))
def test_culled_render_matches_jax_mesh(ranks, specs, name):
    """The culled renderer over 2 ranks against JAX's with a 2-device
    mesh (the small model, chunk 100): stats exactly (n_rendered and
    bucket_counts follow the mesh's tile rounding), every output row
    within 2e-2, on every rank."""
    s = specs["culled"]
    mesh = _mesh()
    jm = _mcfgs()[0]
    jcr = JCulledRenderer(jocc.OccupancyGrid(**s["grid"]),
                          JRenderConfig(**s["rcfg"]), jm, chunk=s["chunk"],
                          mesh=mesh, **CULLED[name])
    ref, ref_stats = jcr(jax.device_put(s["params"],
                                        NamedSharding(mesh, P())),
                         jnp.asarray(s["rays"]), return_stats=True)
    assert ref_stats["n_rendered"] % (WORLD * 8) == 0
    for res in ranks:
        out, stats = res["culled"][name]
        assert stats == ref_stats
        assert set(out) == set(ref)
        for k in ref:
            np.testing.assert_allclose(out[k], np.asarray(ref[k]),
                                       atol=OUT_TOL, err_msg=k)


# ------------------------------------------------------------------- CLIs

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_blender_scene(str(tmp_path_factory.mktemp("scene")),
                              n_train=2, n_val=1, n_test=1, wh=(40, 40))


def test_train_cli_num_gpus_2_on_cpu(scene, tmp_path, monkeypatch, capfd):
    """train --num_gpus 2 with main(device="cpu"): 2 gloo ranks fit 2
    epochs (global batch 512, 256 a rank), rank 0 alone prints and writes
    the checkpoints, which JAX load_checkpoint reads."""
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset_name", "blender", "--root_dir", scene,
            "--img_wh", "40", "40", "--N_samples", "16",
            "--N_importance", "8", "--batch_size", "512",
            "--num_epochs", "2", "--fused_train", "--scan_steps", "4",
            "--val_chunk", "1600", "--exp_name", "dp", "--decay_step", "1",
            "--num_gpus", "2"]
    final = ttrain.main(argv, device="cpu")
    out = capfd.readouterr().out
    assert re.search(r"^\[fit\] .* world 2 \(gloo\)", out, re.M), out
    assert len(re.findall(r"^\[val\] epoch", out, re.M)) == 2
    assert final["epoch"] == 2 and np.isfinite(final["val/psnr"])
    ckpts = tmp_path / "ckpts" / "dp"
    assert {"epoch=1.ckpt", "epoch=2.ckpt", "last.ckpt",
            "topk.json"} <= set(os.listdir(ckpts))
    restored, meta = jload(str(ckpts / "last.ckpt"), _jax_state(0))
    # 2 epochs of ceil(3200 / 512) steps
    assert int(restored.step) == 14 and meta["epoch"] == 2


def test_train_cli_num_gpus_2_occ_train(tmp_path_factory, tmp_path,
                                        monkeypatch, capfd):
    """test_torch_train_occ.py's culled recipe (packed, weight mode, 16
    segments) with --num_gpus 2 on the CPU: rank 0 builds the grid and
    broadcasts it, both ranks tighten their shards, and rank 0 prints the
    one [occ] line, with the packing over the whole store."""
    from test_torch_train_occ import _flags as occ_flags
    scene = make_blender_scene(str(tmp_path_factory.mktemp("occ_scene")),
                               n_train=12, n_val=1, n_test=1, wh=(16, 16))
    monkeypatch.chdir(tmp_path)
    # warmup 0: the grid of the initial weights tightens the store before
    # the first step (at threshold 0 it is not empty)
    final = ttrain.main(occ_flags(scene, 1, ("--num_gpus", "2",
                                             "--occ_warmup_epochs", "0")),
                        device="cpu")
    out = capfd.readouterr().out
    assert np.isfinite(final["val/psnr"]) and final["epoch"] == 1
    occ = re.findall(r"^\[occ\] (\d+) boxes .*packed: x([\d.]+)", out,
                     re.M)
    assert len(occ) == 1 and int(occ[0][0]) > 0 and float(occ[0][1]) >= 1, \
        out
    assert os.path.isfile(tmp_path / "ckpts" / "occ" / "last.ckpt")


@pytest.fixture(scope="module")
def scene3(tmp_path_factory):
    return make_blender_scene(str(tmp_path_factory.mktemp("scene3")),
                              n_train=3, n_val=1, n_test=3, wh=(20, 20))


@pytest.fixture(scope="module")
def occ_ckpt(tmp_path_factory):
    """tests/test_torch_eval_cli.py's occ_ckpt: both sigma heads x50."""
    kc, kf = jax.random.split(jax.random.PRNGKey(0))
    params = {"nerf_coarse": jax.tree_util.tree_map(np.asarray, jinit(kc)),
              "nerf_fine": jax.tree_util.tree_map(np.asarray, jinit(kf))}
    for mlp in params.values():
        mlp["sigma"]["w"] = mlp["sigma"]["w"] * 50
    path = str(tmp_path_factory.mktemp("occ") / "occ.ckpt")
    save_checkpoint(path, TrainState(params, {"mu": params},
                                     jnp.zeros([], jnp.int32)))
    return path


@pytest.mark.parametrize("culled", [False, True], ids=["dense", "culled"])
def test_eval_cli_num_chips_2_matches_jax(scene3, occ_ckpt, tmp_path, capfd,
                                          culled):
    """eval --num_chips 2 through both packages on one checkpoint: JAX's
    eval.py on a 2-device mesh, the port's over 2 gloo ranks with
    main(device="cpu"). PSNR within 0.05 dB (the bar of
    test_culled_eval_cli_matches_jax_cli), rank 0 alone writing the PNGs
    and the GIF."""
    import eval as jeval
    flags = ["--root_dir", scene3, "--dataset_name", "blender",
             "--img_wh", "20", "20", "--N_samples", "8",
             "--N_importance", "4", "--chunk", "256", "--ckpt_path",
             occ_ckpt, "--frames_per_dispatch", "2", "--scene_name", "s",
             "--num_chips", "2"]
    if culled:
        flags += ["--occ_grid", "--occ_tighten", "--occ_budgets",
                  "--occ_segments", "8", "--occ_threshold=0.3",
                  "--occ_range", "-1.5", "1.5", "--occ_N", "32",
                  "--culled_chunk", "64"]
    psnr_j = jeval.main(flags + ["--out_dir", str(tmp_path / "jax")])
    capfd.readouterr()
    psnr_t = teval.main(flags + ["--out_dir", str(tmp_path / "torch")],
                        device="cpu")
    out = capfd.readouterr().out
    assert "; world 2" in out
    assert out.count("Mean PSNR") == 1
    assert np.isfinite(psnr_t) and abs(psnr_t - psnr_j) <= 0.05
    dt = tmp_path / "torch" / "blender" / "s"
    assert {"000.png", "001.png", "002.png", "s.gif"} <= set(os.listdir(dt))


# --------------------------------------------------------- dry run, faults

def test_dryrun_multichip_2_on_cpu():
    """python -m nerf_pl_tpu_torch.dryrun_multichip 2 --device cpu exits 0
    and prints each phase's ok line once."""
    from nerf_pl_tpu_torch import dryrun_multichip
    proc = subprocess.run(
        [sys.executable, "-m", "nerf_pl_tpu_torch.dryrun_multichip", "2",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True,
        timeout=dryrun_multichip.TIMEOUT + 60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("[dryrun_multichip]")]
    assert len(lines) == 5 and all(ln.endswith(" ok") for ln in lines), \
        proc.stdout
    for word in ("gloo on cpu", "fused_loss dp=2", "occ_tighten dp=2",
                 "resume dp=2", "eval/render dp=2"):
        assert sum(word in ln for ln in lines) == 1, word


def test_failed_rank_fails_the_launch():
    """Rank 1 raises while rank 0 waits at a barrier: the launcher raises
    with rank 1's error well inside its timeout, and leaves no rank
    running."""
    import time
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        pdist.launch(ranks_mod.fail_on_rank_one, WORLD, timeout=120)
    assert time.monotonic() - t0 < 60


def test_launch_without_deadline_returns():
    """launch(timeout=None), as the train and eval CLIs launch, waits for
    its ranks with no deadline and returns each rank's result. It runs in
    a process of its own, bounded here, since the launch itself is not."""
    code = ("import torch_dp_ranks as r; from nerf_pl_tpu_torch import dist; "
            "print(dist.launch(r.rank_sum, 2, timeout=None))")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=os.path.join(REPO, "tests"), capture_output=True,
                          text=True, timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == \
        "[(0, 2, 3.0), (1, 2, 3.0)]"


def test_hung_ranks_time_out():
    with pytest.raises(TimeoutError, match="did not finish"):
        pdist.launch(ranks_mod.sleep, WORLD, 60.0, timeout=3)
