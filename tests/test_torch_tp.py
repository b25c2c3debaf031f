"""The port's tensor parallelism: the Trainer on a dp x tp = (2, 2) mesh of
four gloo ranks on the CPU (`parallel/mesh.py`, the work in
tests/torch_tp_ranks.py, which imports no jax), against the port's data
parallel trainer, the JAX package's Trainer on a (2, 2) mesh
(tests/conftest.py's 8 virtual devices) and its checkpoints. Then the dry
run over 4 ranks, whose phases 1 and 4 run on that mesh, and nerf_apply
without a layout, bit for bit the one-device MLP.

The ranks run in one spawn for the module (`ranks`). The bars: each
rank's blocks are the pspec slices of the broadcast params, bit for bit;
5 steps at (2, 2) against dp (2, 1) at tests/test_spmd.py::
test_tp_matches_dp_numerics's rtol 2e-4 (loss) and atol 2e-5 (xyz_0.w);
one step against JAX's mesh step, JAX's global draws injected and sliced
by data index, at tests/test_torch_train.py::
test_autograd_step_matches_jax's bars, block by block; the kernel routes'
gradients (plain versions here) bit for bit the dp step's, since every
rank of a model group runs the kernel on the gathered whole weights; the
resume's loss stream at rtol 1e-5.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_dp_ranks as dp_ranks
import torch_tp_ranks as ranks_mod
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_fused_train import _dense, _inputs, _step_draws
from test_torch_train_occ import _store

from nerf_pl_tpu.models import EmbeddingConfig as JEmbeddingConfig
from nerf_pl_tpu.models import NeRFConfig as JNeRFConfig
from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.parallel import Trainer as JTrainer
from nerf_pl_tpu.parallel import make_mesh as jmake_mesh
from nerf_pl_tpu.parallel.mesh import model_pspecs as jmodel_pspecs
from nerf_pl_tpu.parallel.spmd import TrainState as JTrainState
from nerf_pl_tpu.rendering import ModelConfig as JModelConfig
from nerf_pl_tpu.rendering import RenderConfig as JRenderConfig
from nerf_pl_tpu.training import get_lr_schedule as jsched
from nerf_pl_tpu.training import get_optimizer as jopt
from nerf_pl_tpu.training import loss_dict as jloss
from nerf_pl_tpu.training.checkpoints import flatten_with_paths as jflat
from nerf_pl_tpu.training.checkpoints import load_checkpoint as jload
from nerf_pl_tpu.training.checkpoints import save_checkpoint as jsave
from nerf_pl_tpu_torch import dist as pdist
from nerf_pl_tpu_torch.models import nerf as tnerf
from nerf_pl_tpu_torch.models import init_nerf_params
from nerf_pl_tpu_torch.parallel.mesh import model_pspecs, split_dim
from nerf_pl_tpu_torch.rendering import RenderConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
NUM_DATA = 2
SPAWN_TIMEOUT = 300.0
BATCH = 256
PLAIN = dict(N_samples=8, N_importance=4, white_back=True, perturb=1.0,
             noise_std=1.0)
K_STEPS = 5
LOSS_RTOL, W_ATOL = 2e-4, 2e-5        # test_tp_matches_dp_numerics
ROUTE_BATCH = 64
ROUTES = {"fused": dict(PLAIN, N_importance=8, fused=True),
          "fused_train": dict(PLAIN, N_importance=8, fused_train=True)}
STEP_MODELS = ("small", "odd", "megatron")


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(pdist.RANK_THREADS)
    yield
    torch.set_num_threads(n)


def _jmcfg(name):
    nerf = {"small": JNeRFConfig(D=2, W=32, in_channels_xyz=27,
                                 in_channels_dir=15, skips=(1,)),
            "odd": JNeRFConfig(D=2, W=33, in_channels_xyz=27,
                               in_channels_dir=15, skips=(1,)),
            "megatron": JNeRFConfig(D=4, W=32, in_channels_xyz=27,
                                    in_channels_dir=15, skips=(2,))}[name]
    return JModelConfig(nerf=nerf, emb_xyz=JEmbeddingConfig(3, 4),
                        emb_dir=JEmbeddingConfig(3, 2))


def _jmesh():
    return jmake_mesh(num_data=NUM_DATA, num_model=2)


def _jtrainer(name, rcfg=PLAIN, batch=BATCH):
    sched = jsched(**dp_ranks.SCHED)
    return JTrainer(_jmesh(), _jmcfg(name), JRenderConfig(**rcfg),
                    jopt("adam", sched), sched, jloss["mse"], batch,
                    tensor_parallel=True)


def _jparams(name, seeds=(0, 1)):
    return {m: jax.tree_util.tree_map(
        np.asarray, jinit(jax.random.PRNGKey(k), _jmcfg(name).nerf))
        for m, k in zip(("nerf_coarse", "nerf_fine"), seeds)}


def _draws_np(d):
    return {k: getattr(d, k).numpy() for k in ("perturb", "noise_coarse",
                                              "u", "noise_fine")}


def _jax_ckpt(path):
    """A JAX train state of the small model (adam moments after two
    updates), saved by the JAX package."""
    params = _jparams("small", (3, 4))
    opt = jopt("adam", jsched(**dp_ranks.SCHED))
    state = opt.init(params)
    grads = jax.tree_util.tree_map(lambda p: 0.01 * p + 1e-3, params)
    for _ in range(2):
        upd, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, upd)
    st = JTrainState(params, state, jnp.asarray(2, jnp.int32))
    jsave(path, st, {"step": 2})
    return {k: np.asarray(v) for k, v in jflat(st).items()}


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp_jax") / "jax.ckpt")
    return path, _jax_ckpt(path)


@pytest.fixture(scope="module")
def specs(tmp_path_factory, jax_ckpt):
    rays, rgbs = _store(2048, seed=1)
    base = dict(mcfg="small", rcfg=PLAIN, batch=BATCH, rays=rays,
                rgbs=rgbs)
    key = jax.random.PRNGKey(5)
    step_rays, _, _, gt = _inputs(BATCH, 1, seed=2)
    route_rays, _, _, route_gt = _inputs(ROUTE_BATCH, 1, seed=3)
    route_cfg = RenderConfig(**ROUTES["fused"])
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt") / "mid.ckpt")
    return {
        "shards": ("shards", base),
        "steps": ("steps", dict(base, seed=9, k=K_STEPS)),
        "step": ("step", dict(
            base, rays=step_rays, rgbs=gt[:, :3].copy(), key=key,
            params={m: _jparams(m) for m in STEP_MODELS},
            draws=_draws_np(_step_draws(key, BATCH, RenderConfig(**PLAIN))))),
        "routes": ("routes", dict(
            base, mcfg="full", batch=ROUTE_BATCH, routes=ROUTES,
            rays=route_rays, rgbs=route_gt[:, :3].copy(),
            params={"nerf_coarse": _dense(0), "nerf_fine": _dense(1)},
            draws=_draws_np(_step_draws(jax.random.PRNGKey(7), ROUTE_BATCH,
                                        route_cfg)))),
        "resume": ("resume", dict(base, seed=8, ckpt=ckpt,
                                  jax_ckpt=jax_ckpt[0])),
        "fused_loss": ("fused_loss", dict(
            base, rcfg=dict(PLAIN, fused_train=True, fused_loss=True))),
    }


@pytest.fixture(scope="module")
def ranks(specs):
    """Every part of tests/torch_tp_ranks.py in one spawn of 4 ranks."""
    spec = {name: (part, {k: v for k, v in s.items() if k != "key"})
            for name, (part, s) in specs.items()}
    out = pdist.launch(ranks_mod.probe, WORLD, spec, timeout=SPAWN_TIMEOUT)
    assert len({res["pid"] for res in out}) == WORLD
    return out


def _block(whole, path, specs, model_index):
    """The block of a whole array that model index `model_index` keeps."""
    parts = path.split("/")
    if len(parts) < 3 or parts[-3] not in specs:
        return whole
    dim = split_dim(specs[parts[-3]][parts[-2]][parts[-1]])
    if dim is None:
        return whole
    n = whole.shape[dim] // 2
    return np.take(whole, range(model_index * n, (model_index + 1) * n),
                   axis=dim)


def _port_specs(name):
    params = {m: {layer: {"w": np.empty(dims)} for layer, dims in
                  ranks_mod.mcfg(name).nerf.all_layer_dims().items()}
              for m in ("nerf_coarse", "nerf_fine")}
    return model_pspecs(params, 2, True)


# ----------------------------------------------------------------- layout

def test_tp_params_actually_sharded(ranks):
    """Rank r sits at (r // 2, r % 2) of the (2, 2) mesh. Its params are
    the pspec blocks of rank 0's broadcast params (the one-process init of
    the same generator), bit for bit: xyz_0.w keeps half its columns; the
    gathered params are the whole ones on every rank; the Adam moments
    have the blocks' shapes."""
    g = torch.Generator().manual_seed(0)
    mcfg = ranks_mod.mcfg("small")
    whole = {}
    for m in ("nerf_coarse", "nerf_fine"):
        for layer, leaves in init_nerf_params(g, mcfg.nerf).items():
            for leaf, v in leaves.items():
                whole[f"{m}/{layer}/{leaf}"] = v.numpy()
    specs = _port_specs("small")
    for r, res in enumerate(ranks):
        got = res["shards"]
        assert got["mesh"] == {"data": 2, "model": 2}
        assert got["index"] == (r // 2, r % 2)
        assert set(got["blocks"]) == set(whole)
        for k, v in whole.items():
            np.testing.assert_array_equal(
                got["blocks"][k], _block(v, k, specs, r % 2), err_msg=k)
            np.testing.assert_array_equal(got["whole"][k], v, err_msg=k)
        assert got["blocks"]["nerf_coarse/xyz_0/w"].shape == (27, 16)
        assert got["blocks"]["nerf_coarse/xyz_1/w"].shape == (59, 32)
        for k, v in got["moments"].items():
            if "/mu/" in k or "/nu/" in k:
                path = k.split("/mu/")[-1].split("/nu/")[-1]
                assert v.shape == got["blocks"][path].shape, k


def test_pspecs_match_jax():
    """model_pspecs gives JAX's specs, rule for rule, on the three models
    (a PartitionSpec as a tuple)."""
    for name in ("full",) + STEP_MODELS:
        mcfg = ranks_mod.mcfg(name).nerf
        jparams = {m: jax.tree_util.tree_map(
            np.asarray, jinit(jax.random.PRNGKey(0), JNeRFConfig(
                D=mcfg.D, W=mcfg.W, in_channels_xyz=mcfg.in_channels_xyz,
                in_channels_dir=mcfg.in_channels_dir, skips=mcfg.skips)))
            for m in ("nerf_coarse", "nerf_fine")}
        for size in (1, 2, 4):
            for tp in (False, True):
                ours = model_pspecs(jparams, size, tp)
                ref = jmodel_pspecs(jparams, size, tp)
                assert ours == jax.tree_util.tree_map(
                    tuple, ref, is_leaf=lambda x: isinstance(x, P)), \
                    (name, size, tp)


# ------------------------------------------------------------------ steps

def test_tp_matches_dp_numerics(ranks):
    """5 steps at (2, 2) with tensor parallelism against the port's dp
    (2, 1): the same data axis, so the same batches and draws. Losses
    within rtol 2e-4, the final xyz_0.w within atol 2e-5 (JAX's bars for
    its own TP against DP), and every rank holding the same whole
    params."""
    for res in ranks:
        tp, dp = res["steps"]["tp"], res["steps"]["dp"]
        assert len(tp["losses"]) == K_STEPS
        np.testing.assert_allclose(tp["losses"], dp["losses"],
                                   rtol=LOSS_RTOL)
        k = "nerf_coarse/xyz_0/w"
        np.testing.assert_allclose(tp["params"][k], dp["params"][k],
                                   atol=W_ATOL)
        for k, v in ranks[0]["steps"]["tp"]["params"].items():
            np.testing.assert_array_equal(tp["params"][k], v, err_msg=k)


@pytest.mark.parametrize("name", STEP_MODELS)
def test_step_matches_jax_tp_mesh(ranks, specs, name):
    """One step of JAX's Trainer(make_mesh(2, 2), tensor_parallel=True)
    against the port's at (2, 2), JAX's global draws sliced by data index:
    loss within 1e-6 relative; each rank's gradient block against the
    same block of JAX's at cosine >= 0.999 and relative L2 <= 0.05, and
    the coarse blocks within a relative max error of 1e-2."""
    s = specs["step"][1]
    mesh = _jmesh()
    jt = _jtrainer(name)
    params = s["params"][name]
    shard = jax.tree_util.tree_map(
        lambda spec: NamedSharding(mesh, spec),
        jmodel_pspecs(params, 2, True), is_leaf=lambda x: isinstance(x, P))
    data = NamedSharding(mesh, P("data"))
    loss_j, _, g_j = jax.jit(jt._loss_and_grads)(
        jax.device_put(params, shard), jax.device_put(s["rays"], data),
        jax.device_put(s["rgbs"], data), s["key"])
    g_j = {k: np.asarray(v) for k, v in jflat(g_j).items()}
    specs_t = _port_specs(name)
    for r, res in enumerate(ranks):
        got = res["step"][name]
        assert abs(got["loss"] - float(loss_j)) <= 1e-6 * float(loss_j)
        assert set(got["grads"]) == set(g_j)
        for k, whole in g_j.items():
            a = got["grads"][k].ravel()
            b = _block(whole, k, specs_t, r % 2).ravel()
            cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
            l2 = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert cos >= 0.999 and l2 <= 0.05, (r, k, cos, l2)
            if k.startswith("nerf_coarse"):
                rel = np.abs(a - b).max() / np.abs(b).max()
                assert rel <= 1e-2, (r, k, rel)


@pytest.mark.parametrize("route", list(ROUTES))
def test_kernel_routes_under_tp_equal_dp(ranks, route):
    """The `fused` (point MLP) and `fused_train` routes at (2, 2) with
    the full model: each rank gathers the whole weights before packing,
    so the step's loss and gathered gradients are the dp (2, 1) step's,
    bit for bit (the kernels' plain versions here)."""
    for res in ranks:
        tp, dp = res["routes"][route]["tp"], res["routes"][route]["dp"]
        assert tp["loss"] == dp["loss"] and tp["mse"] == dp["mse"]
        assert set(tp["grads"]) == set(dp["grads"])
        for k, v in dp["grads"].items():
            np.testing.assert_array_equal(tp["grads"][k], v, err_msg=k)


def test_tp_rejected_on_fused_loss_path(ranks):
    """The loss-fused step shards rays only, as in JAX: run_steps raises
    a ValueError naming tensor_parallel on every rank."""
    for res in ranks:
        assert res["fused_loss"] is not None
        assert "tensor_parallel" in res["fused_loss"]


# ----------------------------------------------------------------- resume

def test_resume_continues_the_stream_and_keeps_blocks(ranks):
    """2 steps, a checkpoint of the gathered state rank 0 writes, 2 steps
    from it: the loss stream of 4 uninterrupted steps (rtol 1e-5), at step
    4; the loaded blocks are the saved blocks, bit for bit."""
    for res in ranks:
        got = res["resume"]
        np.testing.assert_allclose(got["head"]["losses"]
                                   + got["tail"]["losses"],
                                   got["full"]["losses"], rtol=1e-5)
        assert got["tail"]["step"] == 4
        assert set(got["tail"]["loaded"]) == set(got["head"]["blocks"])
        for k, v in got["head"]["blocks"].items():
            np.testing.assert_array_equal(got["tail"]["loaded"][k], v,
                                          err_msg=k)


def test_tp_checkpoint_loads_in_jax(ranks, specs):
    """JAX load_checkpoint reads the port's tensor parallel checkpoint
    into the JAX TP Trainer's state: every leaf the port's gathered whole
    state, bit for bit."""
    jt = _jtrainer("small")
    template = jt.init_state(jax.random.PRNGKey(0))
    restored, meta = jload(specs["resume"][1]["ckpt"], template)
    assert int(restored.step) == 2 and meta == {"step": 2}
    flat = {k: np.asarray(v) for k, v in jflat(restored).items()}
    whole = ranks[0]["resume"]["head"]["whole"]
    assert set(flat) == set(whole)
    for k, v in whole.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def test_jax_checkpoint_loads_as_blocks(ranks, jax_ckpt):
    """The port's load_checkpoint(tp=) takes each rank's blocks of a
    checkpoint the JAX package wrote: params and moments, bit for bit."""
    _, flat = jax_ckpt
    specs = _port_specs("small")
    for r, res in enumerate(ranks):
        got = res["resume"]["jax_blocks"]
        assert set(got) == set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k], _block(v, k, specs, r % 2),
                                          err_msg=k)


# ------------------------------------------------------------ nerf_apply

def _linear(p, x, compute_dtype):
    w = p["w"].to(compute_dtype).float()
    return x.to(compute_dtype).float() @ w + p["b"]


def _nerf_apply_one_device(params, xyz_emb, dir_emb, cfg, sigma_only,
                           compute_dtype):
    """models/nerf.py::nerf_apply as it was before the tensor parallel
    layout, line for line."""
    h = xyz_emb
    for i in range(cfg.D):
        if i in cfg.skips:
            h = torch.cat([xyz_emb, h], dim=-1)
        h = torch.relu(_linear(params[f"xyz_{i}"], h, compute_dtype))
    sigma = _linear(params["sigma"], h, compute_dtype)
    if sigma_only:
        return sigma
    feat = _linear(params["xyz_final"], h, compute_dtype)
    d = dir_emb.expand(*feat.shape[:-1], dir_emb.shape[-1])
    hdir = torch.relu(_linear(params["dir"], torch.cat([feat, d], -1),
                              compute_dtype))
    return torch.sigmoid(_linear(params["rgb"], hdir, compute_dtype)), \
        sigma


@pytest.mark.parametrize("name", ("full",) + STEP_MODELS)
def test_nerf_apply_without_tp_is_unchanged(name):
    """nerf_apply with no layout (the default) gives the one-device MLP's
    outputs bit for bit, f32 and bf16 products, with and without the view
    branch."""
    cfg = ranks_mod.mcfg(name).nerf
    params = init_nerf_params(torch.Generator().manual_seed(3), cfg)
    rng = np.random.default_rng(4)
    xyz = torch.from_numpy(rng.normal(size=(16, 5, cfg.in_channels_xyz))
                           .astype(np.float32))
    dirs = torch.from_numpy(rng.normal(size=(16, 1, cfg.in_channels_dir))
                            .astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        for sigma_only in (False, True):
            got = tnerf.nerf_apply(params, xyz, dirs, cfg, sigma_only, dtype)
            ref = _nerf_apply_one_device(params, xyz, dirs, cfg, sigma_only,
                                         dtype)
            for a, b in zip(*((got, ref) if not sigma_only
                              else ((got,), (ref,)))):
                assert torch.equal(a, b), (name, dtype, sigma_only)


# ---------------------------------------------------------------- dry run

def test_dryrun_multichip_4_on_cpu():
    """python -m nerf_pl_tpu_torch.dryrun_multichip 4 --device cpu exits 0
    with five ok lines; phases 1 and 4 run on the (2, 2) mesh with tensor
    parallelism, the others data parallel over 4."""
    from nerf_pl_tpu_torch import dryrun_multichip
    proc = subprocess.run(
        [sys.executable, "-m", "nerf_pl_tpu_torch.dryrun_multichip", "4",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=dryrun_multichip.TIMEOUT + 60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("[dryrun_multichip]")]
    assert len(lines) == 5 and all(ln.endswith(" ok") for ln in lines), \
        proc.stdout
    mesh = "mesh={'data': 2, 'model': 2} tp=True"
    assert mesh in lines[0] and "gloo on cpu" in lines[0], lines[0]
    assert lines[3].startswith("[dryrun_multichip] resume dp=2") \
        and mesh in lines[3], lines[3]
    for i, word in ((1, "fused_loss dp=4"), (2, "occ_tighten dp=4"),
                    (4, "eval/render dp=4")):
        assert word in lines[i] and "tp=True" not in lines[i], lines[i]


def test_dryrun_multichip_needs_cuda(monkeypatch):
    """Without --device the dry run runs on the card; with no CUDA device
    it raises, as dist.plan_world does, and starts no rank."""
    from nerf_pl_tpu_torch import dryrun_multichip
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pdist, "launch", lambda *a, **k: pytest.fail(
        "launched without CUDA"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip.main(["2"])
