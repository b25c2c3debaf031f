"""The port's trainer, checkpoints, training system and train CLI against
the JAX package's.

  * the unfused autograd step against jax.value_and_grad over JAX
    render_rays, f32, with JAX's draws injected (see its docstring);
  * set_data's permutation and padding bit for bit;
  * train states in both directions: a JAX adam TrainState loads into the
    port's and the port's into JAX's, params, mu, nu, counts and step
    identical;
  * the autograd step with --fused_mlp (the fused point MLP's custom
    VJP) against jax.value_and_grad over JAX's fused render;
  * a 2-epoch fit of NeRFSystem(device="cpu") with --fused_train on a
    40x40 synthetic scene, whose checkpoints JAX load_checkpoint reads,
    and its resume; a 2-epoch fit of the train CLI with --fused_mlp alone;
  * validation with --fused_mlp against the JAX NeRFSystem's on the same
    weights (val/loss holds the coarse term).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_fused_train import _inputs, _step_draws

from nerf_pl_tpu.config import get_opts
from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.parallel import Trainer as JTrainer
from nerf_pl_tpu.parallel import make_mesh
from nerf_pl_tpu.parallel.spmd import TrainState as JTrainState
from nerf_pl_tpu.rendering import ModelConfig as JModelConfig
from nerf_pl_tpu.rendering import RenderConfig as JRenderConfig
from nerf_pl_tpu.rendering import render_rays as jrender
from nerf_pl_tpu.training import get_lr_schedule as jsched
from nerf_pl_tpu.training import get_optimizer as jopt
from nerf_pl_tpu.training import loss_dict as jloss
from nerf_pl_tpu.training.checkpoints import load_checkpoint as jload
from nerf_pl_tpu.training.checkpoints import save_checkpoint as jsave
from nerf_pl_tpu.utils.synthetic import make_blender_scene
from nerf_pl_tpu_torch import train as ttrain
from nerf_pl_tpu_torch.models import params_from_numpy
from nerf_pl_tpu_torch.parallel import Trainer, TrainState
from nerf_pl_tpu_torch.rendering import ModelConfig, RenderConfig
from nerf_pl_tpu_torch.training import (get_lr_schedule, get_optimizer,
                                        loss_dict)
from nerf_pl_tpu_torch.training.checkpoints import (TopKCheckpoints,
                                                    load_checkpoint,
                                                    save_checkpoint)
from nerf_pl_tpu_torch.training.system import NeRFSystem

SCHED = dict(lr_scheduler="steplr", lr=1e-3, num_epochs=4,
             steps_per_epoch=10, decay_step=[2], decay_gamma=0.5)


def _trainer(rcfg, batch, device="cpu"):
    sched = get_lr_schedule(**SCHED)
    return Trainer(ModelConfig(), rcfg, get_optimizer("adam", sched), sched,
                   loss_dict["mse"], batch, device)


def _rays(n, seed=0):
    rays, _, _, gt = _inputs(n, 1, seed)
    return rays, gt[:, :3].copy()


def test_autograd_step_matches_jax():
    """Both passes, perturb and noise, JAX-initialised weights. Loss within
    1e-6 relative (measured 7e-8); coarse leaves within a relative max
    error of 1e-2 (measured 5.3e-3); every leaf at cosine >= 0.999 and
    relative L2 error <= 0.05 (measured >= 0.99916 and <= 0.041). The fine
    leaves are held by direction only: sample_pdf sums the coarse weights'
    cdf in another order than XLA and places the fine depths up to 8e-6
    apart, which the 2^9 embedding frequencies turn into feature changes
    of ~4e-3 and flipped ReLU masks."""
    R = 32
    params = {m: jax.tree_util.tree_map(np.asarray,
                                        jinit(jax.random.PRNGKey(k)))
              for k, m in enumerate(("nerf_coarse", "nerf_fine"))}
    rays, rgbs = _rays(R, seed=2)
    base = dict(N_samples=16, N_importance=8, white_back=True, perturb=1.0,
                noise_std=1.0)
    key = jax.random.PRNGKey(5)

    def loss_of(p):
        out = jrender(p, jnp.asarray(rays), key, JRenderConfig(**base))
        return jloss["mse"](out, jnp.asarray(rgbs))

    loss_j, g_j = jax.jit(jax.value_and_grad(loss_of))(params)
    cfg = RenderConfig(**base)
    tr = _trainer(cfg, R)
    loss_t, mse_t, g_t = tr._loss_and_grads(
        {k: params_from_numpy(v) for k, v in params.items()},
        torch.from_numpy(rays), torch.from_numpy(rgbs), None,
        draws=_step_draws(key, R, cfg))
    assert abs(float(loss_t) - float(loss_j)) <= 1e-6 * float(loss_j)
    for model in g_j:
        for layer in g_j[model]:
            for leaf in ("w", "b"):
                a = g_t[model][layer][leaf].numpy().ravel()
                b = np.asarray(g_j[model][layer][leaf]).ravel()
                cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
                l2 = np.linalg.norm(a - b) / np.linalg.norm(b)
                assert cos >= 0.999 and l2 <= 0.05, (model, layer, leaf)
                if model == "nerf_coarse":
                    rel = np.abs(a - b).max() / np.abs(b).max()
                    assert rel <= 1e-2, (model, layer, leaf, rel)


def test_fused_autograd_step_matches_jax():
    """The autograd step with --fused_mlp (both passes through
    fused_nerf_mlp's custom VJP, perturb and noise) against
    jax.value_and_grad over JAX's fused render_rays, JAX's draws injected.
    Loss within 1e-4 relative; each leaf within a relative max error of
    0.03 (the bar of the gradient-parity tests; bf16 roundings and ReLU
    masks of single activations flip between the two summation orders;
    measured <= 1.4e-4 coarse, <= 7.4e-3 fine)."""
    R = 32
    params = {m: jax.tree_util.tree_map(np.asarray,
                                        jinit(jax.random.PRNGKey(k)))
              for k, m in enumerate(("nerf_coarse", "nerf_fine"))}
    rays, rgbs = _rays(R, seed=2)
    base = dict(N_samples=16, N_importance=8, white_back=True, perturb=1.0,
                noise_std=1.0, fused=True)
    key = jax.random.PRNGKey(5)

    def loss_of(p):
        out = jrender(p, jnp.asarray(rays), key, JRenderConfig(**base))
        return jloss["mse"](out, jnp.asarray(rgbs))

    loss_j, g_j = jax.value_and_grad(loss_of)(params)
    cfg = RenderConfig(**base)
    tr = _trainer(cfg, R)
    loss_t, _, g_t = tr._loss_and_grads(
        {k: params_from_numpy(v) for k, v in params.items()},
        torch.from_numpy(rays), torch.from_numpy(rgbs), None,
        draws=_step_draws(key, R, cfg))
    assert abs(float(loss_t) - float(loss_j)) <= 1e-4 * float(loss_j)
    for model in g_j:
        for layer in g_j[model]:
            for leaf in ("w", "b"):
                a = g_t[model][layer][leaf]
                b = np.asarray(g_j[model][layer][leaf])
                assert a.dtype == torch.float32
                rel = np.abs(a.numpy() - b).max() / np.abs(b).max()
                assert rel < 0.03, (model, layer, leaf, rel)


def test_set_data_matches_jax():
    """Permutation and modular padding to whole batches, bit for bit."""
    rays, rgbs = _rays(1000, seed=1)
    rcfg = JRenderConfig(N_samples=8)
    sched = jsched(**SCHED)
    jt = JTrainer(make_mesh(num_data=1), JModelConfig(), rcfg,
                  jopt("adam", sched), sched, jloss["mse"], 384)
    jt.set_data(rays, rgbs, shuffle_seed=3)
    tt = _trainer(RenderConfig(N_samples=8), 384)
    tt.set_data(rays, rgbs, shuffle_seed=3)
    np.testing.assert_array_equal(tt.all_rays.numpy(),
                                  np.asarray(jt.all_rays))
    np.testing.assert_array_equal(tt.all_rgbs.numpy(),
                                  np.asarray(jt.all_rgbs))
    assert tt.steps_per_epoch == jt.steps_per_epoch_local == 3
    a, b = tt._sample_batch(4)          # step 4 = block 1 of the epoch
    torch.testing.assert_close(a, tt.all_rays[384:768])


def _jax_state(step):
    kc, kf = jax.random.split(jax.random.PRNGKey(0))
    params = {"nerf_coarse": jinit(kc), "nerf_fine": jinit(kf)}
    opt = jopt("adam", jsched(**SCHED))
    state = opt.init(params)
    grads = jax.tree_util.tree_map(lambda p: 0.01 * p + 1e-3, params)
    for _ in range(step):
        upd, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, upd)
    return JTrainState(params, state, jnp.asarray(step, jnp.int32))


def _assert_same_state(port: TrainState, jax_state):
    from nerf_pl_tpu.training.checkpoints import flatten_with_paths as jflat
    from nerf_pl_tpu_torch.training.checkpoints import flatten_with_paths
    fj, ft = jflat(jax_state), flatten_with_paths(port)
    assert set(fj) == set(ft)
    for k in fj:
        assert ft[k].dtype == fj[k].dtype, k
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)


def test_checkpoints_load_in_both_packages(tmp_path):
    js = _jax_state(3)
    path = str(tmp_path / "jax.ckpt")
    jsave(path, js, {"step": 3})
    tt = _trainer(RenderConfig(N_samples=8, N_importance=8), 8)
    template = tt.init_state(torch.Generator().manual_seed(0))
    ported, meta = load_checkpoint(path, template)
    assert meta == {"step": 3} and ported.step == 3
    _assert_same_state(ported, js)

    back = str(tmp_path / "torch.ckpt")
    save_checkpoint(back, ported, {"step": 3})
    restored, _ = jload(back, _jax_state(0))
    _assert_same_state(ported, restored)


def test_topk_keeps_the_best(tmp_path):
    tt = _trainer(RenderConfig(N_samples=8), 8)
    state = tt.init_state(torch.Generator().manual_seed(0))
    topk = TopKCheckpoints(str(tmp_path), k=2)
    for epoch, loss in enumerate([0.5, 0.3, 0.4, 0.1]):
        topk.maybe_save(state, loss, epoch)
    assert sorted(os.listdir(tmp_path)) == ["epoch=1.ckpt", "epoch=3.ckpt",
                                            "topk.json"]
    assert TopKCheckpoints(str(tmp_path), k=2).best[0] == 0.1


def test_run_steps_stream_depends_on_seed_and_step_only():
    """One segment of 4 steps equals two of 2: the draws of a step are a
    function of (seed, step), as in the JAX Trainer."""
    rays, rgbs = _rays(256, seed=4)
    rcfg = RenderConfig(N_samples=8, N_importance=4, perturb=1.0,
                        noise_std=1.0, white_back=True, fused_train=True,
                        fused_loss=True)
    runs = []
    for segs in ((4,), (2, 2)):
        tr = _trainer(rcfg, 64)
        tr.set_data(rays, rgbs)
        state = tr.init_state(torch.Generator().manual_seed(0))
        losses = []
        for n in segs:
            state, m = tr.run_steps(state, 9, n)
            losses.append(m["loss"])
        runs.append((state, torch.cat(losses)))
    (s1, l1), (s2, l2) = runs
    assert s1.step == s2.step == 4
    torch.testing.assert_close(l1, l2, rtol=0, atol=0)
    for a, b in zip(*(jax.tree_util.tree_leaves(s.params) for s in (s1, s2))):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_blender_scene(str(tmp_path_factory.mktemp("scene")),
                              n_train=2, n_val=1, n_test=1, wh=(40, 40))


def _flags(scene, epochs, extra=()):
    return ["--dataset_name", "blender", "--root_dir", scene,
            "--img_wh", "40", "40", "--N_samples", "16",
            "--N_importance", "8", "--batch_size", "512",
            "--num_epochs", str(epochs), "--fused_train", "--fused_mlp",
            "--scan_steps", "4", "--val_chunk", "1600", "--exp_name", "t",
            "--decay_step", "1", "--log_every", "1", *extra]


def test_fit_writes_checkpoints_jax_reads_and_resumes(scene, tmp_path):
    kw = dict(log_dir=str(tmp_path / "logs"),
              ckpt_root=str(tmp_path / "ckpts"), device="cpu")
    system = NeRFSystem(get_opts(_flags(scene, 2)), enable_tb=True, **kw)
    final = system.fit()
    spe = system.steps_per_epoch                 # ceil(3200 / 512) = 7
    assert spe == 7 and system.state.step == 2 * spe
    assert np.isfinite(final["val/psnr"]) and final["epoch"] == 2
    ckpts = tmp_path / "ckpts" / "t"
    names = sorted(os.listdir(ckpts))
    assert {"epoch=1.ckpt", "epoch=2.ckpt", "last.ckpt",
            "topk.json"} <= set(names)
    assert os.listdir(tmp_path / "logs" / "t")   # tensorboard events
    restored, meta = jload(str(ckpts / "last.ckpt"), _jax_state(0))
    assert int(restored.step) == 2 * spe and meta["epoch"] == 2

    resumed = NeRFSystem(get_opts(_flags(scene, 3, (
        "--ckpt_path", str(ckpts / "last.ckpt")))), enable_tb=False, **kw)
    resumed.fit()
    assert resumed.state.step == 3 * spe
    assert int(resumed.state.opt_state[1]["count"]) == 3 * spe


@pytest.mark.parametrize("extra", [["--num_gpus", "2"],
                                   ["--optimizer", "radam"],
                                   ["--optimizer", "ranger"],
                                   ["--precision", "bfloat16"]])
def test_train_cli_rejects_unported_flags(scene, extra, capsys):
    argv = _flags(scene, 1, extra)
    with pytest.raises(SystemExit, match="ROADMAP"):
        ttrain.main(argv, device="cpu")


def test_train_cli_fused_mlp_needs_fused_train(scene, tmp_path,
                                               monkeypatch):
    """--fused_mlp needs no --fused_train (the test keeps the name of the
    rejection it replaced, so its history stays one test): the train CLI
    fits 2 epochs with --fused_mlp alone, by autograd through the fused
    point MLP, validates through it, and JAX load_checkpoint reads its
    last.ckpt."""
    monkeypatch.chdir(tmp_path)
    argv = [a for a in _flags(scene, 2) if a != "--fused_train"]
    final = ttrain.main(argv, device="cpu")
    assert np.isfinite(final["val/psnr"]) and final["epoch"] == 2
    restored, meta = jload(str(tmp_path / "ckpts" / "t" / "last.ckpt"),
                           _jax_state(0))
    assert int(restored.step) == 2 * 7 and meta["epoch"] == 2


def test_validate_fused_mlp_matches_jax(scene):
    """With --fused_mlp both packages validate with test_time off, through
    the point-MLP kernel on both passes: val/loss is the coarse plus the
    fine MSE. Same weights in both (params_from_numpy), one 40x40 view."""
    from nerf_pl_tpu.training.system import NeRFSystem as JNeRFSystem
    argv = [a for a in _flags(scene, 1) if a != "--fused_train"] + [
        "--compile_cache", ""]
    params = {m: jax.tree_util.tree_map(np.asarray,
                                        jinit(jax.random.PRNGKey(k)))
              for k, m in enumerate(("nerf_coarse", "nerf_fine"))}
    js = JNeRFSystem(get_opts(argv), mesh=make_mesh(num_data=1),
                     enable_tb=False)
    js.prepare_data()
    js.setup()
    js.state = js.state._replace(
        params=jax.tree_util.tree_map(jnp.asarray, params))
    ref = js.validate(0, max_items=1)
    ts = NeRFSystem(get_opts(argv), enable_tb=False, device="cpu")
    ts.prepare_data()
    ts.setup()
    ts.state = ts.state._replace(
        params={k: params_from_numpy(v) for k, v in params.items()})
    ours = ts.validate(0, max_items=1)
    fine_mse = 10 ** (-ours["val/psnr"] / 10)
    assert ours["val/loss"] > 1.5 * fine_mse        # the coarse term is in
    assert abs(ours["val/loss"] - ref["val/loss"]) <= 1e-2 * ref["val/loss"]
    assert abs(ours["val/psnr"] - ref["val/psnr"]) <= 0.1


def test_train_cli_needs_cuda_unless_given_a_device(scene, monkeypatch,
                                                    tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(_flags(scene, 1))
    assert not (tmp_path / "ckpts").exists()
