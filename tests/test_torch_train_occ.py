"""Occupancy-tightened training in the port against the JAX package's.

  * one step with segment masks on each of the three training routes
    (plain autograd, autograd through fused_train_render, the loss-fused
    step) against JAX's, on the same draws and masks;
  * Trainer.tighten_store against the JAX Trainer on a one-device CPU
    mesh, on the same set_data store: tightened rays, masks, partition
    order and statistics, and the batch offsets of the packed sampler;
  * the canonical reshuffle of a packed store;
  * NeRFSystem fits with --occ_train --occ_pack --occ_mode weight, its
    packed resume, and the train CLI with --occ_train, on the CPU.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_train import _inputs, _rel, _step_draws

from nerf_pl_tpu.config import get_opts
from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu.parallel import Trainer as JTrainer
from nerf_pl_tpu.parallel import make_mesh
from nerf_pl_tpu.rendering import ModelConfig as JModelConfig
from nerf_pl_tpu.rendering import RenderConfig as JRenderConfig
from nerf_pl_tpu.rendering import occupancy as jocc
from nerf_pl_tpu.rendering import render_rays as jrender
from nerf_pl_tpu.rendering.render import fused_mse_train_step as jstep
from nerf_pl_tpu.training import get_lr_schedule as jsched
from nerf_pl_tpu.training import get_optimizer as jopt
from nerf_pl_tpu.training import loss_dict as jloss
from nerf_pl_tpu.utils.synthetic import make_blender_scene
from nerf_pl_tpu_torch import train as ttrain
from nerf_pl_tpu_torch.models import params_from_numpy
from nerf_pl_tpu_torch.parallel import Trainer
from nerf_pl_tpu_torch.rendering import ModelConfig, RenderConfig, render_rays
from nerf_pl_tpu_torch.rendering.render import fused_mse_train_step
from nerf_pl_tpu_torch.training import (get_lr_schedule, get_optimizer,
                                        loss_dict)
from nerf_pl_tpu_torch.training.system import NeRFSystem

SCHED = dict(lr_scheduler="steplr", lr=1e-3, num_epochs=4,
             steps_per_epoch=10, decay_step=[100], decay_gamma=0.5)
BOXES = np.asarray([[-0.6, -0.6, -0.6, 0.2, 0.3, 0.4],
                    [0.5, -0.2, -1.0, 1.2, 0.6, 0.9],
                    [-1.4, 0.4, -0.3, -0.8, 1.3, 0.2]], np.float32)


def _trainer(rcfg, batch):
    sched = get_lr_schedule(**SCHED)
    return Trainer(ModelConfig(), rcfg, get_optimizer("adam", sched), sched,
                   loss_dict["mse"], batch, "cpu")


def _jtrainer(rcfg, batch):
    sched = jsched(**SCHED)
    return JTrainer(make_mesh(num_data=1), JModelConfig(), rcfg,
                    jopt("adam", sched), sched, jloss["mse"], batch)


def _masks(rays, n_seg=32, dilate=1):
    """JAX's dilated segment masks of the rays against BOXES (uint32)."""
    m = jocc.ray_box_segment_bits(jnp.asarray(BOXES), jnp.asarray(rays),
                                  n_seg)
    return np.asarray(jocc.dilate_segment_bits(m, n_seg, dilate))


@pytest.mark.parametrize("route", ["plain", "fused_train", "fused_loss"])
def test_occm_step_matches_jax(route):
    """One step with 32-segment masks (16 + 8 samples, perturb 1, noise 1,
    white background, JAX-initialised weights), JAX's draws injected: the
    render outputs within 2e-2 and the loss within 1e-4 relative. Each
    gradient leaf at cosine >= 0.999 and relative L2 error <= 0.05, the
    bars of test_fused_mse_train_step_matches_jax and
    test_autograd_step_matches_jax (measured >= 0.99937 and <= 0.036): the
    two packages' occupied_z_vals cumulate the segment cdf in different
    orders and place the coarse depths up to ~6e-6 apart
    (test_occupied_z_vals_match_jax), which the 2^9 embedding frequency
    turns into feature changes that flip single ReLU masks and bf16
    roundings, so a leaf's max error is no bar (measured up to 9.4%). The
    plain route's coarse leaves, f32 throughout, keep that test's relative
    max error 1e-2 (measured 8e-4)."""
    R, n_seg = 32, 32
    params = {m: jax.tree_util.tree_map(np.asarray,
                                        jinit(jax.random.PRNGKey(k)))
              for k, m in enumerate(("nerf_coarse", "nerf_fine"))}
    rays, _, _, gt = _inputs(R, 1, seed=3)
    rgbs = gt[:, :3].copy()
    occm = _masks(rays, n_seg)
    assert (occm != np.uint32(0xFFFFFFFF)).any() and (occm >> 31).any()
    base = dict(N_samples=16, N_importance=8, white_back=True, perturb=1.0,
                noise_std=1.0, fused_train=route != "plain",
                fused_loss=route == "fused_loss")
    key = jax.random.PRNGKey(5)
    jcfg, cfg = JRenderConfig(**base), RenderConfig(**base)
    jargs = (jnp.asarray(rays), jnp.asarray(rgbs))
    if route == "fused_loss":
        ls, out_j, g_j = jstep(params, *jargs, key, jcfg, R,
                               occm=jnp.asarray(occm), n_seg=n_seg)
        loss_j = ls / R
    else:
        def loss_of(p):
            out = jrender(p, jargs[0], key, jcfg, occm=jnp.asarray(occm),
                          n_seg=n_seg)
            return jloss["mse"](out, jargs[1]), out

        (loss_j, out_j), g_j = jax.jit(jax.value_and_grad(
            loss_of, has_aux=True))(params)
    tparams = {k: params_from_numpy(v) for k, v in params.items()}
    targs = (torch.from_numpy(rays), torch.from_numpy(rgbs))
    tocc = torch.from_numpy(occm.astype(np.int64))
    draws = _step_draws(key, R, cfg)
    with torch.no_grad():
        if route == "fused_loss":
            _, out_t, _ = fused_mse_train_step(tparams, *targs, cfg, R,
                                               draws=draws, occm=tocc,
                                               n_seg=n_seg)
        else:
            out_t = render_rays(tparams, targs[0], cfg, draws=draws,
                                occm=tocc, n_seg=n_seg)
    assert set(out_t) == set(out_j)
    for k in out_j:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=2e-2, err_msg=k)
    tr = _trainer(cfg, R)
    tr.family.n_seg = n_seg
    loss_t, _, g_t = tr.family.loss_and_grads(tparams, *targs, None,
                                              draws=draws, occm=tocc)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-4 * float(loss_j)
    for model in g_j:
        for layer in g_j[model]:
            for leaf in ("w", "b"):
                a = g_t[model][layer][leaf].numpy().ravel()
                b = np.asarray(g_j[model][layer][leaf]).ravel()
                cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
                l2 = np.linalg.norm(a - b) / np.linalg.norm(b)
                assert cos >= 0.999 and l2 <= 0.05, (model, layer, leaf,
                                                     cos, l2)
                if route == "plain" and model == "nerf_coarse":
                    assert _rel(a, b) <= 1e-2, (layer, leaf, _rel(a, b))


def _store(n, seed):
    """Rays from a sphere of radius 4 at points of [-1.5, 1.5]^3 (near 2,
    far 6, direction norms 0.5-1.5), and colours."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o *= 4.0 / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-1.5, 1.5, (n, 3)) - o
    d *= rng.uniform(0.5, 1.5, (n, 1)) / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 2.0), np.full((n, 1), 6.0)],
                          1).astype(np.float32)
    return rays, rng.random((n, 3)).astype(np.float32)


def _close(a, b, what):
    assert abs(a - b) <= 1e-6 * abs(b), (what, a, b)


@pytest.mark.parametrize("margin,n_seg,dilate,pack",
                         [(0.1, 32, 1, True), (0.05, 16, 0, False)])
def test_tighten_store_matches_jax(margin, n_seg, dilate, pack):
    """The same set_data store (same numpy permutation, padded to whole
    batches of 256): tightened rays and masks bit for bit; with pack the
    same survivors-first row order, survivor count and statistics (within
    1e-6 relative), and every batch of two epochs read at the offset of
    JAX's formula, wrapped over the survivors. Without pack, a reshuffle
    keeps the masks aligned with their rays."""
    rays, rgbs = _store(3000, seed=1)
    rcfg = dict(N_samples=8, white_back=True)
    jt, tt = _jtrainer(JRenderConfig(**rcfg), 256), _trainer(
        RenderConfig(**rcfg), 256)
    jt.set_data(rays, rgbs, shuffle_seed=4)
    tt.set_data(rays, rgbs, shuffle_seed=4)
    kw = dict(margin=margin, n_seg=n_seg, dilate=dilate, pack=pack)
    st_j, st_t = jt.tighten_store(BOXES, **kw), tt.tighten_store(BOXES, **kw)
    assert set(st_t) == set(st_j)
    for k in st_j:
        _close(st_t[k], st_j[k], k)
    assert 0.2 < st_t["hit_frac"] < 0.9 and st_t["shrink"] > 0.1
    np.testing.assert_array_equal(tt.all_rays.numpy(),
                                  np.asarray(jt.all_rays))
    np.testing.assert_array_equal(tt.all_rgbs.numpy(),
                                  np.asarray(jt.all_rgbs))
    np.testing.assert_array_equal(tt.all_occm.numpy().astype(np.uint32),
                                  np.asarray(jt.all_occm))
    np.testing.assert_array_equal(tt.all_idx.numpy(), np.asarray(jt.all_idx))
    b, spe = 256, tt.steps_per_epoch
    if pack:
        np.testing.assert_array_equal(tt.all_hit.numpy(),
                                      np.asarray(jt.all_hit) > 0.5)
        assert tt.all_nsurv == int(np.asarray(jt.all_nsurv).sum())
        assert tt.all_hit[:tt.all_nsurv].all()
        assert not tt.all_hit[tt.all_nsurv:].any()
        K = max(tt.all_nsurv // b, 1) * b
        assert K < spe * b                    # the wrap takes effect
    else:
        K = spe * b
    for step in range(2 * spe):
        # JAX's formula: off = (step % spe) * b, wrapped at K when packed
        off = (step % spe) * b % K
        got = tt._sample_batch(step)
        assert len(got) == 3
        for a, full in zip(got, (tt.all_rays, tt.all_rgbs, tt.all_occm)):
            assert torch.equal(a, full[off:off + b])
    if not pack:
        tt.reshuffle(7)
        shuffled = tt.all_occm.clone()
        tt.tighten_store(BOXES, **kw)
        assert torch.equal(shuffled, tt.all_occm)


def test_canonical_reshuffle_is_order_independent():
    """Two trainers hold one store in different orders; after the packed
    tighten and reshuffle(11), their layouts are equal, survivors first,
    and another seed gives another order."""
    rays, rgbs = _store(2000, seed=2)
    ta, tb = (_trainer(RenderConfig(N_samples=8), 256) for _ in range(2))
    ta.set_data(rays, rgbs)
    tb.set_data(rays, rgbs)
    tb.reshuffle(99)
    for t in (ta, tb):
        t.tighten_store(BOXES, margin=0.0, n_seg=32, pack=True)
        t.reshuffle(11)
    for name in ("all_idx", "all_rays", "all_rgbs", "all_nf0", "all_occm",
                 "all_hit"):
        assert torch.equal(getattr(ta, name), getattr(tb, name)), name
    n = ta.all_nsurv
    assert 0 < n < len(ta.all_hit) and ta.all_hit[:n].all()
    assert not ta.all_hit[n:].any()
    before = ta.all_idx.clone()
    ta.reshuffle(12)
    assert not torch.equal(before, ta.all_idx)
    assert torch.equal(torch.sort(before).values,
                       torch.sort(ta.all_idx).values)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the fits below run thousands of small ops, which
    several threads only slow down when the lane's other workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_blender_scene(str(tmp_path_factory.mktemp("occ_scene")),
                              n_train=12, n_val=1, n_test=1, wh=(16, 16))


def _flags(scene, epochs, extra=()):
    return ["--dataset_name", "blender", "--root_dir", scene,
            "--img_wh", "16", "16", "--N_samples", "16",
            "--N_importance", "8", "--batch_size", "256", "--lr", "3e-3",
            "--num_epochs", str(epochs), "--fused_train", "--scan_steps",
            "4", "--val_chunk", "256", "--exp_name", "occ", "--occ_train",
            "--occ_warmup_epochs", "1", "--occ_refresh_epochs", "2",
            "--occ_N", "16", "--occ_range", "-1.5", "1.5",
            "--occ_threshold", "0", "--occ_segments", "16",
            "--occ_dilate", "1", "--occ_pack", "--occ_mode", "weight",
            *extra]


def test_fit_tightens_packs_and_resumes_packed(scene, tmp_path, capsys):
    """4 epochs (warmup 1, refresh 2, occ_N 16 over [-1.5, 1.5]^3, packed,
    weight mode; test_helpers_match_jax holds the auto ranges): the
    [occ] line prints with its packing, the store's intervals shrink, the
    store stays survivors-first; a resume from last.ckpt past warmup takes
    the packed-resume path (grid from the restored params, then the
    canonical reshuffle of the last epoch) and trains one more epoch."""
    kw = dict(log_dir=str(tmp_path / "logs"),
              ckpt_root=str(tmp_path / "ckpts"), device="cpu",
              enable_tb=False)
    system = NeRFSystem(get_opts(_flags(scene, 4)), **kw)
    final = system.fit()
    out = capsys.readouterr().out
    assert np.isfinite(final["val/psnr"])
    assert "packed: x" in out and "16-segment masks (dilate 1)" in out
    tr = system.trainer
    span = tr.all_rays[:, 7] - tr.all_rays[:, 6]
    span0 = tr.all_nf0[:, 1] - tr.all_nf0[:, 0]
    assert (span < span0 - 1e-4).float().mean() > 0.1
    assert tr.all_hit[:tr.all_nsurv].all()
    assert not tr.all_hit[tr.all_nsurv:].any()

    resumed = NeRFSystem(get_opts(_flags(scene, 5, (
        "--ckpt_path", str(tmp_path / "ckpts" / "occ" / "last.ckpt")))),
        **kw)
    calls = []
    tighten = resumed._occ_tighten
    resumed._occ_tighten = lambda: (calls.append(resumed.state.step),
                                    tighten())[1]
    resumed.fit()
    assert calls[0] == 4 * system.steps_per_epoch     # before any step
    tr = resumed.trainer
    assert resumed.state.step == 5 * system.steps_per_epoch
    assert tr.all_hit is not None and tr.pack_expand > 1.0
    assert tr.all_hit[:tr.all_nsurv].all()
    assert not tr.all_hit[tr.all_nsurv:].any()


def test_train_cli_occ_train_on_cpu(scene, tmp_path, monkeypatch, capsys):
    """--occ_train and its siblings train through the CLI when the caller
    asks for the CPU."""
    monkeypatch.chdir(tmp_path)
    final = ttrain.main(_flags(scene, 2), device="cpu")
    assert np.isfinite(final["val/psnr"]) and final["epoch"] == 2
    assert "[occ] " in capsys.readouterr().out
    assert os.path.isfile(tmp_path / "ckpts" / "occ" / "last.ckpt")
