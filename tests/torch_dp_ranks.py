"""The ranks' side of tests/test_torch_dp.py: what each spawned rank of a
2-rank gloo group computes with the port, from numpy inputs the test
made. It imports nothing of jax or the JAX package, so that a spawned rank
loads only torch and the port; the test holds the results against the
JAX package's and against one process of the port.

`probe(group, device, spec)` runs spec's entries {name: (part, its
inputs)} and returns {name: result}, tensors as numpy arrays."""
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from nerf_pl_tpu_torch import dist as pdist
from nerf_pl_tpu_torch.models import params_from_numpy
from nerf_pl_tpu_torch.parallel import Trainer, make_render_fn
from nerf_pl_tpu_torch.rendering import (CulledRenderer, ModelConfig,
                                         OccupancyGrid, RenderConfig,
                                         TrainDraws)
from nerf_pl_tpu_torch.training import (get_lr_schedule, get_optimizer,
                                        loss_dict)
from nerf_pl_tpu_torch.training.checkpoints import (flatten_with_paths,
                                                    load_checkpoint,
                                                    save_checkpoint)

SCHED = dict(lr_scheduler="steplr", lr=1e-3, num_epochs=4,
             steps_per_epoch=10, decay_step=[100], decay_gamma=0.5)


def trainer(rcfg_kw, batch, group, device="cpu", mcfg=ModelConfig()):
    sched = get_lr_schedule(**SCHED)
    return Trainer(mcfg, RenderConfig(**rcfg_kw), get_optimizer("adam", sched),
                   sched, loss_dict["mse"], batch, device, group=group)


def _np(tree):
    return {k: np.array(v) for k, v in flatten_with_paths(tree).items()}


def _store(tr):
    return {name: a.numpy().copy() for name, a in tr._store_named()}


def _store_part(group, device, s):
    """set_data's shard, then tighten_store's: the arrays, labels, steps
    a shard and the reduced stats."""
    tr = trainer(s["rcfg"], s["batch"], group)
    tr.set_data(s["rays"], s["rgbs"], shuffle_seed=s["shuffle_seed"])
    out = {"set_data": _store(tr), "steps_per_epoch": tr.steps_per_epoch}
    out["stats"] = tr.tighten_store(s["boxes"], **s["tighten"])
    out["tightened"] = _store(tr)
    out["nsurv"], out["expand"] = tr.all_nsurv, tr.pack_expand
    return out


def _step_part(group, device, s):
    """One family.loss_and_grads of the global batch with the given
    params, this rank's rows and draws."""
    rank = pdist.rank_of(group)
    tr = trainer(s["rcfg"], s["batch"], group)
    b = tr.batch_local
    rows = slice(rank * b, (rank + 1) * b)
    draws = TrainDraws(**{k: torch.from_numpy(v[rank])
                          for k, v in s["draws"].items()})
    params = {k: params_from_numpy(v) for k, v in s["params"].items()}
    loss, mse, grads = tr.family.loss_and_grads(
        params, torch.from_numpy(s["rays"][rows]),
        torch.from_numpy(s["rgbs"][rows]), None, draws=draws)
    return {"loss": float(loss), "mse": float(mse), "grads": _np(grads)}


def _fit(tr, seed, splits, state=None):
    if state is None:
        state = tr.init_state(torch.Generator().manual_seed(0))
    losses = []
    for n in splits:
        state, m = tr.run_steps(state, seed, n)
        losses.extend(m["loss"].tolist())
    return state, losses


def _steps_part(group, device, s):
    """K steps in the group, and on each rank a one-rank gloo group's K
    steps beside a no-group trainer's (new_group is collective: every rank
    makes both one-rank groups)."""
    rank = pdist.rank_of(group)
    singles = [dist.new_group([r], backend="gloo")
               for r in range(pdist.world_of(group))]
    out = {}
    for name, rcfg in s["routes"].items():
        tr = trainer(rcfg, s["batch"], group)
        tr.set_data(s["rays"], s["rgbs"])
        state, losses = _fit(tr, s["seed"], [s["k"]])
        finals = {}
        for tag, g in (("one_rank_group", singles[rank]), ("no_group", None)):
            t1 = trainer(rcfg, s["batch"], g)
            t1.set_data(s["rays"], s["rgbs"])
            finals[tag] = _np(_fit(t1, s["seed"], [s["k"]])[0])
        out[name] = {"losses": losses, "state": _np(state), **finals}
    return out


def _resume_part(group, device, s):
    """4 steps, and 2 + a checkpoint rank 0 writes + 2 from it."""
    rcfg = s["rcfg"]

    def run(splits, save=False, restore=False):
        tr = trainer(rcfg, s["batch"], group)
        tr.set_data(s["rays"], s["rgbs"])
        state = tr.init_state(torch.Generator().manual_seed(0))
        if restore:
            state, _ = load_checkpoint(s["ckpt"], state)
        state, losses = _fit(tr, s["seed"], splits, state)
        if save:
            if pdist.is_main(group):
                save_checkpoint(s["ckpt"], state, {"step": state.step})
            pdist.barrier(group)
        return state, losses

    _, full = run([4])
    _, head = run([2], save=True)
    state, tail = run([2], restore=True)
    return {"full": full, "head": head, "tail": tail, "step": state.step}


def _render_part(group, device, s):
    """The dense render of the rays over the group."""
    params = {k: params_from_numpy(v) for k, v in s["params"].items()}
    return make_render_fn(RenderConfig(**s["rcfg"]), s["chunk"], device,
                          s["mcfg"], group=group)(params, s["rays"])


def _culled_part(group, device, s):
    """The culled renderer over the group, one result a config."""
    params = {k: params_from_numpy(v) for k, v in s["params"].items()}
    out = {}
    for name, cfg in s["configs"].items():
        cr = CulledRenderer(OccupancyGrid(**s["grid"]),
                            RenderConfig(**s["rcfg"]), s["mcfg"],
                            chunk=s["chunk"], device="cpu", group=group,
                            **cfg)
        img, stats = cr(params, s["rays"], return_stats=True)
        out[name] = ({k: v.numpy() for k, v in img.items()}, stats)
    return out


PARTS = {"store": _store_part, "step": _step_part, "steps": _steps_part,
         "resume": _resume_part, "render": _render_part,
         "culled": _culled_part}


def probe(group, device, spec):
    out = {name: PARTS[part](group, device, s)
           for name, (part, s) in spec.items()}
    out["pid"] = os.getpid()
    return out


def fail_on_rank_one(group, device):
    """Rank 1 raises; rank 0 waits at a barrier it never passes."""
    if pdist.rank_of(group) == 1:
        raise ValueError("rank 1 fails on purpose")
    pdist.barrier(group)


def sleep(group, device, seconds):
    time.sleep(seconds)


def rank_sum(group, device):
    """(rank, world, the all-reduced sum of rank + 1 over the ranks)."""
    total, = pdist.all_reduce_sum(
        [torch.tensor([pdist.rank_of(group) + 1.0])], group)
    return pdist.rank_of(group), pdist.world_of(group), total.item()


def gloo_on_cuda(group, device):
    """A gloo group's trainer on the card: run_steps raises unless eager,
    and eager steps run; returns the eager losses."""
    tr = trainer(dict(N_samples=8, N_importance=8, perturb=1.0,
                      noise_std=1.0, white_back=True, fused_train=True,
                      fused_loss=True), 64, group, device)
    rng = np.random.default_rng(0)
    rays = np.concatenate([rng.normal(size=(256, 6)), np.full((256, 1), 2.0),
                           np.full((256, 1), 6.0)], 1).astype(np.float32)
    tr.set_data(rays, rng.random((256, 3)).astype(np.float32))
    state = tr.init_state(torch.Generator().manual_seed(0))
    try:
        tr.run_steps(state, 0, 1)
    except RuntimeError as e:
        if "eager=True" not in str(e):
            raise
    else:
        raise AssertionError("run_steps captured a gloo group's step")
    return tr.run_steps(state, 0, 3, eager=True)[1]["loss"].cpu()


def graph_with_group(group, device):
    """One rank's replayed steps with its group and with none: (the
    group's final flat state, no group's, the captures of each)."""
    out = []
    for g in (group, None):
        tr = trainer(dict(N_samples=8, N_importance=8, perturb=1.0,
                          noise_std=1.0, white_back=True, fused_train=True,
                          fused_loss=True), 64, g, device)
        rng = np.random.default_rng(0)
        rays = np.concatenate([rng.normal(size=(640, 6)),
                               np.full((640, 1), 2.0),
                               np.full((640, 1), 6.0)], 1).astype(np.float32)
        tr.set_data(rays, rng.random((640, 3)).astype(np.float32))
        state = tr.init_state(torch.Generator().manual_seed(0))
        state, _ = _fit(tr, 1, [10, 5], state)
        out.append((_np(state), tr.captures))
    return out
