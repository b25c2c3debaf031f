"""The ranks' side of tests/test_torch_tp.py: what each spawned rank of a
4-rank gloo group computes with the port on a dp x tp = (2, 2) mesh, from
numpy inputs the test made. Like tests/torch_dp_ranks.py it imports
nothing of jax or the JAX package (a spawned rank loads torch and the
port only); the test holds the results against the JAX package's and the
port's data parallel trainer.

`probe(group, device, spec)` runs spec's entries {name: (part, inputs)}
and returns {name: result}, tensors as numpy arrays. Besides the (2, 2)
mesh, ranks {0, 1} and {2, 3} form two data parallel groups of 2 (both
compute the same dp (2, 1) run)."""
import os

import torch
import torch.distributed as dist
import torch_dp_ranks as dp

from nerf_pl_tpu_torch import dist as pdist
from nerf_pl_tpu_torch.models import EmbeddingConfig, NeRFConfig
from nerf_pl_tpu_torch.models import params_from_numpy
from nerf_pl_tpu_torch.parallel import Trainer
from nerf_pl_tpu_torch.rendering import ModelConfig, RenderConfig, TrainDraws
from nerf_pl_tpu_torch.training import (get_lr_schedule, get_optimizer,
                                        loss_dict)
from nerf_pl_tpu_torch.training.checkpoints import (gather_state,
                                                    load_checkpoint,
                                                    map_with_paths,
                                                    save_checkpoint)

NUM_MODEL = 2


def mcfg(name):
    """The models of the tests: "small" is tests/test_spmd.py's (its skip
    layer's input, 32 + 27 wide, does not divide by 2 and stays whole, so
    it takes a gathered input); "odd" has a width of 33, so its layer 0
    stays whole and its skip layer (60 wide) is row-parallel on a whole
    input, which each rank slices; "megatron" alternates column and row
    layers through its skip; "full" is the flagship, for the kernels'
    routes."""
    if name == "full":
        return ModelConfig()
    if name == "small":
        nerf = NeRFConfig(D=2, W=32, in_channels_xyz=27, in_channels_dir=15,
                          skips=(1,))
    elif name == "odd":
        nerf = NeRFConfig(D=2, W=33, in_channels_xyz=27, in_channels_dir=15,
                          skips=(1,))
    else:
        nerf = NeRFConfig(D=4, W=32, in_channels_xyz=27, in_channels_dir=15,
                          skips=(2,))
    return ModelConfig(nerf=nerf, emb_xyz=EmbeddingConfig(3, 4),
                       emb_dir=EmbeddingConfig(3, 2))


def trainer(s, group, num_model=NUM_MODEL, tensor_parallel=True,
            device="cpu"):
    sched = get_lr_schedule(**dp.SCHED)
    return Trainer(mcfg(s["mcfg"]), RenderConfig(**s["rcfg"]),
                   get_optimizer("adam", sched), sched, loss_dict["mse"],
                   s["batch"], device, group=group, num_model=num_model,
                   tensor_parallel=tensor_parallel)


def _flat(tree):
    return dp._np(tree)


def _dp_group(group):
    """The data parallel group of 2 this rank belongs to ({0, 1} or
    {2, 3}); every rank makes both."""
    ranks = dist.get_process_group_ranks(group)
    groups = [dist.new_group(ranks[i:i + 2], backend="gloo")
              for i in range(0, len(ranks), 2)]
    return groups[pdist.rank_of(group) // 2]


def _shards_part(group, device, s, dp_group):
    """init_state on the (2, 2) mesh: this rank's blocks, and the whole
    params gathered back."""
    tr = trainer(s, group)
    tr.set_data(s["rays"], s["rgbs"])
    state = tr.init_state(torch.Generator().manual_seed(0))
    return {"blocks": _flat(state.params), "mesh": tr.mesh.shape,
            "index": (tr.mesh.data_index, tr.mesh.model_index),
            "whole": _flat(gather_state(state.params, tr.tp)),
            "moments": _flat(state.opt_state)}


def _fit(tr, seed, splits, state):
    losses = []
    for n in splits:
        state, m = tr.run_steps(state, seed, n)
        losses.extend(m["loss"].tolist())
    return state, losses


def _steps_part(group, device, s, dp_group):
    """K steps at (2, 2) with tensor parallelism, and the same K steps of
    the data parallel trainer over this rank's dp group."""
    out = {}
    for tag, g, nm, tp in (("tp", group, NUM_MODEL, True),
                           ("dp", dp_group, 1, False)):
        tr = trainer(s, g, nm, tp)
        tr.set_data(s["rays"], s["rgbs"])
        state = tr.init_state(torch.Generator().manual_seed(0))
        state, losses = _fit(tr, s["seed"], [s["k"]], state)
        out[tag] = {"losses": losses,
                    "params": _flat(gather_state(state.params, tr.tp))}
    return out


def _step_part(group, device, s, dp_group):
    """One family.loss_and_grads of the global batch at (2, 2) from the
    given whole params (this rank keeps its blocks), this data index's rows
    and draws: the loss and this rank's gradient blocks, per model."""
    out = {}
    for name, params_np in s["params"].items():
        tr = trainer(dict(s, mcfg=name), group)
        d = tr.data_index
        b = tr.batch_local
        rows = slice(d * b, (d + 1) * b)
        draws = TrainDraws(**{k: torch.from_numpy(v[rows])
                              for k, v in s["draws"].items()})
        params = map_with_paths(tr.tp.shard_leaf, {
            k: params_from_numpy(v) for k, v in params_np.items()})
        loss, mse, grads = tr.family.loss_and_grads(
            params, torch.from_numpy(s["rays"][rows]),
            torch.from_numpy(s["rgbs"][rows]), None, draws=draws)
        out[name] = {"loss": float(loss), "mse": float(mse),
                     "grads": _flat(grads)}
    return out


def _routes_part(group, device, s, dp_group):
    """One _loss_and_grads on each kernel route (their plain versions on
    the CPU) at (2, 2), the gradients gathered, and the same step of the
    dp trainer over this rank's dp group."""
    out = {}
    for route, rcfg in s["routes"].items():
        res = {}
        for tag, g, nm, tp in (("tp", group, NUM_MODEL, True),
                               ("dp", dp_group, 1, False)):
            tr = trainer(dict(s, rcfg=rcfg), g, nm, tp)
            d = tr.data_index
            b = tr.batch_local
            rows = slice(d * b, (d + 1) * b)
            draws = TrainDraws(**{k: torch.from_numpy(v[rows])
                                  for k, v in s["draws"].items()})
            params = {k: params_from_numpy(v)
                      for k, v in s["params"].items()}
            if tr.tp is not None:
                params = map_with_paths(tr.tp.shard_leaf, params)
            loss, mse, grads = tr.family.loss_and_grads(
                params, torch.from_numpy(s["rays"][rows]),
                torch.from_numpy(s["rgbs"][rows]), None, draws=draws)
            res[tag] = {"loss": float(loss), "mse": float(mse),
                        "grads": _flat(gather_state(grads, tr.tp))}
        out[route] = res
    return out


def _resume_part(group, device, s, dp_group):
    """4 steps, and 2 + a checkpoint (the whole state, gathered, written
    by rank 0) + 2 from it; the blocks before the save and after the
    load; and this rank's blocks of a checkpoint the JAX package wrote."""
    def run(splits, save=False, restore=False):
        tr = trainer(s, group)
        tr.set_data(s["rays"], s["rgbs"])
        state = tr.init_state(torch.Generator().manual_seed(0))
        if restore:
            state, _ = load_checkpoint(s["ckpt"], state, tp=tr.tp)
            loaded = _flat(state)
        state, losses = _fit(tr, s["seed"], splits, state)
        out = {"losses": losses, "step": state.step}
        if save:
            whole = gather_state(state, tr.tp)
            if pdist.is_main(group):
                save_checkpoint(s["ckpt"], whole, {"step": state.step})
            pdist.barrier(group)
            out.update(blocks=_flat(state), whole=_flat(whole))
        if restore:
            out["loaded"] = loaded
        return out, tr

    full, _ = run([4])
    head, _ = run([2], save=True)
    tail, tr = run([2], restore=True)
    template = tr.init_state(torch.Generator().manual_seed(1))
    jax_blocks = _flat(load_checkpoint(s["jax_ckpt"], template, tp=tr.tp)[0])
    return {"full": full, "head": head, "tail": tail,
            "jax_blocks": jax_blocks}


def _fused_loss_part(group, device, s, dp_group):
    """The loss-fused step under tensor parallelism: the error raised."""
    tr = trainer(s, group)
    tr.set_data(s["rays"], s["rgbs"])
    state = tr.init_state(torch.Generator().manual_seed(0))
    try:
        tr.run_steps(state, 0, 1)
    except ValueError as e:
        return str(e)
    return None


PARTS = {"shards": _shards_part, "steps": _steps_part, "step": _step_part,
         "routes": _routes_part, "resume": _resume_part,
         "fused_loss": _fused_loss_part}


def probe(group, device, spec):
    dp_group = _dp_group(group)
    out = {name: PARTS[part](group, device, s, dp_group)
           for name, (part, s) in spec.items()}
    out["pid"] = os.getpid()
    return out
