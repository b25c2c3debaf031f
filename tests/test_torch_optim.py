"""The port's optimizers and learning-rate schedules against the JAX
package's (optax), on the same numpy parameters and gradients.

Adam and sgd follow optax operation by operation, so 5 steps agree within
rtol 1e-6 (the only differences are float32 pow roundings of the bias
correction); the schedules agree within rtol 1e-6 at every step.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_pl_tpu.training.checkpoints import flatten_with_paths as jflat
from nerf_pl_tpu.training.lr_schedule import get_lr_schedule as jsched
from nerf_pl_tpu.training.optimizers import get_optimizer as jopt
from nerf_pl_tpu_torch.training.checkpoints import flatten_with_paths
from nerf_pl_tpu_torch.training.lr_schedule import get_lr_schedule
from nerf_pl_tpu_torch.training.optimizers import (apply_updates,
                                                   get_optimizer)

SCHED = dict(lr_scheduler="steplr", lr=1e-2, num_epochs=4, steps_per_epoch=2,
             decay_step=[1, 2], decay_gamma=0.5)


def _tree(rng):
    """A two-model params-shaped tree of numpy arrays (keys out of sorted
    order on purpose: the optimizers follow the params' own order)."""
    return {m: {"xyz_0": {"w": rng.normal(size=(5, 4)).astype(np.float32),
                          "b": rng.normal(size=(4,)).astype(np.float32)},
                "rgb": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                        "b": rng.normal(size=(3,)).astype(np.float32)}}
            for m in ("nerf_coarse", "nerf_fine")}


def _torch(tree):
    return {m: {layer: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
                for layer, d in mlp.items()} for m, mlp in tree.items()}


@pytest.mark.parametrize("name,weight_decay,scheduled",
                         [("adam", 0.0, True), ("adam", 1e-2, True),
                          ("adam", 0.0, False), ("sgd", 0.0, True),
                          ("sgd", 1e-2, True)])
def test_optimizer_matches_optax(name, weight_decay, scheduled):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    lr_j = jsched(**SCHED) if scheduled else 1e-2
    lr_t = get_lr_schedule(**SCHED) if scheduled else 1e-2
    jo = jopt(name, lr_j, momentum=0.9, weight_decay=weight_decay)
    to = get_optimizer(name, lr_t, momentum=0.9, weight_decay=weight_decay)
    pj, pt = params, _torch(params)
    sj, st = jo.init(pj), to.init(pt)
    for g in grads:
        uj, sj = jo.update(g, sj, pj)
        pj = optax.apply_updates(pj, uj)
        ut, st = to.update(_torch(g), st, pt)
        pt = apply_updates(pt, ut)
    fj = jflat({"params": pj, "opt_state": sj})
    ft = flatten_with_paths({"params": pt, "opt_state": st})
    assert set(fj) == set(ft)          # optax's state tree, key for key
    for k in fj:
        assert ft[k].dtype == fj[k].dtype, k
        np.testing.assert_allclose(ft[k], fj[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("sched", ["steplr", "cosine", "poly"])
@pytest.mark.parametrize("warmup", [0, 2])
def test_schedules_match_jax(sched, warmup):
    kw = dict(lr_scheduler=sched, lr=5e-4, num_epochs=8, steps_per_epoch=3,
              decay_step=[2, 4, 6], decay_gamma=0.5, poly_exp=0.9,
              warmup_multiplier=4.0, warmup_epochs=warmup)
    fj, ft = jsched(**kw), get_lr_schedule(**kw)
    steps = np.arange(0, 8 * 3 + 2)
    ours = np.array([float(ft(int(s))) for s in steps])
    ref = np.array([float(fj(jnp.asarray(s, jnp.int32))) for s in steps])
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    # a step tensor gives the same, on its own device
    np.testing.assert_array_equal(ft(torch.as_tensor(steps)).numpy(), ours)


@pytest.mark.parametrize("name", ["radam", "ranger"])
def test_unported_optimizers_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP item A4"):
        get_optimizer(name, 1e-3)
