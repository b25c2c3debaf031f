"""The port's optimizers and learning-rate schedules against the JAX
package's (optax), on the same numpy parameters and gradients.

Adam, sgd, radam and ranger follow optax operation by operation, so their
states agree key for key within rtol 1e-6 (the only differences are
float32 pow roundings of the bias correction); the schedules agree within
rtol 1e-6 at every step.
"""
import jax
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


def _jitted(fn, *args):
    """fn under jit, as the JAX Trainer runs the update (lax.pow of the
    traced count; eagerly, jnp.power takes the concrete count to
    integer_pow, which rounds b^t differently), with LLVM's FMA contraction
    off (optimization level 0), so every float32 op rounds as torch's do."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _run(jo, to, params, grads, jit=True):
    """Both optimizers over the same gradients: the flattened train states
    {key: array} of optax's (its update jitted or eager) and the port's."""
    pj, pt = params, _torch(params)
    sj, st = jo.init(pj), to.init(pt)
    for g in grads:
        uj, sj = (_jitted(jo.update, g, sj, pj) if jit
                  else jo.update(g, sj, pj))
        pj = optax.apply_updates(pj, uj)
        ut, st = to.update(_torch(g), st, pt)
        pt = apply_updates(pt, ut)
    return (jflat({"params": pj, "opt_state": sj}),
            flatten_with_paths({"params": pt, "opt_state": st}))


@pytest.mark.parametrize("name,weight_decay,scheduled",
                         [("adam", 0.0, True), ("adam", 1e-2, True),
                          ("adam", 0.0, False), ("sgd", 0.0, True),
                          ("sgd", 1e-2, True), ("radam", 0.0, True),
                          ("radam", 1e-2, True), ("radam", 0.0, False),
                          ("ranger", 0.0, True), ("ranger", 1e-2, True),
                          ("ranger", 0.0, False)])
def test_optimizer_matches_optax(name, weight_decay, scheduled):
    """radam and ranger run 13 steps: radam's rectification switches on
    at count 7 (ro crosses 5 between counts 6 and 7) and ranger's
    lookahead syncs at steps 6 and 12."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(5 if name in ("adam", "sgd")
                                       else 13)]
    lr_j = jsched(**SCHED) if scheduled else 1e-2
    lr_t = get_lr_schedule(**SCHED) if scheduled else 1e-2
    jo = jopt(name, lr_j, momentum=0.9, weight_decay=weight_decay)
    to = get_optimizer(name, lr_t, momentum=0.9, weight_decay=weight_decay)
    fj, ft = _run(jo, to, params, grads)
    assert set(fj) == set(ft)          # optax's state tree, key for key
    for k in fj:
        assert ft[k].dtype == fj[k].dtype, k
        np.testing.assert_allclose(ft[k], fj[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("weight_decay,scheduled",
                         [(0.0, True), (1e-2, True), (0.0, False)])
def test_adam_matches_eager_optax(weight_decay, scheduled):
    """Adam against optax's update run eagerly (no jit), at the same bar
    as test_optimizer_matches_optax: the float64 b^t of the bias
    correction is also eager optax's value for these 5 steps."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    jo = jopt("adam", jsched(**SCHED) if scheduled else 1e-2,
              weight_decay=weight_decay)
    to = get_optimizer("adam", get_lr_schedule(**SCHED) if scheduled
                       else 1e-2, weight_decay=weight_decay)
    fj, ft = _run(jo, to, params, grads, jit=False)
    assert set(fj) == set(ft)
    for k in fj:
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
