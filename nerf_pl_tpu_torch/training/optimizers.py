"""Optimizers: sgd, adam, radam and ranger with torch-style coupled L2, as
functions over the params dict.

Port of nerf_pl_tpu/training/optimizers.py (an optax chain). The state
mirrors optax's tree, so it checkpoints under the JAX package's keys and a
state saved by either package resumes in the other:

  adam, radam  (opt_state/0/count, opt_state/0/mu/..., opt_state/0/nu/...,
                opt_state/1/count)
  sgd           (opt_state/0/trace/..., opt_state/1/count)
  ranger        (opt_state/inner/<radam's keys>, opt_state/slow/...,
                 opt_state/count)

With weight decay a leading stage without leaves shifts the indices by one
(optax's add_decayed_weights), and a constant learning rate has no count.
The learning rate is the schedule at the last stage's count, as optax's
scale_by_learning_rate; Adam's bias correction uses its incremented count,
as scale_by_adam; radam switches between its rectified and plain steps
with torch.where on the device count, as optax's jnp.where, and ranger's
lookahead syncs the same way, so no update reads a value back to the host.
The arithmetic follows optax operation by operation, on the whole
parameter list at once (torch._foreach_*). The moments take the params'
dtype (bf16 master weights keep bf16 moments); the counts are int32.

Adam with `clip_norm` > 0 first scales the gradients by min(1, clip_norm
/ (eps + their global norm)), multinerf's global-norm clip (mip-NeRF
360's recipe; the JAX package has no clip). `optimizer_step` computes the
factor once, a device scalar from one reduction over the leaves, in a
phase of its own (`clip`) before the update's (`optimizer`), and the
update takes it. Without a clip the step is the unclipped chain's, launch
for launch. The clip adds no state, so the tree and its checkpoint keys
stay optax's.

`optimizer_step` is update and apply_updates in one, the Trainer's call.
On float32 CUDA leaves Adam's takes one launch of ops/adam.py's kernel,
which gives the chain's bits; the chain is its plain version and takes
everything else (CPU tensors, bf16 masters, sgd, radam and ranger). Asked
to work in place (the step graph's static buffers), the kernel's route
writes the new params, moments and counts into the given tensors and
returns them; the chain always returns new tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, \
    Union

import numpy as np
import torch

from ..ops import adam as adam_kernel
from ..utils import profiling as P

ScalarOrSchedule = Union[float, Callable]
B1, B2 = 0.9, 0.999     # Adam's decays (optax's defaults)
RADAM_THRESHOLD = 5.0   # optax.scale_by_radam's tractability threshold


def tree_leaves(tree, like=None) -> List[torch.Tensor]:
    """Leaves of a nested dict, in the key order of `like` (default: its
    own insertion order)."""
    like = tree if like is None else like
    if isinstance(like, dict):
        return [leaf for k, v in like.items()
                for leaf in tree_leaves(tree[k], v)]
    return [tree]


def tree_unflatten(template, leaves):
    """A nested dict shaped like `template` holding `leaves` in order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return next(it)

    return build(template)


def apply_updates(params, updates):
    return tree_unflatten(params, torch._foreach_add(
        tree_leaves(params), tree_leaves(updates, params)))


class Optimizer(NamedTuple):
    """init(params) -> state; update(grads, state, params[, scale]) ->
    (updates, state); apply (None: update, then apply_updates) (grads,
    state, params, inplace[, scale]) -> (params, state); clip_norm: the
    global-norm clip (0: none), whose factor `scale` update and apply then
    take (only adam's clips)."""
    init: Callable[[Any], Tuple]
    update: Callable[..., Tuple[Any, Tuple]]
    apply: Optional[Callable[..., Tuple[Any, Tuple]]] = None
    clip_norm: float = 0.0


F32_EPS = float(np.finfo(np.float32).eps)


def clip_scale(grads: List[torch.Tensor], clip_norm: float) -> torch.Tensor:
    """min(1, clip_norm / (eps + the global norm of the leaves)), a
    float32 device scalar (multinerf's clip_gradients)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    return torch.clamp(clip_norm / (F32_EPS + norm), max=1.0)


def optimizer_step(optimizer: Optimizer, grads, state, params,
                   inplace: bool = False) -> Tuple[Any, Tuple]:
    """(params, state) after one update, the gradients cast to the params'
    dtypes: phase `clip` (the clip's factor, where the optimizer clips),
    then `optimizer`. `inplace` lets the optimizer write them into the
    given params' and state's tensors (the step graph's static
    buffers)."""
    p = tree_leaves(params)
    g = tree_leaves(grads, params)
    scale = ()
    if optimizer.clip_norm > 0:
        with P.phase("clip", p[0].device):
            scale = (clip_scale(g, optimizer.clip_norm),)
    with P.phase("optimizer", p[0].device):
        grads = tree_unflatten(params, [x.to(q.dtype) for x, q in zip(g, p)])
        if optimizer.apply is not None:
            return optimizer.apply(grads, state, params, inplace, *scale)
        updates, state = optimizer.update(grads, state, params, *scale)
        return apply_updates(params, updates), state


def _count(params) -> torch.Tensor:
    return torch.zeros([], dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _zeros(params):
    return tree_unflatten(params, [torch.zeros_like(p)
                                   for p in tree_leaves(params)])


class LookaheadState(NamedTuple):
    """The JAX package's lookahead state: the inner optimizer's state, the
    slow weights and the step count."""
    inner: Any
    slow: Any
    count: torch.Tensor


def lookahead(inner: Optimizer, sync_period: int = 6,
              slow_step_size: float = 0.5) -> Optimizer:
    """Lookahead (Zhang et al. 2019) over `inner`, as the JAX package's:
    every `sync_period` steps the slow weights move `slow_step_size` toward
    the fast weights and the fast weights reset to them. Branch-free: the
    sync is a device bool chosen by torch.where, so the update has no host
    sync and replays in a CUDA graph."""

    def init(params) -> LookaheadState:
        slow = tree_unflatten(params, [p.clone()
                                       for p in tree_leaves(params)])
        return LookaheadState(inner.init(params), slow, _count(params))

    def update(grads, state: LookaheadState, params):
        u, inner_state = inner.update(grads, state.inner, params)
        p = tree_leaves(params)
        u = tree_leaves(u, params)
        fast = torch._foreach_add(p, u)
        count = state.count + 1
        sync = (count % sync_period) == 0
        slow = tree_leaves(state.slow, params)
        lerp = torch._foreach_add(slow, torch._foreach_mul(
            torch._foreach_sub(fast, slow), slow_step_size))
        slow_new = [torch.where(sync, a, s) for a, s in zip(lerp, slow)]
        final = [torch.where(sync, s - q, du)
                 for du, s, q in zip(u, slow_new, p)]
        return (tree_unflatten(params, final),
                LookaheadState(inner_state, tree_unflatten(params, slow_new),
                               count))

    return Optimizer(init, update)


def _decay_pow(decay: float, count: torch.Tensor) -> torch.Tensor:
    """decay^count in float32, correctly rounded: optax's `decay**count`
    as XLA computes it under jit (decay rounded to float32 first). radam's
    ro amplifies an ulp of b2^count a thousandfold, so this is taken in
    float64 rather than by a float32 pow, whose last bit differs between
    libraries."""
    base = float(np.float32(decay))
    return torch.pow(base, count.to(torch.float64)).to(torch.float32)


def _chain(name: str, learning_rate: ScalarOrSchedule, momentum: float,
           weight_decay: float, eps: float, b1: float = B1,
           b2: float = B2, clip_norm: float = 0.0) -> Optimizer:
    """optax.chain(add_decayed_weights?, scale_by_<name>,
    scale_by_learning_rate) for name in sgd, adam, radam; adam's after
    the global-norm clip when clip_norm > 0, by the factor `scale` that
    update and apply then take (optimizer_step's)."""
    decay = bool(weight_decay and weight_decay > 0)
    scheduled = callable(learning_rate)
    ro_inf = 2.0 / (1.0 - b2) - 1.0     # radam's maximum length of the SMA

    def init(params) -> Tuple:
        if name == "sgd":
            inner: Dict[str, Any] = {"trace": _zeros(params)}
        else:
            inner = {"count": _count(params), "mu": _zeros(params),
                     "nu": _zeros(params)}
        lr_stage = {"count": _count(params)} if scheduled else {}
        return ((({},) if decay else ()) + (inner, lr_stage))

    def update(grads, state, params, scale=None):
        g = tree_leaves(grads, params)
        p = tree_leaves(params)
        if clip_norm > 0:
            g = torch._foreach_mul(g, scale)
        if decay:   # torch-style coupled L2: g + wd * p
            g = torch._foreach_add(g, torch._foreach_mul(p, weight_decay))
        inner, lr_stage = state[-2], state[-1]
        if name == "sgd":
            u = torch._foreach_mul(tree_leaves(inner["trace"], params),
                                   momentum)
            torch._foreach_add_(u, g)
            inner = {"trace": tree_unflatten(params, u)}
        else:
            mu = torch._foreach_mul(tree_leaves(inner["mu"], params), b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
            nu = torch._foreach_mul(tree_leaves(inner["nu"], params), b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(g, g), 1 - b2))
            count = inner["count"] + 1
            b1t, b2t = _decay_pow(b1, count), _decay_pow(b2, count)
            mu_hat = torch._foreach_div(mu, 1 - b1t)
            nu_hat = torch._foreach_div(nu, 1 - b2t)
            den = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(den, eps)
            u = torch._foreach_div(mu_hat, den)
            if name == "radam":
                # optax.scale_by_radam: the rectified step where the
                # variance is tractable (ro >= 5), else the plain momentum;
                # torch.where on the device count, no host branch
                ro = ro_inf - (2 * count).to(torch.float32) * b2t / (1 - b2t)
                r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / (
                    (ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                rect = torch._foreach_div(
                    [r.to(m.dtype) * m for m in mu_hat], den)
                u = [torch.where(ro >= RADAM_THRESHOLD, x, m)
                     for x, m in zip(rect, mu_hat)]
            inner = {"count": count, "mu": tree_unflatten(params, mu),
                     "nu": tree_unflatten(params, nu)}
        if scheduled:
            step_size = -learning_rate(lr_stage["count"]).to(torch.float32)
            lr_stage = {"count": lr_stage["count"] + 1}
        else:
            step_size = -float(learning_rate)
        u = torch._foreach_mul(u, step_size)
        return (tree_unflatten(params, u),
                state[:-2] + (inner, lr_stage))

    def apply(grads, state, params, inplace, scale=None):
        """adam's update and apply_updates: one kernel launch on float32
        CUDA leaves (reading the clip's factor), else the chain."""
        p = tree_leaves(params)
        g = tree_leaves(grads, params)
        inner, lr_stage = state[-2], state[-1]
        mu = tree_leaves(inner["mu"], params)
        nu = tree_leaves(inner["nu"], params)
        if not adam_kernel.takes_kernel(*p, *g, *mu, *nu):
            updates, state = update(grads, state, params, scale)
            return apply_updates(params, updates), state

        def incremented(c):
            return c.add_(1) if inplace else c + 1

        if scheduled:   # the schedule at the count, before its increment
            lr = learning_rate(lr_stage["count"]).to(torch.float32)
            lr_stage = {"count": incremented(lr_stage["count"])}
        else:           # rounded to float32 as the chain's scalar is
            lr = torch.full((), float(learning_rate), dtype=torch.float32,
                            device=p[0].device)
        count = incremented(inner["count"])
        p, mu, nu = adam_kernel.adam_step(
            p, g, mu, nu, count, lr, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay if decay else 0.0, inplace=inplace,
            clip_scale=scale if clip_norm > 0 else None)
        inner = {"count": count, "mu": tree_unflatten(params, mu),
                 "nu": tree_unflatten(params, nu)}
        return (tree_unflatten(params, p),
                state[:-2] + (inner, lr_stage))

    return Optimizer(init, update, apply if name == "adam" else None,
                     clip_norm)


def get_optimizer(name: str,
                  learning_rate: ScalarOrSchedule,
                  momentum: float = 0.9,
                  weight_decay: float = 0.0,
                  eps: float = 1e-8,
                  clip_norm: float = 0.0) -> Optimizer:
    """Build the optimizer named by the --optimizer flag. `learning_rate`
    is a float or a step -> lr schedule; clip_norm > 0 clips the
    gradients' global norm first (adam only: mip-NeRF 360's recipe)."""
    if clip_norm > 0 and name != "adam":
        raise ValueError(f"no global-norm clip for the {name!r} optimizer")
    if name in ("sgd", "adam", "radam"):
        return _chain(name, learning_rate, momentum, weight_decay, eps,
                      clip_norm=clip_norm)
    if name == "ranger":
        # the reference Ranger's betas (0.95, 0.999) and eps 1e-5
        return lookahead(_chain("radam", learning_rate, momentum,
                                weight_decay, 1e-5, b1=0.95, b2=0.999),
                         sync_period=6, slow_step_size=0.5)
    raise ValueError(f"optimizer not recognized: {name!r}")
