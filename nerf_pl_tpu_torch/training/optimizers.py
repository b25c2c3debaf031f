"""Optimizers: sgd and adam with torch-style coupled L2, as functions over the
params dict.

Port of nerf_pl_tpu/training/optimizers.py (an optax chain). The state
mirrors optax's tree, so it checkpoints under the JAX package's keys and a
state saved by either package resumes in the other:

  adam  (opt_state/0/count, opt_state/0/mu/..., opt_state/0/nu/...,
         opt_state/1/count)
  sgd   (opt_state/0/trace/..., opt_state/1/count)

With weight decay a leading stage without leaves shifts the indices by one
(optax's add_decayed_weights), and a constant learning rate has no count.
The learning rate is the schedule at the last stage's count, as optax's
scale_by_learning_rate; Adam's bias correction uses its incremented count,
as scale_by_adam. The arithmetic follows optax operation by operation, on
the whole parameter list at once (torch._foreach_*). radam and ranger are
ROADMAP item A4.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import torch

ScalarOrSchedule = Union[float, Callable]
B1, B2 = 0.9, 0.999     # Adam's decays (optax's defaults)


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
    """init(params) -> state; update(grads, state, params) -> (updates,
    state)."""
    init: Callable[[Any], Tuple]
    update: Callable[[Any, Tuple, Any], Tuple[Any, Tuple]]


def _count(params) -> torch.Tensor:
    return torch.zeros([], dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _zeros(params):
    return tree_unflatten(params, [torch.zeros_like(p)
                                   for p in tree_leaves(params)])


def get_optimizer(name: str,
                  learning_rate: ScalarOrSchedule,
                  momentum: float = 0.9,
                  weight_decay: float = 0.0,
                  eps: float = 1e-8) -> Optimizer:
    """Build the optimizer named by the --optimizer flag. `learning_rate`
    is a float or a step -> lr schedule."""
    if name in ("radam", "ranger"):
        raise NotImplementedError(
            f"--optimizer {name} is not ported yet: ROADMAP item A4")
    if name not in ("sgd", "adam"):
        raise ValueError(f"optimizer not recognized: {name!r}")
    decay = bool(weight_decay and weight_decay > 0)
    scheduled = callable(learning_rate)

    def init(params) -> Tuple:
        if name == "adam":
            inner: Dict[str, Any] = {"count": _count(params),
                                     "mu": _zeros(params),
                                     "nu": _zeros(params)}
        else:
            inner = {"trace": _zeros(params)}
        lr_stage = {"count": _count(params)} if scheduled else {}
        return ((({},) if decay else ()) + (inner, lr_stage))

    def update(grads, state, params):
        g = tree_leaves(grads, params)
        p = tree_leaves(params)
        if decay:   # torch-style coupled L2: g + wd * p
            g = torch._foreach_add(g, torch._foreach_mul(p, weight_decay))
        inner, lr_stage = state[-2], state[-1]
        if name == "adam":
            mu = torch._foreach_mul(tree_leaves(inner["mu"], params), B1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - B1))
            nu = torch._foreach_mul(tree_leaves(inner["nu"], params), B2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(g, g), 1 - B2))
            count = inner["count"] + 1
            c = count.to(torch.float32)
            den = torch._foreach_sqrt(torch._foreach_div(nu, 1 - B2 ** c))
            torch._foreach_add_(den, eps)
            u = torch._foreach_div(torch._foreach_div(mu, 1 - B1 ** c), den)
            inner = {"count": count, "mu": tree_unflatten(params, mu),
                     "nu": tree_unflatten(params, nu)}
        else:
            u = torch._foreach_mul(tree_leaves(inner["trace"], params),
                                   momentum)
            torch._foreach_add_(u, g)
            inner = {"trace": tree_unflatten(params, u)}
        if scheduled:
            step_size = -learning_rate(lr_stage["count"]).to(torch.float32)
            lr_stage = {"count": lr_stage["count"] + 1}
        else:
            step_size = -float(learning_rate)
        u = torch._foreach_mul(u, step_size)
        return (tree_unflatten(params, u),
                state[:-2] + (inner, lr_stage))

    return Optimizer(init, update)
