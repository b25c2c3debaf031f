"""Faults planted in the program, for the tests that show a broken timed
path comes out not correct. A run applies one by name (in every rank of
a data-parallel run); a benchmark run applies none.

  frozen_state   a training step returns its state unchanged
  half_batch     a training step's second half of rows replaced by its
                 first half: the mean over the rest
  no_allreduce   the data-parallel step's exchange between ranks left out
  altered_answer a rendered ray's colour altered where the tile is made
  stale_frame    a frame served from the previous request's answer
  jax_loaded     a module named jax in sys.modules: the program loaded
                 JAX (in a data-parallel run, in every rank, where only
                 the rank's own look can see it)

Each planter returns what undoes it; `planted` calls that when the run
ends.
"""
from __future__ import annotations

import contextlib
import sys
import types
from typing import Optional


def _frozen_state():
    from nerf_pl_tpu_torch.parallel import spmd
    step = spmd.Trainer._step

    def frozen(self, params, opt_state, step_t, draws):
        _, _, metrics = step(self, params, opt_state, step_t, draws)
        return params, opt_state, metrics
    spmd.Trainer._step = frozen
    return lambda: setattr(spmd.Trainer, "_step", step)


def _half_batch():
    from nerf_pl_tpu_torch.parallel import spmd
    sample = spmd.Trainer._sample_batch

    def half(self, step):
        out = sample(self, step)
        h = out[0].shape[0] // 2
        return tuple(t[:h].repeat((2,) + (1,) * (t.dim() - 1))
                     for t in out)
    spmd.Trainer._sample_batch = half
    return lambda: setattr(spmd.Trainer, "_sample_batch", sample)


def _no_allreduce():
    from nerf_pl_tpu_torch import dist
    original = dist.all_reduce_tree
    dist.all_reduce_tree = lambda tree, group: tree
    return lambda: setattr(dist, "all_reduce_tree", original)


def _altered_answer():
    from nerf_pl_tpu_torch.parallel import render
    render_rays = render.render_rays

    def altered(*args, **kwargs):
        out = render_rays(*args, **kwargs)
        out["rgb_fine"] = out["rgb_fine"].clone()
        out["rgb_fine"][7] += 0.5
        return out
    render.render_rays = altered
    return lambda: setattr(render, "render_rays", render_rays)


def _stale_frame():
    from nerf_pl_tpu_torch.parallel import render
    make = render.make_render_fn

    def make_stale(*args, **kwargs):
        fn, last = make(*args, **kwargs), []

        def stale(params, rays):
            out = fn(params, rays)
            last.append(out)
            return last[-2] if len(last) > 1 else out
        return stale
    render.make_render_fn = make_stale
    return lambda: setattr(render, "make_render_fn", make)


def _jax_loaded():
    sys.modules["jax"] = types.ModuleType("jax")
    return lambda: sys.modules.pop("jax", None)


FAULTS = {"frozen_state": _frozen_state, "half_batch": _half_batch,
          "no_allreduce": _no_allreduce, "altered_answer": _altered_answer,
          "stale_frame": _stale_frame, "jax_loaded": _jax_loaded}


@contextlib.contextmanager
def planted(name: Optional[str]):
    """The program with fault `name` planted (none: as it is) for the
    duration of the block."""
    if name is None:
        yield
        return
    undo = FAULTS[name]()
    try:
        yield
    finally:
        undo()
