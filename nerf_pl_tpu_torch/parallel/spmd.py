"""The trainer on one device: the ray store on the device, contiguous batch
reads, the loss-fused or autograd step, and K steps at a time.

Port of `Trainer` in nerf_pl_tpu/parallel/spmd.py for one device (the
data-parallel mesh is ROADMAP item A10, tensor parallelism A12, occupancy
tightening and survivor packing A5). `run_steps` is a plain Python loop
over steps; nothing in a step waits for the device (no host sync), so a
later CUDA graph can capture it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.nerf import init_nerf_params
from ..rendering.render import (ModelConfig, RenderConfig, TrainDraws,
                                fused_mse_train_step, render_rays)
from ..training.optimizers import Optimizer, apply_updates, tree_leaves, \
    tree_unflatten


class TrainState(NamedTuple):
    params: Any       # {'nerf_coarse': {layer: {w, b}}, 'nerf_fine': ...}
    opt_state: Any    # the optimizer's tree (training/optimizers.py)
    step: int         # global step, kept on the host


def seed_for(seed: int, *counters: int) -> int:
    """A 63-bit generator seed that is a pure function of (seed, counters):
    restarts and segment boundaries leave the random stream unchanged."""
    state = np.random.SeedSequence([seed, *counters]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


class Trainer:
    """Args as the JAX Trainer's, without the mesh:
      mcfg, rcfg_train: model and training render config.
      optimizer: from training.optimizers.get_optimizer.
      lr_schedule: step -> lr (logged beside the metrics).
      loss_fn: results dict, rgbs -> scalar (the autograd branch).
      batch_size: rays per step.
      device: where the store, the params and the step live.
    """

    def __init__(self, mcfg: ModelConfig, rcfg_train: RenderConfig,
                 optimizer: Optimizer, lr_schedule: Callable,
                 loss_fn: Callable, batch_size: int,
                 device: torch.device | str):
        self.mcfg = mcfg
        self.rcfg_train = rcfg_train
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.loss_fn = loss_fn
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.all_rays = None
        self.all_rgbs = None

    # ---------------------------------------------------------------- data
    def set_data(self, all_rays: np.ndarray, all_rgbs: np.ndarray,
                 shuffle_seed: int = 0):
        """Shuffle the store once on the host (the JAX Trainer's numpy
        permutation), pad it to whole batches by repeating head rays
        modulo n, and move it to the device. Step i of an epoch then reads
        the contiguous block i."""
        n = all_rays.shape[0]
        perm = np.random.default_rng(shuffle_seed).permutation(n)
        all_rays = all_rays[perm]
        all_rgbs = all_rgbs[perm]
        pad = (-n) % self.batch_size
        if pad:
            idx = np.arange(pad) % n
            all_rays = np.concatenate([all_rays, all_rays[idx]], 0)
            all_rgbs = np.concatenate([all_rgbs, all_rgbs[idx]], 0)
        self.all_rays = torch.as_tensor(all_rays, dtype=torch.float32,
                                        device=self.device)
        self.all_rgbs = torch.as_tensor(all_rgbs, dtype=torch.float32,
                                        device=self.device)
        self.steps_per_epoch = max(1, all_rays.shape[0] // self.batch_size)

    def reshuffle(self, seed: int):
        """Per-epoch re-permutation of the store on the device, from a
        generator seeded by `seed` (a function of (seed, epoch))."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        perm = torch.randperm(self.all_rays.shape[0], generator=g,
                              device=self.device)
        self.all_rays = self.all_rays[perm]
        self.all_rgbs = self.all_rgbs[perm]

    # --------------------------------------------------------------- state
    def init_state(self, generator: torch.Generator) -> TrainState:
        """Params drawn from `generator` (torch.nn.Linear's init), on the
        device, and the optimizer's state at step 0."""
        names = ["nerf_coarse"] + (["nerf_fine"]
                                   if self.rcfg_train.N_importance > 0 else [])
        params = {name: init_nerf_params(generator, self.mcfg.nerf,
                                         self.device) for name in names}
        return TrainState(params, self.optimizer.init(params), 0)

    # --------------------------------------------------------------- train
    def _sample_batch(self, step: int):
        """Contiguous block `step % steps_per_epoch` of the store."""
        off = (step % self.steps_per_epoch) * self.batch_size
        return (self.all_rays[off:off + self.batch_size],
                self.all_rgbs[off:off + self.batch_size])

    def _loss_and_grads(self, params, rays, rgbs,
                        generator: Optional[torch.Generator],
                        draws: Optional[TrainDraws] = None):
        """(loss, mse, grads): autograd over render_rays, or the loss-fused
        step with the cotangent scale 1 / (batch * 3)."""
        if not self.rcfg_train.fused_loss:
            leaves = [p.detach().requires_grad_() for p in
                      tree_leaves(params)]
            p = tree_unflatten(params, leaves)
            with torch.enable_grad():
                out = render_rays(p, rays, self.rcfg_train, self.mcfg,
                                  generator=generator, draws=draws)
                loss = self.loss_fn(out, rgbs)
                grads = torch.autograd.grad(loss, leaves)
            typ = "fine" if "rgb_fine" in out else "coarse"
            mse = torch.mean((out[f"rgb_{typ}"].detach() - rgbs) ** 2)
            return loss.detach(), mse, tree_unflatten(params, list(grads))

        loss_sum, out, grads = fused_mse_train_step(
            params, rays, rgbs, self.rcfg_train, self.batch_size, self.mcfg,
            generator=generator, draws=draws)
        typ = "fine" if "rgb_fine" in out else "coarse"
        mse = torch.sum((out[f"rgb_{typ}"] - rgbs) ** 2) / (
            self.batch_size * 3)
        return loss_sum / self.batch_size, mse, grads

    def _one_step(self, state: TrainState,
                  generator: torch.Generator) -> Tuple[TrainState, Dict]:
        rays, rgbs = self._sample_batch(state.step)
        loss, mse, grads = self._loss_and_grads(state.params, rays, rgbs,
                                                generator)
        updates, opt_state = self.optimizer.update(grads, state.opt_state,
                                                   state.params)
        params = apply_updates(state.params, updates)
        # clamp: mse == 0 would give an infinite psnr
        psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
        return (TrainState(params, opt_state, state.step + 1),
                {"loss": loss, "psnr": psnr})

    def step_generator(self, seed: int, step: int) -> torch.Generator:
        """The draws of global step `step`: a function of (seed, step)."""
        return torch.Generator(device=self.device).manual_seed(
            seed_for(seed, step))

    def run_steps(self, state: TrainState, seed: int, n_steps: int
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """n_steps optimizer steps; returns (K,) metric tensors: loss and
        psnr on the device, lr (from the host's step count) on the CPU."""
        losses, psnrs, lrs = [], [], []
        for _ in range(n_steps):
            lrs.append(self.lr_schedule(state.step))
            state, m = self._one_step(state,
                                      self.step_generator(seed, state.step))
            losses.append(m["loss"])
            psnrs.append(m["psnr"])
        return state, {"loss": torch.stack(losses),
                       "psnr": torch.stack(psnrs),
                       "lr": torch.stack(lrs)}
