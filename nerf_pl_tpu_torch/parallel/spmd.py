"""The trainer on one device: the ray store on the device, contiguous batch
reads, the loss-fused or autograd step, K steps at a time, and the
occupancy tightening of the store.

Port of `Trainer` in nerf_pl_tpu/parallel/spmd.py for one device (the
data-parallel mesh is ROADMAP item A10, tensor parallelism A12).
`run_steps` is a plain Python loop over steps; nothing in a step waits for
the device (no host sync), so a later CUDA graph can capture it.

Occupancy (`tighten_store`) clips every stored ray's [near, far] to its
occupancy-box overlaps, stores a per-ray occupied-segment mask for the
coarse placement, and with `pack` keeps the store survivors-first so that
batches read only rays that hit a box. It runs on the store's device; the
host reads back only the counts it prints.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.nerf import init_nerf_params
from ..rendering.occupancy import (dilate_segment_bits, ray_box_hits,
                                   ray_box_segment_bits)
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


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32), with no int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser: a bijection of [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash32(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """A counter-based hash of (seed, idx) for int64 idx in [0, 2^32): a
    bijection of idx for each seed, so distinct labels never tie."""
    return _fmix32(_fmix32(idx ^ (seed & _M32)) ^ ((seed >> 32) & _M32))


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
        self.n_rays_local = all_rays.shape[0]
        self.steps_per_epoch = max(1, self.n_rays_local // self.batch_size)
        # Occupancy state, set by tighten_store: the original [near, far]
        # (re-tightening always starts from it), the (R,) int64 segment
        # masks and their count, and with packing the hit flags, the
        # survivor count and total / survivors.
        self.all_nf0 = None
        self.all_occm = None
        self.occ_n_seg = 0
        self.all_hit = None
        self.all_nsurv = None
        self.pack_expand = 1.0
        # stable identity labels, carried through every permutation
        self.all_idx = self._make_idx()

    def _make_idx(self) -> torch.Tensor:
        return torch.arange(self.n_rays_local, device=self.device)

    def _store_named(self):
        """(name, array) of the store's row-aligned arrays."""
        named = [("all_rays", self.all_rays), ("all_rgbs", self.all_rgbs),
                 ("all_nf0", self.all_nf0), ("all_occm", self.all_occm),
                 ("all_hit", self.all_hit), ("all_idx", self.all_idx)]
        return [(n, a) for n, a in named if a is not None]

    def _permute(self, order: torch.Tensor):
        for name, arr in self._store_named():
            setattr(self, name, arr[order])

    def reshuffle(self, seed: int):
        """Per-epoch re-permutation of the store on the device, from a
        generator seeded by `seed` (a function of (seed, epoch)).

        With survivor packing the order is canonical instead
        (`_reshuffle_canonical`): a pure function of (hit, seed, identity),
        whatever the store's current order, with survivors first."""
        if self.all_hit is not None:
            self._reshuffle_canonical(seed)
            return
        g = torch.Generator(device=self.device).manual_seed(seed)
        self._permute(torch.randperm(self.all_rays.shape[0], generator=g,
                                     device=self.device))

    def _reshuffle_canonical(self, seed: int):
        """One stable sort on miss * 2^32 + hash32(seed, identity): the
        keys are distinct, so the order depends on nothing else (a resumed
        run rebuilds the live layout from the grid and the last seed)."""
        key = ((~self.all_hit).to(torch.int64) << 32) | hash32(self.all_idx,
                                                                 seed)
        self._permute(torch.argsort(key, stable=True))

    def tighten_store(self, boxes: np.ndarray, margin: float = 0.1,
                      n_seg: int = 0, dilate: int = 0, pack: bool = False):
        """Occupancy-tighten the [near, far] of every ray in the store to
        the union of its box overlaps, widened by `margin` (rays that miss
        every box keep theirs). Always derives from the original intervals,
        so a refresh with a new grid can widen them again.

        n_seg > 0 also stores each ray's occupied-segment mask over its
        tightened interval (dilated by `dilate` segments a side), which
        the step's coarse placement reads. pack=True keeps the store
        survivors-first (`_partition_store`); batches then read survivors
        only.

        The boxes are not padded to a multiple of 64 as in the JAX Trainer,
        whose compiled program is keyed on the box count: the loops here
        run eagerly, and a padded box, which no ray reaches, changes no
        result.

        Returns {"hit_frac", "shrink"} and, with pack, {"miss_mse",
        "expand"}."""
        if self.all_nf0 is None:
            self.all_nf0 = self.all_rays[:, 6:8].clone()
        boxes = torch.as_tensor(np.asarray(boxes, np.float32),
                                device=self.device)
        rays = self.all_rays
        hit, t_lo, t_hi = ray_box_hits(
            boxes, torch.cat([rays[:, :6], self.all_nf0], dim=1))
        near0, far0 = self.all_nf0[:, 0], self.all_nf0[:, 1]
        near = torch.where(hit, torch.maximum(near0, t_lo - margin), near0)
        far = torch.where(hit, torch.minimum(far0, t_hi + margin), far0)
        far = torch.maximum(far, near + 1e-4)
        self.all_rays = torch.cat([rays[:, :6], near[:, None], far[:, None]],
                                  dim=1)
        n = self.n_rays_local
        shrink = (1.0 - (far - near) / (far0 - near0)).double().sum()
        stats = {"hit_frac": hit.sum().item() / n,
                 "shrink": shrink.item() / n}
        if n_seg > 0:
            occm = ray_box_segment_bits(boxes, self.all_rays, n_seg)
            if dilate > 0:
                occm = dilate_segment_bits(occm, n_seg, dilate)
            self.all_occm, self.occ_n_seg = occm, n_seg
        if pack:
            self.all_hit = hit
            stats.update(self._partition_store())
        return stats

    def _partition_store(self):
        """Stable survivors-first order of the store (the current order
        kept within each class), the survivor count, and the loss the
        packed-out rays leave as they are: the mean (background - gt)^2."""
        miss = ~self.all_hit
        bg = 1.0 if self.rcfg_train.white_back else 0.0
        sse = (((self.all_rgbs - bg) ** 2) * miss[:, None]).double().sum()
        n_miss = miss.sum().item()
        self._permute(torch.argsort(miss.to(torch.uint8), stable=True))
        self.all_nsurv = self.n_rays_local - n_miss
        self.pack_expand = self.n_rays_local / max(self.all_nsurv, 1)
        return {"miss_mse": sse.item() / max(n_miss * 3.0, 1e-9),
                "expand": self.pack_expand}

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
        """Contiguous block `step % steps_per_epoch` of the store: (rays,
        rgbs), and the segment masks when the store has them. With
        survivor packing the offset wraps over the survivor region [0, K),
        K = max(nsurv // batch, 1) * batch, so an epoch keeps its step
        count and cycles through the survivors."""
        b = self.batch_size
        off = (step % self.steps_per_epoch) * b
        if self.all_nsurv is not None:
            off %= max(self.all_nsurv // b, 1) * b
        batch = (self.all_rays[off:off + b], self.all_rgbs[off:off + b])
        if self.all_occm is None:
            return batch
        return batch + (self.all_occm[off:off + b],)

    def _loss_and_grads(self, params, rays, rgbs,
                        generator: Optional[torch.Generator],
                        draws: Optional[TrainDraws] = None,
                        occm: Optional[torch.Tensor] = None):
        """(loss, mse, grads): autograd over render_rays, or the loss-fused
        step with the cotangent scale 1 / (batch * 3). `occm`: the batch's
        segment masks (coarse placement in occupied segments)."""
        n_seg = self.occ_n_seg if occm is not None else 0
        if not self.rcfg_train.fused_loss:
            leaves = [p.detach().requires_grad_() for p in
                      tree_leaves(params)]
            p = tree_unflatten(params, leaves)
            with torch.enable_grad():
                out = render_rays(p, rays, self.rcfg_train, self.mcfg,
                                  generator=generator, draws=draws,
                                  occm=occm, n_seg=n_seg)
                loss = self.loss_fn(out, rgbs)
                grads = torch.autograd.grad(loss, leaves)
            typ = "fine" if "rgb_fine" in out else "coarse"
            mse = torch.mean((out[f"rgb_{typ}"].detach() - rgbs) ** 2)
            return loss.detach(), mse, tree_unflatten(params, list(grads))

        loss_sum, out, grads = fused_mse_train_step(
            params, rays, rgbs, self.rcfg_train, self.batch_size, self.mcfg,
            generator=generator, draws=draws, occm=occm, n_seg=n_seg)
        typ = "fine" if "rgb_fine" in out else "coarse"
        mse = torch.sum((out[f"rgb_{typ}"] - rgbs) ** 2) / (
            self.batch_size * 3)
        return loss_sum / self.batch_size, mse, grads

    def _one_step(self, state: TrainState,
                  generator: torch.Generator) -> Tuple[TrainState, Dict]:
        rays, rgbs, *occm = self._sample_batch(state.step)
        loss, mse, grads = self._loss_and_grads(state.params, rays, rgbs,
                                                generator,
                                                occm=occm[0] if occm
                                                else None)
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
