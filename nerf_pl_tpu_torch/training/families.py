"""The model families, `NeRFFamily` (nerf_pl's NeRF) and `MipFamily`
(mip-NeRF 360), which `family_for` chooses by the model config's type:
each holds what the Trainer, the system and the eval CLI would otherwise
branch on. A CLI's family takes the step's defaults (one device).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import dist as pdist
from ..datasets import LLFF360Dataset, dataset_dict
from ..models.mipnerf360 import MipConfig, init_mip_params
from ..models.nerf import init_nerf_params
from ..parallel.mesh import Mesh, TensorParallel, make_mesh, model_pspecs
from ..parallel.render import make_render_fn
from ..rendering import mip360
from ..rendering.render import (RenderConfig, TrainDraws,
                                fused_mse_train_step, render_rays)
from ..utils import profiling as P
from .checkpoints import load_ckpt
from .losses import loss_dict, mip360_loss
from .lr_schedule import get_loglinear_schedule, get_lr_schedule
from .optimizers import get_optimizer, tree_leaves, tree_unflatten


class _Family:
    columns: Tuple[str, ...] = ()
    parallel = True
    occupancy = False
    n_seg = 0    # bits of the `occm` column's masks (set by tighten_store)

    def __init__(self, mcfg, rcfg: RenderConfig = RenderConfig(),
                 loss_fn: Optional[Callable] = None, batch_size: int = 1,
                 mesh: Optional[Mesh] = None, tensor_parallel: bool = False):
        self.mcfg, self.rcfg, self.loss_fn = mcfg, rcfg, loss_fn
        self.mesh = mesh if mesh is not None else make_mesh()
        self.batch_size = batch_size
        self.batch_local = batch_size // self.mesh.num_data
        self.tensor_parallel = tensor_parallel
        self.tp = None

    def load_params(self, ckpt_path: str):
        """The family's MLPs of a checkpoint (either package's format) as
        CPU tensors; one it lacks raises."""
        params = self.init_params(torch.Generator().manual_seed(0))
        for name in params:
            params = load_ckpt(params, ckpt_path, name)
        return params

    def render_fn(self, rcfg: RenderConfig, chunk: int,
                  device: torch.device, group=None) -> Callable:
        """render(params, samples) -> numpy outputs of the dataset samples'
        rays, one after another, over `group`'s ranks."""
        render = self._ray_render(rcfg, chunk, device, group)
        keys = ("rays",) + self.columns
        return lambda params, samples: render(params, *(
            np.concatenate([s[k] for s in samples]) for k in keys))

    @staticmethod
    def _leaves(params):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        return tree_unflatten(params, leaves), leaves


class NeRFFamily(_Family):
    """The NeRF of nerf_pl (`models/nerf.py`, `rendering/render.py`): data
    and tensor parallel; occupancy tightening adds the `occm` column."""
    name = "nerf"
    Draws = TrainDraws
    occupancy = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.tensor_parallel and self.mesh.num_model > 1:
            # the specs read only the weights' shapes
            self.tp = TensorParallel(self.mesh, model_pspecs(
                self.init_params(torch.Generator(), "meta"),
                self.mesh.num_model, True))

    def init_params(self, generator: torch.Generator, device="cpu"):
        names = ["nerf_coarse"] + (["nerf_fine"]
                                   if self.rcfg.N_importance > 0 else [])
        return {name: init_nerf_params(generator, self.mcfg.nerf, device)
                for name in names}

    def draw_specs(self) -> List[Tuple[str, Tuple[int, int], bool]]:
        """(name, shape, uniform) of the draws a step takes, in the order
        the render takes them from its generator: the perturb uniforms and
        the coarse noise, then the importance u and the fine noise, for
        this data index's rays. These are all the random numbers of a step
        on every path."""
        cfg, R = self.rcfg, self.batch_local
        S, S_imp = cfg.N_samples, cfg.N_importance
        specs = []
        if cfg.perturb > 0:
            specs.append(("perturb", (R, S), True))
        if cfg.noise_std > 0:
            specs.append(("noise_coarse", (R, S), False))
        if S_imp > 0 and cfg.perturb > 0:
            specs.append(("u", (R, S_imp), True))
        if S_imp > 0 and cfg.noise_std > 0:
            specs.append(("noise_fine", (R, S + S_imp), False))
        return specs

    def loss_and_grads(self, params, rays, rgbs,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[TrainDraws] = None,
                       occm: Optional[torch.Tensor] = None):
        """(loss, mse, grads) of the global batch: autograd over
        render_rays, or the loss-fused step with the cotangent scale
        1 / (global batch * 3). `rays`, `rgbs` and `occm` (the segment
        masks, for the coarse placement in occupied segments) are this
        data index's part of the batch, and under tensor parallelism
        `params` and the grads are this rank's blocks. Over a data axis
        the autograd route differentiates the local mean times
        batch_local / batch_size, and both routes sum their loss, squared
        error and gradients across the data group (one all-reduce)."""
        n_seg = self.n_seg if occm is not None else 0
        data_group = self.mesh.data_group
        dev = rays.device
        if not self.rcfg.fused_loss:
            p, leaves = self._leaves(params)
            with torch.enable_grad():
                out = render_rays(p, rays, self.rcfg, self.mcfg,
                                  generator=generator, draws=draws,
                                  occm=occm, n_seg=n_seg, tp=self.tp)
                with P.phase("backward", dev):
                    loss = self.loss_fn(out, rgbs)
                    if data_group is not None:
                        loss = loss * (self.batch_local / self.batch_size)
                    grads = torch.autograd.grad(loss, leaves)
                    typ = "fine" if "rgb_fine" in out else "coarse"
                    mse = torch.mean((out[f"rgb_{typ}"].detach() - rgbs)
                                     ** 2)
            loss, grads = loss.detach(), tree_unflatten(params, list(grads))
            if data_group is None:
                return loss, mse, grads
            with P.phase("allreduce", dev):
                mse = mse * (self.batch_local / self.batch_size)
                return pdist.all_reduce_tree((loss, mse, grads), data_group)

        if self.tensor_parallel:
            raise ValueError(
                "fused_loss shards rays only; run with "
                "tensor_parallel=False (or drop fused_loss to use the "
                "autograd path, which supports the model axis)")
        loss_sum, out, grads = fused_mse_train_step(
            params, rays, rgbs, self.rcfg, self.batch_size, self.mcfg,
            generator=generator, draws=draws, occm=occm, n_seg=n_seg)
        typ = "fine" if "rgb_fine" in out else "coarse"
        sq = torch.sum((out[f"rgb_{typ}"] - rgbs) ** 2)
        if data_group is not None:
            with P.phase("allreduce", dev):
                loss_sum, sq, grads = pdist.all_reduce_tree(
                    (loss_sum, sq, grads), data_group)
        return loss_sum / self.batch_size, sq / (self.batch_size * 3), grads

    def dataset(self, hp, split: str):
        """The --dataset_name scene's `split`."""
        kwargs = {"root_dir": hp.root_dir, "split": split,
                  "img_wh": tuple(hp.img_wh)}
        if hp.dataset_name == "llff":
            kwargs["spheric_poses"] = hp.spheric_poses
            kwargs["val_num"] = hp.val_num
        return dataset_dict[hp.dataset_name](**kwargs)

    def recipe(self, hp, steps_per_epoch: int, white_back: bool):
        """The train CLI's recipe: ((render config, optimizer, schedule,
        loss), the Trainer's arguments after the model config, validation's
        render config, the master weights' dtype, None for float32)."""
        compute_dtype = (torch.bfloat16 if hp.precision == "bfloat16"
                         else torch.float32)
        rcfg_train = RenderConfig(
            N_samples=hp.N_samples, N_importance=hp.N_importance,
            use_disp=hp.use_disp, perturb=hp.perturb,
            noise_std=hp.noise_std, white_back=white_back,
            compute_dtype=compute_dtype, fused=hp.fused_mlp,
            fused_train=hp.fused_train,
            # the loss-fused step is exactly the reference MSE
            fused_loss=(hp.fused_train and hp.loss_type == "mse"),
            occ_keepalive=hp.occ_keepalive)
        rcfg_val = dataclasses.replace(
            rcfg_train, perturb=0.0, noise_std=0.0, fused_train=False,
            fused_loss=False, occ_keepalive=0.0)
        lr_schedule = get_lr_schedule(
            hp.lr_scheduler, hp.lr, hp.num_epochs, steps_per_epoch,
            decay_step=hp.decay_step, decay_gamma=hp.decay_gamma,
            poly_exp=hp.poly_exp, warmup_multiplier=hp.warmup_multiplier,
            warmup_epochs=hp.warmup_epochs, optimizer=hp.optimizer)
        optimizer = get_optimizer(hp.optimizer, lr_schedule,
                                  momentum=hp.momentum,
                                  weight_decay=hp.weight_decay)
        # --precision bfloat16 with the fused kernels (which run bf16
        # products either way) selects bf16 master weights and moments, as
        # the JAX package does; f32 masters stay the default
        master_dtype = (torch.bfloat16 if hp.precision == "bfloat16"
                        and (hp.fused_train or hp.fused_mlp) else None)
        return ((rcfg_train, optimizer, lr_schedule, loss_dict[hp.loss_type]),
                rcfg_val, master_dtype)

    def _ray_render(self, rcfg, chunk, device, group):
        return make_render_fn(rcfg, chunk, device, self.mcfg, group=group)


class MipFamily(_Family):
    """mip-NeRF 360 (`models/mipnerf360.py`, `rendering/mip360.py`) on one
    device, from an llff scene in the 360 layout; its store carries each
    ray's pixel radius."""
    name = "mipnerf360"
    Draws = mip360.MipDraws
    columns = ("radii",)
    parallel = False

    def init_params(self, generator: torch.Generator, device="cpu"):
        return init_mip_params(generator, self.mcfg, device)

    def draw_specs(self) -> List[Tuple[str, Tuple[int, int], bool]]:
        return [("jitter", (self.batch_local,
                            len(self.mcfg.num_prop_samples) + 1), True)]

    def loss_and_grads(self, params, rays, rgbs, radii,
                       draws: mip360.MipDraws):
        """(loss, mse, grads) of mip-NeRF 360's step: autograd over the
        three levels and the three losses."""
        dev = rays.device
        p, leaves = self._leaves(params)
        with torch.enable_grad():
            out = mip360.render_levels(p, rays, radii, self.mcfg,
                                       draws.jitter)
            with P.phase("losses", dev):
                loss, _ = mip360_loss(out, rgbs, self.mcfg)
                mse = torch.mean((out["rgb"].detach() - rgbs) ** 2)
            with P.phase("backward", dev):
                grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), mse, tree_unflatten(params, list(grads))

    def dataset(self, hp, split: str):
        return LLFF360Dataset(hp.root_dir, split, tuple(hp.img_wh),
                              val_num=hp.val_num)

    def recipe(self, hp, steps_per_epoch: int, white_back: bool):
        """The published recipe (multinerf's configs/360.gin): the lr
        log-linear from 2e-3 to 2e-5 over 250,000 steps after a 512-step
        warm-up from 0.01 of it, Adam with eps 1e-6, the gradients' global
        norm clipped to 1e-3."""
        lr_schedule = get_loglinear_schedule(2e-3, 2e-5, 250_000, 512, 0.01)
        optimizer = get_optimizer("adam", lr_schedule, eps=1e-6,
                                  clip_norm=1e-3)
        return (RenderConfig(), optimizer, lr_schedule, None), \
            RenderConfig(), None

    def _ray_render(self, rcfg, chunk, device, group):
        return mip360.make_render_fn(self.mcfg, chunk, device)


def family_for(mcfg, *args: Any, **kwargs: Any) -> _Family:
    """The family of `mcfg`, made with `_Family`'s step arguments."""
    kind = MipFamily if isinstance(mcfg, MipConfig) else NeRFFamily
    return kind(mcfg, *args, **kwargs)
