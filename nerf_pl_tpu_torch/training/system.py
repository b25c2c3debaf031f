"""NeRFSystem: end-to-end training on one device.

Port of nerf_pl_tpu/training/system.py: dataset preparation, the trainer,
the epoch loop (segments of --scan_steps steps), full-image validation
with TensorBoard panels, top-k checkpointing, `last.ckpt` and resume, in
checkpoints both packages load. The dataset classes, the flag checks and
the host utilities are the port's copies of the JAX package's
(`datasets/`, `config.py`, `utils/`). With --occ_train, after
--occ_warmup_epochs and then every --occ_refresh_epochs, an occupancy grid
of the current fine model tightens the ray store (`_occ_tighten`), on the
training device.

Validation renders clean (no jitter or noise) full images through
`make_render_fn` with the training passes (test_time off), as the JAX
package does: with --fused_mlp both passes run the fused point MLP's
forward kernel, and val/loss sums the coarse and fine terms either way.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import validate_hparams
from ..datasets import dataset_dict
from ..device import resolve_device
from ..parallel.render import make_render_fn
from ..parallel.spmd import Trainer, seed_for
from ..rendering.occupancy import (build_occupancy_grid, pick_block,
                                   rays_aabb, resolve_ranges)
from ..rendering.render import ModelConfig, RenderConfig
from ..utils.profiling import PhaseTimer
from ..utils.visualization import visualize_depth
from .checkpoints import (TopKCheckpoints, load_checkpoint, load_ckpt,
                          save_checkpoint)
from .losses import loss_dict
from .lr_schedule import get_lr_schedule
from .metrics import psnr as psnr_fn
from .metrics import ssim as ssim_fn
from .optimizers import get_optimizer


def unported(hp) -> Optional[str]:
    """Why a flag set cannot train with the port yet, naming the ROADMAP
    item; None when it can."""
    if hp.num_gpus > 1:
        return "--num_gpus > 1: data parallel training (ROADMAP A10)"
    if hp.optimizer in ("radam", "ranger"):
        return f"--optimizer {hp.optimizer} (ROADMAP A4)"
    if hp.precision == "bfloat16" and (hp.fused_train or hp.fused_mlp):
        return ("--precision bfloat16 with the fused kernels: bf16 master "
                "weights (ROADMAP A4)")
    return None


class NeRFSystem:
    def __init__(self, hparams, log_dir: str = "logs",
                 ckpt_root: str = "ckpts", enable_tb: bool = True,
                 device: Optional[torch.device | str] = None):
        self.hparams = hparams
        self.device = resolve_device(device)
        self.log_dir = os.path.join(log_dir, hparams.exp_name)
        self.ckpt_dir = os.path.join(ckpt_root, hparams.exp_name)
        self.enable_tb = enable_tb
        self.writer = None
        self.mcfg = ModelConfig()

    # ----------------------------------------------------------------- data
    def prepare_data(self):
        hp = self.hparams
        dataset = dataset_dict[hp.dataset_name]
        kwargs = {"root_dir": hp.root_dir, "img_wh": tuple(hp.img_wh)}
        if hp.dataset_name == "llff":
            kwargs["spheric_poses"] = hp.spheric_poses
            kwargs["val_num"] = hp.val_num
        self.train_dataset = dataset(split="train", **kwargs)
        self.val_dataset = dataset(split="val", **kwargs)

    # ---------------------------------------------------------------- setup
    def setup(self):
        hp = validate_hparams(self.hparams)
        why = unported(hp)
        if why:
            raise NotImplementedError(f"not ported yet: {why}")
        compute_dtype = (torch.bfloat16 if hp.precision == "bfloat16"
                         else torch.float32)
        white_back = self.train_dataset.white_back
        self.rcfg_train = RenderConfig(
            N_samples=hp.N_samples, N_importance=hp.N_importance,
            use_disp=hp.use_disp, perturb=hp.perturb,
            noise_std=hp.noise_std, white_back=white_back,
            compute_dtype=compute_dtype, fused=hp.fused_mlp,
            fused_train=hp.fused_train,
            # the loss-fused step is exactly the reference MSE
            fused_loss=(hp.fused_train and hp.loss_type == "mse"),
            occ_keepalive=hp.occ_keepalive)
        self.rcfg_val = RenderConfig(
            N_samples=hp.N_samples, N_importance=hp.N_importance,
            use_disp=hp.use_disp, perturb=0.0, noise_std=0.0,
            white_back=white_back, compute_dtype=compute_dtype,
            fused=hp.fused_mlp)

        # ceil: the store pads the tail batch, as Trainer.set_data does
        self.steps_per_epoch = max(
            1, -(-len(self.train_dataset) // hp.batch_size))
        self.lr_schedule = get_lr_schedule(
            hp.lr_scheduler, hp.lr, hp.num_epochs, self.steps_per_epoch,
            decay_step=hp.decay_step, decay_gamma=hp.decay_gamma,
            poly_exp=hp.poly_exp, warmup_multiplier=hp.warmup_multiplier,
            warmup_epochs=hp.warmup_epochs, optimizer=hp.optimizer)
        optimizer = get_optimizer(hp.optimizer, self.lr_schedule,
                                  momentum=hp.momentum,
                                  weight_decay=hp.weight_decay)
        self.trainer = Trainer(self.mcfg, self.rcfg_train, optimizer,
                               self.lr_schedule, loss_dict[hp.loss_type],
                               hp.batch_size, self.device)
        self.trainer.set_data(self.train_dataset.all_rays,
                              self.train_dataset.all_rgbs)
        self.state = self.trainer.init_state(
            torch.Generator().manual_seed(hp.seed))
        if hp.ckpt_path:
            self._restore(hp.ckpt_path)

        if self.enable_tb and self.writer is None:
            from tensorboardX import SummaryWriter
            os.makedirs(self.log_dir, exist_ok=True)
            self.writer = SummaryWriter(self.log_dir)
        self.topk = TopKCheckpoints(self.ckpt_dir, k=5)

    def _restore(self, ckpt_path: str):
        """Full resume when the checkpoint holds a complete train state
        (of either package); otherwise a non-strict params-only load."""
        try:
            self.state, _ = load_checkpoint(ckpt_path, self.state)
            print(f"[resume] full train state from {ckpt_path} "
                  f"(step {self.state.step})")
            return
        except (KeyError, ValueError) as e:
            print(f"[resume] partial load ({e})")
        params = self.state.params
        for model_name in params:
            params = load_ckpt(params, ckpt_path, model_name,
                               tuple(self.hparams.prefixes_to_ignore))
        self.state = self.state._replace(params=params)
        print(f"[resume] params from {ckpt_path}")

    # ----------------------------------------------------------- occupancy
    def _occ_tighten(self):
        """Build an occupancy grid from the current fine (else coarse)
        params and tighten every stored ray's interval to its boxes."""
        hp = self.hparams
        params = self.state.params.get("nerf_fine",
                                       self.state.params["nerf_coarse"])
        # the dataset rays never change: their hull is computed once
        if getattr(self, "_rays_aabb", None) is None:
            self._rays_aabb = rays_aabb(self.train_dataset.all_rays)
        aabb = self._rays_aabb
        self._occ_refresh_i = getattr(self, "_occ_refresh_i", -1) + 1
        auto = hp.occ_range is None
        ranges = resolve_ranges(hp.occ_range, params, self.mcfg, aabb=aabb,
                                sigma_threshold=hp.occ_threshold)
        occ = build_occupancy_grid(
            params, self.mcfg, N=hp.occ_N, block=pick_block(hp.occ_N),
            ranges=ranges, sigma_threshold=hp.occ_threshold,
            max_ranges=aabb if auto else None, mode=hp.occ_mode,
            # visibility rays: the dataset's, with their untightened
            # intervals (the store's are tightened in place)
            vis_rays=(self.train_dataset.all_rays
                      if hp.occ_mode == "weight" else None),
            # a new stride phase each refresh, so a thin structure missed
            # by one subsample is recovered by the next rebuild
            vis_offset=self._occ_refresh_i)
        if occ.n_boxes == 0:
            print("[occ] grid empty (model not yet dense) — store unchanged")
            return
        st = self.trainer.tighten_store(
            occ.boxes, margin=hp.occ_margin, n_seg=hp.occ_segments,
            dilate=hp.occ_dilate, pack=hp.occ_pack)
        msg = (f"[occ] {occ.n_boxes} boxes "
               f"({occ.occupied_fraction * 100:.1f}% blocks occupied); "
               f"{st['hit_frac'] * 100:.1f}% rays hit, mean interval shrink "
               f"{st['shrink'] * 100:.1f}%")
        if hp.occ_segments:
            msg += (f", {hp.occ_segments}-segment masks"
                    + (f" (dilate {hp.occ_dilate})" if hp.occ_dilate else ""))
        if hp.occ_pack:
            msg += (f"; packed: x{st['expand']:.2f} effective batch, "
                    f"culled-ray residual mse {st['miss_mse']:.2e}")
        print(msg, flush=True)

    # ------------------------------------------------------------- validate
    def validate(self, global_step: int, max_items: Optional[int] = None
                 ) -> Dict[str, float]:
        hp = self.hparams
        W, H = hp.img_wh
        render = make_render_fn(self.rcfg_val, min(hp.val_chunk, hp.chunk),
                                self.device, self.mcfg)
        typ = "fine" if hp.N_importance > 0 else "coarse"
        losses, psnrs, ssims = [], [], []
        n_items = len(self.val_dataset) if max_items is None else min(
            max_items, len(self.val_dataset))
        for i in range(n_items):
            sample = self.val_dataset[i]
            out = render(self.state.params, sample["rays"])
            rgbs = np.asarray(sample["rgbs"])
            losses.append(float(sum(np.mean((out[f"rgb_{t}"] - rgbs) ** 2)
                                    for t in ("coarse", "fine")
                                    if f"rgb_{t}" in out)))
            pred = out[f"rgb_{typ}"]
            psnrs.append(float(psnr_fn(torch.from_numpy(pred),
                                       torch.from_numpy(rgbs))))
            img_pred = pred.reshape(H, W, 3).transpose(2, 0, 1)
            img_gt = rgbs.reshape(H, W, 3).transpose(2, 0, 1)
            ssims.append(float(ssim_fn(torch.from_numpy(img_pred.copy()),
                                       torch.from_numpy(img_gt.copy()))))
            if i == 0 and self.writer is not None:
                depth = visualize_depth(out[f"depth_{typ}"].reshape(H, W))
                stack = np.stack([img_gt, img_pred, depth])  # (3, 3, H, W)
                self.writer.add_images("val/GT_pred_depth", stack,
                                       global_step)
        metrics = {"val/loss": float(np.mean(losses)),
                   "val/psnr": float(np.mean(psnrs)),
                   "val/ssim": float(np.mean(ssims))}
        if self.writer is not None:
            for k, v in metrics.items():
                self.writer.add_scalar(k, v, global_step)
        return metrics

    # ------------------------------------------------------------------ fit
    def fit(self) -> Dict[str, float]:
        hp = self.hparams
        timer = self.timer = PhaseTimer()
        with timer.phase("prepare_data"):
            self.prepare_data()
        with timer.phase("setup"):
            self.setup()

        step_seed = hp.seed + 1
        spe = self.steps_per_epoch
        start_step = self.state.step
        start_epoch = start_step // spe
        # Replay the per-epoch shuffles a resumed run already consumed. A
        # packed store past warmup reshuffles canonically (its layout is a
        # function of the grid and the last epoch's seed), so it re-derives
        # the grid from the restored params and applies the last seed only.
        packed_resume = (hp.occ_train and hp.occ_pack
                         and start_epoch >= hp.occ_warmup_epochs
                         and start_epoch >= 1)
        if packed_resume:
            self._occ_tighten()
            self.trainer.reshuffle(seed_for(hp.seed + 2, start_epoch))
        else:
            for e in range(1, start_epoch + 1):
                self.trainer.reshuffle(seed_for(hp.seed + 2, e))
        total_steps = hp.num_epochs * spe
        print(f"[fit] {hp.num_epochs} epochs x {spe} steps/epoch = "
              f"{total_steps} steps (resuming at {start_step}) on "
              f"{self.device}", flush=True)
        if start_step == 0:
            sanity = self.validate(0, max_items=1)
            print(f"[sanity] val/psnr={sanity['val/psnr']:.2f}")
        # past warmup, the store is tightened before any step runs
        if hp.occ_train and not packed_resume and \
                start_epoch >= hp.occ_warmup_epochs and \
                start_step < total_steps:
            self._occ_tighten()

        metrics = {}
        step = start_step
        t_start = time.time()
        rays_done = 0
        profiled = False
        while step < total_steps:
            # segments stop at epoch boundaries, where the store reshuffles
            seg = min(hp.scan_steps, total_steps - step, spe - step % spe)
            epoch_before = step // spe
            do_trace = bool(hp.profile_dir) and not profiled and step > 0
            with timer.phase("train_segment"):
                if do_trace:
                    m = self._profiled_segment(step_seed, seg)
                    profiled = True
                else:
                    self.state, m = self.trainer.run_steps(
                        self.state, step_seed, seg)
                m = {k: v.cpu().numpy() for k, v in m.items()}
            rays_done += seg * hp.batch_size
            step += seg
            if self.writer is not None:
                for local_i in range(0, seg, max(1, hp.log_every)):
                    gs = step - seg + local_i
                    self.writer.add_scalar("lr", m["lr"][local_i], gs)
                    self.writer.add_scalar("train/loss", m["loss"][local_i],
                                           gs)
                    self.writer.add_scalar("train/psnr", m["psnr"][local_i],
                                           gs)
            rate = rays_done / max(time.time() - t_start, 1e-9)
            eff = ""
            if self.trainer.pack_expand > 1.0:
                # each batch row is a surviving ray; the culled rest is
                # covered analytically
                eff = (f", x{self.trainer.pack_expand:.2f} packed = "
                       f"{rate * self.trainer.pack_expand:,.0f} effective")
            print(f"[train] step {step}/{total_steps} "
                  f"loss={m['loss'][-1]:.4f} psnr={m['psnr'][-1]:.2f} "
                  f"({rate:,.0f} rays/s{eff})", flush=True)

            epoch = step // spe
            if epoch > epoch_before and step < total_steps:
                self.trainer.reshuffle(seed_for(hp.seed + 2, epoch))
                if hp.occ_train and epoch >= hp.occ_warmup_epochs and \
                        (epoch - hp.occ_warmup_epochs) \
                        % max(hp.occ_refresh_epochs, 1) == 0:
                    with timer.phase("occ_tighten"):
                        self._occ_tighten()
            epoch_val = epoch > epoch_before or step >= total_steps
            mid_val = (not epoch_val and hp.val_every_steps
                       and step // hp.val_every_steps
                       > (step - seg) // hp.val_every_steps)
            if epoch_val or mid_val:
                with timer.phase("validate"):
                    val = self.validate(step)
                metrics = {**val, "epoch": epoch, "step": step}
                tag = (f"epoch {epoch}" if epoch_val
                       else f"step {step} epoch {epoch}")
                print(f"[val] {tag} loss={val['val/loss']:.4f} "
                      f"psnr={val['val/psnr']:.2f} "
                      f"ssim={val['val/ssim']:.3f}", flush=True)
            if epoch_val:
                with timer.phase("checkpoint"):
                    self.topk.maybe_save(self.state, val["val/loss"], epoch,
                                         meta={"step": step})
                    save_checkpoint(os.path.join(self.ckpt_dir, "last.ckpt"),
                                    self.state, {"step": step,
                                                 "epoch": epoch})
        if self.writer is not None:
            self.writer.flush()
        print(f"[profiler]\n{timer.summary()}", flush=True)
        return metrics

    def _profiled_segment(self, step_seed: int, seg: int):
        """One segment under torch.profiler; the trace goes to
        --profile_dir."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            self.state, m = self.trainer.run_steps(self.state, step_seed,
                                                   seg)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(self.hparams.profile_dir, exist_ok=True)
        path = os.path.join(self.hparams.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"[profile] trace written to {path}")
        return m
