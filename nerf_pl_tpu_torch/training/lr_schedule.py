"""Learning-rate schedules: steplr / cosine / poly, with gradual warmup.

Port of nerf_pl_tpu/training/lr_schedule.py. Decay follows the epoch,
`step / steps_per_epoch` as a float32, so the schedule is a pure
step -> lr function. It takes the step as a Python int or as an integer
tensor (on any device, with no host sync) and returns a float32 tensor on
the step's device. Warmup ramps the scale from 1 to the multiplier over
warmup_epochs, then the base schedule runs scaled by the multiplier; it
applies to sgd and adam only, as in the reference.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def get_lr_schedule(lr_scheduler: str,
                    lr: float,
                    num_epochs: int,
                    steps_per_epoch: int,
                    decay_step: Sequence[int] = (20,),
                    decay_gamma: float = 0.1,
                    poly_exp: float = 0.9,
                    warmup_multiplier: float = 1.0,
                    warmup_epochs: int = 0,
                    optimizer: str = "adam",
                    eps: float = 1e-8) -> Callable:
    """Returns a step -> lr function."""
    milestones = sorted(float(m) for m in decay_step)
    if lr_scheduler not in ("steplr", "cosine", "poly"):
        raise ValueError(f"scheduler not recognized: {lr_scheduler!r}")

    def base_scale(epoch):
        if lr_scheduler == "steplr":
            # MultiStepLR: gamma^(#milestones reached by this epoch)
            n_passed = torch.zeros_like(epoch)
            for m in milestones:
                n_passed = n_passed + (epoch >= m).float()
            return decay_gamma ** n_passed
        if lr_scheduler == "cosine":
            # CosineAnnealingLR with T_max=num_epochs, eta_min=eps
            cos = 0.5 * (1 + torch.cos(math.pi * epoch / num_epochs))
            return (eps + (lr - eps) * cos) / lr
        frac = torch.clamp(1.0 - epoch / num_epochs, 0.0, 1.0)
        return frac ** poly_exp

    use_warmup = warmup_epochs > 0 and optimizer in ("sgd", "adam")

    def schedule(step):
        epoch = torch.as_tensor(step).to(torch.float32) / steps_per_epoch
        if not use_warmup:
            return lr * base_scale(epoch)
        ramp = (warmup_multiplier - 1.0) * torch.clamp(
            epoch / warmup_epochs, max=1.0) + 1.0
        after = warmup_multiplier * base_scale(
            torch.clamp(epoch - warmup_epochs, min=0.0))
        return lr * torch.where(epoch <= warmup_epochs, ramp, after)

    return schedule


def get_loglinear_schedule(lr_init: float, lr_final: float, max_steps: int,
                           delay_steps: int = 0,
                           delay_mult: float = 1.0) -> Callable:
    """mip-NeRF 360's schedule (multinerf's learning_rate_decay): the lr
    log-linear from lr_init at step 0 to lr_final at max_steps, scaled
    during the first delay_steps by delay_mult + (1 - delay_mult) sin(pi/2
    min(step / delay_steps, 1)). A step -> float32 tensor function, as
    get_lr_schedule's."""
    lv0, lv1 = math.log(lr_init), math.log(lr_final)

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        frac = torch.clamp(step / max_steps, 0.0, 1.0)
        lr = torch.exp(frac * (lv1 - lv0) + lv0)
        if delay_steps > 0:
            ramp = torch.clamp(step / delay_steps, 0.0, 1.0)
            lr = lr * (delay_mult + (1 - delay_mult)
                       * torch.sin(0.5 * math.pi * ramp))
        return lr

    return schedule
