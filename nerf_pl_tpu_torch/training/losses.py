"""Training losses. Port of nerf_pl_tpu/training/losses.py: mean-squared
error on the coarse rgb plus, when the hierarchical pass runs, the fine
rgb, summed."""
from __future__ import annotations

from typing import Dict

import torch


def mse_loss(results: Dict[str, torch.Tensor],
             rgbs: torch.Tensor) -> torch.Tensor:
    loss = torch.mean((results["rgb_coarse"] - rgbs) ** 2)
    if "rgb_fine" in results:
        loss = loss + torch.mean((results["rgb_fine"] - rgbs) ** 2)
    return loss


loss_dict = {"mse": mse_loss}
