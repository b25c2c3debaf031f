"""Image metrics: MSE, PSNR, SSIM.

Port of nerf_pl_tpu/training/metrics.py: a window-3 gaussian SSIM mapped
to [-1, 1] by 1 - 2 * dssim, as the reference's kornia metric. The blur is
a separable depthwise conv2d with zero padding. On a GPU, cuDNN runs f32
convolutions in TF32 by default, and SSIM's variance terms E[x^2] - mu^2
cancel badly at that precision (the JAX package met the same fault as a
0.06 low bias from bf16 convolutions on the TPU), so TF32 is switched off
for the metric's duration.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def mse(image_pred, image_gt, valid_mask: Optional[torch.Tensor] = None,
        reduction: str = "mean"):
    value = (image_pred - image_gt) ** 2
    if valid_mask is not None:
        value = value[valid_mask]
    if reduction == "mean":
        return torch.mean(value)
    return value


def psnr(image_pred, image_gt, valid_mask: Optional[torch.Tensor] = None,
         reduction: str = "mean"):
    return -10 * torch.log10(mse(image_pred, image_gt, valid_mask, reduction))


@contextlib.contextmanager
def no_tf32():
    """Full f32 matmuls and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable gaussian blur of (C, H, W), zero-padded 'same'."""
    C = img.shape[0]
    pad = len(k) // 2
    kt = torch.as_tensor(k, dtype=img.dtype, device=img.device)
    kh = kt.reshape(1, 1, -1, 1).expand(C, 1, len(k), 1)
    kw = kt.reshape(1, 1, 1, -1).expand(C, 1, 1, len(k))
    x = F.conv2d(img[None], kh, padding=(pad, 0), groups=C)
    x = F.conv2d(x, kw, padding=(0, pad), groups=C)
    return x[0]


def ssim_map(image_pred: torch.Tensor, image_gt: torch.Tensor,
             window_size: int = 3, sigma: float = 1.5,
             max_val: float = 1.0) -> torch.Tensor:
    """Per-pixel SSIM for (C, H, W) images in [0, max_val]."""
    k = _gaussian_kernel1d(window_size, sigma)
    C1 = (0.01 * max_val) ** 2
    C2 = (0.03 * max_val) ** 2
    with no_tf32():
        mu_p = _blur(image_pred, k)
        mu_g = _blur(image_gt, k)
        mu_pp = mu_p * mu_p
        mu_gg = mu_g * mu_g
        mu_pg = mu_p * mu_g
        sigma_p = _blur(image_pred * image_pred, k) - mu_pp
        sigma_g = _blur(image_gt * image_gt, k) - mu_gg
        sigma_pg = _blur(image_pred * image_gt, k) - mu_pg
    num = (2 * mu_pg + C1) * (2 * sigma_pg + C2)
    den = (mu_pp + mu_gg + C1) * (sigma_p + sigma_g + C2)
    return num / den


def ssim(image_pred: torch.Tensor, image_gt: torch.Tensor,
         reduction: str = "mean"):
    """SSIM in [-1, 1] of (1, 3, H, W) or (3, H, W) images in [0, 1]."""
    if image_pred.dim() == 4:
        image_pred = image_pred[0]
        image_gt = image_gt[0]
    smap = ssim_map(image_pred, image_gt)
    dssim_ = torch.clamp((1 - smap) / 2, 0, 1)
    if reduction == "mean":
        dssim_ = torch.mean(dssim_)
    return 1 - 2 * dssim_
