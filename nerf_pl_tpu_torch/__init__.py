"""nerf_pl_tpu_torch — the PyTorch / CUDA port of nerf_pl_tpu for NVIDIA Hopper.

The JAX package `nerf_pl_tpu` is the reference this package is held
against; module names mirror it so each counterpart is easy to find. Plain
tensor code is PyTorch; every TPU (Pallas) kernel on a ported path is a
CUDA C++ kernel written for `sm_90a` (`csrc/`), built with `nvcc` on first
use and bound with ctypes (`ops/_build.py`). This package never imports
jax.

Ported so far: the test-time render (`eval.py --fused_mlp`):
  models     — positional encoding + NeRF MLP over {layer: {w, b}} dicts
  ops        — sample_pdf, the fused-MLP packing, and the two fused render
               kernels (fused_sigma_render, fused_render_eval)
  rendering  — volume quadrature, test-time render_rays
  parallel   — make_render_fn: padded, chunked full-image renderer
  training   — checkpoint loading, PSNR / SSIM
  datasets   — camera rays and sphere poses in torch
  eval       — the eval CLI (python -m nerf_pl_tpu_torch.eval)
"""
