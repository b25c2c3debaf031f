"""nerf_pl_tpu_torch — the PyTorch / CUDA port of nerf_pl_tpu for NVIDIA Hopper.

The JAX package `nerf_pl_tpu` is the reference this package is held
against; module names mirror it so each counterpart is easy to find. Plain
tensor code is PyTorch; every TPU (Pallas) kernel on a ported path is a
CUDA C++ kernel written for `sm_90a` (`csrc/`), built with `nvcc` on first
use and bound with ctypes (`ops/_build.py`). This package imports neither
jax nor the JAX package: it keeps its own copies of the host code it needs
(`config`, `datasets`, `utils`).

Ported, on one device or over several (`dist`; data parallel, and tensor
parallel on a mesh's model axis), with every TPU kernel of the repo: the test-time render (`eval.py --fused_mlp`), the loss-fused training step
(`train.py --fused_train`), training and validation through the fused
point MLP (`train.py --fused_mlp`), and training by autograd through the
two-kernel fused training render (`RenderConfig(fused_train=True)`):
  models     — positional encoding + NeRF MLP over {layer: {w, b}} dicts
  ops        — sample_pdf; the fused point MLP: packing, plain forward and
               gradient bodies and its three kernels (fused_nerf_mlp's
               forward and backward, nerf_sigma_fused); the two fused
               render kernels (fused_sigma_render, fused_render_eval) and
               the training render kernels (fused_mse_render, and
               fused_train_render's forward and backward)
  rendering  — volume quadrature, render_rays (test and train time, fused
               or not), fused_mse_train_step
  parallel   — make_render_fn (padded, chunked full-image renderer) and
               the Trainer, each on one device or over a process group;
               the (data, model) mesh and the MLP's tensor parallel
               layout on its model axis (mesh)
  dist       — data parallel over torch.distributed: the world, the
               launcher of one process a rank, the collectives over trees
  training   — model families, checkpoints (both packages'), losses, lr
               schedules, sgd/adam, PSNR / SSIM, NeRFSystem
  datasets   — blender and llff scenes (numpy), camera rays and sphere
               poses in torch
  mesh       — the σ grid and occlusion renders (plain f32 MLP), marching
               tetrahedra and clustering (native C++, built with g++),
               colour fusion, PLY / COLLADA / .vol export
  utils      — synthetic scenes (the sphere and the hard scene), depth
               visualisation, a phase timer
  config     — the train CLI's flags (Hparams, validate_hparams, get_opts)
  eval, train, render_image, bench_render, extract_color_mesh,
  preview_bounds, save_weights_only, make_hard_datasets, northstar,
  dryrun_multichip, bench_kernels, bench
             — the CLIs (python -m nerf_pl_tpu_torch.<name>)
"""
