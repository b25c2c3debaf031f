"""Train a NeRF with the PyTorch port on NVIDIA GPUs.

    python -m nerf_pl_tpu_torch.train --fused_train --dataset_name blender \
        --root_dir <scene> --N_importance 64 --img_wh 400 400 \
        --num_epochs 16 --batch_size 1024 --lr 5e-4 --lr_scheduler steplr \
        --decay_step 2 4 8 --decay_gamma 0.5 --exp_name exp

Port of the repository's train.py: the same flags and defaults (parsed by
the port's copy of the JAX package's parser, `nerf_pl_tpu_torch.config`),
writing `ckpts/<exp>/epoch=*.ckpt`, `last.ckpt` and `topk.json` in
the format both packages load, and resuming from either package's
checkpoints (--ckpt_path). `--fused_train` takes the loss-fused training
kernel; without it the step runs autograd over the render, through the
fused point-MLP kernels with `--fused_mlp` (which validation then runs
too) or the plain MLP without. `--occ_train` (with `--occ_segments`,
`--occ_dilate`, `--occ_pack`, `--occ_mode`, ...) trains occupancy-tightened
after `--occ_warmup_epochs`, the grid rebuilt every `--occ_refresh_epochs`
on the training device. It runs on cuda:0 (and the next cards with
--num_gpus) and raises without CUDA; only a caller of main(device="cpu")
trains on the CPU.

`--scan_steps` is the number of steps between two reads of the metrics.
`--compile_cache` is accepted and does nothing. TensorBoard logging needs
tensorboardX; without it the CLI says so and trains without logs.

`--optimizer` takes sgd, adam, radam and ranger; `--precision bfloat16`
with `--fused_train` or `--fused_mlp` keeps bf16 master weights and
moments. On the card each segment of steps replays one captured CUDA
graph of the step. Reading the datasets' images needs PIL.

`--model mipnerf360` (with `--dataset_name llff --spheric_poses` and the
`--mip_*` flags, config.py) trains mip-NeRF 360 on one card through the
same NeRFSystem and Trainer; the NeRF paths' flags are refused for it.

`--num_gpus N` trains data parallel, one process a rank
(`dist.py`): on the card over min(N, the cards there are) ranks,
one card each, over NCCL, as the JAX package takes min(--num_gpus,
len(jax.devices())); with main(device="cpu") over N gloo ranks on the
CPU. --batch_size stays the global batch. A world of one trains in the
calling process.
"""
import sys


def _train(hparams, device, group=None):
    from . import dist as pdist
    from .training.system import NeRFSystem

    main_rank = pdist.is_main(group)
    try:
        import tensorboardX  # noqa: F401
        enable_tb = True
    except ImportError:
        enable_tb = False
        if main_rank:
            print("[train] tensorboardX is not installed: TensorBoard "
                  "logging is off")
    system = NeRFSystem(hparams, enable_tb=enable_tb, device=device,
                        group=group)
    final = system.fit()
    if final and main_rank:
        print(f"[done] val/psnr={final.get('val/psnr', float('nan')):.2f} "
              f"val/ssim={final.get('val/ssim', float('nan')):.3f}")
    return final


def _train_rank(group, device, argv):
    """One rank of a data parallel run (spawned by `dist.launch`)."""
    from .config import get_opts
    return _train(get_opts(argv), device, group)


def main(argv=None, device=None):
    from .config import get_opts, validate_hparams
    from . import dist as pdist

    argv = sys.argv[1:] if argv is None else list(argv)
    hparams = validate_hparams(get_opts(argv))
    kind, world = pdist.plan_world(hparams.num_gpus, device)
    if world == 1:
        return _train(hparams, device)
    return pdist.launch(_train_rank, world, argv, device=kind)[0]


if __name__ == "__main__":
    main()
