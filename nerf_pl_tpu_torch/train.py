"""Train a NeRF with the PyTorch port on one NVIDIA GPU.

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
on the training device. It runs on cuda:0 and raises without CUDA; only a
caller of main(device="cpu") trains on the CPU.

`--scan_steps` is the number of steps between two reads of the metrics.
`--compile_cache` is accepted and does nothing. TensorBoard logging needs
tensorboardX; without it the CLI says so and trains without logs.

`--optimizer` takes sgd, adam, radam and ranger; `--precision bfloat16`
with `--fused_train` or `--fused_mlp` keeps bf16 master weights and
moments. On the card each segment of steps replays one captured CUDA
graph of the step. Data parallel training is a later slice: --num_gpus > 1
is rejected, naming its ROADMAP item (A10). Reading the datasets' images
needs PIL.
"""
import sys


def main(argv=None, device=None):
    from .config import get_opts
    from .training.system import NeRFSystem, unported

    argv = sys.argv[1:] if argv is None else list(argv)
    hparams = get_opts(argv)
    why = unported(hparams)
    if why:
        raise SystemExit(f"not ported yet: {why}")
    try:
        import tensorboardX  # noqa: F401
        enable_tb = True
    except ImportError:
        enable_tb = False
        print("[train] tensorboardX is not installed: TensorBoard logging "
              "is off")
    system = NeRFSystem(hparams, enable_tb=enable_tb, device=device)
    final = system.fit()
    if final:
        print(f"[done] val/psnr={final.get('val/psnr', float('nan')):.2f} "
              f"val/ssim={final.get('val/ssim', float('nan')):.3f}")
    return final


if __name__ == "__main__":
    main()
