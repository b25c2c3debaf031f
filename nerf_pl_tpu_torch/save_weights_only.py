"""Strip a full training checkpoint to bare model weights (~5 MB).

    python -m nerf_pl_tpu_torch.save_weights_only --ckpt_path \
        ckpts/exp/last.ckpt [--out scene.ckpt]

Port of scripts/save_weights_only.py (the reference's "portable scene"
export, README.md:181-184), with its flags; numpy only. The output loads in
both packages.
"""
import os
from argparse import ArgumentParser

from .training.checkpoints import save_weights_only


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--ckpt_path", type=str, required=True,
                        help="full checkpoint path")
    parser.add_argument("--out", type=str, default=None,
                        help="output path (default: <ckpt>_weights.ckpt)")
    args = parser.parse_args(argv)
    out = args.out or (os.path.splitext(args.ckpt_path)[0] + "_weights.ckpt")
    save_weights_only(args.ckpt_path, out)
    print(f"{out}: {os.path.getsize(out) / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
