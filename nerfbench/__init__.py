"""The benchmark of nerf_pl_tpu_torch: see run.py."""
