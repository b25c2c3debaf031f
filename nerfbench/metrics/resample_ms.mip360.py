"""Device ms a step (busy) of mip-NeRF 360's resampling between levels:
the program's phases `resample1` and `resample2`, the inverse CDF of the
previous level's weights and the new endpoints
(nerfbench/metrics/_spans.py)."""
from nerfbench.metrics._spans import per_unit_ms


def read(tr, ctx):
    return per_unit_ms(tr, ("resample1", "resample2")) \
        if ctx["kind"] == "train_mip360" else None
