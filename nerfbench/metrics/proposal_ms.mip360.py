"""Device ms a step (busy) of mip-NeRF 360's proposal levels: the
program's phases `prop0` and `prop1`, each the level's samples (level 0's
inverse CDF of [0, 1]), their encoding and the proposal MLP's forward
with its quadrature (nerfbench/metrics/_spans.py)."""
from nerfbench.metrics._spans import per_unit_ms


def read(tr, ctx):
    return per_unit_ms(tr, ("prop0", "prop1")) \
        if ctx["kind"] == "train_mip360" else None
