"""Device ms a step (busy) of mip-NeRF 360's losses: the program's phase
`losses`, the Charbonnier, interlevel and distortion losses' forward
(their backward runs in `backward`) (nerfbench/metrics/_spans.py)."""
from nerfbench.metrics._spans import per_unit_ms


def read(tr, ctx):
    return per_unit_ms(tr, ("losses",)) \
        if ctx["kind"] == "train_mip360" else None
