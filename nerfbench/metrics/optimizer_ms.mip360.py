"""Device ms a step (busy) of mip-NeRF 360's update: the program's phases
`clip` (the gradients' global norm and the clip's factor) and
`optimizer` (the Adam launch that reads the factor)
(nerfbench/metrics/_spans.py)."""
from nerfbench.metrics._spans import per_unit_ms


def read(tr, ctx):
    return per_unit_ms(tr, ("clip", "optimizer")) \
        if ctx["kind"] == "train_mip360" else None
