"""Device ms a step outside the hand-written kernels and the
collectives."""
from nerfbench.metrics._common import plain_ops_ms


def read(tr, ctx):
    return plain_ops_ms(tr) if ctx["kind"] == "train" else None
