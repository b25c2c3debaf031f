"""The device's idle share of mip-NeRF 360's traced window: 100 x (1 -
the union of its operations' spans over the window)."""
from nerfbench.metrics._common import idle_pct


def read(tr, ctx):
    return idle_pct(tr) if ctx["kind"] == "train_mip360" else None
