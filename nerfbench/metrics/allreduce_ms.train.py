"""Device ms a step of the collectives' (NCCL) kernels: the all-reduce
of the data-parallel step."""
from nerfbench import trace as T

from nerfbench.metrics._common import per_unit_ms


def read(tr, ctx):
    if ctx["kind"] != "train" or ctx.get("world", 1) < 2:
        return None
    spent = T.device_s(tr.device, T.COLLECTIVE)
    return per_unit_ms(spent, tr) if spent > 0 else None
