"""Device ms a step of occupancy's per-step work (busy): the program's
`occupied_z` phase, the coarse depths placed in each ray's occupied
segments (occupied_z_vals). None on a store with no segment masks
(nerfbench/metrics/_spans.py)."""
from nerfbench.metrics._spans import per_unit_ms


def read(tr, ctx):
    return per_unit_ms(tr, ("occupied_z",)) if ctx["kind"] == "train" \
        else None
