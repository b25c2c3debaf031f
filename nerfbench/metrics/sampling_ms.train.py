"""Device ms a step of the sampling (busy): the program's phases `draws`
(the step's random numbers, outside the step's graph), `batch` (the rows
at the step's offset), `coarse_z` or `occupied_z` (the coarse depths) and
`fine_z` (sample_pdf and the sort) (nerfbench/metrics/_spans.py)."""
from nerfbench.metrics._spans import per_unit_ms


def read(tr, ctx):
    if ctx["kind"] != "train":
        return None
    return per_unit_ms(tr, ("draws", "batch", "coarse_z", "occupied_z",
                            "fine_z"))
