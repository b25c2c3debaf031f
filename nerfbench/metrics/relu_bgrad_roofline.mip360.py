"""mip-NeRF 360's ReLU backward's share of its roofline: the least time of
a step's ReLU-backward bytes, at the HBM rate, times the steps traced,
over the device time of the kernels named `relu_bgrad` (the launch pair of
the program's ops/relu_bgrad.py). The bytes are 6 a value of every ReLU
layer's output (grad and y read, g written): the `layer_*` of both MLPs,
at each proposal point of both levels and each NeRF point, and the NeRF
MLP's view layer (work_mip360.layer_dims). The partial rows the pair
writes and reads are left out, so the share reads low, never high. None
outside the mip-NeRF 360 runner, and where the program keeps no launch
count `relu_bgrad_launches` or launched none."""
import re
import sys
from typing import Dict

from nerfbench import trace as T
from nerfbench.work import HBM_BYTES_PER_S
from nerfbench.work_mip360 import layer_dims

PATTERN = re.compile(r"relu_bgrad")
MODULE = "nerf_pl_tpu_torch.ops.relu_bgrad"
BYTES_PER_VALUE = 6


def relu_values(model: Dict, unit: Dict) -> int:
    """The values of a step's ReLU layers' outputs."""
    dims = layer_dims(model)
    prop = sum(fo for name, (_, fo) in dims["prop_mlp"].items()
               if name.startswith("layer_"))
    nerf = sum(fo for name, (_, fo) in dims["nerf_mlp"].items()
               if name.startswith("layer_") or name == "view")
    return unit["prop_points"] * prop + unit["nerf_points"] * nerf


def least_s(model: Dict, unit: Dict) -> float:
    """A step's ReLU-backward bytes at the HBM rate."""
    return BYTES_PER_VALUE * relu_values(model, unit) / HBM_BYTES_PER_S


def read(tr, ctx):
    if ctx["kind"] != "train_mip360" or not tr.units:
        return None
    if not getattr(sys.modules.get(MODULE), "relu_bgrad_launches", 0):
        return None
    spent = T.device_s(tr.device, PATTERN)
    if spent <= 0:
        return None
    return 100.0 * least_s(ctx["model"], ctx["unit"]) * tr.units / spent
