"""Both mip-NeRF 360 MLPs' products' share of their roofline: the least
time of a step's products (work_mip360: their operations at the bf16
peak) times the steps traced, over the device time of the kernels that
compute them. Those are cuBLAS's, as the trace on an H100 names them:
`nvjet_*` and `sm90_xmma_gemm_*` products, `gemv*` for the one-column
heads, and `splitKreduce_kernel` where cuBLAS splits a product's sum."""
import re

from nerfbench import trace as T
from nerfbench.work_mip360 import least_s

PATTERN = re.compile(r"nvjet|gemm|gemv|splitKreduce", re.IGNORECASE)


def read(tr, ctx):
    if ctx["kind"] != "train_mip360" or not tr.units:
        return None
    spent = T.device_s(tr.device, PATTERN)
    if spent <= 0:
        return None
    return 100.0 * least_s(ctx["unit"]["ops"]) * tr.units / spent
