"""The work of a configuration, and the device's peaks: the yardstick
that rooflines and MFU read.

Operations are counted at the MLP's published widths (D=8, W=256, the
skip at layer 4, gamma(x) 3 + 6 * 10 = 63 wide, gamma(d) 3 + 6 * 4 = 27
wide, a 128-wide view layer), whatever a kernel pads them to. A training
point's forward and backward count once, with no recomputation: the
forward, every weight gradient (as many operations as the forward) and the
data gradient of every product's input except the embeddings. These are
chip_smoke.py's `mlp_flops_per_point` and `bound`, copied here so that a
later change to the program cannot move them.

Bytes: each input read once and each output written once, as the port's
kernels take them (rays 8 floats, depths and noise one float a sample, the
weights in bf16, the gradients in f32).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def mlp_layers(model: Dict, full: bool) -> List[Tuple[int, int, bool]]:
    """(fan_in, fan_out, input is an embedding) of each product of one
    point through the MLP: the trunk with its skip (the skip's x part a
    product of its own) and the sigma head, and with `full` the feature,
    view (its direction part apart) and rgb layers."""
    D, W = model["D"], model["W"]
    kx = 3 + 6 * model["xyz_freqs"]
    kd = 3 + 6 * model["dir_freqs"]
    wd = W // 2
    n_skip = len(model["skips"])
    layers = ([(kx, W, True)] * (1 + n_skip) + [(W, W, False)] * (D - 1)
              + [(W, 1, False)])
    if full:
        layers += [(W, W, False), (W, wd, False), (kd, wd, True),
                   (wd, 3, False)]
    return layers


def flops_per_point(model: Dict, full: bool = True,
                    train: bool = False) -> int:
    """2 x the multiply-adds of one point: the forward of the sigma trunk
    (full=False) or of the whole MLP, or with `train` its forward and
    backward (forward + weight gradients + data gradients)."""
    layers = mlp_layers(model, full)
    fwd = sum(k * n for k, n, _ in layers)
    if not train:
        return 2 * fwd
    data = sum(k * n for k, n, emb in layers if not emb)
    return 2 * (fwd + fwd + data)


def n_params(model: Dict) -> int:
    """Weights and biases of one MLP."""
    return sum(fi * fo + fo for fi, fo in layer_dims(model).values())


def layer_dims(model: Dict) -> Dict[str, Tuple[int, int]]:
    """{layer: (fan_in, fan_out)} of one MLP, in the port's layer names
    and init order."""
    D, W = model["D"], model["W"]
    kx = 3 + 6 * model["xyz_freqs"]
    kd = 3 + 6 * model["dir_freqs"]
    dims = {}
    for i in range(D):
        fi = kx if i == 0 else (W + kx if i in model["skips"] else W)
        dims[f"xyz_{i}"] = (fi, W)
    dims["xyz_final"] = (W, W)
    dims["dir"] = (W + kd, W // 2)
    dims["sigma"] = (W, 1)
    dims["rgb"] = (W // 2, 3)
    return dims


def kernel_work(kernel: str, model: Dict, R: int, S: int) -> Tuple[float,
                                                                   float]:
    """(operations, bytes) of one call of a kernel over R rays of S
    samples."""
    P = R * S
    ps, rays = 4 * P, 32 * R
    np_ = n_params(model)
    w_full = 2 * np_
    if kernel == "sigma_render":
        trunk = 2 * sum(k * n + n for k, n, _ in mlp_layers(model, False))
        return (P * flops_per_point(model, full=False),
                rays + ps + trunk + ps + 4 * R)
    if kernel == "render_eval":
        return (P * flops_per_point(model), rays + ps + w_full + 20 * R)
    if kernel == "mse_render":
        # in: rays, z, noise, gt, weights; out: out8, weights, gradients
        return (P * flops_per_point(model, train=True),
                rays + 2 * ps + 12 * R + w_full + 32 * R + ps + 4 * np_)
    raise ValueError(f"no work count for kernel {kernel!r}")


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the HBM rate."""
    return max(ops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def train_step_work(cfg: Dict, rays: int) -> Dict:
    """A training step over `rays` rays: the operations of its MLP work
    and the mse_render calls (R, S) it makes (coarse, then fine)."""
    r = cfg["render"]
    S_c, S_f = r["N_samples"], r["N_samples"] + r["N_importance"]
    calls = [(rays, S_c)] + ([(rays, S_f)] if r["N_importance"] else [])
    ops = sum(R * S * flops_per_point(cfg["model"], train=True)
              for R, S in calls)
    return {"ops": ops, "mse_render": calls}


def frame_work(cfg: Dict, rays: int) -> Dict:
    """A test-time frame of `rays` rays: the operations of the coarse
    sigma pass and the fine pass, and the render calls' (R, S)."""
    ev = cfg["eval"]
    S_c, S_f = ev["N_samples"], ev["N_samples"] + ev["N_importance"]
    m = cfg["model"]
    ops = rays * (S_c * flops_per_point(m, full=False)
                  + S_f * flops_per_point(m))
    return {"ops": ops, "sigma_render": [(rays, S_c)],
            "render_eval": [(rays, S_f)]}
