"""The backward of a bf16 ReLU layer and its bias gradient in one pass.

`relu_bgrad(grad, y)` gives (g, db) for a layer whose output was y =
relu(x @ w + b): g = grad where y > 0 and 0 where y <= 0 (torch's
threshold_backward(grad, y, 0), so a NaN in y passes grad, and g has its
bits), and db = g summed over rows, in float32. On CUDA tensors it is one
launch pair of `csrc/relu_bgrad.cu`, which reads grad and y once, writes g
once and keeps the column sums in registers on the way; on CPU tensors it
is `relu_bgrad_plain`. There is no path from the kernel to the plain
version: a launch that fails raises.

grad and y are bf16 [P, N]; y is contiguous. grad is read where it lies
when its columns are adjacent and its rows at least a row apart (a narrow
column view among them) and copied contiguous otherwise. g comes out
contiguous. Where N, the row stride and both addresses are multiples of 8
values (16 bytes) the kernel takes 16-byte words; otherwise it goes
element by element. Each launch pair adds one to `relu_bgrad_launches`.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

# Launch pairs of the kernel (a plain int; set it to 0 to start a count).
relu_bgrad_launches = 0

VEC = 8      # bf16 values in the kernel's 16-byte word


def _rows(grad: torch.Tensor) -> torch.Tensor:
    """grad as the kernel reads it: itself where its columns are adjacent
    and its rows at least a row apart, else a contiguous copy."""
    if grad.dim() == 2 and grad.stride(1) == 1 and \
            grad.stride(0) >= grad.shape[1]:
        return grad
    return grad.contiguous()


def fits_vector(grad: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether the width, grad's row stride and both addresses are whole
    16-byte words."""
    return (y.shape[1] % VEC == 0 and grad.stride(0) % VEC == 0
            and grad.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)


def _check(grad: torch.Tensor, y: torch.Tensor) -> None:
    if grad.dtype != torch.bfloat16 or y.dtype != torch.bfloat16:
        raise ValueError(f"relu_bgrad takes bf16 grad and y; got "
                         f"{grad.dtype} and {y.dtype}")
    if y.dim() != 2 or grad.shape != y.shape:
        raise ValueError(f"relu_bgrad takes grad and y of one [P, N] shape; "
                         f"got {tuple(grad.shape)} and {tuple(y.shape)}")
    if grad.device != y.device:
        raise ValueError(f"grad on {grad.device}, y on {y.device}")
    if not y.is_contiguous():
        raise ValueError("relu_bgrad takes a contiguous y")


def relu_bgrad_plain(grad: torch.Tensor, y: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: (g, db) by torch.where and a float32 column
    sum."""
    g = torch.where(y <= 0, 0, grad)
    return g, g.float().sum(0)


@functools.lru_cache(maxsize=None)
def _blocks(device_index: int, rows: int, cols: int, vec: int) -> int:
    """The kernel's blocks (its partial rows) for this launch's shape on
    this device."""
    from ._build import load_library
    n = load_library().nerf_relu_bgrad_blocks(rows, cols, vec)
    if n < 1:
        raise RuntimeError(f"relu_bgrad: no block count for {rows} x {cols} "
                           f"(vec {vec}): {n}")
    return n


def relu_bgrad(grad: torch.Tensor, y: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g bf16 [P, N] contiguous, db float32 [N]) of the ReLU layer whose
    output was y, under its output's gradient grad."""
    global relu_bgrad_launches
    grad = _rows(grad)
    _check(grad, y)
    dev = y.device
    if dev.type == "cpu":
        return relu_bgrad_plain(grad, y)
    if dev.type != "cuda":
        raise ValueError(f"relu_bgrad runs on CUDA or the CPU, not {dev}")
    rows, cols = y.shape
    g = torch.empty((rows, cols), dtype=torch.bfloat16, device=dev)
    if rows == 0 or cols == 0:
        return g, torch.zeros((cols,), dtype=torch.float32, device=dev)
    vec = VEC if fits_vector(grad, y) else 1
    from ._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        blocks = _blocks(torch.cuda.current_device(), rows, cols, vec)
        partial = torch.empty((blocks, cols), dtype=torch.float32,
                              device=dev)
        db = torch.empty((cols,), dtype=torch.float32, device=dev)
        err = lib.nerf_relu_bgrad(
            grad.data_ptr(), grad.stride(0), y.data_ptr(), g.data_ptr(),
            partial.data_ptr(), db.data_ptr(), rows, cols, vec, blocks,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"relu_bgrad kernel launch failed: CUDA error "
                           f"{err}")
    relu_bgrad_launches += 1
    return g, db
