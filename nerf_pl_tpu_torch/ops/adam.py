"""Adam's update of every leaf of a training step in one launch.

`adam_step` runs `csrc/adam.cu` on CUDA float32 leaves: it reads each
parameter's p, g, mu and nu once and writes p, mu and nu once, with the
arithmetic of `training/optimizers.py`'s foreach chain rounded operation
by operation, so the two give the same bits. The chain stays the plain
PyTorch version: `optimizers.py` sends every other case there (CPU
tensors, bf16 master weights, sgd, radam and ranger). There is no path
from the kernel to the chain; a launch that fails raises.

The leaves go to the kernel as one table passed by value, `MAX_LEAVES` at
most (the two MLPs have 48); a longer list raises. A gradient may be a
strided view whose rows are `g_stride` floats apart (`unpack_grads` gives
`gws[:, :1]` and `gwr[:, :3]`): the kernel reads it where it lies; params
and moments are contiguous. With `inplace` the kernel writes the new
values into p, mu and nu themselves (the step graph's static buffers);
otherwise into new tensors. With `clip_scale` (a float32 device scalar,
the global-norm clip's factor) the kernel multiplies every gradient by it
first; without it the table's pointer is null and nothing more is read.
Each launch adds one to `adam_launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

# Launches of the kernel (a plain int; set it to 0 to start a count).
adam_launches = 0

MAX_LEAVES = 56       # the table's capacity: it stays under 4 KB
BLOCK_ELEMS = 1024    # elements a block updates (csrc/adam.cu)
_MAX_ELEMS = 2 ** 31 - 1   # the kernel indexes a leaf with an int

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _Leaf(ctypes.Structure):
    """csrc/adam.cu's Leaf."""
    _fields_ = [("p", _P), ("g", _P), ("mu", _P), ("nu", _P),
                ("p_out", _P), ("mu_out", _P), ("nu_out", _P),
                ("rows", _I), ("cols", _I), ("g_stride", _I),
                ("first_block", _I)]


class _Table(ctypes.Structure):
    """csrc/adam.cu's Table."""
    _fields_ = [("count", _P), ("lr", _P), ("clip_scale", _P), ("b1", _F),
                ("b2", _F), ("one_minus_b1", _F), ("one_minus_b2", _F),
                ("eps", _F), ("weight_decay", _F), ("decay", _I),
                ("n_leaves", _I), ("leaves", _Leaf * MAX_LEAVES)]


class LeafLayout(NamedTuple):
    """Where a leaf's elements are: element e of p, mu and nu (row
    e // cols, column e % cols) has its gradient at row * g_stride + column,
    and the leaf's blocks start at first_block."""
    rows: int
    cols: int
    g_stride: int
    first_block: int


def blocks_of(n: int) -> int:
    """Blocks of BLOCK_ELEMS that n elements take."""
    return -(-n // BLOCK_ELEMS)


def _rows_cols(t: torch.Tensor) -> Tuple[int, int]:
    """A leaf as rows of its last dimension."""
    cols = max(t.shape[-1], 1) if t.dim() else 1
    return t.numel() // cols, cols


def _g_stride(g: torch.Tensor) -> Optional[int]:
    """The row stride the kernel reads g with, or None where it cannot."""
    cols = _rows_cols(g)[1]
    if g.is_contiguous():
        return cols
    if g.dim() == 2 and g.stride(1) == 1 and g.stride(0) >= cols:
        return g.stride(0)
    return None


def leaf_layout(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor]
                ) -> Tuple[List[LeafLayout], int]:
    """Each leaf's rows, columns, gradient row stride and first block, and
    the launch's blocks. Raises on a list longer than the table holds, a
    gradient shaped unlike its parameter, or a gradient the kernel cannot
    read where it lies."""
    if len(params) != len(grads):
        raise ValueError(f"{len(params)} params but {len(grads)} grads")
    if not 0 < len(params) <= MAX_LEAVES:
        raise ValueError(f"the adam kernel's table holds 1 to {MAX_LEAVES} "
                         f"leaves; got {len(params)}")
    out, first = [], 0
    for i, (p, g) in enumerate(zip(params, grads)):
        if g.shape != p.shape:
            raise ValueError(f"leaf {i}: grad {tuple(g.shape)} for param "
                             f"{tuple(p.shape)}")
        if p.numel() > _MAX_ELEMS:
            raise ValueError(f"leaf {i}: {p.numel()} elements, above "
                             f"{_MAX_ELEMS}")
        stride = _g_stride(g)
        if stride is None:
            raise ValueError(f"leaf {i}: grad strides {g.stride()} are not "
                             "rows of its last dimension")
        rows, cols = _rows_cols(p)
        out.append(LeafLayout(rows, cols, stride, first))
        first += blocks_of(p.numel())
    return out, first


def make_table(params, grads, mu, nu, outs, layout: Sequence[LeafLayout],
               count: torch.Tensor, lr: torch.Tensor, *,
               b1: float, b2: float, eps: float,
               weight_decay: float,
               clip_scale: Optional[torch.Tensor] = None) -> _Table:
    """The kernel's argument: the leaves' addresses and layout, and the
    scalars rounded to float as torch rounds a Python scalar (1 - b1 and
    1 - b2 are taken in double first, as the chain's Python arithmetic)."""
    t = _Table()
    t.count, t.lr = count.data_ptr(), lr.data_ptr()
    t.clip_scale = None if clip_scale is None else clip_scale.data_ptr()
    t.b1, t.b2 = float(np.float32(b1)), float(np.float32(b2))
    t.one_minus_b1 = float(np.float32(1 - b1))
    t.one_minus_b2 = float(np.float32(1 - b2))
    t.eps = float(np.float32(eps))
    t.decay = int(weight_decay > 0)
    t.weight_decay = float(np.float32(weight_decay)) if t.decay else 0.0
    t.n_leaves = len(layout)
    for leaf, s, p, g, m, v, (po, mo, vo) in zip(t.leaves, layout, params,
                                                  grads, mu, nu, outs):
        leaf.p, leaf.g, leaf.mu, leaf.nu = (p.data_ptr(), g.data_ptr(),
                                            m.data_ptr(), v.data_ptr())
        leaf.p_out, leaf.mu_out, leaf.nu_out = (po.data_ptr(), mo.data_ptr(),
                                                vo.data_ptr())
        leaf.rows, leaf.cols = s.rows, s.cols
        leaf.g_stride, leaf.first_block = s.g_stride, s.first_block
    return t


def takes_kernel(*leaves: torch.Tensor) -> bool:
    """Whether these leaves (params, grads, moments) go to the kernel:
    float32 tensors on one CUDA device."""
    dev = leaves[0].device
    return dev.type == "cuda" and all(
        t.device == dev and t.dtype == torch.float32 for t in leaves)


@functools.lru_cache(maxsize=None)
def _checked_library():
    """The kernels' library, its table layout checked against ours."""
    from ._build import load_library
    lib = load_library()
    if (lib.nerf_adam_table_bytes() != ctypes.sizeof(_Table)
            or lib.nerf_adam_block_elems() != BLOCK_ELEMS):
        raise RuntimeError(
            f"adam table mismatch: kernel {lib.nerf_adam_table_bytes()} "
            f"bytes, {lib.nerf_adam_block_elems()} elements a block; "
            f"wrapper {ctypes.sizeof(_Table)}, {BLOCK_ELEMS}")
    return lib


def adam_step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
              count: torch.Tensor, lr: torch.Tensor, *,
              b1: float, b2: float, eps: float, weight_decay: float = 0.0,
              inplace: bool = False,
              clip_scale: Optional[torch.Tensor] = None):
    """One Adam step of every leaf in one launch: (params, mu, nu) after
    it, as lists. `count` is Adam's int32 count already incremented (the
    t of b1^t), `lr` the learning rate as a float32 device scalar,
    `clip_scale` the gradients' factor (a float32 device scalar) or None.
    With `inplace` the new values are written into params, mu and nu,
    which are returned; otherwise into new tensors."""
    global adam_launches
    if not takes_kernel(*params, *grads, *mu, *nu):
        raise ValueError("the adam kernel takes float32 leaves on one CUDA "
                         "device")
    dev = params[0].device
    if count.dtype != torch.int32 or count.numel() != 1 or \
            count.device != dev:
        raise ValueError(f"count must be one int32 on {dev}")
    if not isinstance(lr, torch.Tensor) or lr.dtype != torch.float32 or \
            lr.numel() != 1 or lr.device != dev:
        raise ValueError(f"lr must be one float32 on {dev}")
    if clip_scale is not None and (
            clip_scale.dtype != torch.float32 or clip_scale.numel() != 1
            or clip_scale.device != dev):
        raise ValueError(f"clip_scale must be one float32 on {dev}")
    if not all(t.is_contiguous() for ts in (params, mu, nu) for t in ts):
        raise ValueError("the adam kernel takes contiguous params and "
                         "moments")
    layout, blocks = leaf_layout(params, grads)
    if inplace:
        outs = (params, mu, nu)
    else:
        outs = tuple([torch.empty_like(t) for t in ts]
                     for ts in (params, mu, nu))
    table = make_table(params, grads, mu, nu, list(zip(*outs)), layout,
                       count, lr, b1=b1, b2=b2, eps=eps,
                       weight_decay=weight_decay, clip_scale=clip_scale)
    lib = _checked_library()
    with torch.cuda.device(dev):
        err = lib.nerf_adam(ctypes.addressof(table), blocks,
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"adam kernel launch failed: CUDA error {err}")
    adam_launches += 1
    return outs
