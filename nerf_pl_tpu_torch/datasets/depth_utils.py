"""PFM depth-map I/O (for depth export to Unity / MVS tooling).

The port's own copy of nerf_pl_tpu/datasets/depth_utils.py, unchanged.

Capability parity with reference datasets/depth_utils.py (read_pfm/save_pfm),
re-derived from the PFM specification: a PFM file is three whitespace-
terminated ASCII header tokens — magic ("Pf" grayscale / "PF" RGB), "<w> <h>",
and a nonzero scale whose SIGN encodes byte order (negative = little-endian)
— followed by rows of raw float32 samples stored bottom-to-top.
"""
from __future__ import annotations

import sys

import numpy as np

_MAGIC_CHANNELS = {b"Pf": 1, b"PF": 3}


def _read_header_line(f) -> bytes:
    """One header token line; PFM headers are newline-terminated ASCII."""
    line = f.readline()
    if not line:
        raise ValueError("Truncated PFM header.")
    return line.strip()


def read_pfm(filename: str):
    """Decode a PFM file.

    Returns (data, scale): `data` is float32 with shape (H, W) for grayscale
    or (H, W, 3) for color, already flipped to top-down row order; `scale`
    is the absolute value of the header scale factor.
    """
    with open(filename, "rb") as f:
        magic = _read_header_line(f)
        channels = _MAGIC_CHANNELS.get(magic)
        if channels is None:
            raise ValueError(f"Not a PFM file (magic {magic!r}).")

        dims = _read_header_line(f).split()
        if len(dims) != 2 or not all(t.isdigit() for t in dims):
            raise ValueError(f"Malformed PFM dimension line: {dims!r}")
        w, h = int(dims[0]), int(dims[1])

        scale = float(_read_header_line(f))
        if scale == 0:
            raise ValueError("PFM scale must be nonzero.")
        byte_order = "<" if scale < 0 else ">"

        n_values = w * h * channels
        raw = f.read(4 * n_values)
    if len(raw) != 4 * n_values:
        raise ValueError(
            f"PFM payload truncated: expected {4 * n_values} bytes, "
            f"got {len(raw)}.")
    data = np.frombuffer(raw, dtype=byte_order + "f4")
    data = data.reshape((h, w) if channels == 1 else (h, w, channels))
    return data[::-1].copy(), abs(scale)


def save_pfm(filename: str, image: np.ndarray, scale: float = 1):
    """Encode a float32 raster as PFM.

    Accepts (H, W), (H, W, 1) (both written grayscale) or (H, W, 3) arrays;
    writes in the machine's native byte order, encoded via the scale sign.
    """
    if image.dtype != np.float32:
        raise ValueError("Image dtype must be float32.")
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    if image.ndim == 2:
        magic = b"Pf"
    elif image.ndim == 3 and image.shape[2] == 3:
        magic = b"PF"
    else:
        raise ValueError("Image must be HxWx3, HxWx1 or HxW.")

    h, w = image.shape[:2]
    order = image.dtype.byteorder
    little = order == "<" or (order == "=" and sys.byteorder == "little")
    signed_scale = -abs(scale) if little else abs(scale)

    header = b"%s\n%d %d\n%f\n" % (magic, w, h, signed_scale)
    with open(filename, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(image[::-1]).tobytes())
