"""Depth-map visualization (JET colormap) for TensorBoard logging.

The port's own copy of nerf_pl_tpu/utils/visualization.py, unchanged.

Parity: reference utils/visualization.py:6-18. cv2 is used when present;
otherwise a numpy JET approximation keeps the dependency optional.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def _jet_numpy(x_u8: np.ndarray) -> np.ndarray:
    """Approximate OpenCV COLORMAP_JET for a (H, W) uint8 array -> BGR u8."""
    x = x_u8.astype(np.float32) / 255.0
    # piecewise-linear jet
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([b, g, r], -1) * 255).astype(np.uint8)


def visualize_depth(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth -> (3, H, W) float RGB in [0,1], JET-colored.

    NaNs -> 0; min-max normalized like the reference."""
    x = np.nan_to_num(np.asarray(depth, dtype=np.float32))
    mi, ma = np.min(x), np.max(x)
    x = (x - mi) / (ma - mi + 1e-8)
    x_u8 = (255 * x).astype(np.uint8)
    if _HAS_CV2:
        bgr = cv2.applyColorMap(x_u8, cv2.COLORMAP_JET)
    else:
        bgr = _jet_numpy(x_u8)
    rgb = bgr[..., ::-1].astype(np.float32) / 255.0  # BGR -> RGB
    return np.transpose(rgb, (2, 0, 1))
