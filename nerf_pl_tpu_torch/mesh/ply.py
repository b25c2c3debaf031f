"""Binary little-endian PLY writer (replaces the plyfile dependency used at
reference extract_color_mesh.py:160-161, 296-297).

The port's own copy of nerf_pl_tpu/mesh/ply.py, unchanged."""
from __future__ import annotations

from typing import Optional

import numpy as np


def write_ply(path: str, vertices: np.ndarray, triangles: np.ndarray,
              colors: Optional[np.ndarray] = None):
    """Write an indexed triangle mesh as binary_little_endian PLY.

    Args:
      vertices: (V, 3) float.  triangles: (T, 3) int.
      colors: optional (V, 3) uint8 per-vertex RGB.
    """
    vertices = np.asarray(vertices, dtype="<f4")
    triangles = np.asarray(triangles, dtype="<i4")
    V, T = len(vertices), len(triangles)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors, dtype=np.uint8)
        assert colors.shape == (V, 3)

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {V}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {T}",
               "property list uchar int vertex_indices", "end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            rec = np.zeros(V, dtype=[("xyz", "<f4", (3,)),
                                     ("rgb", "u1", (3,))])
            rec["xyz"] = vertices
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(vertices.tobytes())
        face = np.zeros(T, dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        face["n"] = 3
        face["idx"] = triangles
        f.write(face.tobytes())


def read_ply(path: str):
    """Minimal reader for the files written by write_ply (for tests).

    Returns (vertices (V,3) f32, triangles (T,3) i32, colors (V,3) u8|None).
    """
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        V = int(next(h for h in header if h.startswith("element vertex"))
                .split()[-1])
        T = int(next(h for h in header if h.startswith("element face"))
                .split()[-1])
        has_color = any("uchar red" in h for h in header)
        if has_color:
            rec = np.frombuffer(f.read(V * (12 + 3)),
                                dtype=[("xyz", "<f4", (3,)),
                                       ("rgb", "u1", (3,))])
            verts, colors = rec["xyz"].copy(), rec["rgb"].copy()
        else:
            verts = np.frombuffer(f.read(V * 12), dtype="<f4").reshape(V, 3)
            colors = None
        face = np.frombuffer(f.read(T * 13),
                             dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        return verts, face["idx"].copy(), colors
