"""Minimal COLLADA (.dae) triangle-mesh writer/reader.

Covers the reference's colorless `.dae` export (extract_mesh.ipynb cell 5,
`mcubes.export_mesh`) without the PyCollada dependency, and additionally
supports per-vertex colors so the colored-mesh pipeline can target .dae too.

The port's own copy of nerf_pl_tpu/mesh/dae.py, unchanged.
"""
from __future__ import annotations

import io
from typing import Optional
from xml.etree import ElementTree as ET

import numpy as np

_NS = "http://www.collada.org/2005/11/COLLADASchema"


def _floats(arr: np.ndarray) -> str:
    buf = io.StringIO()
    np.savetxt(buf, arr.reshape(1, -1), fmt="%g", newline="")
    return buf.getvalue().strip()


def _source(sid: str, data: np.ndarray, params) -> str:
    n = len(data)
    return (
        f'<source id="{sid}">'
        f'<float_array id="{sid}-array" count="{3 * n}">'
        f'{_floats(np.asarray(data, np.float32))}</float_array>'
        f'<technique_common>'
        f'<accessor source="#{sid}-array" count="{n}" stride="3">'
        + "".join(f'<param name="{p}" type="float"/>' for p in params)
        + '</accessor></technique_common></source>')


def write_dae(path: str, vertices: np.ndarray, triangles: np.ndarray,
              colors: Optional[np.ndarray] = None):
    """Write an indexed triangle mesh as COLLADA 1.4.1.

    Args:
      vertices: (V, 3) float.  triangles: (T, 3) int.
      colors: optional (V, 3) uint8 or [0,1] float per-vertex RGB.
    """
    vertices = np.asarray(vertices, np.float32)
    triangles = np.asarray(triangles, np.int64)
    V, T = len(vertices), len(triangles)

    parts = [_source("positions", vertices, ("X", "Y", "Z"))]
    tri_inputs = ('<input semantic="VERTEX" source="#vertices" offset="0"/>')
    if colors is not None:
        colors = np.asarray(colors)
        assert colors.shape == (V, 3)
        if colors.dtype == np.uint8:
            colors = colors.astype(np.float32) / 255.0
        parts.append(_source("colors", colors, ("R", "G", "B")))
        tri_inputs += ('<input semantic="COLOR" source="#colors" '
                       'offset="0"/>')

    idx = " ".join(map(str, triangles.ravel().tolist()))
    doc = (
        '<?xml version="1.0" encoding="utf-8"?>'
        f'<COLLADA xmlns="{_NS}" version="1.4.1">'
        '<asset><up_axis>Z_UP</up_axis></asset>'
        '<library_geometries><geometry id="mesh" name="mesh"><mesh>'
        + "".join(parts) +
        '<vertices id="vertices">'
        '<input semantic="POSITION" source="#positions"/></vertices>'
        f'<triangles count="{T}">{tri_inputs}<p>{idx}</p></triangles>'
        '</mesh></geometry></library_geometries>'
        '<library_visual_scenes><visual_scene id="Scene">'
        '<node id="node" name="node">'
        '<instance_geometry url="#mesh"/></node></visual_scene>'
        '</library_visual_scenes>'
        '<scene><instance_visual_scene url="#Scene"/></scene>'
        '</COLLADA>')
    with open(path, "w", encoding="utf-8") as f:
        f.write(doc)


def read_dae(path: str):
    """Read back a write_dae file (for tests / interchange checks).

    Returns (vertices (V,3) f32, triangles (T,3) i64, colors (V,3) f32|None).
    """
    root = ET.parse(path).getroot()
    ns = {"c": _NS}
    mesh = root.find(".//c:geometry/c:mesh", ns)
    arrays = {fa.get("id"): np.array(fa.text.split(), np.float64)
              for fa in mesh.findall(".//c:float_array", ns)}
    verts = arrays["positions-array"].reshape(-1, 3).astype(np.float32)
    colors = None
    if "colors-array" in arrays:
        colors = arrays["colors-array"].reshape(-1, 3).astype(np.float32)
    p = mesh.find(".//c:triangles/c:p", ns)
    tris = np.array(p.text.split(), np.int64).reshape(-1, 3)
    return verts, tris, colors
