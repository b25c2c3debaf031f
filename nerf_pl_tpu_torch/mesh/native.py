"""ctypes bindings for the native mesh library (csrc/marching_cubes.cpp).

The port's own copy of nerf_pl_tpu/mesh/native.py, with one change: the
shared library is built with the same g++ flags into `build/torch_mesh/`
at the repository root (gitignored), named by a hash of the source and the
flags, on first use. A build that fails raises; there is no Python
fallback. Exposes:
  marching_cubes(field, iso)     -> (vertices (V,3) f32, triangles (T,3) i32)
  cluster_triangles(tris, n_verts) -> (cluster_id per triangle, counts)
  keep_largest_cluster(vertices, triangles)

These are the equivalents of PyMCubes.marching_cubes and open3d's
cluster_connected_triangles used by the reference mesh pipeline
(extract_color_mesh.py:144,163-171).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_LOCK = threading.Lock()
_LIB = None

CPP_PATH = Path(__file__).resolve().parent / "csrc" / "marching_cubes.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_mesh"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(CPP_PATH.read_bytes())
    return BUILD_DIR / f"libnerfmesh_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the one for this source exists. The
    output is written under a temporary name and renamed, so processes
    that build at once each find a whole library."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                           str(CPP_PATH)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed with code {proc.returncode} "
                           f"building {CPP_PATH}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        lib.nerfmesh_marching_cubes.restype = ctypes.c_void_p
        lib.nerfmesh_marching_cubes.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float]
        lib.nerfmesh_num_vertices.restype = ctypes.c_int64
        lib.nerfmesh_num_vertices.argtypes = [ctypes.c_void_p]
        lib.nerfmesh_num_triangles.restype = ctypes.c_int64
        lib.nerfmesh_num_triangles.argtypes = [ctypes.c_void_p]
        lib.nerfmesh_copy.restype = None
        lib.nerfmesh_copy.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32)]
        lib.nerfmesh_free.restype = None
        lib.nerfmesh_free.argtypes = [ctypes.c_void_p]
        lib.nerfmesh_cluster_triangles.restype = ctypes.c_int32
        lib.nerfmesh_cluster_triangles.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]
        _LIB = lib
        return lib


def marching_cubes(field: np.ndarray, iso: float):
    """Extract the iso-surface of a 3D scalar field.

    Args:
      field: (nx, ny, nz) float array.
      iso: iso level (vertices where field crosses this value).

    Returns: (vertices (V, 3) float32 in grid-index units, triangles
    (T, 3) int32). Same coordinate convention as PyMCubes: vertex
    components are (i, j, k) indices into the field.
    """
    lib = _load()
    field = np.ascontiguousarray(field, dtype=np.float32)
    nx, ny, nz = field.shape
    h = lib.nerfmesh_marching_cubes(
        field.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, ny, nz, float(iso))
    try:
        nv = lib.nerfmesh_num_vertices(h)
        nt = lib.nerfmesh_num_triangles(h)
        verts = np.empty((nv, 3), dtype=np.float32)
        tris = np.empty((nt, 3), dtype=np.int32)
        if nv:
            lib.nerfmesh_copy(
                h, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return verts, tris
    finally:
        lib.nerfmesh_free(h)


def cluster_triangles(triangles: np.ndarray, n_vertices: int):
    """Connected components of triangles through shared vertices.

    Returns (cluster_idx (T,) int32, counts (n_clusters,) int64)."""
    lib = _load()
    tris = np.ascontiguousarray(triangles, dtype=np.int32)
    out = np.empty(len(tris), dtype=np.int32)
    n = lib.nerfmesh_cluster_triangles(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(tris), int(n_vertices),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    counts = np.bincount(out, minlength=n).astype(np.int64)
    return out, counts


def keep_largest_cluster(vertices: np.ndarray, triangles: np.ndarray):
    """Noise removal: drop all triangles outside the largest connected
    cluster, then drop unreferenced vertices (reference
    extract_color_mesh.py:163-171)."""
    if len(triangles) == 0:
        return vertices, triangles
    idxs, counts = cluster_triangles(triangles, len(vertices))
    keep = idxs == int(np.argmax(counts))
    tris = triangles[keep]
    used = np.unique(tris)
    remap = np.full(len(vertices), -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    return vertices[used], remap[tris].astype(np.int32)
