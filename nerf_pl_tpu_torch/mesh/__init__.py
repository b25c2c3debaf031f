"""Mesh extraction: the native marching-cubes and clustering library, PLY
and COLLADA I/O, and the pipeline of `extract_color_mesh` (`extract`).

The port's counterpart of nerf_pl_tpu/mesh, with the same exports.
"""
from .dae import read_dae, write_dae
from .native import cluster_triangles, marching_cubes
from .ply import write_ply

__all__ = ["marching_cubes", "cluster_triangles", "write_ply",
           "write_dae", "read_dae"]
