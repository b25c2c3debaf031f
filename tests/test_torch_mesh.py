"""The port's mesh modules (nerf_pl_tpu_torch.mesh) against the JAX
package's, on the same inputs:

  * the native library, built by g++ from the port's copy of the source:
    marching_cubes, cluster_triangles and keep_largest_cluster give arrays
    identical to nerf_pl_tpu.mesh's on tests/test_mesh.py's fields;
  * every case of tests/test_mesh.py, re-run with the port's copies in
    place of the JAX package's;
  * write_ply, write_dae and export_vol write byte-identical files;
  * query_grid (sigma, and rgb + sigma) and occlusion_opacity on the same
    weights in f32: within rtol 1e-5 / atol 1e-4 (sigma) and atol 1e-4
    (opacity; the two sum the quadrature's cumprod in other orders);
  * fuse_colors_by_projection on the port's 20x20 sphere scene: uint8
    colours within 1 of the JAX package's on every vertex.
The weights are the JAX package's init with the sigma head scaled so that
the field changes sign inside the grid (a threshold and an occlusion test
then have something to decide).
"""
import inspect

import jax
import numpy as np
import pytest
import torch

import test_mesh
from nerf_pl_tpu import mesh as jmesh
from nerf_pl_tpu.datasets import dataset_dict as jdatasets
from nerf_pl_tpu.mesh import extract as jext
from nerf_pl_tpu.mesh import native as jnative
from nerf_pl_tpu.models import init_nerf_params as jinit
from nerf_pl_tpu_torch import mesh as tmesh
from nerf_pl_tpu_torch.datasets import dataset_dict as tdatasets
from nerf_pl_tpu_torch.mesh import extract as text
from nerf_pl_tpu_torch.mesh import native as tnative
from nerf_pl_tpu_torch.mesh.ply import read_ply
from nerf_pl_tpu_torch.models import params_from_numpy
from nerf_pl_tpu_torch.utils.synthetic import make_blender_scene


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sphere(n):
    return test_mesh.sphere_field(n)[0]


def _two_blobs():
    g = np.linspace(-1.5, 1.5, 32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    f1 = 0.5 - np.sqrt((X + 0.8) ** 2 + Y ** 2 + Z ** 2)
    f2 = 0.3 - np.sqrt((X - 0.9) ** 2 + Y ** 2 + Z ** 2)
    return np.maximum(f1, f2)


FIELDS = {"sphere16": (lambda: _sphere(16), 0.0),
          "sphere24": (lambda: _sphere(24), 0.0),
          "sphere32": (lambda: _sphere(32), 0.0),
          "sphere48": (lambda: _sphere(48), 0.0),
          "two_blobs": (_two_blobs, 0.0),
          "empty": (lambda: np.zeros((8, 8, 8), np.float32), 1.0)}


@pytest.mark.parametrize("field", list(FIELDS))
def test_native_library_matches_jax(field):
    make, iso = FIELDS[field]
    f = make()
    v, t = tnative.marching_cubes(f, iso)
    jv, jt = jnative.marching_cubes(f, iso)
    assert v.dtype == jv.dtype and t.dtype == jt.dtype
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)
    idx, counts = tnative.cluster_triangles(t, len(v))
    jidx, jcounts = jnative.cluster_triangles(jt, len(jv))
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(counts, jcounts)
    for a, b in zip(tnative.keep_largest_cluster(v, t),
                    jnative.keep_largest_cluster(jv, jt)):
        np.testing.assert_array_equal(a, b)


def test_library_is_built_from_the_ports_copy():
    """The port's library sits under build/torch_mesh/, named by a hash of
    its own source, which is the JAX package's byte for byte."""
    path = tnative.build()
    assert path == tnative.library_path() and path.is_file()
    assert path.parent.name == "torch_mesh"
    assert path.parent.parent.name == "build"
    with open(jnative._CPP_PATH, "rb") as f:
        assert tnative.CPP_PATH.read_bytes() == f.read()


# Every case of tests/test_mesh.py, with the port's functions in place of
# the JAX package's in the names the cases look up.
PORT_NAMES = {
    "marching_cubes": tnative.marching_cubes,
    "cluster_triangles": tnative.cluster_triangles,
    "keep_largest_cluster": tnative.keep_largest_cluster,
    "write_ply": tmesh.write_ply,
    "read_ply": read_ply,
    "bilinear_sample": text.bilinear_sample,
    "compute_vertex_normals": text.compute_vertex_normals,
    "export_vol": text.export_vol,
    "grid_to_world": text.grid_to_world,
    "make_grid": text.make_grid,
}
MESH_CASES = [f"{name}::{m}" for name, cls in vars(test_mesh).items()
              if name.startswith("Test") for m in vars(cls)
              if m.startswith("test_")]


def test_every_mesh_case_is_rerun():
    assert len(MESH_CASES) == 16
    for name in PORT_NAMES:
        assert hasattr(test_mesh, name), name


@pytest.mark.parametrize("case", MESH_CASES)
def test_jax_mesh_case_on_port(case, monkeypatch, tmp_path, rng):
    cls_name, method = case.split("::")
    for name, fn in PORT_NAMES.items():
        monkeypatch.setattr(test_mesh, name, fn)
    # TestDae imports these from the package inside its cases
    monkeypatch.setattr(jmesh, "read_dae", tmesh.read_dae)
    monkeypatch.setattr(jmesh, "write_dae", tmesh.write_dae)
    fn = getattr(getattr(test_mesh, cls_name)(), method)
    fixtures = {"tmp_path": tmp_path, "rng": rng}
    fn(**{k: fixtures[k] for k in inspect.signature(fn).parameters})


def _mesh_inputs(rng, colors):
    v = rng.random((37, 3)).astype(np.float32) * 4 - 2
    t = rng.integers(0, 37, (53, 3)).astype(np.int32)
    c = rng.integers(0, 256, (37, 3)).astype(np.uint8) if colors else None
    return v, t, c


WRITERS = {"ply_colored": ("ply", True), "ply_plain": ("ply", False),
           "dae_colored": ("dae", True), "dae_plain": ("dae", False)}


@pytest.mark.parametrize("case", list(WRITERS))
def test_writers_are_byte_identical(case, tmp_path, rng):
    fmt, colors = WRITERS[case]
    v, t, c = _mesh_inputs(rng, colors)
    ours, ref = tmp_path / f"t.{fmt}", tmp_path / f"j.{fmt}"
    getattr(tmesh, f"write_{fmt}")(str(ours), v, t, c)
    getattr(jmesh, f"write_{fmt}")(str(ref), v, t, c)
    assert ours.read_bytes() == ref.read_bytes()


def test_export_vol_is_byte_identical(tmp_path, rng):
    rgbsigma = np.concatenate([rng.random((512, 3)),
                               rng.normal(0, 20, (512, 1))],
                              1).astype(np.float32)
    text.export_vol(str(tmp_path / "t.vol"), rgbsigma, 8, (-1.3, 1.3))
    jext.export_vol(str(tmp_path / "j.vol"), rgbsigma, 8, (-1.3, 1.3))
    ours = (tmp_path / "t.vol").read_bytes()
    assert len(ours) > 0 and ours == (tmp_path / "j.vol").read_bytes()


@pytest.fixture(scope="module")
def weights():
    """The JAX package's init, the sigma head x300 and -1: raw sigma
    changes sign inside [-1.2, 1.2]^3. (numpy for JAX, tensors for the
    port)."""
    p = jinit(jax.random.PRNGKey(3))
    p = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
         for k, v in p.items()}
    p["sigma"]["w"] = p["sigma"]["w"] * 300
    p["sigma"]["b"] = p["sigma"]["b"] - 1.0
    return p, params_from_numpy(p)


@pytest.mark.parametrize("with_rgb", [False, True])
def test_query_grid_matches_jax(weights, with_rgb):
    jp, tp = weights
    xyz = text.make_grid(16, (-1.2, 1.2), (-1.2, 1.2), (-1.2, 1.2))
    # chunk 1000: three whole chunks and a ragged fifth of 96 points
    ours = text.query_grid(tp, xyz, chunk=1000, with_rgb=with_rgb)
    ref = jext.query_grid(jp, xyz, chunk=1000, with_rgb=with_rgb)
    assert ours.shape == ref.shape == ((4096, 4) if with_rgb else (4096,))
    assert ours.dtype == np.float32
    sigma = ref[:, 3] if with_rgb else ref
    assert sigma.min() < 0 < sigma.max()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        text.sigma_grid(tp, 16, (-1.2, 1.2), (-1.2, 1.2), (-1.2, 1.2),
                        chunk=1000),
        jext.sigma_grid(jp, 16, (-1.2, 1.2), (-1.2, 1.2), (-1.2, 1.2),
                        chunk=1000), rtol=1e-5, atol=1e-4)


def test_occlusion_opacity_matches_jax(weights):
    """Camera->vertex rays from radius 4 through the field: far < near
    (a vertex nearer than bounds.min(), as fuse_colors_by_projection can
    make), far before the field's far side, and far past it."""
    jp, tp = weights
    rng = np.random.default_rng(0)
    R = 96
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    far = np.tile([1.0, 1.9, 3.0, 4.0, 5.5, 6.0], R // 6)[:, None]
    rays = np.concatenate([-4 * d, d, np.full((R, 1), 2.0), far],
                          1).astype(np.float32)
    ours = text.occlusion_opacity(tp, rays, 8, 40)
    ref = jext.occlusion_opacity(jp, rays, 8, 40)
    assert ours.shape == ref.shape == (R,)
    ours, ref = np.nan_to_num(ours, nan=1.0), np.nan_to_num(ref, nan=1.0)
    assert ref.min() < 0.9      # some rays pass the field's empty parts
    np.testing.assert_allclose(ours, ref, atol=1e-4)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_blender_scene(str(tmp_path_factory.mktemp("scene")),
                              n_train=3, n_val=1, n_test=1, wh=(20, 20))


def test_fuse_colors_matches_jax(weights, scene):
    jp, tp = weights
    v, t = tnative.marching_cubes(_sphere(16), 0.0)
    verts = (v / 15 * 3.0 - 1.5).astype(np.float32)   # the unit sphere
    kw = dict(root_dir=scene, img_wh=(20, 20), split="train")
    ours = text.fuse_colors_by_projection(tp, verts, tdatasets["blender"](
        **kw), (20, 20), 8, 512, 0.2, progress=False)
    ref = jext.fuse_colors_by_projection(jp, verts, jdatasets["blender"](
        **kw), (20, 20), 8, 512, 0.2, progress=False)
    assert ours.dtype == np.uint8 and ours.shape == (len(verts), 3)
    assert len(np.unique(ref, axis=0)) > 10
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
