"""The port's camera helpers against the numpy originals they stand in for
(nerf_pl_tpu/datasets/ray_utils.py, nerf_pl_tpu/utils/synthetic.py)."""
import numpy as np
import pytest
import torch

from nerf_pl_tpu.datasets.ray_utils import get_ray_directions as np_dirs
from nerf_pl_tpu.datasets.ray_utils import get_rays as np_rays
from nerf_pl_tpu.utils.synthetic import look_at_pose
from nerf_pl_tpu_torch.datasets.rays import (frame_rays, get_ray_directions,
                                             get_rays, sphere_pose)


@pytest.mark.parametrize("theta,phi,radius", [(0.3, 0.6, 4.0),
                                              (2.5, -0.2, 3.0)])
def test_sphere_pose_matches_look_at(theta, phi, radius):
    pos = radius * np.array([np.cos(theta) * np.cos(phi),
                             np.sin(theta) * np.cos(phi), np.sin(phi)])
    np.testing.assert_allclose(sphere_pose(theta, phi, radius).numpy(),
                               look_at_pose(pos), atol=1e-12)


@pytest.mark.parametrize("H,W,focal", [(5, 7, 6.5), (12, 12, 30.0)])
def test_rays_match_numpy(H, W, focal):
    d_t = get_ray_directions(H, W, focal)
    np.testing.assert_array_equal(d_t.numpy(), np_dirs(H, W, focal))
    c2w = look_at_pose([1.0, -3.0, 2.0]).astype(np.float32)
    o_t, dd_t = get_rays(d_t, torch.from_numpy(c2w))
    o_n, dd_n = np_rays(np_dirs(H, W, focal), c2w)
    np.testing.assert_allclose(o_t.numpy(), o_n, atol=1e-6)
    np.testing.assert_allclose(dd_t.numpy(), dd_n, atol=1e-6)
    rays = frame_rays(torch.from_numpy(c2w), H, W, focal, 2.0, 6.0)
    assert rays.shape == (H * W, 8)
    assert torch.all(rays[:, 6] == 2.0) and torch.all(rays[:, 7] == 6.0)
