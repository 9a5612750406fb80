"""The port's map and box drawings against the JAX package's: polylines
clipped at the image plane, depth-coded thick lines and filled convex
hulls over several frames, equal uint8 images."""

import numpy as np
import pytest
import torch

from infinicube_tpu.camera import draw as JD
from infinicube_tpu.camera.pinhole import PinholeCamera as JCam
from infinicube_tpu_torch.camera import draw as TD
from infinicube_tpu_torch.camera.pinhole import PinholeCamera as TCam

INTR = dict(fx=100.3, fy=99.7, cx=80.2, cy=60.1, w=160, h=120)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, :3, 3] = rng.uniform(-2, 2, (3, 3))
    # polylines ahead of, across and behind the image plane
    lines = [np.cumsum(rng.uniform(-3, 3, (6, 3)), 0) + [0, 0, z]
             for z in rng.uniform(-4, 12, 12)]
    hulls = [rng.uniform(-2, 2, (8, 3)) + [rng.uniform(-6, 6),
                                          rng.uniform(-4, 4),
                                          rng.uniform(-3, 25)]
             for _ in range(10)]
    return poses, lines, hulls


@pytest.mark.parametrize("kw", [dict(radius=8),
                                dict(radius=5, segment_interval=1.0,
                                     colors=[200, 100, 50])])
def test_line_depth_equals_jax(scene, kw):
    poses, lines, _ = scene
    want = JD.draw_line_depth(JCam(**INTR), poses, lines, **kw)
    got = TD.draw_line_depth(TCam(**INTR), poses, lines, **kw)
    assert got.dtype == np.uint8 and got.shape == (3, 120, 160, 3)
    assert (got > 0).mean() > 0.05
    np.testing.assert_array_equal(got, want)
    one = TD.draw_line_depth(TCam(**INTR), poses[0], lines, **kw)
    np.testing.assert_array_equal(one, want[0])


def test_hull_depth_equals_jax(scene):
    poses, _, hulls = scene
    want = JD.draw_hull_depth(JCam(**INTR), poses, hulls)
    got = TD.draw_hull_depth(TCam(**INTR), poses, hulls)
    assert got.dtype == np.uint8 and (got > 0).mean() > 0.05
    np.testing.assert_array_equal(got, want)


def test_clipping_and_hulls_equal_jax(scene):
    _, lines, hulls = scene
    for poly in lines:
        np.testing.assert_array_equal(TD.clip_polyline_to_image_plane(poly),
                                      JD.clip_polyline_to_image_plane(poly))
    for h in hulls:
        np.testing.assert_array_equal(TD.convex_hull_2d(h[:, :2]),
                                      JD.convex_hull_2d(h[:, :2]))
    assert TD.clip_polyline_to_image_plane(
        np.array([[0, 0, -1.0], [1, 0, -2.0]])).shape == (0, 3)
