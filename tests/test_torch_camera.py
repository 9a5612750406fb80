"""Port parity: the camera conventions, the pinhole model and the projection
ops of ``infinicube_tpu_torch.camera`` against ``infinicube_tpu.camera`` on
the same poses, points and depths (f32, atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.camera import conventions as jconv
from infinicube_tpu.camera import projection as jproj
from infinicube_tpu.camera.pinhole import PinholeCamera as JaxCamera
from infinicube_tpu_torch.camera import conventions as tconv
from infinicube_tpu_torch.camera import projection as tproj
from infinicube_tpu_torch.camera.pinhole import PinholeCamera
from infinicube_tpu_torch.utils.interpolate import quat_to_rot

TOL = dict(atol=1e-5, rtol=1e-5)
CAM = dict(fx=61.5, fy=58.25, cx=31.7, cy=22.1, w=64, h=48)


def _poses(seed, n):
    """n random rigid camera-to-world poses, f32 [n, 4, 4]."""
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        q = rng.standard_normal(4)
        out[i, :3, :3] = quat_to_rot(q / np.linalg.norm(q))
        out[i, :3, 3] = rng.uniform(-5, 5, 3)
    return out


def _close(got, ref, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), **(tol or TOL))


def test_conventions_on_numpy_and_torch():
    poses = _poses(0, 5)
    pts = np.random.default_rng(1).standard_normal((5, 7, 3)).astype(
        np.float32)
    for fn in ("opencv_to_flu", "flu_to_opencv", "invert_pose"):
        ref = getattr(jconv, fn)(jnp.asarray(poses))
        _close(getattr(tconv, fn)(poses), ref)
        got = getattr(tconv, fn)(torch.from_numpy(poses))
        assert isinstance(got, torch.Tensor)
        _close(got, ref)
    _close(tconv.flu_to_opencv(tconv.opencv_to_flu(poses)), poses)
    ref = jconv.transform_points(jnp.asarray(pts), jnp.asarray(poses))
    _close(tconv.transform_points(torch.from_numpy(pts),
                                  torch.from_numpy(poses)), ref)
    _close(tconv.transform_points(pts, poses), ref)


def test_pinhole_rays_pixels_and_depths():
    jc, tc = JaxCamera(**CAM), PinholeCamera(**CAM)
    _close(tc.intrinsics_matrix(), jc.intrinsics_matrix())
    _close(tc.get_rays(), jc.get_rays())
    poses = _poses(2, 3)
    for got, ref in zip(tc.get_rays_posed(torch.from_numpy(poses)),
                        jc.get_rays_posed(jnp.asarray(poses))):
        _close(got, ref)
    pix = np.random.default_rng(3).uniform(0, 60, (10, 2)).astype(np.float32)
    rays = jc.pixel2ray(jnp.asarray(pix))
    _close(tc.pixel2ray(torch.from_numpy(pix)), rays)
    _close(tc.ray2pixel(torch.from_numpy(np.asarray(rays))),
           jc.ray2pixel(rays), atol=1e-4, rtol=1e-5)
    dist = np.random.default_rng(4).uniform(1, 50, (48, 64)).astype(
        np.float32)
    _close(tc.distance_to_zdepth(torch.from_numpy(dist)),
           jc.distance_to_zdepth(jnp.asarray(dist)), atol=1e-4, rtol=1e-5)
    _close(tc.zdepth_to_distance(torch.from_numpy(dist)),
           jc.zdepth_to_distance(jnp.asarray(dist)), atol=1e-4, rtol=1e-5)
    for scale in (0.5, None):
        kw = dict(w=100, h=40) if scale is None else {}
        assert tc.rescale(scale, **kw) == PinholeCamera(
            **vars(jc.rescale(scale, **kw)))


def test_projection_and_unprojection():
    rng = np.random.default_rng(5)
    jc = JaxCamera(**CAM)
    K = np.asarray(jc.intrinsics_matrix())
    pose = _poses(6, 1)[0]
    # points in front of and behind the camera
    pts_cam = np.stack([rng.uniform(-8, 8, 500), rng.uniform(-6, 6, 500),
                        rng.uniform(-5, 30, 500)], -1).astype(np.float32)
    pts = (pts_cam @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
    ref = jproj.project_points(jnp.asarray(pts), jnp.asarray(pose),
                               jnp.asarray(K), (48, 64))
    got = tproj.project_points(torch.from_numpy(pts), torch.from_numpy(pose),
                               torch.from_numpy(K), (48, 64))
    _close(got[0], ref[0], atol=1e-4, rtol=1e-5)
    _close(got[1], ref[1])
    assert (got[2].numpy() == np.asarray(ref[2])).mean() >= 0.998
    mask = rng.random(500) < 0.8
    for fn in ("zdepth_map_from_points",):
        _close(getattr(tproj, fn)(torch.from_numpy(pts),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(pose),
                                  torch.from_numpy(K), (48, 64)),
               getattr(jproj, fn)(jnp.asarray(pts), jnp.asarray(mask),
                                  jnp.asarray(pose), jnp.asarray(K),
                                  (48, 64)))
    vals = rng.standard_normal((500, 2)).astype(np.float32)
    _close(tproj.draw_points(torch.from_numpy(vals), torch.from_numpy(pts),
                             torch.from_numpy(mask), torch.from_numpy(pose),
                             torch.from_numpy(K), (48, 64)),
           jproj.draw_points(jnp.asarray(vals), jnp.asarray(pts),
                             jnp.asarray(mask), jnp.asarray(pose),
                             jnp.asarray(K), (48, 64)))
    for normalize in (True, False):
        _close(tproj.rays_from_intrinsics(torch.from_numpy(K), (48, 64),
                                          normalize),
               jproj.rays_from_intrinsics(jnp.asarray(K), (48, 64),
                                          normalize))
        for got, ref in zip(
                tproj.posed_rays_from_intrinsics(
                    torch.from_numpy(K), torch.from_numpy(pose), (48, 64),
                    normalize),
                jproj.posed_rays_from_intrinsics(
                    jnp.asarray(K), jnp.asarray(pose), (48, 64), normalize)):
            _close(got, ref)
    depth = rng.uniform(1, 40, (48, 64)).astype(np.float32)
    _close(tproj.unproject_depth(torch.from_numpy(depth), torch.from_numpy(K),
                                 torch.from_numpy(pose)),
           jproj.unproject_depth(jnp.asarray(depth), jnp.asarray(K),
                                 jnp.asarray(pose)), atol=1e-4, rtol=1e-5)
    line = rng.standard_normal((4, 3)).astype(np.float32)
    _close(tproj.polyline_to_points(torch.from_numpy(line), 9),
           jproj.polyline_to_points(jnp.asarray(line), 9))


@pytest.mark.parametrize("scale", [0.5, 0.25])
def test_rescale_keeps_rays_through_the_same_scene(scale):
    """A rescaled camera is the reference's: the same intrinsics."""
    jc, tc = JaxCamera(**CAM).rescale(scale), PinholeCamera(**CAM).rescale(
        scale)
    _close(tc.intrinsics_matrix(), jc.intrinsics_matrix())
    assert (tc.w, tc.h) == (jc.w, jc.h)
