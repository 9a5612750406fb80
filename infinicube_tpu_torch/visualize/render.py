"""Offscreen scene rendering for the viewers; counterpart of
``infinicube_tpu/visualize/render.py``.

The reference's viewers are viser apps; the console tools render offscreen
instead: voxel points by painter's algorithm through the camera core
(``camera/projection.draw_points``), Gaussian scenes through the port's
rasterizer (``ops/gsplat.render_gaussians``), on the card unless the caller
asks for the CPU. The interactive paths are gated behind ``import viser``
(``HAS_VISER``)."""

from __future__ import annotations

import numpy as np
import torch

from infinicube_tpu_torch.camera.pinhole import PinholeCamera
from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.utils.interpolate import rot_to_quat
from infinicube_tpu_torch.utils.semantic import semantic_to_color

HAS_VISER = False
try:  # pragma: no cover - optional dependency
    import viser  # noqa: F401
    HAS_VISER = True
except ImportError:
    pass

DEFAULT_CAMERA = PinholeCamera(fx=300.0, fy=300.0, cx=320, cy=240, w=640,
                               h=480)


def orbit_poses(center: np.ndarray, radius: float, height: float,
                n: int = 8) -> np.ndarray:
    """n OpenCV camera-to-world poses orbiting ``center`` looking inward."""
    out = []
    for a in np.linspace(0, 2 * np.pi, n, endpoint=False):
        eye = center + np.array([radius * np.cos(a), radius * np.sin(a),
                                 height])
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        T = np.eye(4)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
        out.append(T)
    return np.asarray(out)


def _to_uint8(img: torch.Tensor) -> np.ndarray:
    return (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def render_voxel_points(ijk: np.ndarray, semantics: np.ndarray, voxel_size,
                        origin, pose: np.ndarray,
                        camera: PinholeCamera | None = None,
                        device="cuda") -> np.ndarray:
    """uint8 [H, W, 3] painter's-algorithm render of voxel centres coloured
    by their semantics."""
    from infinicube_tpu_torch.camera.projection import draw_points
    dev = resolve_device(device)
    camera = camera or DEFAULT_CAMERA
    pts = np.asarray(ijk, np.float64) * np.asarray(voxel_size) + \
        np.asarray(origin)
    colors = semantic_to_color(np.asarray(semantics))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    img = draw_points(t(colors), t(pts),
                      torch.ones(len(pts), dtype=torch.bool, device=dev),
                      t(pose), camera.intrinsics_matrix(dev),
                      (camera.h, camera.w), background=1.0)
    return _to_uint8(img)


def render_gaussian_scene(gdict: dict, pose: np.ndarray,
                          camera: PinholeCamera | None = None,
                          background=(1.0, 1.0, 1.0),
                          device="cuda") -> np.ndarray:
    """uint8 [H, W, 3] render of a gaussian dict (``means``, ``quats``,
    ``scales``, ``opacities``, ``colors``) seen from the camera-to-world
    ``pose``."""
    from infinicube_tpu_torch.camera.conventions import invert_pose
    from infinicube_tpu_torch.ops.gsplat import render_gaussians
    dev = resolve_device(device)
    camera = camera or DEFAULT_CAMERA

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    with torch.no_grad():
        color, _, _ = render_gaussians(
            t(gdict["means"]), t(gdict["quats"]), t(gdict["scales"]),
            t(gdict["opacities"]), t(gdict["colors"]), invert_pose(t(pose)),
            camera.intrinsics_matrix(dev), (camera.h, camera.w),
            background=t(background))
    return _to_uint8(color)


def transform_gaussians(gdict: dict, transform: np.ndarray) -> dict:
    """Rigidly move a gaussian set (vis-dynamic's per-timestep object
    transforms): means by the transform, quaternions (wxyz) by its
    rotation."""
    out = dict(gdict)
    R = np.asarray(transform)[:3, :3]
    out["means"] = gdict["means"] @ R.T + transform[:3, 3]
    qr = rot_to_quat(R)

    def qmul(q1, q2):
        w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
        w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
        return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                         w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                         w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                         w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)

    out["quats"] = qmul(np.broadcast_to(qr, gdict["quats"].shape),
                        gdict["quats"])
    return out
