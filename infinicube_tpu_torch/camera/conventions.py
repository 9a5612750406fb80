"""Coordinate-frame conventions; counterpart of
``infinicube_tpu/camera/conventions.py``.

Two frames are used throughout:

- **OpenCV / RDF**: x right, y down, z forward (camera frame).
- **FLU**: x forward, y left, z up (ego/world frame; Waymo vehicle frame).

A pose matrix ``T`` (4x4) maps camera-frame points to world:
``p_world = T[:3, :3] @ p_cam + T[:3, 3]``. Converting the *convention* of a
pose is a column permutation of its rotation block: FLU basis (f, l, u)
expressed via OpenCV basis (r, d, fwd): f = fwd, l = -r, u = -d.

Every function takes numpy arrays or torch tensors and returns the same
kind."""

from __future__ import annotations

import numpy as np
import torch


def _cat(parts, axis):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def _swap(m):
    return m.transpose(-1, -2) if isinstance(m, torch.Tensor) else \
        np.swapaxes(m, -1, -2)


def opencv_to_flu(pose):
    """Re-express a camera-to-world pose whose camera frame is OpenCV as one
    whose camera frame is FLU. pose (..., 4, 4)."""
    return _cat([pose[..., 2:3], -pose[..., 0:1], -pose[..., 1:2],
                 pose[..., 3:4]], -1)


def flu_to_opencv(pose):
    """Inverse of opencv_to_flu. pose (..., 4, 4)."""
    return _cat([-pose[..., 1:2], -pose[..., 2:3], pose[..., 0:1],
                 pose[..., 3:4]], -1)


def transform_points(points, tfm):
    """Apply a rigid transform. points (..., N, 3), tfm (..., 4, 4)."""
    return points @ _swap(tfm[..., :3, :3]) + tfm[..., None, :3, 3]


def invert_pose(tfm):
    """Invert a rigid 4x4 transform analytically."""
    r = _swap(tfm[..., :3, :3])
    t = -(r @ tfm[..., :3, 3:4])
    top = _cat([r, t], -1)
    if isinstance(tfm, torch.Tensor):
        bot = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=tfm.dtype,
                           device=tfm.device).expand(tfm[..., :1, :].shape)
    else:
        bot = np.broadcast_to(np.asarray([0.0, 0.0, 0.0, 1.0],
                                         dtype=tfm.dtype),
                              tfm[..., :1, :].shape)
    return _cat([top, bot], -2)
