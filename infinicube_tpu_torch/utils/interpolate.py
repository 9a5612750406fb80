"""SE(3) keyframe interpolation and trajectory helpers; the port's own copy
of ``infinicube_tpu/utils/interpolate.py`` (NumPy, host side): pairwise
slerp, Gaussian-smoothed multi-keyframe interpolation (``inter_poses``),
uniform two-pose interpolation, polyline densification, quaternion
averaging and the straight-ahead trajectory extrapolation of world
generation."""

from __future__ import annotations

import numpy as np


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 4) wxyz."""
    R = np.asarray(R, dtype=np.float64)
    w = np.sqrt(np.maximum(0, 1 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])) / 2
    x = np.sqrt(np.maximum(0, 1 + R[..., 0, 0] - R[..., 1, 1] - R[..., 2, 2])) / 2
    y = np.sqrt(np.maximum(0, 1 - R[..., 0, 0] + R[..., 1, 1] - R[..., 2, 2])) / 2
    z = np.sqrt(np.maximum(0, 1 - R[..., 0, 0] - R[..., 1, 1] + R[..., 2, 2])) / 2
    x = np.copysign(x, R[..., 2, 1] - R[..., 1, 2])
    y = np.copysign(y, R[..., 0, 2] - R[..., 2, 0])
    z = np.copysign(z, R[..., 1, 0] - R[..., 0, 1])
    q = np.stack([w, x, y, z], axis=-1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def slerp(q0: np.ndarray, q1: np.ndarray, t) -> np.ndarray:
    """Spherical interpolation, t scalar or (...,)."""
    t = np.asarray(t)[..., None]
    d = np.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = np.where(d < 0, -q1, q1)
    d = np.abs(d)
    theta = np.arccos(np.clip(d, -1, 1))
    sin_t = np.sin(theta)
    small = sin_t < 1e-6
    w0 = np.where(small, 1 - t, np.sin((1 - t) * theta) / np.maximum(sin_t, 1e-9))
    w1 = np.where(small, t, np.sin(t * theta) / np.maximum(sin_t, 1e-9))
    q = w0 * q0 + w1 * q1
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def interpolate_two_poses(T0: np.ndarray, T1: np.ndarray, n: int) -> np.ndarray:
    """Uniform interpolation between two 4x4 poses, inclusive of ends."""
    q0, q1 = rot_to_quat(T0[:3, :3]), rot_to_quat(T1[:3, :3])
    ts = np.linspace(0.0, 1.0, n)
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3] = quat_to_rot(slerp(q0, q1, ts))
    out[:, :3, 3] = (1 - ts)[:, None] * T0[:3, 3] + ts[:, None] * T1[:3, 3]
    return out


def inter_poses(key_poses: np.ndarray, n_out: int, smoothness: float = 1.0
                ) -> np.ndarray:
    """Interpolate a keyframe pose sequence [K, 4, 4] to n_out frames with
    optional Gaussian smoothing of the samples."""
    key_poses = np.asarray(key_poses)
    K = key_poses.shape[0]
    if K == 1:
        return np.tile(key_poses, (n_out, 1, 1))
    u = np.linspace(0, K - 1, n_out)
    i0 = np.clip(np.floor(u).astype(int), 0, K - 2)
    frac = u - i0
    quats = rot_to_quat(key_poses[:, :3, :3])
    out = np.tile(np.eye(4), (n_out, 1, 1))
    q = slerp(quats[i0], quats[i0 + 1], frac)
    out[:, :3, :3] = quat_to_rot(q)
    pos = (1 - frac)[:, None] * key_poses[i0, :3, 3] + \
        frac[:, None] * key_poses[i0 + 1, :3, 3]
    if smoothness > 0 and n_out > 5:
        from scipy.ndimage import gaussian_filter1d
        pos = gaussian_filter1d(pos, smoothness, axis=0, mode="nearest")
    out[:, :3, 3] = pos
    return out


def polyline_to_points(polyline: np.ndarray, spacing: float) -> np.ndarray:
    """Densify a 3D polyline [M, 3] at a fixed arc-length spacing."""
    pts = [polyline[0]]
    for a, b in zip(polyline[:-1], polyline[1:]):
        seg = np.linalg.norm(b - a)
        n = max(1, int(np.ceil(seg / spacing)))
        for i in range(1, n + 1):
            pts.append(a + (b - a) * i / n)
    return np.asarray(pts)


def average_quaternions(quats: np.ndarray) -> np.ndarray:
    """Eigen-based quaternion mean."""
    q = np.asarray(quats, dtype=np.float64)
    A = np.einsum("ni,nj->ij", q, q) / q.shape[0]
    vals, vecs = np.linalg.eigh(A)
    m = vecs[:, -1]
    if m[0] < 0:
        m = -m
    return m / np.linalg.norm(m)


def extrapolate_trajectory(poses: np.ndarray, n_extra: int,
                           step: float) -> np.ndarray:
    """Extend an ego trajectory along the last heading: translation
    continues along the last pose's forward (+x FLU) axis; rotation held
    fixed."""
    poses = np.asarray(poses)
    last = poses[-1]
    fwd = last[:3, 0]
    out = []
    for i in range(1, n_extra + 1):
        T = last.copy()
        T[:3, 3] = last[:3, 3] + fwd * step * i
        out.append(T)
    return np.concatenate([poses, np.asarray(out)], axis=0) if n_extra else poses
