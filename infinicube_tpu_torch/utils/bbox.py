"""Oriented 3D bounding-box utilities; counterpart of
``infinicube_tpu/utils/bbox.py``: lwh + pose -> 8 corners, point-in-OBB
tests, instance-id stamping, the AABB crop and the exact oriented-box
overlap (the pytorch3d ``box3d_overlap`` replacement, numpy and scipy).
Functions take numpy arrays or torch tensors and return the same kind."""

from __future__ import annotations

import numpy as np
import torch

# corner order: all sign combinations of (±l/2, ±w/2, ±h/2) in row-major
_SIGNS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                   for sz in (-1, 1)], np.float32)


def _is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


def corners_from_lwh_pose(lwh, object_to_world):
    """lwh (..., 3), object_to_world (..., 4, 4) -> corners (..., 8, 3)
    world. The canonical box is axis-aligned, centered at the object
    origin."""
    if _is_torch(lwh):
        signs = torch.from_numpy(_SIGNS).to(lwh.device, lwh.dtype)
        swap = object_to_world[..., :3, :3].transpose(-1, -2)
    else:
        lwh = np.asarray(lwh)
        signs = _SIGNS
        swap = np.swapaxes(object_to_world[..., :3, :3], -1, -2)
    half = lwh[..., None, :] * 0.5 * signs                    # (..., 8, 3)
    t = object_to_world[..., :3, 3]
    return half @ swap + t[..., None, :]


def points_in_obb(points, object_to_world, lwh, enlarge: float = 1.0):
    """bool mask of points (..., N, 3) inside the oriented box(es)
    object_to_world (..., 4, 4) with sizes lwh (..., 3): points go into the
    object frame and are tested against |p| <= lwh / 2 * enlarge."""
    R = object_to_world[..., :3, :3]
    t = object_to_world[..., :3, 3]
    local = (points - t[..., None, :]) @ R   # R^T applied from the right
    if _is_torch(points):
        half = lwh * 0.5 * enlarge
        return (local.abs() <= half[..., None, :]).all(dim=-1)
    half = np.asarray(lwh) * 0.5 * enlarge
    return np.all(np.abs(local) <= half[..., None, :], axis=-1)


def assign_instance_ids(points, semantics, object_poses, object_lwhs,
                        object_ids, car_like_ids, enlarge: float = 1.2):
    """Stamp instance ids onto car-like scene points by point-in-OBB test.

    points f32 [N, 3] world; semantics int [N]; object_poses f32 [M, 4, 4];
    object_lwhs f32 [M, 3]; object_ids int [M]. Later boxes win on overlap.
    Returns int32 [N] (0 = no instance)."""
    n = points.shape[0]
    if _is_torch(points):
        car_mask = torch.zeros(n, dtype=torch.bool, device=points.device)
        inst = torch.zeros(n, dtype=torch.int32, device=points.device)
    else:
        car_mask = np.zeros(n, dtype=bool)
        inst = np.zeros(n, dtype=np.int32)
    for cid in car_like_ids:
        car_mask = car_mask | (semantics == cid)
    for m in range(object_poses.shape[0]):
        inside = points_in_obb(points, object_poses[m], object_lwhs[m],
                               enlarge)
        inst[inside & car_mask] = int(object_ids[m])
    return inst


def crop_points_aabb(points, bbox_min, bbox_max):
    """bool mask of points inside an axis-aligned box."""
    if _is_torch(points):
        lo = torch.as_tensor(bbox_min, dtype=points.dtype,
                             device=points.device)
        hi = torch.as_tensor(bbox_max, dtype=points.dtype,
                             device=points.device)
        return ((points >= lo) & (points <= hi)).all(dim=-1)
    return np.all((points >= np.asarray(bbox_min)) &
                  (points <= np.asarray(bbox_max)), axis=-1)


# ---------------------------------------------------------------------------
# exact oriented-box overlap (host side, numpy)
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if _is_torch(x) else np.asarray(x)


def _clip_polygon_halfspace(poly: np.ndarray, n: np.ndarray, d: float):
    """Sutherland-Hodgman: clip a 3D polygon to {x: n.x <= d}."""
    if len(poly) == 0:
        return poly
    dist = poly @ n - d
    out = []
    k = len(poly)
    for i in range(k):
        a, b = poly[i], poly[(i + 1) % k]
        da, db = dist[i], dist[(i + 1) % k]
        if da <= 0:
            out.append(a)
        if (da <= 0) != (db <= 0):
            t = da / (da - db)
            out.append(a + t * (b - a))
    return np.asarray(out) if out else np.zeros((0, 3))


_FACE_IDX = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]


def _box_faces(lwh, pose):
    c = np.asarray(corners_from_lwh_pose(lwh, pose))
    return [c[list(f)] for f in _FACE_IDX]


def _box_halfspaces(lwh, pose):
    """6 half-spaces (n, d) with n.x <= d inside."""
    pose = np.asarray(pose, np.float64)
    R, t = pose[:3, :3], pose[:3, 3]
    half = np.asarray(lwh, np.float64) / 2
    hs = []
    for axis in range(3):
        n = R[:, axis]
        c = n @ t
        hs.append((n, c + half[axis]))
        hs.append((-n, -(c - half[axis])))
    return hs


def _polyhedron_volume(faces: list) -> float:
    """Volume of the convex hull of the clipped boundary vertices (robust to
    duplicated or coincident faces, e.g. identical boxes)."""
    allv = np.unique(np.round(np.concatenate(faces, axis=0), 9), axis=0)
    if len(allv) < 4:
        return 0.0
    try:
        from scipy.spatial import ConvexHull
        return float(ConvexHull(allv, qhull_options="QJ").volume)
    except Exception:
        return 0.0


def _clipped_faces(lwh_a, pose_a, lwh_b, pose_b) -> list:
    """Box a's faces clipped to box b's half-spaces (those left with an
    area)."""
    hs = _box_halfspaces(lwh_b, pose_b)
    out = []
    for g in _box_faces(lwh_a, pose_a):
        for n, d in hs:
            g = _clip_polygon_halfspace(g, n, d)
            if len(g) == 0:
                break
        if len(g) >= 3:
            out.append(g)
    return out


def box3d_overlap(lwh1, pose1, lwh2, pose2):
    """Exact intersection volume and IoU of two oriented boxes
    (pytorch3d.ops.box3d_overlap semantics). Returns (volume, iou)."""
    lwh1, pose1, lwh2, pose2 = map(_np, (lwh1, pose1, lwh2, pose2))
    clipped = _clipped_faces(lwh1, pose1, lwh2, pose2) + \
        _clipped_faces(lwh2, pose2, lwh1, pose1)
    if not clipped:
        return 0.0, 0.0
    vol = _polyhedron_volume(clipped)
    union = float(np.prod(lwh1)) + float(np.prod(lwh2)) - vol
    return vol, (vol / union if union > 0 else 0.0)
