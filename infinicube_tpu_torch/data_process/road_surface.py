"""Road surface densification from HD-map polylines; counterpart of
``infinicube_tpu/data_process/road_surface.py``: densify the road-edge
polylines, lay a 2D lattice over their extent, give each cell the
inverse-distance-weighted height of its nearest polyline points
(``ops/knn_host.knn_query``) and keep the cells inside their Delaunay
triangulation: the ``3d_road_surface`` attribute (0.4 m)."""

from __future__ import annotations

import numpy as np

from infinicube_tpu_torch.ops.knn_host import knn_query
from infinicube_tpu_torch.utils.interpolate import polyline_to_points


def densify_polylines(polylines: list[np.ndarray], spacing: float
                      ) -> np.ndarray:
    pts = [polyline_to_points(np.asarray(p, np.float64), spacing)
           for p in polylines if len(p) >= 2]
    return np.concatenate(pts, axis=0) if pts else np.zeros((0, 3))


def estimate_road_surface(edge_polylines: list[np.ndarray],
                          lattice_spacing: float = 0.4,
                          height_knn: int = 4,
                          max_fill_dist: float = 30.0) -> np.ndarray:
    """Surface points filling the region between road-edge polylines; a
    degenerate triangulation (collinear edges) keeps every lattice cell
    within ``max_fill_dist``."""
    from scipy.spatial import Delaunay, QhullError
    edge_pts = densify_polylines(edge_polylines, lattice_spacing)
    if len(edge_pts) < 3:
        return np.zeros((0, 3))
    lo = edge_pts[:, :2].min(0) - lattice_spacing
    hi = edge_pts[:, :2].max(0) + lattice_spacing
    xs = np.arange(lo[0], hi[0], lattice_spacing)
    ys = np.arange(lo[1], hi[1], lattice_spacing)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    grid2d = np.stack([gx.ravel(), gy.ravel()], -1)

    q = np.concatenate([grid2d, np.zeros((len(grid2d), 1))], -1)
    r = np.concatenate([edge_pts[:, :2], np.zeros((len(edge_pts), 1))], -1)
    d2, idx = knn_query(q.astype(np.float32), r.astype(np.float32),
                        k=min(height_knn, len(edge_pts)))
    near = np.sqrt(d2[:, 0]) < max_fill_dist
    w = 1.0 / np.maximum(d2, 1e-6)
    w = w / w.sum(1, keepdims=True)
    z = (edge_pts[idx, 2] * w).sum(1)
    pts = np.concatenate([grid2d, z[:, None]], -1)[near]
    try:
        hull = Delaunay(edge_pts[:, :2])
    except (QhullError, ValueError):
        return pts.astype(np.float32)
    return pts[hull.find_simplex(pts[:, :2]) >= 0].astype(np.float32)
