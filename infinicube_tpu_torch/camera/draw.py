"""Host-side drawings of the map and box conditions; counterpart of
``infinicube_tpu/camera/draw.py``.

Polyline clipping at the image plane, projection, Liang-Barsky clipping to
the image, thick lines as stamped discs, convex hulls (monotone chain) and
scanline polygon fills, in numpy on the port's ``PinholeCamera``. The depth
coding is the reference's: drawn value = ``colors * 2 * (depth_max -
mean_depth) / 255`` (uint8) on a black canvas."""

from __future__ import annotations

import numpy as np
import torch

from infinicube_tpu_torch.camera.pinhole import PinholeCamera


def _pixels(camera: PinholeCamera, cam: np.ndarray) -> np.ndarray:
    """f64 camera-frame points [N, 3] -> f32 pixel coordinates [N, 2]: the
    projection in f64, rounded once to f32."""
    return camera.ray2pixel(torch.from_numpy(np.asarray(cam, np.float64))
                            ).float().numpy()


def clip_polyline_to_image_plane(points_in_cam: np.ndarray,
                                 eps: float = 5e-2) -> np.ndarray:
    """Clip a camera-space polyline to z >= 0, inserting intersection points
    on crossing edges."""
    depth = points_in_cam[:, 2]
    out = []
    for i in range(len(points_in_cam) - 1):
        p1, p2 = points_in_cam[i], points_in_cam[i + 1]
        if depth[i] >= 0 and depth[i + 1] >= 0:
            out.append(p1)
        elif depth[i] < 0 and depth[i + 1] < 0:
            continue
        elif depth[i] >= 0:
            out.append(p1)
            t = (-p2[2]) / (p1[2] - p2[2]) + eps
            out.append(p2 + t * (p1 - p2))
        else:
            t = (-p1[2]) / (p2[2] - p1[2]) + eps
            out.append(p1 + t * (p2 - p1))
    if depth[-1] >= 0:
        out.append(points_in_cam[-1])
    if not out:
        return np.zeros((0, 3), points_in_cam.dtype)
    return np.stack(out, axis=0)


def _resample_polyline(poly: np.ndarray, interval: float) -> np.ndarray:
    """Insert points so no segment exceeds ``interval`` meters."""
    out = [poly[0]]
    for a, b in zip(poly[:-1], poly[1:]):
        d = float(np.linalg.norm(b - a))
        n = max(1, int(np.ceil(d / interval)))
        for k in range(1, n + 1):
            out.append(a + (b - a) * (k / n))
    return np.stack(out)


def project_line_depth(camera: PinholeCamera, camera_poses: np.ndarray,
                       polylines: list, segment_interval: float = 0,
                       depth_max: float = 122.5) -> list:
    """Per frame: clip each world polyline to the image plane, project, and
    return 2-point segments [(u1,v1,d1),(u2,v2,d2)]."""
    camera_poses = np.asarray(camera_poses, np.float64)
    if camera_poses.ndim == 2:
        camera_poses = camera_poses[None]
    frames = []
    for pose in camera_poses:
        w2c = np.linalg.inv(pose)
        segs = []
        for poly in polylines:
            poly = np.asarray(poly, np.float64)
            if len(poly) < 2:
                continue
            if segment_interval > 0:
                poly = _resample_polyline(poly, segment_interval)
            cam = poly @ w2c[:3, :3].T + w2c[:3, 3]
            cam = clip_polyline_to_image_plane(cam)
            if len(cam) < 2:
                continue
            uv = _pixels(camera, cam)
            d = np.clip(cam[:, 2], 0, depth_max)
            for i in range(len(cam) - 1):
                segs.append([(uv[i, 0], uv[i, 1], d[i]),
                             (uv[i + 1, 0], uv[i + 1, 1], d[i + 1])])
        frames.append(segs)
    return frames


def _clip_line_2d(p1, p2, w, h):
    """Liang-Barsky line clip to [0,w) x [0,h); returns (ok, q1, q2)."""
    x1, y1 = float(p1[0]), float(p1[1])
    dx, dy = float(p2[0]) - x1, float(p2[1]) - y1
    t0, t1 = 0.0, 1.0
    for p, q in ((-dx, x1), (dx, w - 1 - x1), (-dy, y1), (dy, h - 1 - y1)):
        if p == 0:
            if q < 0:
                return False, None, None
            continue
        r = q / p
        if p < 0:
            if r > t1:
                return False, None, None
            t0 = max(t0, r)
        else:
            if r < t0:
                return False, None, None
            t1 = min(t1, r)
    q1 = np.array([x1 + t0 * dx, y1 + t0 * dy])
    q2 = np.array([x1 + t1 * dx, y1 + t1 * dy])
    return True, q1, q2


def _draw_thick_line(canvas: np.ndarray, p1, p2, value, radius: int):
    """Rasterize a thick line by stamping discs along the segment."""
    h, w = canvas.shape[:2]
    n = max(2, int(np.ceil(np.linalg.norm(np.asarray(p2) - np.asarray(p1)))))
    ts = np.linspace(0, 1, n)
    pts = np.asarray(p1)[None] + ts[:, None] * (np.asarray(p2) -
                                                np.asarray(p1))[None]
    r = max(1, radius // 2)
    for px, py in pts:
        x0, x1 = int(max(0, px - r)), int(min(w, px + r + 1))
        y0, y1 = int(max(0, py - r)), int(min(h, py + r + 1))
        if x0 >= x1 or y0 >= y1:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1]
        disc = (xx - px) ** 2 + (yy - py) ** 2 <= r * r
        canvas[y0:y1, x0:x1][disc] = value


def draw_line_depth(camera: PinholeCamera, camera_poses: np.ndarray,
                    polylines: list, radius: int = 8, colors=None,
                    segment_interval: float = 0,
                    depth_max: float = 122.5) -> np.ndarray:
    """Depth-coded line images."""
    single = np.asarray(camera_poses).ndim == 2
    colors = np.asarray([255, 255, 255] if colors is None else colors,
                        np.float64)
    frames = project_line_depth(camera, camera_poses, polylines,
                                segment_interval, depth_max)
    h, w = int(camera.h), int(camera.w)
    images = []
    for segs in frames:
        canvas = np.zeros((h, w, 3), np.uint8)
        for (u1, v1, d1), (u2, v2, d2) in segs:
            ok, p1, p2 = _clip_line_2d((u1, v1), (u2, v2), w, h)
            if not ok:
                continue
            dm = np.clip((d1 + d2) / 2, 0, depth_max)
            fill = (colors * 2 * (depth_max - dm) / 255).astype(np.uint8)
            _draw_thick_line(canvas, p1, p2, fill, radius)
        images.append(canvas)
    out = np.stack(images)
    return out[0] if single else out


def convex_hull_2d(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain (replaces cv2.convexHull)."""
    pts = np.unique(np.asarray(points, np.float64), axis=0)
    if len(pts) < 3:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(a, b):
        return a[0] * b[1] - a[1] * b[0]

    def half(iterable):
        out = []
        for p in iterable:
            while len(out) >= 2 and cross2(out[-1] - out[-2],
                                           p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.stack(lower[:-1] + upper[:-1])


def _fill_polygon(canvas: np.ndarray, poly: np.ndarray, value):
    """Scanline polygon fill (replaces shapely + cv2.fillPoly)."""
    h, w = canvas.shape[:2]
    ys = np.arange(max(0, int(np.floor(poly[:, 1].min()))),
                   min(h, int(np.ceil(poly[:, 1].max())) + 1))
    n = len(poly)
    for y in ys:
        xs = []
        for i in range(n):
            y1, y2 = poly[i, 1], poly[(i + 1) % n, 1]
            x1, x2 = poly[i, 0], poly[(i + 1) % n, 0]
            if (y1 <= y < y2) or (y2 <= y < y1):
                xs.append(x1 + (y - y1) / (y2 - y1) * (x2 - x1))
        xs.sort()
        for a, b in zip(xs[::2], xs[1::2]):
            x0, x1 = int(max(0, np.ceil(a))), int(min(w, np.floor(b) + 1))
            if x0 < x1:
                canvas[y, x0:x1] = value


def project_hull_depth(camera: PinholeCamera, camera_poses: np.ndarray,
                       hulls: list, depth_max: float = 122.5) -> list:
    """Per frame: project each 3D hull's z>0 points -> [(u, v, d), ...]
   ."""
    camera_poses = np.asarray(camera_poses, np.float64)
    if camera_poses.ndim == 2:
        camera_poses = camera_poses[None]
    frames = []
    for pose in camera_poses:
        w2c = np.linalg.inv(pose)
        items = []
        for hull in hulls:
            hull = np.asarray(hull, np.float64)
            if len(hull) < 3:
                continue
            cam = hull @ w2c[:3, :3].T + w2c[:3, 3]
            if (cam[:, 2] < 0).all():
                continue
            keep = cam[:, 2] > 0
            uv = _pixels(camera, cam[keep])
            d = np.clip(cam[keep, 2], 0, depth_max)
            items.append(np.concatenate([uv, d[:, None]], axis=1))
        frames.append(items)
    return frames


def draw_hull_depth(camera: PinholeCamera, camera_poses: np.ndarray,
                    hulls: list, colors=None,
                    depth_max: float = 122.5) -> np.ndarray:
    """Depth-coded filled convex hulls."""
    single = np.asarray(camera_poses).ndim == 2
    colors = np.asarray([255, 255, 255] if colors is None else colors,
                        np.float64)
    frames = project_hull_depth(camera, camera_poses, hulls, depth_max)
    h, w = int(camera.h), int(camera.w)
    images = []
    for items in frames:
        canvas = np.zeros((h, w, 3), np.uint8)
        for hull in items:
            ch = convex_hull_2d(hull[:, :2])
            if len(ch) < 3:
                continue
            # clip hull bbox fully outside -> skip
            if ch[:, 0].max() < 0 or ch[:, 0].min() >= w or \
                    ch[:, 1].max() < 0 or ch[:, 1].min() >= h:
                continue
            dm = np.clip(hull[:, 2].mean(), 0, depth_max)
            fill = (colors * 2 * (depth_max - dm) / 255).astype(np.uint8)
            _fill_polygon(canvas, ch, fill)
        images.append(canvas)
    out = np.stack(images)
    return out[0] if single else out
