"""Per-clip derived attributes; counterpart of
``infinicube_tpu/data_process/generate_additional_attributes.py``. For
each converted clip it writes:

- sky masks: a segmenter when one is given (``make_segformer_sky_segmenter``
  of ``models/gsm/segformer.py``), else the fallback: pixels without a
  LiDAR return;
- LiDAR depth images: the points projected with a per-pixel minimum;
- map points discretized at 0.25 m, and the 0.4 m road surface;
- the map-augmented, car-removed point clouds;
- (``write_buffers``) the voxel depth, semantic and instance buffers at
  0.2 m, splat-rendered for every frame.

The tensor work (projection, voxelization, the buffers) runs on ``device``,
the card unless the caller asks for the CPU; the rest is numpy.

    python -m infinicube_tpu_torch.data_process.generate_additional_attributes \\
        --root data/waymo [--clips clip0 ...] [--device cpu]

Clips are split over the ``torch.distributed`` processes where a process
group is initialised."""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from infinicube_tpu_torch.camera import projection as proj
from infinicube_tpu_torch.camera.pinhole import PinholeCamera
from infinicube_tpu_torch.data.codec import decode_member, encode_member
from infinicube_tpu_torch.data.tario import TarReader, TarWriter
from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.models.gsm.segformer import (  # noqa: F401
    make_segformer_sky_segmenter)
from infinicube_tpu_torch.utils.semantic import (CAR_LIKE_IDS,
                                                WAYMO_CATEGORY_NAMES)

SkySegmenter = Callable[[np.ndarray], np.ndarray]


def lidar_depth_image(points_world: np.ndarray, cam_to_world_cv: np.ndarray,
                      K: np.ndarray, hw: tuple[int, int],
                      device="cuda") -> np.ndarray:
    """Sparse z-depth image f32 [H, W] from LiDAR points (0 = no return)."""
    device = resolve_device(device)
    z = proj.zdepth_map_from_points(
        torch.as_tensor(np.asarray(points_world, np.float32), device=device),
        torch.ones(len(points_world), dtype=torch.bool, device=device),
        torch.as_tensor(np.asarray(cam_to_world_cv, np.float32),
                        device=device),
        torch.as_tensor(np.asarray(K, np.float32), device=device), hw)
    return z.cpu().numpy()


def sky_mask_fallback(depth: np.ndarray) -> np.ndarray:
    """uint8 [H, W]: 1 = sky, taken as pixels with no depth return."""
    return (depth <= 0).astype(np.uint8)


def sky_mask(image: np.ndarray | None, depth: np.ndarray,
             segmenter: SkySegmenter | None = None) -> np.ndarray:
    """The segmenter's mask where there is one and an image, else the
    fallback."""
    if segmenter is not None and image is not None:
        return np.asarray(segmenter(image)).astype(np.uint8)
    return sky_mask_fallback(depth)


def discretize_points(points: np.ndarray, spacing: float) -> np.ndarray:
    """Deduplicate points on a ``spacing`` lattice, first point of a cell
    kept, in order."""
    if len(points) == 0:
        return points
    q = np.round(points / spacing).astype(np.int64)
    _, first = np.unique(q, axis=0, return_index=True)
    return points[np.sort(first)]


def remove_car_points(points: np.ndarray, semantics: np.ndarray):
    """The cloud without vehicle-class points."""
    keep = ~np.isin(semantics, list(CAR_LIKE_IDS))
    return points[keep], semantics[keep]


def _read_polylines(root: Path, clip: str, kind: str) -> list:
    """[Ni, 3] world polylines from 3d_{kind}/{clip}.tar (member
    '{kind}.json'); [] when absent."""
    tar = root / f"3d_{kind}" / f"{clip}.tar"
    if not tar.exists():
        return []
    with TarReader(tar) as r:
        name = f"{kind}.json"
        if name not in r:
            return []
        polys = decode_member("json", r.read(name))
    return [np.asarray(p, np.float32) for p in polys if len(p) >= 2]


def generate_discrete_map_points(root: Path, clip: str,
                                 spacing: float = 0.25) -> dict:
    """The lane, road-edge and road-line polylines as 0.25 m points
    (3d_{kind}_voxelsize_025/{clip}.tar, member '{kind}.npy') and the 0.4 m
    road surface (3d_road_surface_voxelsize_04). Returns the arrays."""
    from infinicube_tpu_torch.data_process.road_surface import (
        densify_polylines, estimate_road_surface)
    out = {}
    for kind in ("lane", "road_edge", "road_line"):
        polys = _read_polylines(root, clip, kind)
        pts = densify_polylines(polys, spacing) if polys else \
            np.zeros((0, 3), np.float32)
        pts = discretize_points(pts.astype(np.float32), spacing)
        out[kind] = pts
        with TarWriter(root / f"3d_{kind}_voxelsize_025" /
                       f"{clip}.tar") as w:
            w.add(f"{kind}.npy", encode_member("npy", pts))
    edge_polys = _read_polylines(root, clip, "road_edge")
    if len(out["lane"]) and edge_polys:
        surface = estimate_road_surface(edge_polys, lattice_spacing=0.4)
    else:
        surface = np.zeros((0, 3), np.float32)
    out["road_surface"] = surface.astype(np.float32)
    with TarWriter(root / "3d_road_surface_voxelsize_04" /
                   f"{clip}.tar") as w:
        w.add("road_surface.npy", encode_member("npy", out["road_surface"]))
    return out


def car_removed_cloud(points: np.ndarray, semantics: np.ndarray,
                      map_points: dict) -> tuple[np.ndarray, np.ndarray]:
    """The cloud with the road-line points appended as LANE_MARKER and the
    vehicle-class points dropped."""
    road_line = map_points.get("road_line", np.zeros((0, 3), np.float32))
    lane_marker = WAYMO_CATEGORY_NAMES.index("LANE_MARKER")
    pts = np.concatenate([points, road_line]).astype(np.float32)
    sem = np.concatenate([semantics,
                          np.full(len(road_line), lane_marker, np.int32)])
    return remove_car_points(pts, sem)


def generate_voxel_buffers(root: Path, clip: str, poses: np.ndarray,
                           K: np.ndarray, hw: tuple[int, int],
                           points: np.ndarray, semantics: np.ndarray,
                           voxel_size: float = 0.2,
                           capacity: int = 1 << 20, device="cuda"):
    """Voxelize the accumulated car-removed cloud at 0.2 m and splat-render
    every frame: voxel_depth_100 (uint16, x100), semantic_buffer and
    instance_buffer (uint16) tars."""
    from infinicube_tpu_torch.grid.build import grid_from_points
    from infinicube_tpu_torch.grid.ops import majority_label
    from infinicube_tpu_torch.utils.buffers import generate_guidance_buffers
    device = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)[None]
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=device)
    origin = torch.as_tensor(np.asarray(
        points.mean(0) if len(points) else np.zeros(3), np.float32),
        device=device)
    grid = grid_from_points(pts, mask, voxel_size, origin, capacity=capacity)
    vox_sem = majority_label(grid, pts, torch.as_tensor(
        np.asarray(semantics, np.int32), device=device)[None], mask, 23)
    cam = PinholeCamera.from_intrinsics_matrix(K, hw[1], hw[0])
    bufs = generate_guidance_buffers(
        grid, vox_sem[0], torch.zeros_like(vox_sem[0]), cam,
        torch.as_tensor(np.asarray(poses, np.float32), device=device))
    depth = bufs["depth"].cpu().numpy()
    sem = bufs["semantic"].cpu().numpy()
    inst = bufs["instance"].cpu().numpy()
    with TarWriter(root / "voxel_depth_100" / f"{clip}.tar") as wd, \
            TarWriter(root / "semantic_buffer" / f"{clip}.tar") as ws, \
            TarWriter(root / "instance_buffer" / f"{clip}.tar") as wi:
        for i in range(depth.shape[0]):
            key = f"{i:06d}.png"
            wd.add(key, encode_member(
                "png", np.clip(depth[i] * 100, 0, 65535).astype(np.uint16)))
            ws.add(key, encode_member("png", sem[i].astype(np.uint16)))
            wi.add(key, encode_member("png", inst[i].astype(np.uint16)))


def process_clip(root: Path, clip: str, camera: PinholeCamera | None = None,
                 write_buffers: bool = True, write_map_attrs: bool = True,
                 buffer_capacity: int = 1 << 20,
                 sky_segmenter: SkySegmenter | None = None, device="cuda"):
    """The whole per-clip attribute set: sky masks, LiDAR depth, the
    discretized map points and road surface, the car-removed clouds and,
    with ``write_buffers``, the voxel buffers."""
    root = Path(root)
    device = resolve_device(device)
    readers = {a: TarReader(root / a / f"{clip}.tar")
               for a in ("pose", "intrinsic", "pc")
               if (root / a / f"{clip}.tar").exists()}
    img_reader = TarReader(root / "image" / f"{clip}.tar") \
        if (root / "image" / f"{clip}.tar").exists() else None
    frames = sorted({n.partition(".")[0] for n in readers["pose"].names()})
    out_sky = TarWriter(root / "skymask" / f"{clip}.tar")
    out_dep = TarWriter(root / "lidar_depth" / f"{clip}.tar")
    out_nocar = TarWriter(root / "pc_with_map_without_car" / f"{clip}.tar")
    all_pts, all_sem = [], []
    poses, K0 = [], None
    hw = None
    try:
        map_points = generate_discrete_map_points(root, clip) \
            if write_map_attrs else {}
        for key in frames:
            pose = np.asarray(decode_member(
                "npy", readers["pose"].read(f"{key}.npy"))).reshape(4, 4)
            K = np.asarray(decode_member(
                "npy", readers["intrinsic"].read(f"{key}.npy"))).reshape(3, 3)
            pc = decode_member("npz", readers["pc"].read(f"{key}.npz"))
            cam = camera or PinholeCamera.from_intrinsics_matrix(
                K, int(K[0, 2] * 2), int(K[1, 2] * 2))
            depth = lidar_depth_image(pc["xyz"], pose, K, (cam.h, cam.w),
                                      device)
            img = None
            if img_reader is not None and f"{key}.png" in img_reader:
                img = decode_member("png", img_reader.read(f"{key}.png"))
            out_sky.add(f"{key}.png", encode_member(
                "png", sky_mask(img, depth, sky_segmenter)))
            out_dep.add(f"{key}.png", encode_member(
                "png", np.clip(depth * 100, 0, 65535).astype(np.uint16)))
            sem = np.asarray(pc.get("semantic",
                                    np.zeros(len(pc["xyz"]), np.int32)))
            pts_nc, sem_nc = car_removed_cloud(
                np.asarray(pc["xyz"], np.float32), sem.astype(np.int32),
                map_points)
            out_nocar.add(f"{key}.npz", encode_member(
                "npz", {"xyz": pts_nc, "semantic": sem_nc}))
            all_pts.append(pts_nc)
            all_sem.append(sem_nc)
            poses.append(pose)
            K0 = K if K0 is None else K0
            hw = (cam.h, cam.w)
    finally:
        out_sky.close()
        out_dep.close()
        out_nocar.close()
        for r in readers.values():
            r.close()
        if img_reader:
            img_reader.close()
    if write_buffers and all_pts and K0 is not None:
        generate_voxel_buffers(
            root, clip, np.stack(poses), K0, hw,
            np.concatenate(all_pts), np.concatenate(all_sem),
            capacity=buffer_capacity, device=device)


def main(argv=None):
    import torch.distributed as dist
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--clips", nargs="*", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = Path(args.root)
    clips = args.clips or sorted(p.stem for p in (root / "pose").glob("*.tar"))
    grouped = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    world = dist.get_world_size() if grouped else 1
    for i, clip in enumerate(clips):
        if i % world != rank:
            continue
        process_clip(root, clip, device=args.device)
        print(f"[attrs] {clip} done")


if __name__ == "__main__":
    main()
