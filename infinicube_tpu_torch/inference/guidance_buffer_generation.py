"""Stage-2 CLI: render guidance buffers from a voxel world, then
(optionally) drive the video model; counterpart of
``infinicube_tpu/inference/guidance_buffer_generation.py``.

Loads the stage-1 voxel world, builds the camera trajectory (resampled by
frame or meter offset, or interpolated from recorded keyframes), renders the
depth / semantic / instance buffers and the coordinate buffer on the card,
writes the six tars (depth x100 uint16 png, instance uint16 png, semantic
png, pose npy, intrinsic npy, dynamic_object_info json) and the preview
videos, then, with ``--run_video``, calls the video generator on the first
93 frames.

    python -m infinicube_tpu_torch.inference.guidance_buffer_generation \
        --voxel_world out/world.npz --output out/buffers [--num_frames 93] \
        [--device cpu]

The buffers are made on ``--device`` (default ``cuda``); without a card the
CLI raises unless ``--device cpu`` is given."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from infinicube_tpu_torch.camera.conventions import flu_to_opencv
from infinicube_tpu_torch.camera.pinhole import PinholeCamera
from infinicube_tpu_torch.data.codec import encode_member
from infinicube_tpu_torch.data.tario import TarWriter
from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.grid.build import grid_from_ijk
from infinicube_tpu_torch.utils.buffers import (DynamicObjects,
                                                generate_guidance_buffers)
from infinicube_tpu_torch.utils.precision import set_float32_precision
from infinicube_tpu_torch.utils.semantic import generate_rgb_semantic_buffer
from infinicube_tpu_torch.utils.world_grid import WorldGrid

DEFAULT_CAMERA = PinholeCamera(fx=480.0, fy=480.0, cx=416.0, cy=240.0,
                               w=832, h=480)  # 480p (480 x 832)

# the video stage's clip length
VIDEO_FRAMES = 93


def load_voxel_world(path: str | Path) -> WorldGrid:
    """Load a stage-1 world (.npz with ijk / semantics / voxel_size /
    origin)."""
    d = np.load(path)
    w = WorldGrid(d["voxel_size"], d.get("origin"))
    w.merge_ijk(d["ijk"].astype(np.int64), d["semantics"].astype(np.int32))
    return w


def save_voxel_world(path: str | Path, world: WorldGrid):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, ijk=world.ijk(), semantics=world.semantics,
                        voxel_size=world.voxel_size, origin=world.origin)


def resample_trajectory(poses: np.ndarray, num_frames: int,
                        frame_offset: int = 0, meter_offset: float = 0.0
                        ) -> np.ndarray:
    """Key poses selected by frame and meter offset, interpolated to
    ``num_frames``."""
    from infinicube_tpu_torch.utils.interpolate import inter_poses
    poses = np.asarray(poses)[frame_offset:]
    if meter_offset > 0:
        d = np.concatenate([[0], np.cumsum(np.linalg.norm(
            np.diff(poses[:, :3, 3], axis=0), axis=-1))])
        poses = poses[d >= meter_offset]
    return inter_poses(poses, num_frames, smoothness=1.0)


def stamp_static_instances(world: WorldGrid, static_object_info: dict,
                           enlarge: float = 1.2) -> np.ndarray:
    """Instance ids for the world's car-like voxels from parked-object
    boxes. static_object_info: {gid: {object_to_world, object_lwh,
    object_id_int}}."""
    from infinicube_tpu_torch.utils.bbox import assign_instance_ids
    from infinicube_tpu_torch.utils.semantic import CAR_LIKE_IDS
    objs = list(static_object_info.values())
    if not objs:
        return np.zeros(world.num_voxels, np.int32)
    poses = np.asarray([o["object_to_world"] for o in objs], np.float64)
    lwhs = np.asarray([o["object_lwh"] for o in objs], np.float64)
    ids = np.asarray([o["object_id_int"] for o in objs], np.int64)
    return assign_instance_ids(world.points(), world.semantics, poses, lwhs,
                               ids, CAR_LIKE_IDS, enlarge).astype(np.int32)


def world_to_grid(world: WorldGrid, instance_ids: np.ndarray | None = None,
                  device_capacity: int = 2_000_000, device="cuda"):
    """The world as a batch-1 grid on ``device`` (capacity the next power of
    two; above ``device_capacity`` voxels an even subsample) with its
    semantics and instance ids aligned to the grid's slots: (grid, sem
    int32 [C], instance int32 [C])."""
    dev = resolve_device(device)
    ijk = world.ijk()
    sem = world.semantics
    inst = instance_ids if instance_ids is not None else \
        np.zeros(len(ijk), np.int32)
    if len(ijk) > device_capacity:
        sel = np.linspace(0, len(ijk) - 1, device_capacity).astype(int)
        ijk, sem, inst = ijk[sel], sem[sel], inst[sel]
    cap = 1 << int(np.ceil(np.log2(max(len(ijk), 2))))
    grid = grid_from_ijk(
        torch.as_tensor(ijk, dtype=torch.int32, device=dev)[None],
        torch.ones((1, len(ijk)), dtype=torch.bool, device=dev),
        torch.as_tensor(world.voxel_size, dtype=torch.float32, device=dev),
        torch.as_tensor(world.origin, dtype=torch.float32, device=dev), cap)
    # grid slots are sorted lexicographically by (i, j, k); align attributes
    order = np.lexsort((ijk[:, 2], ijk[:, 1], ijk[:, 0]))
    sem_dev = torch.zeros((cap,), dtype=torch.int32, device=dev)
    sem_dev[:len(ijk)] = torch.as_tensor(sem[order], dtype=torch.int32)
    inst_dev = torch.zeros((cap,), dtype=torch.int32, device=dev)
    inst_dev[:len(ijk)] = torch.as_tensor(inst[order], dtype=torch.int32)
    return grid, sem_dev, inst_dev


def generate_buffers_for_world(world: WorldGrid,
                               cam_to_worlds_flu: np.ndarray,
                               camera: PinholeCamera = DEFAULT_CAMERA,
                               objects: DynamicObjects | None = None,
                               instance_ids: np.ndarray | None = None,
                               device_capacity: int = 2_000_000,
                               device="cuda") -> dict:
    """Render all buffers on ``device`` (the card unless the caller asks
    for the CPU). cam_to_worlds_flu [T, 4, 4] FLU camera poses in the world
    frame, converted to OpenCV for the rays; instance_ids: optional
    per-voxel ids aligned with ``world.ijk()`` (``stamp_static_instances``).
    Returns the tensors of ``generate_guidance_buffers`` on ``device``."""
    dev = resolve_device(device)
    grid, sem_dev, inst_dev = world_to_grid(world, instance_ids,
                                            device_capacity, dev)
    poses_cv = np.stack([flu_to_opencv(p) for p in cam_to_worlds_flu])
    if objects is not None:
        objects = objects.to(dev)
    return generate_guidance_buffers(
        grid, sem_dev, inst_dev, camera,
        torch.as_tensor(poses_cv, dtype=torch.float32, device=dev),
        objects=objects)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def write_buffer_tars(output: Path, buffers: dict, poses_flu: np.ndarray,
                      camera: PinholeCamera,
                      dynamic_object_info: dict | None = None):
    """Write the buffers in the reference's on-disk format: six tars of one
    member per frame (``000000.png`` ...)."""
    output = Path(output)
    output.mkdir(parents=True, exist_ok=True)
    depth = _host(buffers["depth"])
    sem = _host(buffers["semantic"])
    inst = _host(buffers["instance"])
    T = depth.shape[0]
    with TarWriter(output / "depth.tar") as wd, \
            TarWriter(output / "instance.tar") as wi, \
            TarWriter(output / "semantic.tar") as ws, \
            TarWriter(output / "pose.tar") as wp, \
            TarWriter(output / "intrinsic.tar") as wk, \
            TarWriter(output / "dynamic_object_info.tar") as wo:
        K = camera.intrinsics_matrix().numpy()
        for t in range(T):
            wd.add(f"{t:06d}.png", encode_member(
                "png", np.clip(depth[t] * 100.0, 0, 65535).astype(np.uint16)))
            wi.add(f"{t:06d}.png", encode_member(
                "png", inst[t].astype(np.uint16)))
            ws.add(f"{t:06d}.png", encode_member(
                "png", sem[t].astype(np.uint8)))
            wp.add(f"{t:06d}.npy", encode_member(
                "npy", flu_to_opencv(poses_flu[t]).astype(np.float32)))
            wk.add(f"{t:06d}.npy", encode_member("npy", K.astype(np.float32)))
            info = (dynamic_object_info or {}).get(t, {})
            wo.add(f"{t:06d}.dynamic_object_info.json",
                   encode_member("json", info))


def write_preview_videos(output: Path, buffers: dict):
    """semantic.mp4, depth.mp4 and coordinate.mp4 (png frame directories
    where no video writer is installed); returns the colored semantic
    buffer (float [T, H, W, 3] in [0, 1]) and the uint8 coordinate buffer,
    the video stage's inputs."""
    from infinicube_tpu_torch.utils.depth_vis import vis_depth
    from infinicube_tpu_torch.utils.fileio import write_video
    output = Path(output)
    sem_rgb = generate_rgb_semantic_buffer(_host(buffers["semantic"]),
                                           _host(buffers["instance"]))
    write_video(output / "semantic.mp4", (sem_rgb * 255).astype(np.uint8))
    dep = np.stack([vis_depth(d) for d in _host(buffers["depth"])])
    write_video(output / "depth.mp4", dep)
    coord = (_host(buffers["coordinate"]) * 255).astype(np.uint8)
    write_video(output / "coordinate.mp4", coord)
    return sem_rgb, coord


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--voxel_world", required=True)
    ap.add_argument("--static_objects", default=None,
                    help="json {gid: {object_to_world, object_lwh, "
                         "object_id_int}} for parked-car instance ids")
    ap.add_argument("--poses", default=None,
                    help="npy [T,4,4] FLU poses; default: straight-line")
    ap.add_argument("--keyframes", default=None,
                    help="npy [K,4,4] keyframe poses -> smooth trajectory "
                         "(visualize.recorder.TrajectoryRecorder)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--num_frames", type=int, default=93)
    ap.add_argument("--frame_offset", type=int, default=0)
    ap.add_argument("--meter_offset", type=float, default=0.0)
    ap.add_argument("--run_video", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="with --run_video: a checkpoint written by "
                         "'python -m infinicube_tpu_torch.convert' (the "
                         "released Wan2.1 weights); default: random weights")
    ap.add_argument("--prompt", default="a realistic driving scene")
    ap.add_argument("--device", default="cuda",
                    help="where the buffers (and the video) are made")
    args = ap.parse_args(argv)
    set_float32_precision()
    device = resolve_device(args.device)

    world = load_voxel_world(args.voxel_world)
    if args.keyframes:
        from infinicube_tpu_torch.visualize.recorder import TrajectoryRecorder
        rec = TrajectoryRecorder()
        for T in np.load(args.keyframes):
            rec.add_keyframe(pose=T)
        poses = rec.interpolate(args.num_frames)
    elif args.poses:
        poses = np.load(args.poses)
    else:
        poses = np.tile(np.eye(4), (args.num_frames, 1, 1))
        poses[:, 0, 3] = np.linspace(0, 40, args.num_frames)
        poses[:, 2, 3] = 1.8
    poses = resample_trajectory(poses, args.num_frames, args.frame_offset,
                                args.meter_offset)
    out = Path(args.output)
    inst = None
    if args.static_objects:
        inst = stamp_static_instances(
            world, json.loads(Path(args.static_objects).read_text()))
    buffers = generate_buffers_for_world(world, poses, instance_ids=inst,
                                         device=device)
    write_buffer_tars(out, buffers, poses, DEFAULT_CAMERA)
    sem_rgb, coord = write_preview_videos(out, buffers)

    if args.run_video:
        from infinicube_tpu_torch.models.wan.pipeline import (
            WanPipelineConfig, WanVideoGenerator)
        from infinicube_tpu_torch.utils.fileio import write_video
        if args.ckpt:
            gen = WanVideoGenerator.from_checkpoint(args.ckpt, device=device)
        else:
            gen = WanVideoGenerator(WanPipelineConfig(), device=device)
            gen.init_params(torch.Generator(device=device).manual_seed(0))
        frames = gen.generate(
            (sem_rgb[:VIDEO_FRAMES] * 255).astype(np.uint8),
            coord[:VIDEO_FRAMES], args.prompt)
        write_video(out / "video.mp4", frames)
    print(f"buffers written to {out}")
    return buffers


if __name__ == "__main__":
    main()
