"""Waymo clip-shard dataset; counterpart of
``infinicube_tpu/data/waymo_dataset.py``: per-process sharded iteration
over per-clip tars, drawing from the same ``numpy.random.default_rng(seed +
host)`` in the same order, so its samples equal the reference's bit for
bit.

- Clips are assigned cyclically (``i % num_hosts == host``) after a
  seed-keyed shuffle of the clip order (train split); each clip gives
  ``samples_per_shard`` samples at random start frames (train) or one at
  ``val_starting_frame`` (any other split).
- Per sample: the crop frame is the first input camera's FLU pose moved to
  the crop box's center (plus an optional jitter), so crop coordinates are
  symmetric about the grid origin; either every vehicle box gets the
  procedural CAD car (vehicle-class points removed) or the clip's
  accumulated dynamic-object points are posed at this frame's boxes; boxes
  from the static and dynamic object info pass ``healthy_boxes``; per-view
  images, poses and intrinsics with side views padded to the front view's
  height, depth images (``<depth_attr>`` / 100), and the 4-channel GSM mask
  (ch0 not sky, ch1 non-dynamic, ch2 not padding, ch3 filled by the
  model).
- A clip that raises anywhere is skipped whole (the reference's policy for
  broken samples), so a fault shows as fewer samples, not as an error.

On-disk layout, as ``data_process/waymo2shards.py`` writes it:
``<root>/<attr>/<clip_id>.tar`` with members ``{frame:06d}.<ext>`` (or
``{frame:06d}.{view}.<ext>`` for the side views). Plain numpy."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from infinicube_tpu_torch.camera.conventions import opencv_to_flu
from infinicube_tpu_torch.data.codec import decode_member
from infinicube_tpu_torch.data.specs import DatasetSpec
from infinicube_tpu_torch.data.tario import TarReader
from infinicube_tpu_torch.utils.semantic import (CAR_LIKE_IDS,
                                                WAYMO_CATEGORY_NAMES)


@dataclasses.dataclass
class WaymoDatasetConfig:
    root: str = "data/waymo"
    scene_list_file: str | None = None
    attr_subfolders: tuple = ("pose", "intrinsic", "pc", "static_object_info",
                              "dynamic_object_info", "map",
                              "dynamic_object_points_canonical")
    input_frames: tuple = (0,)
    sup_frames: tuple = (0,)
    frame_start: int = 0
    frame_end: int = 110
    samples_per_shard: int = 4
    crop_bbox_min: tuple = (-25.6, -25.6, -6.4)
    crop_bbox_max: tuple = (25.6, 25.6, 19.2)
    crop_augment: bool = False
    crop_augment_range: tuple = (3.2, 3.2, 0.8)
    map_types: tuple = ("road_edge", "road_line", "road_surface")
    views: tuple = ()                  # e.g. ("front", "front_left", ...);
    # empty = single-camera members ({frame:06d}.<ext>)
    depth_attr: str = "lidar_depth"    # or "depth_buffer_100"
    replace_all_car_with_cad: bool = False
    cad_points_per_meter3: float = 60.0
    merge_dynamic_points: bool = True
    seed: int = 0
    # train/val split semantics (waymo_wds.py:95,112-116: 'train' draws
    # samples_per_shard random start frames per clip and shuffles the clip
    # order with the seed; any other split is DETERMINISTIC — one sample per
    # clip at val_starting_frame, clips in list order)
    split: str = "train"
    val_starting_frame: int = 50


def healthy_boxes(poses: np.ndarray, lwhs: np.ndarray,
                  half_range: np.ndarray, margin: float = 2.0) -> np.ndarray:
    """bool[N]: finite pose, positive extent, center inside crop + margin
    (the reference drops boxes its box3d_overlap self-test rejects,
    waymo_wds.py:403-411 — degenerate extents / non-finite corners)."""
    ok = np.isfinite(poses).all(axis=(1, 2)) & np.isfinite(lwhs).all(axis=1)
    ok &= (lwhs > 1e-3).all(axis=1) & (lwhs < 40.0).all(axis=1)
    centers = poses[:, :3, 3]
    ok &= np.all(np.abs(centers) <= half_range + margin, axis=1)
    return ok


class WaymoClipDataset:
    """Iterable over per-clip samples (NumPy dicts keyed by DatasetSpec)."""

    def __init__(self, cfg: WaymoDatasetConfig, host_index: int = 0,
                 num_hosts: int = 1):
        self.cfg = cfg
        root = Path(cfg.root)
        if cfg.scene_list_file and Path(cfg.scene_list_file).exists():
            # the reference ships per-split clip-name lists
            # (assets/waymo_split/*.json, e.g. official_train_static_scene)
            # and selects shards from them (waymo_wds.py:107-132); pass one
            # of those files (or any JSON list of clip ids) here
            scenes = json.loads(Path(cfg.scene_list_file).read_text())
        else:
            first = root / cfg.attr_subfolders[0]
            scenes = sorted(p.stem for p in first.glob("*.tar")) \
                if first.exists() else []
        if cfg.split == "train":
            # deterministic seed-keyed shuffle of the clip order
            # (waymo_wds.py:112-116) BEFORE host sharding, so each host's
            # subset is drawn from the shuffled list like the per-rank wds
            # pipeline does
            shuf = np.random.default_rng(cfg.seed)
            scenes = [scenes[i] for i in shuf.permutation(len(scenes))]
        self.scenes = [s for i, s in enumerate(scenes)
                       if i % num_hosts == host_index]
        self.rng = np.random.default_rng(cfg.seed + host_index)

    def __iter__(self):
        cfg = self.cfg
        for scene in self.scenes:
            readers = {}
            try:
                for attr in set(cfg.attr_subfolders) | {"image", "skymask",
                                                        cfg.depth_attr}:
                    p = Path(cfg.root) / attr / f"{scene}.tar"
                    if p.exists():
                        readers[attr] = TarReader(p)
                # val/test: ONE deterministic sample per clip at
                # val_starting_frame (waymo_wds.py:95: sample_time_from_shard
                # = 1 unless train); train: samples_per_shard random starts
                n_samples = cfg.samples_per_shard if cfg.split == "train" \
                    else 1
                for _ in range(n_samples):
                    if cfg.split == "train":
                        start = int(self.rng.integers(
                            cfg.frame_start,
                            max(cfg.frame_start + 1, cfg.frame_end - 1)))
                    else:
                        # clamp INTO the configured window (a small
                        # val_starting_frame must not select below
                        # frame_start)
                        start = min(max(cfg.val_starting_frame,
                                        cfg.frame_start),
                                    max(cfg.frame_start, cfg.frame_end - 2))
                    sample = self._build_sample(scene, readers, start)
                    if sample is not None:
                        yield sample
            except Exception:
                continue  # skip-broken-sample policy (waymo_wds.py:303-310)
            finally:
                for r in readers.values():
                    r.close()

    # ------------------------------------------------------------------ I/O
    def _read_frame(self, reader: TarReader, frame: int,
                    view: str | None = None,
                    exts=("npy", "npz", "json", "png", "jpg")):
        # Legacy single-camera tars store members as '{frame}.{ext}' with no
        # view tag; that fallback is only valid for the FRONT camera — for a
        # side view a missing member must yield None (sample rejected), not
        # silently substitute front-camera data (front image with side pose).
        front = self.cfg.views[0] if self.cfg.views else None
        allow_untagged = view is None or view == front
        for ext in exts:
            names = ([f"{frame:06d}.{view}.{ext}"] if view else []) + \
                ([f"{frame:06d}.{ext}"] if allow_untagged else [])
            for name in names:
                if name in reader:
                    return decode_member(ext, reader.read(name))
        return None

    def _object_info(self, readers: dict, frame: int) -> dict:
        """static + dynamic object info merged (dynamic first, reference's
        all_object_dict, waymo_wds.py:391-395)."""
        out = {}
        for attr in ("dynamic_object_info", "static_object_info"):
            if attr in readers:
                info = self._read_frame(readers[attr], frame)
                if isinstance(info, dict):
                    for gid, obj in info.items():
                        out.setdefault(gid, dict(obj, dynamic="dynamic" in attr))
        return out

    # ------------------------------------------------------------ transform
    def _build_sample(self, scene: str, readers: dict, start: int):
        cfg = self.cfg
        frames = [start + f for f in cfg.input_frames]
        if "pose" not in readers or "pc" not in readers:
            return None
        front = cfg.views[0] if cfg.views else None
        pose_cv = self._read_frame(readers["pose"], frames[0], front)
        if pose_cv is None:
            return None
        pose_cv = np.asarray(pose_cv, np.float64).reshape(4, 4)
        cam_flu = opencv_to_flu(pose_cv)          # first-camera FLU -> world

        # crop frame: camera FLU axes, translation moved to the crop CENTER
        # (reference crop_pcd_and_generate_grid_raw:434-455) so grid coords
        # are symmetric about the origin
        lo = np.asarray(cfg.crop_bbox_min, np.float64)
        hi = np.asarray(cfg.crop_bbox_max, np.float64)
        center_offset = (lo + hi) / 2
        if cfg.crop_augment and cfg.split == "train":  # waymo_wds.py:444
            center_offset = center_offset + self.rng.uniform(-1, 1, 3) * \
                np.asarray(cfg.crop_augment_range)
        grid_to_world = cam_flu.copy()
        grid_to_world[:3, 3] = cam_flu[:3, 3] + \
            cam_flu[:3, :3] @ center_offset
        world_to_crop = np.linalg.inv(grid_to_world)
        half = ((hi - lo) / 2).astype(np.float64)

        pc = self._read_frame(readers["pc"], frames[0])
        if pc is None:
            return None
        if isinstance(pc, dict):
            xyz = np.asarray(pc.get("xyz"), np.float32)
            sem = np.asarray(pc.get("semantic",
                                    np.zeros(len(xyz))), np.int32)
        else:
            xyz = np.asarray(pc, np.float32)
            sem = np.zeros(len(xyz), np.int32)
        xyz_crop = xyz @ world_to_crop[:3, :3].T + world_to_crop[:3, 3]

        objects = self._object_info(readers, frames[0])

        if cfg.replace_all_car_with_cad:
            # drop all vehicle-class points, stamp the procedural CAD car at
            # every (healthy) vehicle box (reference :473-487 removes
            # CAR/TRUCK/BUS/OTHER_VEHICLE points and instances CAD meshes)
            from infinicube_tpu_torch.utils.cad_car import canonical_car_points
            keep_sem = ~np.isin(sem, np.asarray(CAR_LIKE_IDS))
            xyz_crop, sem = xyz_crop[keep_sem], sem[keep_sem]
            car_id = WAYMO_CATEGORY_NAMES.index("CAR")
            base = canonical_car_points()
            extra, extra_sem = [], []
            for gid, obj in objects.items():
                o2c = world_to_crop @ np.asarray(obj["object_to_world"],
                                                 np.float64)
                lwh = np.asarray(obj["object_lwh"], np.float64)
                if not healthy_boxes(o2c[None], lwh[None], half)[0]:
                    continue
                pts = base * lwh
                pts = pts @ o2c[:3, :3].T + o2c[:3, 3]
                extra.append(pts.astype(np.float32))
                extra_sem.append(np.full(len(pts), car_id, np.int32))
            if extra:
                xyz_crop = np.concatenate([xyz_crop, *extra], axis=0)
                sem = np.concatenate([sem, *extra_sem], axis=0)
        elif cfg.merge_dynamic_points and \
                "dynamic_object_points_canonical" in readers:
            # accumulated dynamic-object LiDAR, posed at this frame's boxes
            # (reference :488-511; static accumulation already lives in pc)
            dr = readers["dynamic_object_points_canonical"]
            canon = decode_member("npz", dr.read("points.npz")) \
                if "points.npz" in dr else {}
            extra, extra_sem = [], []
            for gid, obj in objects.items():
                if not obj.get("dynamic") or f"{gid}_xyz" not in canon:
                    continue
                o2c = world_to_crop @ np.asarray(obj["object_to_world"],
                                                 np.float64)
                pts = np.asarray(canon[f"{gid}_xyz"], np.float64)
                pts = pts @ o2c[:3, :3].T + o2c[:3, 3]
                extra.append(pts.astype(np.float32))
                extra_sem.append(np.full(
                    len(pts), int(canon.get(f"{gid}_semantic", 0)), np.int32))
            if extra:
                xyz_crop = np.concatenate([xyz_crop, *extra], axis=0)
                sem = np.concatenate([sem, *extra_sem], axis=0)

        keep = np.all(np.abs(xyz_crop) <= half, axis=-1)

        sample = {
            DatasetSpec.SHAPE_NAME: scene,
            DatasetSpec.INPUT_PC: xyz_crop[keep].astype(np.float32),
            DatasetSpec.GT_SEMANTIC: sem[keep],
            DatasetSpec.GRID_CROP_RANGE: np.stack(
                [-half, half]).astype(np.float32),
            DatasetSpec.GRID_TO_FIRST_CAMERA_FLU: (
                np.linalg.inv(cam_flu) @ grid_to_world).astype(np.float32),
            DatasetSpec.GRID_TO_WORLD: grid_to_world.astype(np.float32),
        }

        if "map" in readers:
            mp = self._read_frame(readers["map"], frames[0])
            if isinstance(mp, dict):
                maps = {}
                for t in cfg.map_types:
                    if t in mp and len(mp[t]):
                        w = np.asarray(mp[t], np.float64)
                        maps[t] = (w @ world_to_crop[:3, :3].T +
                                   world_to_crop[:3, 3]).astype(np.float32)
                    else:
                        maps[t] = np.zeros((0, 3), np.float32)
                sample[DatasetSpec.MAPS_3D] = maps

        if objects:
            poses = np.asarray(
                [world_to_crop @ np.asarray(o["object_to_world"], np.float64)
                 for o in objects.values()], np.float32)
            lwhs = np.asarray([o["object_lwh"] for o in objects.values()],
                              np.float32)
            ok = healthy_boxes(poses, lwhs, half)
            if ok.any():
                sample[DatasetSpec.BOXES_3D] = {
                    "poses": poses[ok], "lwhs": lwhs[ok]}

        if "image" in readers:
            views = list(cfg.views) if cfg.views else [None]
            imgs, poses_i, Ks, masks, depths = [], [], [], [], []
            pad_h = None
            for f in frames:
                for vi, view in enumerate(views):
                    img = self._read_frame(readers["image"], f, view)
                    pc_pose = self._read_frame(readers["pose"], f, view)
                    K = self._read_frame(readers["intrinsic"], f, view) \
                        if "intrinsic" in readers else None
                    if img is None or pc_pose is None:
                        return None
                    img = np.asarray(img, np.float32) / 255.0
                    if pad_h is None:
                        pad_h = img.shape[0]     # front-view height
                    h, w = img.shape[:2]
                    mask = np.ones((pad_h, w, 4), np.float32)
                    if h < pad_h:                # side view: pad + mask ch2
                        img = np.concatenate(
                            [img, np.zeros((pad_h - h, w, img.shape[2]),
                                           np.float32)], axis=0)
                        mask[h:, :, 2] = 0.0
                    sm = self._read_frame(readers["skymask"], f, view) \
                        if "skymask" in readers else None
                    if sm is not None:
                        mask[:h, :, 0] = (np.asarray(sm)[:h] == 0)
                    dp = self._read_frame(readers[cfg.depth_attr], f, view) \
                        if cfg.depth_attr in readers else None
                    if dp is not None:
                        d = np.asarray(dp, np.float32) / 100.0
                        if d.shape[0] < pad_h:
                            d = np.concatenate(
                                [d, np.zeros((pad_h - d.shape[0], w),
                                             np.float32)], axis=0)
                        depths.append(d[..., None])
                    imgs.append(img)
                    poses_i.append(world_to_crop @
                                   np.asarray(pc_pose, np.float64).reshape(4, 4))
                    kk = np.eye(3, dtype=np.float32)
                    if K is not None:
                        K = np.asarray(K, np.float32)
                        if K.ndim == 2 and K.shape == (3, 3):
                            kk = K            # converter layout: 3x3 matrix
                        elif K.size >= 6:     # fx fy cx cy w h (reference)
                            K = K.ravel()
                            kk = np.array([[K[0], 0, K[2]],
                                           [0, K[1], K[3]],
                                           [0, 0, 1]], np.float32)
                            # rescale to the stored image resolution
                            kk[0] *= w / K[4]
                            kk[1] *= h / K[5]
                    Ks.append(kk)
                    masks.append(mask)
            sample[DatasetSpec.IMAGES_INPUT] = np.stack(imgs)
            sample[DatasetSpec.IMAGES_INPUT_POSE] = np.stack(poses_i).astype(
                np.float32)
            sample[DatasetSpec.IMAGES_INPUT_INTRINSIC] = np.stack(Ks)
            sample[DatasetSpec.IMAGES_INPUT_MASK] = np.stack(masks)
            if depths and len(depths) == len(imgs):
                sample[DatasetSpec.IMAGES_INPUT_DEPTH] = np.stack(depths)
        return sample


def build_dataset(cfg: WaymoDatasetConfig, host_index: int | None = None,
                  num_hosts: int | None = None) -> WaymoClipDataset:
    """The dataset of this process: its rank and the world size where a
    ``torch.distributed`` process group is initialised, else 0 and 1."""
    import torch.distributed as dist
    grouped = dist.is_available() and dist.is_initialized()
    if host_index is None:
        host_index = dist.get_rank() if grouped else 0
    if num_hosts is None:
        num_hosts = dist.get_world_size() if grouped else 1
    return WaymoClipDataset(cfg, host_index=host_index, num_hosts=num_hosts)
