"""Offline converter from Waymo Open Dataset segments to per-clip
attribute tars; counterpart of ``infinicube_tpu/data_process/waymo2shards.py``.

Per clip, one tar per attribute with members ``{frame:06d}.<ext>``:

- pose and intrinsic (npy; the front camera at ``{frame}.npy``, the other
  cameras at ``{frame}.{view}.npy``), image (png, the same layout);
- pc (npz xyz / semantic);
- static_object_info and dynamic_object_info (json; dynamic = moving more
  than 0.05 m between two frames);
- dynamic_object_points_canonical (points.npz: each moving object's points
  gathered over the clip in its box frame);
- map (npz per polyline type) and the per-type 3d_{lane,road_edge,road_line}
  polyline tars.

Decoding sits behind ``FrameSource``, so the sharding and writing run
without the Waymo environment; the range-image maths is plain numpy.
``WaymoTFRecordSource`` needs tensorflow and waymo-open-dataset:

    python -m infinicube_tpu_torch.data_process.waymo2shards \
        --segments segment-*.tfrecord --output data/waymo"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from infinicube_tpu_torch.data.codec import encode_member
from infinicube_tpu_torch.data.tario import TarWriter

DYNAMIC_MOTION_THRESHOLD = 0.05  # meters between frames => moving object


@dataclasses.dataclass
class FrameRecord:
    """One frame's decoded payload (already in numpy)."""
    index: int
    cam_to_world_opencv: np.ndarray          # [4, 4]
    intrinsic: np.ndarray                    # [3, 3]
    image: np.ndarray | None                 # [H, W, 3] uint8
    points: np.ndarray                       # [N, 3] world
    point_semantics: np.ndarray              # [N]
    objects: dict                            # gid -> {pose, lwh, type}
    map_points: dict                         # type -> [M, 3]
    # type -> list of [Ni, 3] world polylines (lane / road_edge / road_line);
    # populated on the first frame only (map features are per-segment)
    map_polylines: dict | None = None
    # view name -> {"pose": [4,4] OpenCV cam-to-world, "intrinsic": [3,3],
    # "image": [H,W,3] uint8 | None} for the side cameras (reference writes
    # all five: front, front_left, front_right, side_left, side_right)
    cameras: dict | None = None


# ---------------------------------------------------------------------------
# Range-image decoding — pure numpy mirrors of the waymo-open-dataset
# frame_utils math (reference waymo2webdataset.py:233-246 calls
# frame_utils.convert_range_image_to_point_cloud; these reimplementations are
# testable without the TF/waymo env).
# ---------------------------------------------------------------------------

def rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    """[..., 3] (roll, pitch, yaw) -> [..., 3, 3], R = Rz(yaw)Ry(pitch)Rx(roll)."""
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.empty(rpy.shape[:-1] + (3, 3), np.float64)
    R[..., 0, 0] = cy * cp
    R[..., 0, 1] = cy * sp * sr - sy * cr
    R[..., 0, 2] = cy * sp * cr + sy * sr
    R[..., 1, 0] = sy * cp
    R[..., 1, 1] = sy * sp * sr + cy * cr
    R[..., 1, 2] = sy * sp * cr - cy * sr
    R[..., 2, 0] = -sp
    R[..., 2, 1] = cp * sr
    R[..., 2, 2] = cp * cr
    return R


def range_image_polar_angles(H: int, W: int, extrinsic: np.ndarray,
                             beam_inclinations: np.ndarray):
    """(inclination [H], azimuth [W]) of range-image pixels.

    Waymo convention: rows top-to-bottom = inclinations reversed
    (calibration lists them bottom-to-top); columns sweep azimuth right-to-
    left over [-pi, pi) corrected by the sensor extrinsic's yaw."""
    az_correction = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    ratios = (np.arange(W, dtype=np.float64)[::-1] + 0.5) / W
    azimuth = (ratios * 2.0 - 1.0) * np.pi - az_correction
    inclination = np.asarray(beam_inclinations, np.float64)[::-1]
    assert inclination.shape[0] == H
    return inclination, azimuth


def range_image_to_points(range_img: np.ndarray, extrinsic: np.ndarray,
                          beam_inclinations: np.ndarray,
                          pixel_pose: np.ndarray | None = None,
                          frame_pose: np.ndarray | None = None):
    """Spherical range image -> vehicle-frame cartesian points.

    range_img f32[H, W] (channel 0 of the waymo range image; <=0 = no
    return); extrinsic [4,4] sensor->vehicle; beam_inclinations [H]
    bottom-to-top (waymo calibration order); pixel_pose optional [H, W, 6]
    (roll, pitch, yaw, x, y, z) per-pixel vehicle->world transforms for the
    rolling-shutter-corrected TOP lidar — when given, frame_pose [4,4]
    brings the world points back into this frame's vehicle frame.

    Returns (points f32[N, 3] vehicle frame, valid bool[H, W])."""
    H, W = range_img.shape
    inclination, azimuth = range_image_polar_angles(
        H, W, extrinsic, beam_inclinations)
    incl = inclination[:, None]
    az = azimuth[None, :]
    r = range_img.astype(np.float64)
    x = r * np.cos(incl) * np.cos(az)
    y = r * np.cos(incl) * np.sin(az)
    z = r * np.sin(incl)
    sensor = np.stack([x, y, z], axis=-1)                       # [H, W, 3]
    vehicle = sensor @ extrinsic[:3, :3].T + extrinsic[:3, 3]
    if pixel_pose is not None:
        Rp = rpy_to_matrix(pixel_pose[..., :3])                 # [H, W, 3, 3]
        tp = pixel_pose[..., 3:]
        world = np.einsum("hwij,hwj->hwi", Rp, vehicle) + tp
        inv = np.linalg.inv(frame_pose)
        vehicle = world @ inv[:3, :3].T + inv[:3, 3]
    valid = range_img > 0
    return vehicle[valid].astype(np.float32), valid


def waymo_box_to_pose_lwh(center_vcs: np.ndarray, heading: float,
                          dims_lwh: np.ndarray,
                          vehicle_to_world: np.ndarray):
    """laser_label box (vehicle frame, z-heading) -> (object_to_world [4,4],
    lwh [3]) matching the reference's object_info convention
    (waymo2webdataset.py:281-320)."""
    c, s = np.cos(heading), np.sin(heading)
    Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    pose = np.eye(4)
    pose[:3, :3] = vehicle_to_world[:3, :3] @ Rz
    pose[:3, 3] = (vehicle_to_world
                   @ np.array([*center_vcs, 1.0]))[:3]
    return pose, np.asarray(dims_lwh, np.float64)


class FrameSource:
    """Abstract clip decoder; the Waymo TFRecord implementation plugs in
    here (requires the tensorflow/waymo-open-dataset env)."""

    def clips(self) -> Iterable[str]:
        raise NotImplementedError

    def frames(self, clip_id: str) -> Iterator[FrameRecord]:
        raise NotImplementedError


_BOX_TYPES = {1: "vehicle", 2: "pedestrian", 3: "sign", 4: "cyclist"}


class WaymoTFRecordSource(FrameSource):
    """Decodes Waymo Open Dataset v1.4+ segment TFRecords (front camera +
    TOP lidar, both returns, 3D seg labels when present, laser_labels boxes,
    map features). Mirrors reference waymo2webdataset.py:87-766; requires
    the TF/waymo env only at the proto layer (README/env.md:3-40) — the
    geometry is the pure-numpy helpers above."""

    FRONT_CAMERA = 1   # dataset_pb2.CameraName.FRONT
    CAMERA_NAMES = {1: "front", 2: "front_left", 3: "front_right",
                    4: "side_left", 5: "side_right"}
    TOP_LIDAR = 1      # dataset_pb2.LaserName.TOP

    def __init__(self, segment_files: list[str]):
        self.segment_files = segment_files

    def clips(self):
        return [Path(p).stem for p in self.segment_files]

    # ---- proto decoding helpers (waymo env only) --------------------------
    @staticmethod
    def _matrix(compressed, proto_cls) -> np.ndarray:
        import zlib
        m = proto_cls()
        m.ParseFromString(zlib.decompress(compressed))
        return np.asarray(m.data, np.float32).reshape(list(m.shape.dims))

    def _decode_lidar(self, frame, dataset_pb2):
        """TOP lidar, both returns -> (points_vehicle [N,3], semantics [N])."""
        calib = next(c for c in frame.context.laser_calibrations
                     if c.name == self.TOP_LIDAR)
        laser = next(l for l in frame.lasers if l.name == self.TOP_LIDAR)
        extrinsic = np.asarray(calib.extrinsic.transform).reshape(4, 4)
        frame_pose = np.asarray(frame.pose.transform).reshape(4, 4)

        pts_all, sem_all = [], []
        for i, ret in enumerate((laser.ri_return1, laser.ri_return2)):
            if not ret.range_image_compressed:
                continue
            ri = self._matrix(ret.range_image_compressed,
                              dataset_pb2.MatrixFloat)
            H, W = ri.shape[:2]
            incl = np.asarray(calib.beam_inclinations, np.float64)
            if incl.size == 0:  # uniform fallback per waymo spec
                incl = np.linspace(calib.beam_inclination_min,
                                   calib.beam_inclination_max, H)
            pixel_pose = None
            if i == 0 and laser.ri_return1.range_image_pose_compressed:
                pixel_pose = self._matrix(
                    laser.ri_return1.range_image_pose_compressed,
                    dataset_pb2.MatrixFloat)
            pts, valid = range_image_to_points(
                ri[..., 0], extrinsic, incl,
                pixel_pose=pixel_pose, frame_pose=frame_pose)
            sem = np.zeros(len(pts), np.int32)
            if ret.segmentation_label_compressed:
                seg = self._matrix(ret.segmentation_label_compressed,
                                   dataset_pb2.MatrixInt32)
                sem = seg[..., 1][valid].astype(np.int32)
            pts_all.append(pts)
            sem_all.append(sem)
        if not pts_all:
            return np.zeros((0, 3), np.float32), np.zeros((0,), np.int32)
        return np.concatenate(pts_all), np.concatenate(sem_all)

    @staticmethod
    def _decode_map(frame) -> dict:
        """frame.map_features -> {type: [polyline [Ni,3] world, ...]}
        (reference extract_map_data, waymo2webdataset.py:365-430)."""
        polys: dict[str, list] = {"lane": [], "road_edge": [], "road_line": []}
        off = np.zeros(3)
        if frame.HasField("map_pose_offset"):
            off = np.array([frame.map_pose_offset.x, frame.map_pose_offset.y,
                            frame.map_pose_offset.z])
        for feat in frame.map_features:
            for kind in polys:
                if feat.HasField(kind):
                    pl = getattr(feat, kind).polyline
                    if len(pl):
                        polys[kind].append(np.asarray(
                            [[p.x, p.y, p.z] for p in pl]) + off)
        return polys

    def frames(self, clip_id: str):  # pragma: no cover - needs waymo env
        try:
            import tensorflow as tf
            from waymo_open_dataset import dataset_pb2
        except ImportError as e:
            raise RuntimeError(
                "waymo-open-dataset env required for TFRecord decoding "
                "(reference README/env.md:3-40)") from e
        from infinicube_tpu_torch.camera.conventions import flu_to_opencv

        path = next(p for p in self.segment_files
                    if Path(p).stem == clip_id)
        for idx, data in enumerate(
                tf.data.TFRecordDataset(path, compression_type="")):
            frame = dataset_pb2.Frame()
            frame.ParseFromString(bytes(data.numpy()))
            vehicle_to_world = np.asarray(
                frame.pose.transform).reshape(4, 4)

            # all five cameras: pose (waymo cam frame is FLU) + intrinsics
            cameras = {}
            for calib in frame.context.camera_calibrations:
                view = self.CAMERA_NAMES.get(calib.name)
                if view is None:
                    continue
                cam_to_vehicle = np.asarray(
                    calib.extrinsic.transform).reshape(4, 4)
                f_u, f_v, c_u, c_v = calib.intrinsic[:4]
                Kv = np.array([[f_u, 0, c_u], [0, f_v, c_v], [0, 0, 1]])
                img_proto = next((im for im in frame.images
                                  if im.name == calib.name), None)
                cameras[view] = {
                    "pose": flu_to_opencv(
                        vehicle_to_world @ cam_to_vehicle).astype(np.float32),
                    "intrinsic": Kv.astype(np.float32),
                    "image": None if img_proto is None else np.asarray(
                        tf.io.decode_jpeg(img_proto.image).numpy()),
                }
            front = cameras.get("front", {})
            cam_to_world = front.get("pose", np.eye(4, dtype=np.float32))
            K = front.get("intrinsic", np.eye(3, dtype=np.float32))
            image = front.get("image")

            pts_vehicle, sem = self._decode_lidar(frame, dataset_pb2)
            pts_world = pts_vehicle @ vehicle_to_world[:3, :3].T + \
                vehicle_to_world[:3, 3]

            objects = {}
            for label in frame.laser_labels:
                pose, lwh = waymo_box_to_pose_lwh(
                    np.array([label.box.center_x, label.box.center_y,
                              label.box.center_z]),
                    label.box.heading,
                    np.array([label.box.length, label.box.width,
                              label.box.height]),
                    vehicle_to_world)
                objects[label.id] = {
                    "pose": pose, "lwh": lwh,
                    "type": _BOX_TYPES.get(label.type, "unknown")}

            map_polys = self._decode_map(frame) if idx == 0 else None
            map_pts = {}
            if map_polys:
                map_pts = {k: (np.concatenate(v) if v else
                               np.zeros((0, 3), np.float32))
                           for k, v in map_polys.items()}
            yield FrameRecord(
                index=idx, cam_to_world_opencv=cam_to_world.astype(np.float32),
                intrinsic=K.astype(np.float32), image=image,
                points=pts_world.astype(np.float32), point_semantics=sem,
                objects=objects, map_points=map_pts,
                map_polylines=map_polys, cameras=cameras)


def classify_objects_dynamic(frames: list[FrameRecord]) -> set:
    """gids whose center moves > threshold between any adjacent frames."""
    tracks: dict[str, list[np.ndarray]] = {}
    for fr in frames:
        for gid, obj in fr.objects.items():
            tracks.setdefault(gid, []).append(
                np.asarray(obj["pose"])[:3, 3])
    dynamic = set()
    for gid, centers in tracks.items():
        c = np.asarray(centers)
        if len(c) > 1 and np.linalg.norm(np.diff(c, axis=0), axis=-1).max() \
                > DYNAMIC_MOTION_THRESHOLD:
            dynamic.add(gid)
    return dynamic


def convert_clip(source: FrameSource, clip_id: str, output_root: Path,
                 write_images: bool = True):
    """Write one clip's attribute tars."""
    frames = list(source.frames(clip_id))
    dynamic_gids = classify_objects_dynamic(frames)
    writers = {}

    def w(attr) -> TarWriter:
        if attr not in writers:
            writers[attr] = TarWriter(output_root / attr / f"{clip_id}.tar")
        return writers[attr]

    # stable int ids: static from 1, dynamic from 10000 (instance convention)
    all_gids = sorted({g for fr in frames for g in fr.objects})
    id_map = {}
    s_next, d_next = 1, 10000
    for g in all_gids:
        if g in dynamic_gids:
            id_map[g], d_next = d_next, d_next + 1
        else:
            id_map[g], s_next = s_next, s_next + 1

    # accumulate per-dynamic-object points in the object's canonical (box)
    # frame across the whole clip (the reference's
    # dynamic_object_points_canonical.npz, consumed by WaymoWdsDataset's
    # accumulated-LiDAR dynamic merge, waymo_wds.py:488-511)
    dyn_pts: dict[str, list] = {g: [] for g in dynamic_gids}
    dyn_sem: dict[str, list] = {g: [] for g in dynamic_gids}
    for fr in frames:
        for gid in dynamic_gids:
            obj = fr.objects.get(gid)
            if obj is None or len(fr.points) == 0:
                continue
            w2o = np.linalg.inv(np.asarray(obj["pose"], np.float64))
            local = fr.points @ w2o[:3, :3].T + w2o[:3, 3]
            half = np.asarray(obj["lwh"], np.float64) / 2 + 0.05
            inside = np.all(np.abs(local) <= half, axis=-1)
            if inside.any():
                dyn_pts[gid].append(local[inside].astype(np.float32))
                dyn_sem[gid].append(fr.point_semantics[inside])

    try:
        canon = {}
        for gid in dynamic_gids:
            if not dyn_pts[gid]:
                continue
            xyz = np.concatenate(dyn_pts[gid], axis=0)
            if len(xyz) > 20000:            # bound per-object accumulation
                xyz = xyz[np.random.default_rng(0).choice(
                    len(xyz), 20000, replace=False)]
            sem = np.concatenate(dyn_sem[gid])
            vals, counts = np.unique(sem, return_counts=True)
            # keyed by the raw gid so the dataset can join against the
            # dynamic_object_info.json entries of any frame
            canon[f"{gid}_xyz"] = xyz
            canon[f"{gid}_semantic"] = np.int32(vals[counts.argmax()])
        if canon:
            w("dynamic_object_points_canonical").add(
                "points.npz", encode_member("npz", canon))

        for fr in frames:
            key = f"{fr.index:06d}"
            w("pose").add(f"{key}.npy", encode_member(
                "npy", fr.cam_to_world_opencv.astype(np.float32)))
            w("intrinsic").add(f"{key}.npy", encode_member(
                "npy", fr.intrinsic.astype(np.float32)))
            if write_images and fr.image is not None:
                w("image").add(f"{key}.png", encode_member("png", fr.image))
            # per-view members (reference writes all five cameras;
            # WaymoClipDataset reads {frame}.{view}.<ext> when views are
            # configured)
            for view, cam in (fr.cameras or {}).items():
                if view == "front":
                    continue  # legacy members above are the front camera
                w("pose").add(f"{key}.{view}.npy", encode_member(
                    "npy", cam["pose"]))
                w("intrinsic").add(f"{key}.{view}.npy", encode_member(
                    "npy", cam["intrinsic"]))
                if write_images and cam.get("image") is not None:
                    w("image").add(f"{key}.{view}.png",
                                   encode_member("png", cam["image"]))
            w("pc").add(f"{key}.npz", encode_member(
                "npz", {"xyz": fr.points.astype(np.float32),
                        "semantic": fr.point_semantics.astype(np.int32)}))
            stat, dyn = {}, {}
            for gid, obj in fr.objects.items():
                rec = {"object_to_world": np.asarray(obj["pose"]).tolist(),
                       "object_lwh": list(map(float, obj["lwh"])),
                       "object_is_moving": gid in dynamic_gids,
                       "object_type": obj.get("type", "car"),
                       "object_id_int": id_map[gid]}
                (dyn if gid in dynamic_gids else stat)[gid] = rec
            w("static_object_info").add(f"{key}.json",
                                        encode_member("json", stat))
            w("dynamic_object_info").add(f"{key}.json",
                                         encode_member("json", dyn))
            w("map").add(f"{key}.npz", encode_member(
                "npz", {k: np.asarray(v, np.float32)
                        for k, v in fr.map_points.items()}))
            if fr.map_polylines:
                # per-type polyline tars (reference 3d_lane / 3d_road_edge /
                # 3d_road_line layout consumed by the attribute generator)
                for kind, polys in fr.map_polylines.items():
                    w(f"3d_{kind}").add(
                        f"{kind}.json",
                        encode_member("json", [np.asarray(p).tolist()
                                               for p in polys]))
    finally:
        for tw in writers.values():
            tw.close()


def convert(source: FrameSource, output_root: str | Path, node_rank: int = 0,
            num_nodes: int = 1):
    """Node-split conversion (the reference's multiproc node_split)."""
    output_root = Path(output_root)
    for i, clip in enumerate(source.clips()):
        if i % num_nodes != node_rank:
            continue
        convert_clip(source, clip, output_root)


def main(argv=None):  # pragma: no cover - needs waymo env
    ap = argparse.ArgumentParser()
    ap.add_argument("--segments", nargs="+", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--node_rank", type=int, default=0)
    ap.add_argument("--num_nodes", type=int, default=1)
    args = ap.parse_args(argv)
    convert(WaymoTFRecordSource(args.segments), args.output, args.node_rank,
            args.num_nodes)


if __name__ == "__main__":
    main()
