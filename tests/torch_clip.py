"""A small synthetic Waymo clip for the port's data-path tests, made from
a seed with numpy (the scene of tests/test_real_data_train.py with three
cameras and map polylines): per frame a ground plane, a wall ahead, a car
driving and one parked, the front camera and two side cameras, map points,
and on the first frame the lane, road-edge and road-line polylines."""

import numpy as np

VIEWS = ("front", "front_left", "front_right")
HW = (48, 64)


def _cam_pose(x, yaw):
    """OpenCV camera-to-world looking along +x turned by ``yaw``."""
    c, s = np.cos(yaw), np.sin(yaw)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    T = np.eye(4)
    T[:3, :3] = rz @ np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]],
                              np.float64)
    T[:3, 3] = [x, 0, 1.5]
    return T


def frames(FrameRecord, n=4, seed=0, n_ground=2000):
    rng = np.random.default_rng(seed)
    h, w = HW
    K = np.array([[60.0, 0, w / 2], [0, 60, h / 2], [0, 0, 1]], np.float32)
    polylines = {
        "lane": [np.stack([np.linspace(-5, 30, 12), np.zeros(12),
                           np.zeros(12)], -1)],
        "road_edge": [np.stack([np.linspace(-5, 30, 12), np.full(12, e),
                                rng.normal(0, 0.02, 12)], -1)
                      for e in (-6.0, 6.0)],
        "road_line": [np.stack([np.linspace(-5, 30, 8), np.full(8, 2.0),
                                np.zeros(8)], -1)],
    }
    out = []
    for f in range(n):
        ground = np.stack([rng.uniform(-5, 30, n_ground),
                           rng.uniform(-10, 10, n_ground),
                           rng.normal(0, 0.03, n_ground)], -1)
        wall = np.stack([np.full(500, 25.0) + rng.normal(0, 0.05, 500),
                         rng.uniform(-10, 10, 500),
                         rng.uniform(0, 5, 500)], -1)
        car_pose = np.eye(4)
        car_pose[:3, 3] = [8.0 + f * 1.0, 2.0, 0.7]
        car_local = rng.uniform(-0.45, 0.45, (300, 3)) * [4.0, 1.9, 1.4]
        car = car_local @ car_pose[:3, :3].T + car_pose[:3, 3]
        pts = np.concatenate([ground, wall, car]).astype(np.float32)
        sem = np.concatenate([np.full(n_ground, 18), np.full(500, 14),
                              np.full(300, 1)]).astype(np.int32)
        cams = {}
        for v, yaw in zip(VIEWS, (0.0, 0.6, -0.6)):
            cams[v] = {"pose": _cam_pose(f * 2.0, yaw).astype(np.float32),
                       "intrinsic": K,
                       "image": rng.integers(0, 255, (h, w, 3)).astype(
                           np.uint8)}
        out.append(FrameRecord(
            index=f, cam_to_world_opencv=cams["front"]["pose"],
            intrinsic=K, image=cams["front"]["image"], points=pts,
            point_semantics=sem,
            objects={"car1": {"pose": car_pose, "lwh": [4.0, 1.9, 1.4],
                              "type": "car"},
                     "parked": {"pose": np.asarray(
                         [[1, 0, 0, 15.0], [0, 1, 0, -3.0],
                          [0, 0, 1, 0.7], [0, 0, 0, 1]], np.float64),
                         "lwh": [4.2, 1.9, 1.5], "type": "car"}},
            map_points={"road_edge": ground[:50].astype(np.float32),
                        "road_line": ground[50:90].astype(np.float32),
                        "road_surface": ground[:200].astype(np.float32)},
            map_polylines=polylines if f == 0 else None, cameras=cams))
    return out


class Source:
    """A FrameSource over fixed frames."""

    def __init__(self, clips):
        self._clips = clips

    def clips(self):
        return list(self._clips)

    def frames(self, clip_id):
        return iter(self._clips[clip_id])


def make_root(root, FrameRecord, convert_clip, process_clip, clips=("clip0",),
              n=4, seed=0, **process_kw):
    """Convert and process ``clips`` (one seed each) under ``root``."""
    src = Source({c: frames(FrameRecord, n, seed + i)
                  for i, c in enumerate(clips)})
    for c in clips:
        convert_clip(src, c, root)
        process_clip(root, c, write_buffers=False, **process_kw)
    return root
