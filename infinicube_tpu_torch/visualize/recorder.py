"""Camera-trajectory recorder; counterpart of
``infinicube_tpu/visualize/recorder.py``: capture key camera poses,
interpolate a smooth trajectory (1 pose -> still, 2 -> uniform two-pose
interpolation, 3+ -> spline ``inter_poses``), render each frame through a
user render function, and persist poses and frames. ``attach_viser``
recreates the interactive workflow (a Recording checkbox and an "add
keyframe" button) when a viser server is handed to it; nothing here imports
viser."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from infinicube_tpu_torch.utils.interpolate import (
    inter_poses, interpolate_two_poses, quat_to_rot)


def pose_from_wxyz_position(wxyz, position) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_to_rot(np.asarray(wxyz, np.float64))
    T[:3, 3] = np.asarray(position, np.float64)
    return T


class TrajectoryRecorder:
    """Keyframe capture -> interpolated trajectory -> rendered video."""

    def __init__(self):
        self.key_poses: list[np.ndarray] = []

    # ---- keyframes --------------------------------------------------------
    def add_keyframe(self, pose: np.ndarray | None = None, *, wxyz=None,
                     position=None):
        """Add a camera-to-world keyframe (4x4, or viser-style
        wxyz+position)."""
        if pose is None:
            pose = pose_from_wxyz_position(wxyz, position)
        self.key_poses.append(np.asarray(pose, np.float64))

    def clear(self):
        self.key_poses.clear()

    # ---- trajectory -------------------------------------------------------
    def interpolate(self, num_frames: int = 120) -> np.ndarray:
        """[N, 4, 4] trajectory by keyframe count: 1 -> still frame, 2 ->
        uniform two-pose interpolation, 3+ -> smooth multi-pose spline."""
        k = len(self.key_poses)
        if k == 0:
            raise ValueError("no keyframes recorded")
        if k == 1:
            return np.repeat(self.key_poses[0][None], 1, axis=0)
        if k == 2:
            return interpolate_two_poses(self.key_poses[0],
                                         self.key_poses[1], num_frames)
        return inter_poses(np.stack(self.key_poses), num_frames)

    # ---- persistence ------------------------------------------------------
    def save_poses(self, path, poses: np.ndarray | None = None):
        poses = self.interpolate() if poses is None else poses
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        np.save(path, np.asarray(poses, np.float32))
        return poses

    @staticmethod
    def load_poses(path) -> np.ndarray:
        """Load a previously saved interpolated-pose .npy."""
        return np.load(path)

    # ---- recording --------------------------------------------------------
    def record(self, render_fn, num_frames: int = 120, out_path=None,
               poses: np.ndarray | None = None, fps: int = 30):
        """Render every trajectory pose: render_fn(pose [4,4]) -> HWC uint8/
        float image. Saves an .mp4 when imageio+ffmpeg are available, else
        an .npz frame stack beside ``out_path``."""
        poses = self.interpolate(num_frames) if poses is None else poses
        frames = []
        for T in poses:
            img = np.asarray(render_fn(T))
            if img.dtype != np.uint8:
                img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            frames.append(img)
        frames = np.stack(frames)
        if out_path is not None:
            out_path = Path(out_path)
            out_path.parent.mkdir(parents=True, exist_ok=True)
            try:
                import imageio.v3 as iio
                iio.imwrite(out_path.with_suffix(".mp4"), frames, fps=fps)
            except Exception:
                np.savez_compressed(out_path.with_suffix(".npz"),
                                    frames=frames,
                                    poses=poses.astype(np.float32))
        return frames, poses

    # ---- optional interactive hookup -------------------------------------
    def attach_viser(self, server):
        """Recreate the interactive workflow on a viser server: a
        Recording checkbox, an 'Add keyframe' button capturing the client
        camera, and a 'Finish' button returning the interpolated poses via
        ``self.last_trajectory``."""
        self.last_trajectory = None
        rec = server.gui.add_checkbox("Recording", initial_value=False)
        add = server.gui.add_button("Add keyframe")
        fin = server.gui.add_button("Finish (interpolate)")

        @add.on_click
        def _(event):
            if not rec.value:
                return
            cam = event.client.camera
            self.add_keyframe(wxyz=cam.wxyz, position=cam.position)

        @fin.on_click
        def _(event):
            if self.key_poses:
                self.last_trajectory = self.interpolate()
        return rec, add, fin
