"""Artifact file formats; counterpart of ``infinicube_tpu/utils/fileio.py``:
video write and read, and the stage-1 hand-off grid file."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_video(path, frames: np.ndarray, fps: int = 10):
    """frames uint8 [T, H, W, 3]. Through imageio where it is installed;
    otherwise (the card's machine has neither imageio nor PIL) as png
    frames in a directory beside the target (``<stem>/000000.png``...),
    the reference's last resort, encoded by ``data.codec.encode_png``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    frames = np.ascontiguousarray(frames)
    try:
        import imageio.v3 as iio
        iio.imwrite(path, frames, fps=fps)
        return
    except Exception:
        pass
    try:
        import imageio
        w = imageio.get_writer(path, fps=fps)
        for f in frames:
            w.append_data(f)
        w.close()
        return
    except Exception:
        pass
    from infinicube_tpu_torch.data.codec import encode_png
    d = path.with_suffix("")
    d.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        (d / f"{i:06d}.png").write_bytes(encode_png(f))


def read_video(path) -> np.ndarray:
    """-> uint8 [T, H, W, 3]. Through imageio where it is installed and the
    file exists; otherwise from the directory of png frames that
    ``write_video`` falls back to (``<stem>/000000.png``...), decoded by
    ``data.codec.decode_png``."""
    path = Path(path)
    frames = path.with_suffix("")
    try:
        import imageio
    except ImportError:
        imageio = None
    if (imageio is None or not path.exists()) and frames.is_dir():
        from infinicube_tpu_torch.data.codec import decode_png
        return np.stack([decode_png(p.read_bytes())
                         for p in sorted(frames.glob("*.png"))])
    if imageio is None:
        raise ModuleNotFoundError(
            f"reading {path} needs imageio, and no frame directory "
            f"{frames} exists")
    try:
        import imageio.v3 as iio
        return np.asarray(iio.imread(path, plugin="pyav"))
    except Exception:
        r = imageio.get_reader(path)
        return np.stack([np.asarray(f) for f in r])


def save_grid_semantic(path, ijk: np.ndarray, semantics: np.ndarray,
                       voxel_size, origin):
    """Stage-1 hand-off file (npz): voxel coordinates and their labels."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, ijk=ijk.astype(np.int64),
                        semantics=semantics.astype(np.int32),
                        voxel_size=np.asarray(voxel_size, np.float64),
                        origin=np.asarray(origin, np.float64))


def load_grid_semantic(path):
    d = np.load(path)
    return (d["ijk"], d["semantics"], d["voxel_size"], d["origin"])
