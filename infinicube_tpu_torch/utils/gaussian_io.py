"""3D Gaussian scene serialization: .pkl / .splat / .ply; the port's own
copy of ``infinicube_tpu/utils/gaussian_io.py`` (numpy only), writing the
same bytes: the gaussian dict packaging, the antimatter15 .splat layout (32
bytes a gaussian) and the Inria 3DGS PLY (x/y/z, f_dc_*, opacity, scale_*,
rot_*)."""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

SH_C0 = 0.28209479177387814


def gaussians_to_dict(means, scales, quats, opacities, colors,
                      valid=None) -> dict:
    """Compact numpy dict of the active gaussians."""
    arrs = [np.asarray(a) for a in (means, scales, quats, opacities, colors)]
    if valid is not None:
        v = np.asarray(valid).astype(bool)
        arrs = [a[v] for a in arrs]
    means, scales, quats, opacities, colors = arrs
    return {"means": means.astype(np.float32),
            "scales": scales.astype(np.float32),
            "quats": quats.astype(np.float32),
            "opacities": opacities.astype(np.float32),
            "colors": colors.astype(np.float32)}


def save_pkl(path, gdict: dict):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(gdict, f)


def load_pkl(path) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_splat(path, gdict: dict):
    """antimatter15 .splat: per gaussian 32 bytes —
    float32 xyz, float32 scale xyz, rgba uint8, quat uint8x4."""
    g = gdict
    n = len(g["means"])
    buf = np.zeros((n, 32), np.uint8)
    buf[:, 0:12] = g["means"].astype(np.float32).view(np.uint8).reshape(n, 12)
    buf[:, 12:24] = g["scales"].astype(np.float32).view(np.uint8).reshape(n, 12)
    rgba = np.concatenate([
        np.clip(g["colors"] * 255, 0, 255),
        np.clip(g["opacities"][:, None] * 255, 0, 255)], axis=1)
    buf[:, 24:28] = rgba.astype(np.uint8)
    q = g["quats"] / np.linalg.norm(g["quats"], axis=-1, keepdims=True)
    buf[:, 28:32] = np.clip(q * 128 + 128, 0, 255).astype(np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(buf.tobytes())


def load_splat(path) -> dict:
    raw = np.frombuffer(Path(path).read_bytes(), np.uint8).reshape(-1, 32)
    means = raw[:, 0:12].copy().view(np.float32).reshape(-1, 3)
    scales = raw[:, 12:24].copy().view(np.float32).reshape(-1, 3)
    rgba = raw[:, 24:28].astype(np.float32)
    quats = (raw[:, 28:32].astype(np.float32) - 128.0) / 128.0
    quats = quats / np.linalg.norm(quats, axis=-1, keepdims=True)
    return {"means": means, "scales": scales, "quats": quats,
            "opacities": rgba[:, 3] / 255.0, "colors": rgba[:, :3] / 255.0}


def save_ply(path, gdict: dict):
    """Inria-format 3DGS PLY (log scales, logit opacities, SH DC colors)."""
    g = gdict
    n = len(g["means"])
    names = (["x", "y", "z", "nx", "ny", "nz"] +
             [f"f_dc_{i}" for i in range(3)] + ["opacity"] +
             [f"scale_{i}" for i in range(3)] +
             [f"rot_{i}" for i in range(4)])
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n" +
              "".join(f"property float {m}\n" for m in names) +
              "end_header\n")
    op = np.clip(g["opacities"], 1e-5, 1 - 1e-5)
    data = np.concatenate([
        g["means"], np.zeros((n, 3), np.float32),
        (g["colors"] - 0.5) / SH_C0,
        np.log(op / (1 - op))[:, None],
        np.log(np.maximum(g["scales"], 1e-8)),
        g["quats"]], axis=1).astype("<f4")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(data.tobytes())


def load_ply(path) -> dict:
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode().splitlines()
        n = int([l for l in lines if l.startswith("element vertex")][0]
                .split()[-1])
        props = [l.split()[-1] for l in lines if l.startswith("property")]
        data = np.frombuffer(f.read(), "<f4").reshape(n, len(props))
    col = {p: data[:, i] for i, p in enumerate(props)}
    colors = np.stack([col[f"f_dc_{i}"] for i in range(3)], -1) * SH_C0 + 0.5
    op = 1.0 / (1.0 + np.exp(-col["opacity"]))
    return {"means": np.stack([col["x"], col["y"], col["z"]], -1),
            "scales": np.exp(np.stack([col[f"scale_{i}"] for i in range(3)], -1)),
            "quats": np.stack([col[f"rot_{i}"] for i in range(4)], -1),
            "opacities": op, "colors": np.clip(colors, 0, 1)}
