"""Panorama / sky direction math; counterpart of
``infinicube_tpu/utils/sky_math.py``: direction <-> lat-long and sky
lat-long uv, panorama and cubemap sampling, and the skybox files read
beside a saved gaussian scene. Directions are FLU world vectors (x forward,
y left, z up).

The direction functions take torch tensors or numpy arrays: numpy in gives
numpy out (computed by torch on the CPU in the arrays' dtype)."""

from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np
import torch


def _numpy_io(fn):
    """Run ``fn`` on torch tensors: numpy arguments go to the device of the
    first tensor argument (or stay on the CPU, and the result comes back as
    numpy, when every array argument is numpy)."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   None)
        conv = [torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray)
                else a for a in args]
        out = fn(*conv, **kw)
        return out.numpy() if dev is None else out
    return wrapped


def _unit(d: torch.Tensor) -> torch.Tensor:
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(
        1e-8)


@_numpy_io
def direction_to_latlong_uv(d):
    """Unit directions (..., 3) -> equirect uv in [0,1]^2. u wraps azimuth
    (atan2(y, x)), v maps zenith: z=+1 (up) -> v=0."""
    n = _unit(d)
    az = torch.atan2(n[..., 1], n[..., 0])              # [-pi, pi]
    el = torch.acos(n[..., 2].clamp(-1.0, 1.0))         # [0, pi], 0 = up
    return torch.stack([(az + math.pi) / (2 * math.pi), el / math.pi], -1)


@_numpy_io
def latlong_uv_to_direction(uv):
    """Inverse of direction_to_latlong_uv."""
    az = uv[..., 0] * (2 * math.pi) - math.pi
    el = uv[..., 1] * math.pi
    s = torch.sin(el)
    return torch.stack([s * torch.cos(az), s * torch.sin(az), torch.cos(el)],
                       -1)


@_numpy_io
def direction_to_skylatlong_uv(d):
    """Sky-only variant: v spans just the upper hemisphere (z >= 0)."""
    n = _unit(d)
    az = torch.atan2(n[..., 1], n[..., 0])
    el = torch.acos(n[..., 2].clamp(0.0, 1.0))          # clamp below horizon
    return torch.stack([(az + math.pi) / (2 * math.pi), el / (math.pi / 2)],
                       -1)


def _bilinear(img, u, v, lookup):
    """Bilinear lookup at clipped texel coords: img(v, u) through
    ``lookup``."""
    H, W = img.shape[-3:-1]
    u = u.clamp(0, W - 1.001)
    v = v.clamp(0, H - 1.001)
    u0, v0 = torch.floor(u).long(), torch.floor(v).long()
    du, dv = (u - u0)[..., None], (v - v0)[..., None]
    u1, v1 = (u0 + 1).clamp_max(W - 1), (v0 + 1).clamp_max(H - 1)
    return (lookup(v0, u0) * (1 - du) * (1 - dv) +
            lookup(v0, u1) * du * (1 - dv) +
            lookup(v1, u0) * (1 - du) * dv + lookup(v1, u1) * du * dv)


@_numpy_io
def sample_panorama(pano, dirs, mapping: str = "latlong"):
    """Bilinear panorama lookup. pano [H, W, C]; dirs (..., 3)."""
    H, W = pano.shape[:2]
    uv = direction_to_latlong_uv(dirs) if mapping == "latlong" else \
        direction_to_skylatlong_uv(dirs)
    pano = pano.to(uv.dtype)
    return _bilinear(pano, uv[..., 0] * (W - 1), uv[..., 1] * (H - 1),
                     lambda v, u: pano[v, u])


def render_panorama(sample_fn, hw: tuple[int, int] = (256, 512),
                    mapping: str = "latlong") -> np.ndarray:
    """Bake a sky model into an equirect panorama image. sample_fn(dirs
    (..., 3) numpy) -> rgb (..., 3), numpy or a tensor."""
    H, W = hw
    u = (np.arange(W) + 0.5) / W
    v = (np.arange(H) + 0.5) / H
    uu, vv = np.meshgrid(u, v, indexing="xy")
    uv = np.stack([uu, vv], -1)
    if mapping == "skylatlong":
        uv[..., 1] *= 0.5  # upper hemisphere only
    out = sample_fn(latlong_uv_to_direction(uv))
    return out.detach().cpu().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)


def save_skybox(path, pano: np.ndarray):
    """Persist a baked panorama (npz)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, panorama=np.asarray(pano, np.float32))


def load_skybox(path) -> np.ndarray:
    return np.load(path)["panorama"]


@_numpy_io
def cubemap_face_uv_to_direction(face: int, uv):
    """Cubemap face (+x,-x,+y,-y,+z,-z = 0..5) + uv in [0,1]^2 -> direction."""
    a = uv[..., 0] * 2 - 1
    b = uv[..., 1] * 2 - 1
    one = torch.ones_like(a)
    table = [(one, -a, -b), (-one, a, -b), (a, one, -b), (-a, -one, -b),
             (b, a, one), (-b, a, -one)]
    return _unit(torch.stack(table[face], -1))


@_numpy_io
def sample_cubemap(faces, dirs):
    """Bilinear cubemap lookup. faces [6, S, S, C]; dirs (..., 3)."""
    n = _unit(dirs)
    x, y, z = n.unbind(-1)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    xdom = (ax >= ay) & (ax >= az)
    ydom = ay >= az
    # dominant axis -> face id matching cubemap_face_uv_to_direction
    face = torch.where(xdom, torch.where(x > 0, 0, 1),
                       torch.where(ydom, torch.where(y > 0, 2, 3),
                                   torch.where(z > 0, 4, 5)))
    denom = torch.where(xdom, ax, torch.where(ydom, ay, az))
    xs, ys, zs = x / denom, y / denom, z / denom

    def pick(choices):
        out = choices[-1]
        for f in range(4, -1, -1):
            out = torch.where(face == f, choices[f], out)
        return out

    a = pick([-ys, ys, xs, -xs, ys, ys])
    b = pick([-zs, -zs, -zs, -zs, xs, -xs])
    S = faces.shape[1]
    faces = faces.to(n.dtype)
    return _bilinear(faces, (a + 1) / 2 * (S - 1), (b + 1) / 2 * (S - 1),
                     lambda v, u: faces[face, v, u])


def camera_dirs_from_fov(camera_to_world, height, width, vfov, hfov):
    """FLU world ray directions through a FoV-specified pinhole (numpy)."""
    fx = width / (2 * np.tan(np.radians(hfov) / 2))
    fy = height / (2 * np.tan(np.radians(vfov) / 2))
    u = np.arange(width) + 0.5
    v = np.arange(height) + 0.5
    uu, vv = np.meshgrid(u, v, indexing="xy")
    d_cam = np.stack([(uu - width / 2) / fx, (vv - height / 2) / fy,
                      np.ones_like(uu)], -1)
    R = np.asarray(camera_to_world)[:3, :3]
    d = d_cam @ R.T
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def read_skybox(gaussian_model_path, white_bg: bool = False) -> dict:
    """Read the skybox saved beside a gaussian model. Recognized siblings
    of ``<stem>.{ply,pkl,splat}``:
      <stem>_pano.npz / _pano.png (+ _pano_mask.png)  -> rgb_panorama
      <stem>_cubemap.npz (faces [6,S,S,3])            -> rgb_cubemap
      <stem>_sky_token.npy + _modulator.npz           -> sky_modulator
    Fallback: black panorama (white when white_bg)."""
    from infinicube_tpu_torch.data.codec import decode_member
    stem = Path(gaussian_model_path).with_suffix("")
    if white_bg:
        return {"type": "rgb_panorama",
                "panorama": np.ones((64, 128, 3), np.float32),
                "panorama_mask": np.zeros((64, 128), np.float32)}

    def sibling(suffix):
        return stem.parent / (stem.name + suffix)

    pano_npz, pano_png = sibling("_pano.npz"), sibling("_pano.png")
    cubemap = sibling("_cubemap.npz")
    token, modulator = sibling("_sky_token.npy"), sibling("_modulator.npz")
    if pano_npz.exists() or pano_png.exists():
        if pano_npz.exists():
            pano = np.load(pano_npz)["panorama"].astype(np.float32)
        else:
            pano = np.asarray(decode_member(
                "png", pano_png.read_bytes()), np.float32) / 255.0
        mask_p = sibling("_pano_mask.png")
        if mask_p.exists():
            mask = np.asarray(decode_member(
                "png", mask_p.read_bytes()), np.float32) / 255.0
        else:
            mask = np.zeros(pano.shape[:2], np.float32)
        return {"type": "rgb_panorama", "panorama": pano,
                "panorama_mask": mask}
    if cubemap.exists():
        return {"type": "rgb_cubemap",
                "cubemap": np.load(cubemap)["faces"].astype(np.float32)}
    if token.exists() and modulator.exists():
        loaded = np.load(modulator, allow_pickle=True)
        return {"type": "sky_modulator",
                "sky_token": np.load(token),
                "modulator_params": loaded["params"].item()
                if "params" in loaded else dict(loaded)}
    return {"type": "rgb_panorama",
            "panorama": np.zeros((64, 128, 3), np.float32),
            "panorama_mask": np.zeros((64, 128), np.float32)}


def render_sky_api(skybox_dict: dict, camera_to_world, height: int,
                   width: int, vfov: float, hfov: float) -> np.ndarray:
    """Render the sky for one camera: dispatches on the skybox type; a
    panorama of shape H x 4H is sky lat-long (hemisphere), H x 2H full
    lat-long. A ``sky_modulator`` skybox carries the flax-layout parameters
    of the sky model, converted by ``weights.from_jax.gsm_from_jax``."""
    dirs = camera_dirs_from_fov(camera_to_world, height, width, vfov, hfov)
    kind = skybox_dict["type"]
    if kind == "rgb_panorama":
        pano = skybox_dict["panorama"]
        mapping = "skylatlong" if pano.shape[1] == 4 * pano.shape[0] \
            else "latlong"
        return np.asarray(sample_panorama(pano, dirs, mapping)).clip(0, 1)
    if kind == "rgb_cubemap":
        return np.asarray(
            sample_cubemap(skybox_dict["cubemap"], dirs)).clip(0, 1)
    if kind == "sky_modulator":
        from infinicube_tpu_torch.models.gsm.sky import (SkyboxMlpModulator,
                                                         SkyConfig)
        from infinicube_tpu_torch.weights.from_jax import gsm_from_jax
        mod = SkyboxMlpModulator(skybox_dict.get("config") or SkyConfig())
        # the file may hold only the sampling MLP's parameters
        sd = gsm_from_jax(skybox_dict["modulator_params"])
        missing = set(mod.state_dict()) - set(sd)
        if any(k.split(".")[0] in SkyboxMlpModulator.SAMPLE_PARTS
               for k in missing):
            raise KeyError(f"sky modulator parameters missing: "
                           f"{sorted(missing)}")
        mod.load_state_dict(sd, strict=False)
        with torch.inference_mode():
            rgb = mod.sample(torch.as_tensor(skybox_dict["sky_token"],
                                             dtype=torch.float32),
                             torch.as_tensor(dirs, dtype=torch.float32))
        return rgb.numpy().clip(0, 1)
    raise NotImplementedError(kind)
