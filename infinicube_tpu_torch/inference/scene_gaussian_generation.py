"""Stage-3 CLI: lift the video, voxels and buffers into a 3D Gaussian
scene; counterpart of
``infinicube_tpu/inference/scene_gaussian_generation.py``.

Loads the stage-2 buffer folder (the voxel world ``world.npz``, the pose /
intrinsic / depth / instance tars, the video as ``video.mp4`` or as the
directory of png frames that ``utils.fileio.write_video`` falls back to),
builds the 4-channel GSM masks (sky from the SegFormer with
``--segformer-ckpt``, else from the depth buffer: depth == 0;
dynamic pixels from instance ids >= 10000), runs the static reconstruction
with the buffer depth as the pixel branch's prior, then the dynamic pass:
every pixel's gaussians (``decode_all_pixels``), kept per dynamic instance
id. Saves decoded_gs_static.pkl / .splat, decoded_gs_object.pkl and a
first-view composite png.

    python -m infinicube_tpu_torch.inference.scene_gaussian_generation \\
        --buffer_folder out/buffers --output out/scene [--num_frames 16] \\
        [--max_views 8] [--device cpu]

The model has random weights (no checkpoint is ported yet) and runs on
``--device`` (default ``cuda``); without a card the CLI raises unless
``--device cpu`` is given. The scene grid keeps at most 2^18 voxels, as
the reference's: a larger world drops its highest keys
(``Grid.num_dropped`` counts them)."""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from infinicube_tpu_torch.data.codec import decode_member, encode_png
from infinicube_tpu_torch.data.tario import TarReader
from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.grid.build import grid_from_ijk
from infinicube_tpu_torch.models.gsm.model import GSM, GSMConfig
from infinicube_tpu_torch.utils.gaussian_io import (gaussians_to_dict,
                                                    save_pkl, save_splat)
from infinicube_tpu_torch.utils.precision import set_float32_precision

DYNAMIC_ID_BASE = 10000  # instance >= 10000 => dynamic
GRID_CAPACITY_MAX = 1 << 18
_GS_KEYS = ("means", "scales", "quats", "opacities", "colors")


def load_buffer_folder(folder: str | Path, num_frames: int | None = None,
                       stride: int = 1) -> dict:
    """Read the stage-2 output folder into numpy arrays: every ``stride``-th
    frame, at most ``num_frames``."""
    folder = Path(folder)
    out: dict = {}

    def read_tar(name, ext, post):
        p = folder / f"{name}.tar"
        if not p.exists():
            return None
        with TarReader(p) as r:
            frames = sorted(n for n in r.names() if n.endswith(ext))
            frames = frames[::stride][:num_frames]
            return np.stack([post(decode_member(ext.split(".")[-1],
                                                r.read(n))) for n in frames])

    out["depth"] = read_tar("depth", "png",
                            lambda a: np.asarray(a, np.float32) / 100.0)
    out["instance"] = read_tar("instance", "png",
                               lambda a: np.asarray(a, np.int32))
    out["semantic"] = read_tar("semantic", "png",
                               lambda a: np.asarray(a, np.int32))
    out["poses_cv"] = read_tar("pose", "npy", lambda a: np.asarray(a))
    out["Ks"] = read_tar("intrinsic", "npy", lambda a: np.asarray(a))
    video = folder / "video.mp4"
    if video.exists() or video.with_suffix("").is_dir():
        from infinicube_tpu_torch.utils.fileio import read_video
        v = read_video(video)[::stride][:num_frames]
        out["video"] = np.asarray(v, np.float32) / 255.0
    world = folder / "world.npz"
    if world.exists():
        with np.load(world) as d:
            out["world"] = dict(d)
    return out


def merge_buffer_folders(folders: list, num_frames: int | None = None,
                         stride: int = 1) -> dict:
    """Concatenate several recorded passes over the same scene into one
    data dict; the world grid is the first pass's."""
    parts = [load_buffer_folder(f, num_frames, stride) for f in folders]
    out = {}
    for k in ("depth", "instance", "semantic", "poses_cv", "Ks", "video"):
        arrs = [p[k] for p in parts if p.get(k) is not None]
        if arrs:
            out[k] = np.concatenate(arrs, axis=0)
    for p in parts:
        if "world" in p:
            out["world"] = p["world"]
            break
    return out


def build_gsm_masks(depth: np.ndarray, instance: np.ndarray,
                    sky_seg: np.ndarray | None = None,
                    pixel_branch_last_n: int | None = 1) -> np.ndarray:
    """4-channel masks [V, H, W, 4]: ch0 foreground from segmentation
    (sky = 0; depth == 0 when there is none), ch1 non-dynamic, ch2 hood /
    pad (all ones), ch3 foreground from the grid (depth > 0).

    The pixel branch models the midground = ch0 & ~ch3. ``pixel_branch_last
    _n`` empties the midground of every frame before the last N by setting
    ch0 = ch3 there; None or 0 does so for every frame."""
    V, H, W = depth.shape
    fg_grid = (depth > 0).astype(np.float32)
    fg_seg = (~(sky_seg > 0)).astype(np.float32) if sky_seg is not None \
        else fg_grid
    m = np.ones((V, H, W, 4), np.float32)
    m[..., 0] = fg_seg
    m[..., 1] = (instance < DYNAMIC_ID_BASE).astype(np.float32)
    m[..., 3] = fg_grid
    n = pixel_branch_last_n or 0
    if n <= 0:
        m[..., 0] = m[..., 3]
    elif n < V:
        m[:-n, ..., 0] = m[:-n, ..., 3]
    return m


def scene_grid(world: dict | None, device):
    """The scene grid of a world (capacity the next power of two of its
    voxels, at most 2^18) and whether there is one; without a world a
    2-slot empty grid."""
    if world is None:
        return grid_from_ijk(torch.zeros((1, 2, 3), dtype=torch.int32,
                                         device=device),
                             torch.zeros((1, 2), dtype=torch.bool,
                                         device=device), 0.2, 0.1,
                             capacity=2), False
    ijk = np.asarray(world["ijk"])
    cap = 1 << int(np.ceil(np.log2(max(len(ijk), 2))))
    grid = grid_from_ijk(
        torch.as_tensor(ijk, dtype=torch.int32, device=device)[None],
        torch.ones((1, len(ijk)), dtype=torch.bool, device=device),
        torch.as_tensor(np.asarray(world["voxel_size"]), dtype=torch.float32),
        torch.as_tensor(np.asarray(world["origin"]), dtype=torch.float32),
        capacity=min(cap, GRID_CAPACITY_MAX))
    return grid, True


def _host_gaussians(g: dict, keys=_GS_KEYS + ("valid",)) -> dict:
    return {k: g[k].cpu().numpy() for k in keys}


def scene_batch(data: dict, max_views: int, device,
                pixel_branch_last_n: int = 1):
    """The GSM batch of a loaded buffer folder: ``max_views`` frames spread
    evenly, their masks, and the scene grid. Returns (batch, the selected
    frames' instance ids, whether there is a world)."""
    depth = data["depth"]
    V = min(max_views, depth.shape[0])
    sel = np.linspace(0, depth.shape[0] - 1, V).astype(int)
    depth = depth[sel]
    instance = data["instance"][sel]
    rgb = data.get("video")
    rgb = rgb[sel] if rgb is not None else \
        np.zeros(depth.shape + (3,), np.float32)
    sky_seg = data.get("sky_seg")
    masks = build_gsm_masks(depth, instance,
                            sky_seg[sel] if sky_seg is not None else None,
                            pixel_branch_last_n=pixel_branch_last_n)
    grid, has_world = scene_grid(data.get("world"), device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    batch = {"grid": grid, "images": t(rgb), "masks": t(masks),
             "Ks": t(data["Ks"][sel]),
             "cam_to_worlds": t(data["poses_cv"][sel]),
             "depth_prior": t(depth)[..., None]}
    return batch, instance, has_world


def reconstruct_scene(data: dict, params: dict | None = None,
                      model: GSM | None = None, cfg: GSMConfig | None = None,
                      max_views: int = 8, seed: int = 0,
                      pixel_branch_last_n: int = 1, device="cuda"):
    """Static + dynamic reconstruction on ``device``. ``params``: a GSM
    ``state_dict`` (for instance from ``weights.from_jax.gsm_from_jax``);
    without one (and without ``model``) the weights are random from
    ``seed``. Returns (static_gs, object_gs dict, out, model, params)."""
    device = resolve_device(device)
    batch, instance, use_voxel = scene_batch(data, max_views, device,
                                             pixel_branch_last_n)
    cfg = cfg or (model.cfg if model is not None else
                  GSMConfig(use_voxel_branch=use_voxel))
    if model is None:
        model = GSM(cfg, device=device)
        if params is None:
            model.init_params(torch.Generator(device=device).manual_seed(
                seed))
    if params is not None:
        model.load_state_dict(params)
    with torch.inference_mode():
        # static pass (the buffer depth drives the pixel branch)
        out = model(batch)
        static_gs = gaussians_to_dict(**_host_gaussians(out["gaussians"]))
        # dynamic pass: every pixel's gaussians, kept per dynamic instance
        object_gs: dict[int, dict] = {}
        dyn_ids = np.unique(instance[instance >= DYNAMIC_ID_BASE])
        if len(dyn_ids):
            out_dyn = model(batch, decode_all_pixels=True)
            g = _host_gaussians(out_dyn["gaussians"])
            del out_dyn
            K = cfg.pixel.gs_per_pixel
            if cfg.use_voxel_branch:
                n_vox = g["valid"].shape[0] - instance.size * K
                g = {k: v[n_vox:] for k, v in g.items()}
            pix_inst = np.repeat(instance.reshape(-1), K)
            for gid in dyn_ids:
                m = pix_inst == gid
                object_gs[int(gid)] = gaussians_to_dict(
                    *(g[k][m] for k in _GS_KEYS))
    return static_gs, object_gs, out, model, model.state_dict()


def segment_sky(video: np.ndarray, ckpt: str, variant: str = "b0",
                device="cuda", chunk: int = 4) -> np.ndarray:
    """Sky masks [V, H, W] uint8 (1 = sky) of the video frames [V, H, W, 3]
    in [0, 1] by the SegFormer (the reference runs the cityscapes SegFormer
    here). ``ckpt``: an HF-layout state dict (.pth / .pt;
    ``weights.convert.load_torch_state_dict``), converted by
    ``convert_segformer_hf``; ``chunk`` frames a call."""
    from infinicube_tpu_torch.models.gsm.segformer import (
        SegformerConfig, convert_segformer_hf, make_segformer_sky_segmenter)
    from infinicube_tpu_torch.weights.convert import load_torch_state_dict
    cfg = getattr(SegformerConfig, variant)()
    params = convert_segformer_hf(load_torch_state_dict(ckpt), cfg)
    seg = make_segformer_sky_segmenter(params, cfg, device=device)
    return np.concatenate([seg.batch(video[i:i + chunk])
                           for i in range(0, len(video), chunk)]
                          ).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--buffer_folder", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--num_frames", type=int, default=16)
    ap.add_argument("--max_views", type=int, default=8)
    ap.add_argument("--segformer-ckpt", default=None,
                    help="SegFormer weights (.pth, HF layout): sky masks "
                         "from segmentation instead of the depth == 0 sky")
    ap.add_argument("--segformer-variant", default="b0")
    ap.add_argument("--device", default="cuda",
                    help="where the scene is reconstructed")
    args = ap.parse_args(argv)
    set_float32_precision()
    device = resolve_device(args.device)

    data = load_buffer_folder(args.buffer_folder, args.num_frames)
    if args.segformer_ckpt and data.get("video") is not None and \
            data.get("sky_seg") is None:
        data["sky_seg"] = segment_sky(data["video"], args.segformer_ckpt,
                                      args.segformer_variant, device=device)
    static_gs, object_gs, out, _, _ = reconstruct_scene(
        data, max_views=args.max_views, device=device)
    outdir = Path(args.output)
    save_pkl(outdir / "decoded_gs_static.pkl", static_gs)
    save_pkl(outdir / "decoded_gs_object.pkl", object_gs)
    save_splat(outdir / "decoded_gs_static.splat", static_gs)
    rgb0 = out["render"]["rgb"][0].cpu().numpy()
    (outdir / "composite_frame0.png").write_bytes(encode_png(
        (np.clip(rgb0, 0, 1) * 255).astype(np.uint8)))
    print(f"static gaussians: {len(static_gs['means'])}; "
          f"objects: {list(object_gs)} -> {outdir}")
    return static_gs, object_gs


if __name__ == "__main__":
    main()
