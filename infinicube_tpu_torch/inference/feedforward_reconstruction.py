"""GSM feed-forward reconstruction eval (stage-3 eval); counterpart of
``infinicube_tpu/inference/feedforward_reconstruction.py``: reconstruct a
scene from voxels and input images in dual / 3D-only / 2D-only branch
modes and report PSNR and SSIM of the renders against the inputs (or
against held-out target images when target views are given); the CLI
saves the renders and optionally the gaussians. Like the reference's, the
CLI reconstructs with ``reconstruct_scene``'s default configuration:
``--mode`` is accepted and not used.

    python -m infinicube_tpu_torch.inference.feedforward_reconstruction \\
        --buffer_folder out/buffers --output out/eval [--mode dual] \\
        [--save_gs] [--device cpu]"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from infinicube_tpu_torch.data.codec import encode_png
from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.models.gsm.loss import psnr, ssim
from infinicube_tpu_torch.models.gsm.model import GSM, GSMConfig
from infinicube_tpu_torch.utils.gaussian_io import save_pkl
from infinicube_tpu_torch.utils.precision import set_float32_precision

MODES = ("dual", "3d", "2d")


def mode_config(mode: str, cfg: GSMConfig | None = None) -> GSMConfig:
    """``cfg`` with the branches of a mode: dual = both, 3d = voxel only,
    2d = pixel only."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    return dataclasses.replace(cfg or GSMConfig(),
                               use_voxel_branch=mode in ("dual", "3d"),
                               use_pixel_branch=mode in ("dual", "2d"))


def reconstruct(batch: dict, mode: str = "dual", params: dict | None = None,
                seed: int = 0, cfg: GSMConfig | None = None):
    """One GSM pass over ``batch`` (tensors on the device the model is
    built on). ``params``: a GSM ``state_dict``; without one the weights
    are random from ``seed``. Returns (out, metrics, model, params)."""
    cfg = mode_config(mode, cfg)
    device = batch["images"].device
    model = GSM(cfg, device=device)
    if params is None:
        model.init_params(torch.Generator(device=device).manual_seed(seed))
    else:
        model.load_state_dict(params)
    with torch.inference_mode():
        out = model(batch)
        gt = batch.get("target_images", batch["images"]) \
            if "target_poses" in batch else batch["images"]
        metrics = {}
        if gt is not None and gt.shape == out["render"]["rgb"].shape:
            metrics = {"psnr": float(psnr(out["render"]["rgb"], gt)),
                       "ssim": float(ssim(out["render"]["rgb"], gt))}
    return out, metrics, model, model.state_dict()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--buffer_folder", required=True)
    ap.add_argument("--mode", default="dual", choices=list(MODES))
    ap.add_argument("--output", required=True)
    ap.add_argument("--save_gs", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from infinicube_tpu_torch.inference.scene_gaussian_generation import (
        load_buffer_folder, reconstruct_scene)
    set_float32_precision()
    device = resolve_device(args.device)
    data = load_buffer_folder(args.buffer_folder)
    static_gs, _, out, _, _ = reconstruct_scene(data, device=device)
    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.save_gs:
        save_pkl(outdir / "gs.pkl", static_gs)
    for i, img in enumerate(out["render"]["rgb"].cpu().numpy()):
        (outdir / f"render_{i:03d}.png").write_bytes(encode_png(
            (np.clip(img, 0, 1) * 255).astype(np.uint8)))
    print(f"renders -> {outdir}")


if __name__ == "__main__":
    main()
