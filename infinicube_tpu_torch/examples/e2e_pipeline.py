"""The three-stage pipeline chained end to end on one card (random
weights); counterpart of ``examples/e2e_pipeline.py``.

Chunked voxel-world diffusion (stage 1) -> guidance buffers (stage 2,
93 frames at 480x832, the splat route) -> the Wan video (the buffers
encoded, a 50-step CFG denoise, the tiled decode) -> the GSM's Gaussian
scene (stage 3) -> the artifacts: ``world.npz``, ``buffers/`` (the six
tars, the preview videos and ``world.npz``), ``video.mp4`` (or the
``video/`` png frames where no video writer is installed),
``decoded_gs_static.pkl`` / ``.splat`` and ``render0.png``.

    python -m infinicube_tpu_torch.examples.e2e_pipeline [outdir]

Knobs, as the reference's script:
- ``E2E_PROFILE``: ``demo`` (default; REDUCED stages 1 and 3: a
  ``transformer_depth=2`` UNet with a VAE-free threshold decode, a
  shrunken GSM over 2 views) or ``release`` (the release
  ``DiffusionConfig()`` with the sparse VAE's structure decode per chunk,
  the release ``GSMConfig`` over 16 views: every 6th of 93 frames);
- ``E2E_DDIM``: stage 1's DDIM steps (default 10; 100 is the reference's
  release default);
- ``E2E_VIDEO=0`` skips the video stage (stage 3 then takes random frames);
- ``E2E_STEADY=1`` runs every timed stage a second time in-process and
  reports both times.

``main`` builds the card's kernels first and prints the build's seconds.
Each timed stage prints its seconds (cold, and steady with ``E2E_STEADY``)
and, on the card, the memory resident at its start and its peak
(``torch.cuda.max_memory_allocated``, reset at the stage's start). Stage 1's models are freed before the video
stage and the buffer stack is dropped before the DiT, as the reference
does; the video towers are freed before stage 3 too (the reference keeps
them; freeing them changes no result and keeps stage 3's peak its own).

``run_pipeline`` is the chain with every size as an argument; ``main``
only picks the profile's values. Its stages are functions of their own
(``stage1_world``, ``stage2_buffers``, ``stage3_data``,
``stage3_scene``), which the resume and the port's parity tests call. Runs on the card unless the caller of
``run_pipeline`` asks for the CPU."""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from infinicube_tpu_torch.device import resolve_device

PROMPT = "a realistic driving scene"
RELEASE_HW = (480, 832)
RELEASE_FRAMES = 93


@dataclasses.dataclass(frozen=True)
class Stage3Views:
    """The stage-3 key frames: every ``stride``-th of the buffer frames, at
    most ``num_frames``, of which ``max_views`` go into the GSM."""
    num_frames: int
    stride: int
    max_views: int


RELEASE_VIEWS = Stage3Views(16, 6, 16)   # every 6th of 93 frames
DEMO_VIEWS = Stage3Views(8, 8, 2)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(label: str, fn: Callable, device: torch.device,
          steady: bool = False, record: dict | None = None):
    """Run ``fn`` once (cold), and again with ``steady``; print the seconds
    and, on the card, the memory resident at the stage's start and its
    peak. Each run ends with a device sync. The numbers go into
    ``record[label]``."""
    cuda = device.type == "cuda"
    resident = None
    if cuda:
        resident = torch.cuda.memory_allocated(device) / 2**30
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    cold = time.perf_counter() - t0
    warm = None
    if steady:
        del out
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None
    mem = f", peak {peak:.2f} GiB ({resident:.2f} GiB resident at its " \
        "start)" if cuda else ""
    if warm is None:
        print(f"[{label}] {cold:.3f} s{mem}", flush=True)
    else:
        print(f"[{label}] cold {cold:.3f} s -> steady {warm:.3f} s{mem}",
              flush=True)
    if record is not None:
        record[label] = {"cold_s": cold, "steady_s": warm, "peak_gib": peak,
                         "resident_gib": resident}
    return out


def camera_for(hw: tuple[int, int]):
    """The reference script's camera (fx = fy = 480 at 832 wide, the
    principal point in the middle), scaled to ``hw``."""
    from infinicube_tpu_torch.camera.pinhole import PinholeCamera
    h, w = hw
    f = 480.0 * w / 832
    return PinholeCamera(fx=f, fy=f, cx=w / 2, cy=h / 2, w=w, h=h)


def stage2_poses(frames: int) -> np.ndarray:
    """The buffers' FLU camera path: 40 m along x, 1.8 m up."""
    poses = np.tile(np.eye(4), (frames, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 40, frames)
    poses[:, 2, 3] = 1.8
    return poses


def stage1_scene():
    """The ego path (45 m along x, 30 poses) and two map polylines."""
    T_ego = np.tile(np.eye(4), (30, 1, 1))
    T_ego[:, 0, 3] = np.linspace(0, 45, 30)
    maps = {"road_edge": np.stack([np.linspace(0, 80, 200),
                                   np.full(200, -4.0), np.zeros(200)], -1),
            "road_line": np.stack([np.linspace(0, 80, 200),
                                   np.full(200, 4.0), np.zeros(200)], -1)}
    return T_ego, maps


def threshold_decode(dcfg) -> Callable:
    """The demo profile's VAE-free decode: a voxel at 4x subdivision where
    latent channel 0 exceeds 1, road (18) or building (14) by the sign of
    channel 1."""
    def decode_fn(latents: torch.Tensor):
        lat = latents[0].float().cpu().numpy()
        occ = lat[..., 0] > 1.0
        ii, jj, kk = np.meshgrid(*[np.arange(s) for s in lat.shape[:3]],
                                 indexing="ij")
        ijk = np.stack([ii, jj, kk], -1)[occ] + np.asarray(dcfg.cube_ijk_min)
        sem = np.where(lat[..., 1][occ] > 0, 18, 14).astype(np.int32)
        return (ijk * 4).astype(np.int64), sem
    return decode_fn


def build_stage1(dcfg, vcfg, device: torch.device, seed: int = 0):
    """The voxel diffusion model (random weights from ``seed``) and its
    decode: the sparse VAE's structure decoder (weights from ``seed + 1``)
    or, without ``vcfg``, the threshold decode. The port's initializers
    need no sample input (flax's take a hash tree of 500 points)."""
    from infinicube_tpu_torch.inference.voxel_world_generation import \
        vae_decode_fn
    from infinicube_tpu_torch.models.diffusion.model import VoxelDiffusion
    from infinicube_tpu_torch.models.vae.sunet import SparseStructureVAE
    diffusion = VoxelDiffusion(dcfg, device=device)
    diffusion.init_params(torch.Generator(device=device).manual_seed(seed))
    if vcfg is None:
        return diffusion, None, threshold_decode(dcfg)
    vae = SparseStructureVAE(vcfg, device=device)
    vae.init_params(torch.Generator(device=device).manual_seed(seed + 1))
    return diffusion, vae, vae_decode_fn(vae)


def _png(path: Path, rgb: np.ndarray) -> None:
    from infinicube_tpu_torch.data.codec import encode_png
    path.write_bytes(encode_png((np.clip(rgb, 0, 1) * 255).astype(np.uint8)))


def stage1_world(dcfg, vcfg, ddim_steps: int, device: torch.device,
                 steady: bool = False, record: dict | None = None):
    """Stage 1: the chunked voxel world along ``stage1_scene``'s ego path.
    Returns (world, the number of chunks). The models are freed on
    return."""
    from infinicube_tpu_torch.inference.voxel_world_generation import (
        VoxelWorldGenerator, WorldGenConfig)
    diffusion, vae, decode_fn = build_stage1(dcfg, vcfg, device)
    gen = VoxelWorldGenerator(diffusion, decode_fn,
                              WorldGenConfig(ddim_steps=ddim_steps),
                              finest_voxel_size=0.2)
    T_ego, maps = stage1_scene()
    world = timed("stage1 world", lambda: gen.generate_trajectory(
        T_ego, map_points=maps, seed=0), device, steady, record)
    chunks = len(gen.last_chunks)
    print(f"[stage1] world: {world.num_voxels} voxels in {chunks} chunks",
          flush=True)
    return world, chunks


def stage2_buffers(outdir, world, frames: int, hw: tuple[int, int],
                   device: torch.device, steady: bool = False,
                   record: dict | None = None) -> dict:
    """Stage 2: the guidance buffers of ``world`` along ``stage2_poses``
    seen by ``camera_for(hw)``, written to ``outdir/buffers`` as the six
    tars and ``world.npz``. Returns the buffers (on ``device``)."""
    from infinicube_tpu_torch.inference.guidance_buffer_generation import (
        generate_buffers_for_world, save_voxel_world, write_buffer_tars)
    outdir = Path(outdir)
    cam = camera_for(hw)
    poses = stage2_poses(frames)
    buffers = timed(f"stage2 buffers {frames}f@{hw[0]}x{hw[1]}",
                    lambda: generate_buffers_for_world(world, poses, cam,
                                                       device=device),
                    device, steady, record)
    print(f"[stage2] hit {float((buffers['depth'] > 0).float().mean()):.2f}",
          flush=True)
    timed("stage2 tars", lambda: write_buffer_tars(
        outdir / "buffers", buffers, poses, cam), device, False, record)
    save_voxel_world(outdir / "buffers" / "world.npz", world)
    return buffers


def stage3_data(outdir, views: Stage3Views,
                video: np.ndarray | None) -> dict:
    """Stage 3's input: the key frames of ``outdir/buffers`` with the video
    frames at the same stride (float in [0, 1]; None: random frames from
    numpy seed 0)."""
    from infinicube_tpu_torch.inference.scene_gaussian_generation import \
        load_buffer_folder
    data = load_buffer_folder(Path(outdir) / "buffers",
                              num_frames=views.num_frames,
                              stride=views.stride)
    if video is not None:
        data["video"] = video[::views.stride][: data["depth"].shape[0]]
    else:
        rng = np.random.default_rng(0)
        data["video"] = rng.uniform(size=data["depth"].shape + (3,)).astype(
            np.float32)
    return data


def stage3_scene(outdir, data: dict, gsm_cfg, views: Stage3Views,
                 device: torch.device, steady: bool = False,
                 record: dict | None = None, params: dict | None = None,
                 label: str = "stage3 GSM"):
    """Stage 3: the GSM's Gaussian scene of ``data`` (random weights
    without ``params``), written to ``outdir`` as
    ``decoded_gs_static.pkl`` / ``.splat`` and ``render0.png``. Returns
    (static_gs, object_gs, out)."""
    from infinicube_tpu_torch.inference.scene_gaussian_generation import \
        reconstruct_scene
    from infinicube_tpu_torch.utils.gaussian_io import save_pkl, save_splat
    outdir = Path(outdir)
    static_gs, object_gs, out, _, _ = timed(
        f"{label} ({views.max_views} views)",
        lambda: reconstruct_scene(data, params=params, cfg=gsm_cfg,
                                  max_views=views.max_views, device=device),
        device, steady, record)
    print(f"[stage3] {len(static_gs['means'])} gaussians", flush=True)
    save_pkl(outdir / "decoded_gs_static.pkl", static_gs)
    save_splat(outdir / "decoded_gs_static.splat", static_gs)
    _png(outdir / "render0.png", out["render"]["rgb"][0].cpu().numpy())
    return static_gs, object_gs, out


def run_pipeline(outdir, dcfg, vcfg, gsm_cfg, wan_cfg,
                 views: Stage3Views = DEMO_VIEWS,
                 frames: int = RELEASE_FRAMES,
                 hw: tuple[int, int] = RELEASE_HW, ddim_steps: int = 10,
                 device="cuda", steady: bool = False) -> dict:
    """The chain. ``dcfg`` / ``vcfg``: stage 1's diffusion and sparse-VAE
    configs (``vcfg`` None: the threshold decode); ``wan_cfg``: the video
    stage's config (None skips it); ``gsm_cfg``: stage 3's. Random weights
    throughout. ``frames`` buffer frames at ``hw``.
    Returns {"world", "chunks" (stage 1's), "buffers" (host arrays; None
    where the video stage dropped them), "video" (float frames or None),
    "static_gs", "object_gs", "out", "seconds" (per stage: cold_s,
    steady_s, peak_gib, resident_gib)}."""
    from infinicube_tpu_torch.inference.guidance_buffer_generation import (
        save_voxel_world, write_preview_videos)
    device = resolve_device(device)
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    record: dict = {}
    t_all = time.perf_counter()

    world, chunks = stage1_world(dcfg, vcfg, ddim_steps, device, steady,
                                 record)
    # stage 1's models are gone: release their memory for the video stage
    if device.type == "cuda":
        torch.cuda.empty_cache()
    save_voxel_world(outdir / "world.npz", world)
    buffers = stage2_buffers(outdir, world, frames, hw, device, steady,
                             record)

    # ---- the video stage --------------------------------------------------
    video = None
    if wan_cfg is not None:
        from infinicube_tpu_torch.models.wan.pipeline import \
            WanVideoGenerator
        from infinicube_tpu_torch.utils.fileio import write_video
        sem_rgb, coord = timed("stage2 previews", lambda: write_preview_videos(
            outdir / "buffers", buffers), device, False, record)
        buffers = None    # free the buffer stack: the DiT needs the memory
        if device.type == "cuda":
            torch.cuda.empty_cache()
        wan = WanVideoGenerator(wan_cfg, device=device)
        wan.init_params(torch.Generator(device=device).manual_seed(0))
        wan.cast_params_bf16()           # serving residency
        sem_u8 = (sem_rgb * 255).astype(np.uint8)
        rgb = timed(f"video {frames}f@{hw[0]}x{hw[1]} "
                    f"{wan_cfg.num_steps}-step CFG",
                    lambda: wan.generate(sem_u8, coord, PROMPT),
                    device, steady, record)
        print("[video] " + " ".join(f"{k}={v:.3f}s" for k, v in
                                    wan.last_phase_seconds.items()),
              flush=True)
        write_video(outdir / "video.mp4", rgb)
        video = np.asarray(rgb, np.float32) / 255.0
        del wan
        if device.type == "cuda":
            torch.cuda.empty_cache()
    host_buffers = None if buffers is None else {
        k: v.cpu().numpy() for k, v in buffers.items()}
    buffers = None

    static_gs, object_gs, out = stage3_scene(
        outdir, stage3_data(outdir, views, video), gsm_cfg, views, device,
        steady, record)
    print(f"[e2e] done in {time.perf_counter() - t_all:.1f} s -> {outdir}",
          flush=True)
    return {"world": world, "chunks": chunks, "buffers": host_buffers,
            "video": video,
            "static_gs": static_gs, "object_gs": object_gs, "out": out,
            "seconds": record}


def profile_configs(profile: str):
    """(DiffusionConfig, SparseVAEConfig or None, GSMConfig, Stage3Views) of
    ``E2E_PROFILE``."""
    from infinicube_tpu_torch.models.diffusion.model import DiffusionConfig
    from infinicube_tpu_torch.models.gsm.encoders import UnifiedEncoderConfig
    from infinicube_tpu_torch.models.gsm.model import GSMConfig
    from infinicube_tpu_torch.models.gsm.pixel_branch import \
        PixelBranchConfig
    from infinicube_tpu_torch.models.gsm.sky import SkyConfig
    from infinicube_tpu_torch.models.gsm.voxel_branch import \
        VoxelBranchConfig
    from infinicube_tpu_torch.models.vae.sunet import SparseVAEConfig
    crop = dict(dense_dims=(512, 256, 64), dense_ijk_min=(-32, -128, -16))
    if profile == "release":
        # the release 750M UNet with the sparse VAE's structure decode; the
        # release GSM (only the scene crop describes this world)
        return (DiffusionConfig(), SparseVAEConfig(), GSMConfig(**crop),
                RELEASE_VIEWS)
    if profile != "demo":
        raise ValueError(f"E2E_PROFILE={profile!r}: demo or release")
    gsm = GSMConfig(
        encoder=UnifiedEncoderConfig(conv_width=32),
        voxel=VoxelBranchConfig(f_maps=32, levels=2, gaussians_per_voxel=2),
        pixel=PixelBranchConfig(width=16, dims=(1, 2, 4), gs_per_pixel=1),
        sky=SkyConfig(embed_dim=64, num_layers=2, num_heads=4),
        render_tile_capacity=128, **crop)
    return DiffusionConfig(transformer_depth=2), None, gsm, DEMO_VIEWS


def build_kernels(device) -> None:
    """Build the card's kernels before the first stage (each source that is
    not built yet, one ``nvcc`` each, all at once), so that no stage's
    time holds the build; print its seconds."""
    from infinicube_tpu_torch import kernels
    device = resolve_device(device)
    print(f"[setup] torch {torch.__version__} on "
          f"{torch.cuda.get_device_name(device)}", flush=True)
    print(f"[setup] kernels built in {kernels.build():.1f} s", flush=True)


def main(outdir="out/e2e"):
    from infinicube_tpu_torch.models.wan.pipeline import WanPipelineConfig
    from infinicube_tpu_torch.utils.precision import set_float32_precision
    set_float32_precision()
    build_kernels("cuda")
    profile = os.environ.get("E2E_PROFILE", "demo")
    dcfg, vcfg, gsm_cfg, views = profile_configs(profile)
    wan_cfg = WanPipelineConfig.serving() \
        if os.environ.get("E2E_VIDEO", "1") != "0" else None
    return run_pipeline(
        outdir, dcfg, vcfg, gsm_cfg, wan_cfg, views,
        ddim_steps=int(os.environ.get("E2E_DDIM", "10")),
        steady=os.environ.get("E2E_STEADY", "0") == "1")


if __name__ == "__main__":
    main(*sys.argv[1:])
