"""One map-conditioned latent chunk, sampled and decoded (the stage-1
single-chunk check); counterpart of
``infinicube_tpu/inference/voxel_generation_single_chunk.py``.

    python -m infinicube_tpu_torch.inference.voxel_generation_single_chunk \
        --output out/ [--map_points maps.npz] [--ddim_steps 100] [--guidance 1]

The CLI builds the release UNet (``DiffusionConfig()``) with random weights
from seed 0 on the card, samples one cube and decodes it without a VAE by
thresholding the first latent channel, as the JAX CLI does, and writes
``chunk.npz`` (``save_grid_semantic``)."""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from infinicube_tpu_torch.inference.voxel_world_generation import (
    VoxelWorldGenerator, WorldGenConfig)
from infinicube_tpu_torch.models.diffusion.model import (DiffusionConfig,
                                                         VoxelDiffusion)
from infinicube_tpu_torch.utils.fileio import save_grid_semantic
from infinicube_tpu_torch.utils.precision import set_float32_precision


def sample_single_chunk(diffusion: VoxelDiffusion, decode_fn,
                        map_points: dict | None = None,
                        boxes: dict | None = None, ddim_steps: int = 100,
                        guidance: float = 1.0, seed: int = 0,
                        noise: dict | None = None):
    """Sample one chunk at the identity pose and decode it. ``noise`` (keys
    of ``VoxelDiffusion.sample``) replaces the draws of a generator seeded
    with ``seed``. Returns (ijk, semantics, latents)."""
    gen = VoxelWorldGenerator(diffusion, decode_fn,
                              WorldGenConfig(ddim_steps=ddim_steps,
                                             guidance_scale=guidance))
    cond = gen._cond_for_chunk(np.eye(4), map_points, boxes)
    generator = torch.Generator(device=diffusion.device)
    generator.manual_seed(seed)
    latents = gen._sample_chunk(cond, generator, None, noise)
    ijk, sem = decode_fn(latents)
    return np.asarray(ijk), np.asarray(sem), latents


def occupancy_decode_fn(cfg: DiffusionConfig):
    """decode_fn without a VAE: the cells whose first latent channel is
    positive, at the finest voxel pitch (4x the latent's), all label 1."""
    def fn(latents):
        lat = latents[0].float().cpu().numpy()
        occ = lat[..., 0] > 0
        ii, jj, kk = np.meshgrid(*[np.arange(n) for n in lat.shape[:3]],
                                 indexing="ij")
        ijk = (np.stack([ii, jj, kk], -1)[occ] +
               np.asarray(cfg.cube_ijk_min)) * 4
        return ijk.astype(np.int64), np.ones(len(ijk), np.int32)
    return fn


def main(argv=None, device="cuda",
         cfg: DiffusionConfig = DiffusionConfig()) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--map_points", default=None, help="npz per-type points")
    ap.add_argument("--output", required=True)
    ap.add_argument("--ddim_steps", type=int, default=100)
    ap.add_argument("--guidance", type=float, default=1.0)
    args = ap.parse_args(argv)
    set_float32_precision()
    diffusion = VoxelDiffusion(cfg, device=device)
    generator = torch.Generator(device=diffusion.device)
    generator.manual_seed(0)
    diffusion.init_params(generator)
    maps = dict(np.load(args.map_points)) if args.map_points else None
    ijk, sem, _ = sample_single_chunk(diffusion, occupancy_decode_fn(cfg),
                                      maps, ddim_steps=args.ddim_steps,
                                      guidance=args.guidance)
    save_grid_semantic(Path(args.output) / "chunk.npz", ijk, sem, 0.2, 0.1)
    print(f"sampled {len(ijk)} voxels -> {args.output}")


if __name__ == "__main__":
    main()
