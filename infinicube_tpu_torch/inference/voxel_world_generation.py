"""Unbounded voxel-world generation along a trajectory: chunked diffusion
with SDEdit overlap; counterpart of the trajectory mode of
``infinicube_tpu/inference/voxel_world_generation.py``.

Key poses every ``pose_interval_ratio x chunk extent`` meters along the ego
trajectory; per chunk the map and box conditions are moved into the chunk
frame, a latent cube is sampled (DDIM, the previous chunk's latents
re-noised into the overlap), decoded by the sparse VAE's structure decoder
and merged into the world (existing voxels win). Sampling and decoding run
on the model's device; chunk scheduling, warps and the world stay host-side
NumPy, as in JAX.

Waits: blocks mode (``generate_blocks`` and its latent table), the
connected-component filter and trajectory extrapolation (both off by
default)."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from infinicube_tpu_torch.models.diffusion.model import (CondCubes,
                                                         VoxelDiffusion)
from infinicube_tpu_torch.models.diffusion.sdedit import (SDEditState,
                                                          warp_prev_latents)
from infinicube_tpu_torch.utils.world_grid import WorldGrid, transform_ijk


@dataclasses.dataclass(frozen=True)
class WorldGenConfig:
    pose_interval_ratio: float = 0.75   # chunk spacing (x chunk extent)
    ddim_steps: int = 100
    guidance_scale: float = 1.0
    scale_factor: float = 1.0
    max_map_points: int = 8192
    max_boxes: int = 32


class VoxelWorldGenerator:
    """decode_fn(latents [1, D, H, W, C]) -> (ijk np [M, 3], semantics
    np [M]) in chunk-frame voxel coordinates at the finest voxel size."""

    def __init__(self, diffusion: VoxelDiffusion, decode_fn: Callable,
                 cfg: WorldGenConfig = WorldGenConfig(),
                 finest_voxel_size=0.2):
        self.diffusion = diffusion
        self.decode_fn = decode_fn
        self.cfg = cfg
        self.vs = np.broadcast_to(np.asarray(finest_voxel_size, np.float64),
                                  (3,)).copy()
        dc = diffusion.cfg
        self.chunk_extent = (np.asarray(dc.cube_dims) *
                             np.asarray(dc.latent_voxel_size))
        # per chunk of the last generate_trajectory: sample_s, decode_s,
        # merged (voxels the chunk added to the world)
        self.last_chunks: list[dict] = []

    def _sync(self) -> None:
        if self.diffusion.device.type == "cuda":
            torch.cuda.synchronize(self.diffusion.device)

    # ------------------------------------------------------------ condition
    def _cond_for_chunk(self, world_to_chunk: np.ndarray,
                        map_points: dict[str, np.ndarray] | None,
                        boxes: dict | None) -> CondCubes:
        T = self.diffusion.cfg.num_map_types
        N = self.cfg.max_map_points
        mp = np.zeros((1, T, N, 3), np.float32)
        mm = np.zeros((1, T, N), bool)
        if map_points:
            for ti, (_, pts) in enumerate(sorted(map_points.items())):
                if ti >= T or pts is None or len(pts) == 0:
                    continue
                w = np.asarray(pts, np.float64)
                c = w @ world_to_chunk[:3, :3].T + world_to_chunk[:3, 3]
                n = min(len(c), N)
                sel = np.linspace(0, len(c) - 1, n).astype(int)
                mp[0, ti, :n] = c[sel]
                mm[0, ti, :n] = True
        M = self.cfg.max_boxes
        bp = np.tile(np.eye(4, dtype=np.float32), (1, M, 1, 1))
        bl = np.ones((1, M, 3), np.float32)
        bm = np.zeros((1, M), bool)
        if boxes and len(boxes.get("poses", [])) > 0:
            poses = np.asarray(boxes["poses"], np.float64)[:M]
            n = len(poses)
            bp[0, :n] = (world_to_chunk @ poses).astype(np.float32)
            bl[0, :n] = np.asarray(boxes["lwhs"], np.float32)[:M]
            bm[0, :n] = True
        return self.diffusion.encode_conditions(
            *map(torch.from_numpy, (mp, mm, bp, bl, bm)))

    # --------------------------------------------------------------- chunks
    def _sample_chunk(self, cond: CondCubes, generator: torch.Generator,
                      sdedit: SDEditState | None,
                      noise: dict | None = None) -> torch.Tensor:
        return self.diffusion.sample(
            cond, num_steps=self.cfg.ddim_steps,
            guidance_scale=self.cfg.guidance_scale,
            scale_factor=self.cfg.scale_factor, sdedit=sdedit,
            generator=generator, **(noise or {}))

    def _decode_and_merge(self, latents: torch.Tensor,
                          chunk_to_world: np.ndarray,
                          world: WorldGrid) -> int:
        ijk, semantics = self.decode_fn(latents)
        wijk = transform_ijk(np.asarray(ijk, np.int64), chunk_to_world,
                             world.voxel_size, world.origin)
        before = world.num_voxels
        world.merge_ijk(wijk, semantics, keep_existing=True)
        return world.num_voxels - before

    def _sdedit_from_prev(self, prev_latents: torch.Tensor,
                          cur_to_prev: np.ndarray) -> SDEditState:
        dc = self.diffusion.cfg
        valid = torch.ones(prev_latents.shape[:4], dtype=torch.bool,
                           device=prev_latents.device)
        return warp_prev_latents(
            prev_latents, valid,
            torch.as_tensor(cur_to_prev, dtype=torch.float32),
            dc.cube_ijk_min, dc.latent_voxel_size, dc.latent_origin)

    # -------------------------------------------------------------- publics
    def key_poses_along_trajectory(self, ego_poses: np.ndarray) -> np.ndarray:
        """Resample FLU ego poses to chunk key poses every interval meters."""
        interval = float(self.chunk_extent[0]) * self.cfg.pose_interval_ratio
        pts = ego_poses[:, :3, 3]
        d = np.concatenate([[0], np.cumsum(
            np.linalg.norm(np.diff(pts, axis=0), axis=-1))])
        keys = [ego_poses[0]]
        next_d = interval
        for i in range(1, len(ego_poses)):
            if d[i] >= next_d:
                keys.append(ego_poses[i])
                next_d += interval
        return np.asarray(keys)

    def generate_trajectory(self, ego_poses: np.ndarray,
                            map_points: dict[str, np.ndarray] | None = None,
                            boxes: dict | None = None, seed: int = 0,
                            world: WorldGrid | None = None,
                            chunk_noise: Sequence[dict] | None = None
                            ) -> WorldGrid:
        """ego_poses f64 [T, 4, 4] FLU world. Returns the accumulated world.
        The random numbers come from a generator seeded with ``seed``;
        ``chunk_noise[i]`` (keys ``noise``, ``sdedit_noise`` of
        ``VoxelDiffusion.sample``) replaces them for chunk i."""
        world = world or WorldGrid(self.vs)
        keys = self.key_poses_along_trajectory(np.asarray(ego_poses))
        generator = torch.Generator(device=self.diffusion.device)
        generator.manual_seed(seed)
        self.last_chunks = []
        prev_latents, prev_pose = None, None
        for step, pose in enumerate(keys):
            t0 = time.perf_counter()
            w2c = np.linalg.inv(pose)
            cond = self._cond_for_chunk(w2c, map_points, boxes)
            sdedit = None
            if prev_latents is not None:
                cur_to_prev = np.linalg.inv(prev_pose) @ pose
                sdedit = self._sdedit_from_prev(prev_latents, cur_to_prev)
            latents = self._sample_chunk(
                cond, generator, sdedit,
                chunk_noise[step] if chunk_noise is not None else None)
            self._sync()
            t1 = time.perf_counter()
            merged = self._decode_and_merge(latents, pose, world)
            self.last_chunks.append(dict(
                sample_s=t1 - t0, decode_s=time.perf_counter() - t1,
                merged=merged, latents=latents,
                overlap=None if sdedit is None
                else int(sdedit.overlap_mask.sum())))
            prev_latents, prev_pose = latents, pose
        return world


def vae_decode_fn(vae, batch_idx: int = 0) -> Callable:
    """decode_fn of the VAE's structure decoder: latents -> (ijk,
    semantics) of the finest decoded grid, as NumPy."""
    def fn(latents: torch.Tensor):
        dec = vae.decode(latents)
        grid = dec["grid"]
        mask = grid.mask[batch_idx]
        ijk = grid.ijk[batch_idx][mask].cpu().numpy()
        sem = dec["semantic_logits"][batch_idx].argmax(-1)[mask]
        return ijk, sem.to(torch.int32).cpu().numpy()
    return fn
