"""Unbounded voxel-world generation: chunked diffusion with SDEdit overlap;
counterpart of ``infinicube_tpu/inference/voxel_world_generation.py``.

- Trajectory mode: key poses every ``pose_interval_ratio x chunk extent``
  meters along the ego trajectory (optionally extrapolated along the last
  heading); per chunk the map and box conditions are moved into the chunk
  frame, a latent cube is sampled (DDIM, the previous chunk's latents
  re-noised into the overlap), decoded by the sparse VAE's structure
  decoder, optionally cleared of small connected components, and merged
  into the world (existing voxels win).
- Blocks mode: the map extent is tiled with ``block_overlap_ratio``; tiles
  a caller's test calls empty are skipped; a latent table keyed by world
  latent coordinates (sorted packed int64 keys, the first block to generate
  a cell owns it) feeds SDEdit in every later block that overlaps.

Sampling and decoding run on the model's device; scheduling, warps, the
table and the world stay host-side NumPy, as in JAX."""

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
from infinicube_tpu_torch.utils.interpolate import extrapolate_trajectory
from infinicube_tpu_torch.utils.world_grid import (WorldGrid,
                                                   connected_component_filter,
                                                   transform_ijk)


@dataclasses.dataclass(frozen=True)
class WorldGenConfig:
    pose_interval_ratio: float = 0.75   # chunk spacing (x chunk extent)
    block_overlap_ratio: float = 0.25
    ddim_steps: int = 100
    guidance_scale: float = 1.0
    scale_factor: float = 1.0
    max_map_points: int = 8192
    max_boxes: int = 32
    extrapolation_steps: int = 0        # chunks beyond the data trajectory
    cc_min_size: int = 0                # connected-component filter (off)


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
        # per chunk (or block) of the last generation: sample_s, decode_s,
        # merged (voxels it added to the world), latents, overlap
        self.last_chunks: list[dict] = []
        # blocks mode's latent table: sorted packed world latent ijk and
        # the row-aligned latents
        self._table_keys = np.empty((0,), np.int64)
        self._table_vals = np.empty((0, dc.latent_channels), np.float32)

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
        ijk, semantics = np.asarray(ijk, np.int64), np.asarray(semantics)
        if self.cfg.cc_min_size > 1 and len(ijk):
            keep = connected_component_filter(ijk, self.cfg.cc_min_size)
            ijk, semantics = ijk[keep], semantics[keep]
        wijk = transform_ijk(ijk, chunk_to_world,
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
        """Resample FLU ego poses to chunk key poses every interval meters
        (plus ``extrapolation_steps`` more along the last heading)."""
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
        keys = np.asarray(keys)
        if self.cfg.extrapolation_steps:
            keys = extrapolate_trajectory(keys, self.cfg.extrapolation_steps,
                                          interval)
        return keys

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
            sdedit = None
            if prev_latents is not None:
                cur_to_prev = np.linalg.inv(prev_pose) @ pose
                sdedit = self._sdedit_from_prev(prev_latents, cur_to_prev)
            latents = self._chunk(
                pose, map_points, boxes, sdedit, generator, world, t0,
                chunk_noise[step] if chunk_noise is not None else None)
            prev_latents, prev_pose = latents, pose
        return world

    def _chunk(self, chunk_to_world, map_points, boxes, sdedit, generator,
               world, t0, noise) -> torch.Tensor:
        """Condition, sample, decode and merge one chunk or block (timed
        from ``t0``, noted in ``last_chunks``). Returns its latents."""
        cond = self._cond_for_chunk(np.linalg.inv(chunk_to_world),
                                    map_points, boxes)
        latents = self._sample_chunk(cond, generator, sdedit, noise)
        self._sync()
        t1 = time.perf_counter()
        merged = self._decode_and_merge(latents, chunk_to_world, world)
        self.last_chunks.append(dict(
            sample_s=t1 - t0, decode_s=time.perf_counter() - t1,
            merged=merged, latents=latents,
            overlap=None if sdedit is None
            else int(sdedit.overlap_mask.sum())))
        return latents

    # ------------------------------------------------------------ blocks mode
    def _block_centers(self, bbox_min, bbox_max) -> np.ndarray:
        ext = self.chunk_extent[:2]
        step = ext * (1.0 - self.cfg.block_overlap_ratio)
        xs = np.arange(bbox_min[0] + ext[0] / 2, bbox_max[0] + step[0] / 2,
                       step[0])
        ys = np.arange(bbox_min[1] + ext[1] / 2, bbox_max[1] + step[1] / 2,
                       step[1])
        cx, cy = np.meshgrid(xs, ys, indexing="ij")
        return np.stack([cx.ravel(), cy.ravel(), np.zeros(cx.size)], -1)

    def _latent_world_ijk(self, chunk_to_world: np.ndarray) -> np.ndarray:
        """World latent coordinates of the chunk's cube cells (integer for
        axis-aligned, translated blocks)."""
        dc = self.diffusion.cfg
        ii, jj, kk = np.meshgrid(*[np.arange(n) for n in dc.cube_dims],
                                 indexing="ij")
        ijk = np.stack([ii, jj, kk], -1).reshape(-1, 3) + \
            np.asarray(dc.cube_ijk_min)
        lvs = np.asarray(dc.latent_voxel_size)
        lorg = np.asarray(dc.latent_origin)
        world = (ijk * lvs + lorg) @ np.asarray(chunk_to_world)[:3, :3].T + \
            chunk_to_world[:3, 3]
        return np.round((world - lorg) / lvs).astype(np.int64)

    @staticmethod
    def _pack_keys(wijk: np.ndarray) -> np.ndarray:
        """World latent ijk -> int64 (21 bits an axis, offset by 2^20: about
        +-800 km at the 0.8 m release latent pitch). Outside that domain a
        coordinate would alias into its neighbour's bits, so it raises."""
        b = wijk.astype(np.int64) + (1 << 20)
        if not ((b >= 0) & (b < (1 << 21))).all():
            raise ValueError("latent ijk outside the +-2^20 table domain")
        return (b[:, 0] << 42) | (b[:, 1] << 21) | b[:, 2]

    def _table_lookup(self, keys: np.ndarray):
        """(row of each key in the table, whether it is there)."""
        n = len(self._table_keys)
        pos = np.searchsorted(self._table_keys, keys)
        pos_c = np.minimum(pos, n - 1)
        return pos_c, (self._table_keys[pos_c] == keys) & (pos < n)

    def _sdedit_from_table(self, chunk_to_world: np.ndarray
                           ) -> SDEditState | None:
        """The table's latents at the block's cells as an SDEdit state, or
        None when the block overlaps nothing generated yet."""
        dc = self.diffusion.cfg
        D, H, W = dc.cube_dims
        if len(self._table_keys) == 0:
            return None
        pos, mask = self._table_lookup(
            self._pack_keys(self._latent_world_ijk(chunk_to_world)))
        if not mask.any():
            return None
        lat = np.zeros((D * H * W, dc.latent_channels), np.float32)
        lat[mask] = self._table_vals[pos[mask]]
        dev = self.diffusion.device
        return SDEditState(
            warped_latents=torch.from_numpy(lat.reshape(1, D, H, W, -1))
            .to(dev),
            overlap_mask=torch.from_numpy(mask.reshape(1, D, H, W)).to(dev))

    def _update_table(self, latents, chunk_to_world: np.ndarray) -> None:
        """Insert the block's latents at the cells not in the table yet:
        the first block to generate a cell owns it, and within one update
        the first of two cells that round onto one world cell wins."""
        keys = self._pack_keys(self._latent_world_ijk(chunk_to_world))
        flat = np.asarray(torch.as_tensor(latents).cpu(), np.float32)
        flat = flat.reshape(-1, flat.shape[-1])
        _, first = np.unique(keys, return_index=True)
        if len(first) != len(keys):
            keys, flat = keys[first], flat[first]
        fresh = np.ones(len(keys), bool) if len(self._table_keys) == 0 \
            else ~self._table_lookup(keys)[1]
        all_k = np.concatenate([self._table_keys, keys[fresh]])
        all_v = np.concatenate([self._table_vals, flat[fresh]])
        order = np.argsort(all_k, kind="stable")
        self._table_keys, self._table_vals = all_k[order], all_v[order]

    @property
    def _latent_table(self) -> dict:
        """Dict view of the table, {world latent ijk: latent} (small
        worlds, tests)."""
        return {tuple(((int(k) >> s) & ((1 << 21) - 1)) - (1 << 20)
                      for s in (42, 21, 0)): v
                for k, v in zip(self._table_keys, self._table_vals)}

    def generate_blocks(self, bbox_min, bbox_max,
                        map_points: dict[str, np.ndarray] | None = None,
                        boxes: dict | None = None, seed: int = 0,
                        skip_empty_fn: Callable | None = None,
                        world: WorldGrid | None = None,
                        block_noise: Sequence[dict] | None = None
                        ) -> WorldGrid:
        """Tile [bbox_min, bbox_max] (world xy) with overlapping blocks;
        ``skip_empty_fn(center) -> bool`` skips a block. The random numbers
        come from a generator seeded with ``seed``; ``block_noise[i]`` (keys
        of ``VoxelDiffusion.sample``) replaces them for the i-th block that
        is generated (skipped blocks draw nothing)."""
        world = world or WorldGrid(self.vs)
        generator = torch.Generator(device=self.diffusion.device)
        generator.manual_seed(seed)
        self.last_chunks = []
        for center in self._block_centers(bbox_min, bbox_max):
            if skip_empty_fn is not None and skip_empty_fn(center):
                continue
            t0 = time.perf_counter()
            c2w = np.eye(4)
            c2w[:3, 3] = center
            i = len(self.last_chunks)
            latents = self._chunk(
                c2w, map_points, boxes, self._sdedit_from_table(c2w),
                generator, world, t0,
                block_noise[i] if block_noise is not None else None)
            self._update_table(latents, c2w)
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
