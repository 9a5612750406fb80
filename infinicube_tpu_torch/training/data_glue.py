"""Dataset to model-batch adapters; counterpart of
``infinicube_tpu/training/data_glue.py``: the bridge between the host data
path (``data/waymo_dataset.py``) and the train steps.

- VAE batches: crop points and labels -> the hash-tree grids and the voxel
  labels, on the card unless the caller asks for the CPU.
- Diffusion batches: latents from the frozen VAE's encode (on the VAE's
  device) and the map and box condition cubes.
- GSM batches: the grid, the input images, masks and poses, and the voxel
  depth prior.

Ragged samples are padded to fixed capacities (a longer sample keeps its
first ``point_capacity`` points)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np
import torch

from infinicube_tpu_torch.data.specs import DatasetSpec, pad_stack
from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.grid.ops import majority_label
from infinicube_tpu_torch.models.vae.sunet import (SparseVAEConfig,
                                                   build_hash_tree)


def _points_batch(samples: list[dict], capacity: int, device):
    pts, mask = pad_stack([s[DatasetSpec.INPUT_PC] for s in samples],
                          capacity)
    sem, _ = pad_stack([s[DatasetSpec.GT_SEMANTIC].astype(np.int32)
                        for s in samples], capacity)
    return tuple(torch.from_numpy(a).to(device) for a in (pts, mask, sem))


def _batched(dataset: Iterable, batch_size: int) -> Iterator[list[dict]]:
    buf: list[dict] = []
    for sample in dataset:
        buf.append(sample)
        if len(buf) == batch_size:
            yield buf
            buf = []


def vae_batches(dataset, cfg: SparseVAEConfig, batch_size: int = 1,
                point_capacity: int = 65536, device="cuda") -> Iterator:
    """-> (grids, voxel_semantics) batches for ``SparseStructureVAE``."""
    device = resolve_device(device)
    for buf in _batched(dataset, batch_size):
        pts, mask, sem = _points_batch(buf, point_capacity, device)
        grids = build_hash_tree(cfg, pts, mask)
        vox_sem = majority_label(grids[0], pts, sem, mask, cfg.num_semantic)
        yield grids, vox_sem


def _cond_from_sample(s: dict, num_map_types: int, max_map: int,
                      max_box: int):
    maps = s.get(DatasetSpec.MAPS_3D, {})
    T = num_map_types
    mp = np.zeros((T, max_map, 3), np.float32)
    mm = np.zeros((T, max_map), bool)
    for ti, key in enumerate(sorted(maps)[:T]):
        p = maps[key]
        n = min(len(p), max_map)
        if n:
            sel = np.linspace(0, len(p) - 1, n).astype(int)
            mp[ti, :n] = p[sel]
            mm[ti, :n] = True
    boxes = s.get(DatasetSpec.BOXES_3D, {})
    bp = np.tile(np.eye(4, dtype=np.float32), (max_box, 1, 1))
    bl = np.ones((max_box, 3), np.float32)
    bm = np.zeros((max_box,), bool)
    poses = np.asarray(boxes.get("poses", np.zeros((0, 4, 4))))[:max_box]
    if len(poses):
        bp[:len(poses)] = poses
        bl[:len(poses)] = np.asarray(boxes["lwhs"])[:len(poses)]
        bm[:len(poses)] = True
    return mp, mm, bp, bl, bm


def diffusion_batches(dataset, diffusion, vae, vae_cfg: SparseVAEConfig,
                      batch_size: int = 2, point_capacity: int = 65536,
                      max_map: int = 8192, max_box: int = 32,
                      generator: torch.Generator | None = None,
                      eps: Iterable | None = None) -> Iterator:
    """-> (latents, CondCubes) batches: the frozen VAE's encode, mu +
    exp(logvar / 2) eps, and the condition cubes. ``eps`` (one standard
    normal tensor of the latents' shape per batch) replaces the draws from
    ``generator`` (seeded 0 on the VAE's device when None)."""
    dev = vae.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    eps_it = iter(eps) if eps is not None else None
    for buf in _batched(dataset, batch_size):
        pts, mask, sem = _points_batch(buf, point_capacity, dev)
        conds = [_cond_from_sample(s, diffusion.cfg.num_map_types, max_map,
                                   max_box) for s in buf]
        with torch.no_grad():
            grids = build_hash_tree(vae_cfg, pts, mask)
            vox_sem = majority_label(grids[0], pts, sem, mask,
                                     vae_cfg.num_semantic)
            mu, logvar = vae.encode(grids, vox_sem)
            e = next(eps_it).to(dev) if eps_it is not None else \
                torch.randn(mu.shape, generator=generator, device=dev)
            latents = mu + torch.exp(0.5 * logvar) * e
        cond = diffusion.encode_conditions(*(
            torch.from_numpy(np.stack([c[i] for c in conds]))
            for i in range(5)))
        yield latents, cond


def scale_by_std(batches: Iterator, save_path=None) -> Iterator:
    """Fix scale_factor = 1 / std(latents) (the population std) from the
    first batch, scale every batch's latents by it, and, with
    ``save_path``, write it as json so inference divides samples by the same
    value."""
    it = iter(batches)
    latents, cond = next(it)
    std = float(torch.std(latents.float(), correction=0))
    sf = float(1.0 / max(std, 1e-6))
    if save_path is not None:
        p = Path(save_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps({"scale_factor": sf}))
    yield latents * sf, cond
    for latents, cond in it:
        yield latents * sf, cond


def gsm_batches(dataset, gsm_cfg, voxel_capacity: int = 65536,
                point_capacity: int = 65536, device="cuda") -> Iterator:
    """-> GSM batch dicts, one scene a step; samples without input images
    are skipped."""
    from infinicube_tpu_torch.grid.build import grid_from_points
    from infinicube_tpu_torch.models.gsm.lifter import voxel_depth_prior
    device = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for s in dataset:
        if DatasetSpec.IMAGES_INPUT not in s:
            continue
        pts = t(s[DatasetSpec.INPUT_PC])[None]
        mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=device)
        grid = grid_from_points(pts, mask, 0.2, 0.1, capacity=voxel_capacity)
        images = t(s[DatasetSpec.IMAGES_INPUT])
        Ks = t(s[DatasetSpec.IMAGES_INPUT_INTRINSIC])
        poses = t(s[DatasetSpec.IMAGES_INPUT_POSE])
        depth_prior = voxel_depth_prior(
            grid, Ks, poses, gsm_cfg.dense_ijk_min, gsm_cfg.dense_dims,
            tuple(images.shape[1:3]))
        yield {
            "grid": grid,
            "images": images,
            "masks": t(s[DatasetSpec.IMAGES_INPUT_MASK]),
            "Ks": Ks,
            "cam_to_worlds": poses,
            "depth_prior": depth_prior,
        }
