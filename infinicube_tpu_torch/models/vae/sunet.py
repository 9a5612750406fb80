"""Sparse structure-prediction VAE; counterpart of
``infinicube_tpu/models/vae/sunet.py``.

The module holds the JAX module's whole parameter tree under the flax names
(``featurizer``, ``enc{l}_{i}``, ``neck``, ``dec{l}_{i}``, ``struct{l}``,
``sem_head``), so ``weights/from_jax.sparse_vae_from_jax`` loads it strictly.
Ported so far: the inference branch of ``decode`` (latents -> dense neck ->
per-level struct decisions that grow a capacity-bounded sparse grid ->
semantic logits on the finest grid), with the subpixel struct heads and the
unstable-structure cutoff. ``encode`` (it needs ``max_pool``'s scatter-max),
the teacher-forced training branch, the normal and color heads and the
attention levels (all off at release) wait.

The sparse convs of the decoder are K4 on the card; the release VAE
computes in f32 end to end."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.grid import keys as GK
from infinicube_tpu_torch.grid.build import grid_from_keys
from infinicube_tpu_torch.grid.grid import Grid
from infinicube_tpu_torch.grid.ops import (index_map, read_from_dense,
                                           upsample_nearest)
from infinicube_tpu_torch.nn.layers import Dense, conv3d_ndhwc, lecun_normal_
from infinicube_tpu_torch.nn.sparse import (GroupNormSparse, SparseConv3d,
                                            SparseResBlock, conv_plan)


@dataclasses.dataclass(frozen=True)
class SparseVAEConfig:
    num_semantic: int = 23
    sem_embed_dim: int = 32
    posenc_freqs: int = 5
    c_dim: int = 32
    f_maps: int = 64                       # level l features = f_maps * 2^l
    pooling_factors: tuple = ((2, 2, 1), (2, 2, 2))
    latent_channels: int = 8
    neck_dims: tuple = (64, 64, 64)
    neck_ijk_min: tuple = (-32, -32, -32)
    capacities: tuple = (131072, 65536, 32768)
    finest_voxel_size: tuple = (0.2, 0.2, 0.2)
    origin: tuple = (0.1, 0.1, 0.1)
    unstable_cutoff: bool = True
    unstable_cutoff_threshold: float = 0.4
    # the level-0 ijk cube that covers every voxel of the data crop; the
    # sparse convs' neighbour lookup goes through a slot volume over it
    dense_lookup_ijk_min: tuple = (-132, -132, -68)
    dense_lookup_dims: tuple = (264, 264, 136)
    dtype: torch.dtype = torch.float32

    @property
    def tree_depth(self) -> int:
        return len(self.pooling_factors) + 1

    def level_features(self, level: int) -> int:
        return self.f_maps * (2 ** level)

    def level_dense_bounds(self, level: int):
        """Static (ijk_min, dims) covering level ``level``: the level-0 cube
        pushed through the floor-div coarsening."""
        mn = np.asarray(self.dense_lookup_ijk_min, np.int64)
        mx = mn + np.asarray(self.dense_lookup_dims, np.int64) - 1
        for f in self.pooling_factors[:level]:
            f = np.asarray(f, np.int64)
            mn = np.floor_divide(mn, f)
            mx = np.floor_divide(mx, f)
        return (tuple(int(v) for v in mn),
                tuple(int(v) for v in (mx - mn + 1)))


class VoxelFeaturizer(nn.Module):
    """posenc(world xyz) + semantic embedding -> c_dim (parameters only: it
    feeds ``encode``, which waits)."""

    def __init__(self, cfg: SparseVAEConfig, device=None):
        super().__init__()
        self.Embed_0 = nn.Embedding(cfg.num_semantic, cfg.sem_embed_dim,
                                    device=device)
        self.Dense_0 = Dense(3 * (1 + 2 * cfg.posenc_freqs) +
                             cfg.sem_embed_dim, cfg.c_dim, device=device)


class DenseNeck(nn.Module):
    """Dense 64^3 bottleneck: ``pre`` and ``to_stats`` (encoder side) and
    ``post`` (decoder side), flax ``nn.Conv`` in f32."""

    def __init__(self, cfg: SparseVAEConfig, device=None):
        super().__init__()
        c = cfg.level_features(cfg.tree_depth - 1)
        self.pre = nn.Conv3d(c, c, 3, device=device)
        self.to_stats = nn.Conv3d(c, 2 * cfg.latent_channels, 1,
                                  device=device)
        self.post = nn.Conv3d(cfg.latent_channels, c, 3, device=device)
        self.dtype = cfg.dtype

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return F.silu(conv3d_ndhwc(z, self.post.weight, self.post.bias,
                                   self.dtype, padding=1))


def compact_dense_to_grid(occ_mask: torch.Tensor, cfg: SparseVAEConfig,
                          capacity: int, voxel_size, origin) -> Grid:
    """bool [B, D, H, W] -> sorted sparse Grid (capacity-bounded: overflow
    drops the highest keys)."""
    B, D, H, W = occ_mask.shape
    dev = occ_mask.device
    ii, jj, kk = torch.meshgrid(torch.arange(D, device=dev),
                                torch.arange(H, device=dev),
                                torch.arange(W, device=dev), indexing="ij")
    ijk = torch.stack([ii, jj, kk], -1).reshape(-1, 3) + \
        torch.tensor(cfg.neck_ijk_min, device=dev)
    keys = GK.pack(ijk)[None].expand(B, -1)
    qkeys = torch.where(occ_mask.reshape(B, -1), keys,
                        torch.full_like(keys, GK.INVALID_KEY))
    return grid_from_keys(qkeys, capacity, voxel_size, origin)


class SparseStructureVAE(nn.Module):
    """The VAE's parameters and its inference decode. Built on the card
    unless ``device="cpu"``."""

    def __init__(self, cfg: SparseVAEConfig = SparseVAEConfig(),
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.device = cfg, dev
        L = cfg.tree_depth
        lf = cfg.level_features
        self.featurizer = VoxelFeaturizer(cfg, device=dev)
        for l in range(L):
            fin = cfg.c_dim if l == 0 else lf(l - 1)
            for i in range(2):
                setattr(self, f"enc{l}_{i}", SparseResBlock(
                    fin if i == 0 else lf(l), lf(l), cfg.dtype, device=dev))
        self.neck = DenseNeck(cfg, device=dev)
        for l in range(L):
            fin = lf(l) if l == L - 1 else lf(l + 1)
            for i in range(2):
                setattr(self, f"dec{l}_{i}", SparseResBlock(
                    fin if i == 0 else lf(l), lf(l), cfg.dtype, device=dev))
        for l in range(L):
            if l < L - 1:
                fin, fout = lf(l + 1), 2 * int(np.prod(cfg.pooling_factors[l]))
            else:
                fin, fout = lf(l), 2
            setattr(self, f"struct{l}", Dense(fin, fout, device=dev))
        self.sem_head = Dense(lf(0), cfg.num_semantic, device=dev)

    def dec_blocks(self, level: int) -> list[SparseResBlock]:
        return [getattr(self, f"dec{level}_{i}") for i in range(2)]

    def struct_head(self, level: int) -> Dense:
        return getattr(self, f"struct{level}")

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random weights with the JAX module's initializer scales."""
        for m in self.modules():
            if isinstance(m, (Dense, nn.Conv3d)):
                fan_in = m.weight[0].numel()
                lecun_normal_(m.weight, fan_in, generator)
                m.bias.zero_()
            elif isinstance(m, SparseConv3d):
                m.reset_parameters(generator)
            elif isinstance(m, GroupNormSparse):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                                 generator=generator)

    def _level_voxel_size(self, level: int):
        vs = np.asarray(self.cfg.finest_voxel_size, np.float64)
        org = np.asarray(self.cfg.origin, np.float64)
        for f in self.cfg.pooling_factors[:level]:
            f = np.asarray(f)
            org = org + vs * (f - 1) / 2.0
            vs = vs * f
        return (torch.tensor(vs, dtype=torch.float32, device=self.device),
                torch.tensor(org, dtype=torch.float32, device=self.device))

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> dict:
        """Latents [B, D, H, W, latent] (the dense neck cube) -> dict with
        ``grid`` (finest Grid), ``grids`` (the grid of every level, coarsest
        first), ``semantic_logits`` [B, C0, num_semantic] and ``features``
        [B, C0, f_maps]."""
        cfg = self.cfg
        L = cfg.tree_depth
        z = z.to(self.device)
        B = z.shape[0]
        h_dense = self.neck.decode(z).float()
        logits_top = self.struct_head(L - 1)(h_dense)
        vs, org = self._level_voxel_size(L - 1)
        grid = compact_dense_to_grid(logits_top.argmax(-1) > 0, cfg,
                                     cfg.capacities[L - 1], vs, org)
        h = read_from_dense(grid, h_dense, cfg.neck_ijk_min)
        del h_dense, logits_top
        grids = [grid]
        for l in range(L - 1, -1, -1):
            plan = conv_plan(grid, dense_bounds=cfg.level_dense_bounds(l))
            for blk in self.dec_blocks(l):
                h = blk(h.to(cfg.dtype), plan, grid.mask)
            if l == 0:
                break
            factor = cfg.pooling_factors[l - 1]
            nchild = int(np.prod(factor))
            cand, h_cand = upsample_nearest(grid, h, factor,
                                            capacity=grid.capacity * nchild)
            # subpixel struct head: per-child logits from the parent's
            # features, gathered by parent index and row-major child slot
            plog = self.struct_head(l - 1)(h.float())
            plog = plog.reshape(B, grid.capacity * nchild, 2)
            f = torch.tensor(factor, dtype=torch.int32, device=self.device)
            pijk = torch.div(cand.ijk, f, rounding_mode="floor")
            pidx = grid.ijk_to_index(pijk, cand.mask).long()
            off = cand.ijk - pijk * f
            off_idx = (off[..., 0] * f[1] + off[..., 1]) * f[2] + off[..., 2]
            slot = pidx.clamp_min(0) * nchild + off_idx
            logits = torch.gather(plog, 1, slot[..., None].expand(-1, -1, 2))
            ok = (pidx >= 0) & cand.mask
            logits = torch.where(ok[..., None], logits,
                                 torch.zeros_like(logits))
            keep = (logits.argmax(-1) > 0) & cand.mask
            if cfg.unstable_cutoff:
                # runaway-structure guard: drop the decision where the
                # predicted occupancy exceeds the threshold share of the
                # dense bound at the candidate level
                bound = float(np.prod(cfg.neck_dims))
                for fac in cfg.pooling_factors[l - 1:]:
                    bound *= float(np.prod(fac))
                ratio = keep.sum(dim=1) / bound
                keep = keep & (ratio[:, None] <= cfg.unstable_cutoff_threshold)
            kept = torch.where(keep, cand.keys,
                               torch.full_like(cand.keys, GK.INVALID_KEY))
            new_grid = grid_from_keys(kept, cfg.capacities[l - 1],
                                      cand.voxel_size, cand.origin)
            move = index_map(new_grid, cand).long()
            h = torch.gather(h_cand, 1, move.clamp_min(0)[..., None].expand(
                -1, -1, h_cand.shape[-1]))
            h = torch.where((move >= 0)[..., None], h, torch.zeros_like(h))
            grid = new_grid
            grids.append(grid)
        return {"grid": grid, "grids": grids,
                "semantic_logits": self.sem_head(h.float()), "features": h}
