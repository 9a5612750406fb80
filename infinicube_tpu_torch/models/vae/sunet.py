"""Sparse structure-prediction VAE; counterpart of
``infinicube_tpu/models/vae/sunet.py``.

The module holds the JAX module's whole parameter tree under the flax names
(``featurizer``, ``enc{l}_{i}``, ``neck``, ``dec{l}_{i}``, ``struct{l}``,
``sem_head``), so ``weights/from_jax.sparse_vae_from_jax`` loads it strictly.
Ported: the hash tree, the voxel featurizer, ``encode`` (sparse res blocks
with max pooling into the hash tree's next level, then the dense neck), ``reparametrize``
with injectable noise, both branches of ``decode`` (inference: per-level
struct decisions grow a capacity-bounded sparse grid, under ``no_grad``;
training: teacher forcing on the hash tree's grids and plans, returning the
per-level struct triples) and ``forward``; and, all off at release, the
attention levels (``attn{l}_{enc,dec}_qkv`` / ``_proj``: ``sparse_attention``
after a level's encoder blocks and, in f32, after its decoder blocks), the
normal head and the color head behind a sigmoid (outputs only: the loss
does not read them), the featurizer's extra per-voxel inputs (its width a
constructor argument, since the VAE itself never passes them), and the
``conv_backend`` and ``dense_lookup`` switches of every conv plan.

The sparse convs are K4 on the card, their gradients K4 again and K6, and
the attention levels ``flash_attn_f32`` and its backward; the release VAE
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
from infinicube_tpu_torch.grid.build import (coarsened_grid, grid_from_keys,
                                             grid_from_points)
from infinicube_tpu_torch.grid.grid import Grid
from infinicube_tpu_torch.grid.ops import (index_map, max_pool,
                                           read_from_dense, to_dense,
                                           upsample_nearest)
from infinicube_tpu_torch.nn.layers import Dense, conv3d_ndhwc, lecun_normal_
from infinicube_tpu_torch.nn.sparse import (GroupNormSparse, SparseConv3d,
                                            SparseResBlock, conv_plan,
                                            sparse_attention)


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
    use_normal_head: bool = False
    use_color_head: bool = False
    attention_levels: tuple = ()          # levels with sparse attention
    attn_heads: int = 4
    unstable_cutoff: bool = True
    unstable_cutoff_threshold: float = 0.4
    conv_backend: str = "auto"            # nn.sparse.conv_plan's backend
    # the level-0 ijk cube that covers every voxel of the data crop; with
    # dense_lookup the sparse convs' neighbour lookup goes through a slot
    # volume over it
    dense_lookup: bool = True
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
        pushed through the floor-div coarsening; None when dense_lookup is
        off."""
        if not self.dense_lookup:
            return None
        mn = np.asarray(self.dense_lookup_ijk_min, np.int64)
        mx = mn + np.asarray(self.dense_lookup_dims, np.int64) - 1
        for f in self.pooling_factors[:level]:
            f = np.asarray(f, np.int64)
            mn = np.floor_divide(mn, f)
            mx = np.floor_divide(mx, f)
        return (tuple(int(v) for v in mn),
                tuple(int(v) for v in (mx - mn + 1)))


def build_hash_tree(cfg: SparseVAEConfig, points: torch.Tensor,
                    point_mask: torch.Tensor) -> list[Grid]:
    """Grid pyramid [G0 (finest) ... G_L (coarsest)] from input points
    [B, N, 3] and their mask [B, N]."""
    g = grid_from_points(points, point_mask, cfg.finest_voxel_size,
                         cfg.origin, capacity=cfg.capacities[0])
    grids = [g]
    for lvl, f in enumerate(cfg.pooling_factors):
        g = coarsened_grid(g, tuple(f), capacity=cfg.capacities[lvl + 1])
        grids.append(g)
    return grids


def posenc(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """NeRF positional encoding incl. identity."""
    out = [x]
    for i in range(num_freqs):
        out.append(torch.sin(x * (2.0 ** i)))
        out.append(torch.cos(x * (2.0 ** i)))
    return torch.cat(out, dim=-1)


class VoxelFeaturizer(nn.Module):
    """posenc(world xyz) + semantic embedding [+ extra per-voxel inputs,
    such as normals, intensity or color, ``extra_dim`` wide] -> c_dim
    features per voxel."""

    def __init__(self, cfg: SparseVAEConfig, device=None,
                 extra_dim: int = 0):
        super().__init__()
        self.cfg, self.extra_dim = cfg, extra_dim
        self.Embed_0 = nn.Embedding(cfg.num_semantic, cfg.sem_embed_dim,
                                    device=device)
        self.Dense_0 = Dense(3 * (1 + 2 * cfg.posenc_freqs) +
                             cfg.sem_embed_dim + extra_dim, cfg.c_dim,
                             device=device)

    def forward(self, grid: Grid, semantics: torch.Tensor,
                extra_feats: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        dev = grid.ijk.device
        # normalize by the crop extent for stable scales
        extent = torch.tensor(cfg.neck_dims, dtype=torch.float32,
                              device=dev) * \
            torch.tensor(cfg.finest_voxel_size, dtype=torch.float32,
                         device=dev) * 4.0
        pe = posenc(grid.voxel_centers() / extent, cfg.posenc_freqs)
        sem = self.Embed_0(semantics.long().clamp(0, cfg.num_semantic - 1))
        parts = [pe, sem]
        if (extra_feats is not None) != bool(self.extra_dim):
            raise ValueError(f"this featurizer takes {self.extra_dim} extra "
                             "input channels")
        if extra_feats is not None:
            parts.append(extra_feats.to(pe.device, pe.dtype))
        h = self.Dense_0(torch.cat(parts, dim=-1))
        return torch.where(grid.mask[..., None], h, torch.zeros_like(h))


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

    def encode(self, dense: torch.Tensor):
        """Dense [B, D, H, W, c] -> (mu, logvar), each [B, D, H, W, latent]
        f32; logvar clipped to [-30, 20]."""
        h = F.silu(conv3d_ndhwc(dense, self.pre.weight, self.pre.bias,
                                self.dtype, padding=1))
        stats = conv3d_ndhwc(h, self.to_stats.weight, self.to_stats.bias,
                             torch.float32)
        mu, logvar = stats.chunk(2, dim=-1)
        return mu, logvar.clamp(-30.0, 20.0)

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
    """The full VAE. Built on the card unless ``device="cpu"``."""

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
        if cfg.use_normal_head:
            self.normal_head = Dense(lf(0), 3, device=dev)
        if cfg.use_color_head:
            self.color_head = Dense(lf(0), 3, device=dev)
        for l in cfg.attention_levels:
            for side in ("enc", "dec"):
                setattr(self, f"attn{l}_{side}_qkv",
                        Dense(lf(l), 3 * lf(l), compute_dtype=None,
                              device=dev))
                setattr(self, f"attn{l}_{side}_proj",
                        Dense(lf(l), lf(l), compute_dtype=None, device=dev))

    def enc_blocks(self, level: int) -> list[SparseResBlock]:
        return [getattr(self, f"enc{level}_{i}") for i in range(2)]

    def dec_blocks(self, level: int) -> list[SparseResBlock]:
        return [getattr(self, f"dec{level}_{i}") for i in range(2)]

    def struct_head(self, level: int) -> Dense:
        return getattr(self, f"struct{level}")

    def _attend(self, h: torch.Tensor, grid: Grid, level: int,
                side: str) -> torch.Tensor:
        """The level's sparse attention (its ``side``'s Dense pair) where
        the config attends at ``level``; the decoder's in f32."""
        if level not in self.cfg.attention_levels:
            return h
        if side == "dec":
            h = h.float()
        return sparse_attention(h, grid.mask, self.cfg.attn_heads,
                                getattr(self, f"attn{level}_{side}_qkv"),
                                getattr(self, f"attn{level}_{side}_proj"))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random weights with the JAX module's initializer scales (the
        attention levels' ``proj`` kernels at zero)."""
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
        for l in self.cfg.attention_levels:
            for side in ("enc", "dec"):
                getattr(self, f"attn{l}_{side}_proj").weight.zero_()

    def _level_voxel_size(self, level: int):
        vs = np.asarray(self.cfg.finest_voxel_size, np.float64)
        org = np.asarray(self.cfg.origin, np.float64)
        for f in self.cfg.pooling_factors[:level]:
            f = np.asarray(f)
            org = org + vs * (f - 1) / 2.0
            vs = vs * f
        return (torch.tensor(vs, dtype=torch.float32, device=self.device),
                torch.tensor(org, dtype=torch.float32, device=self.device))

    def level_plans(self, grids: list[Grid]) -> list:
        """The conv plan of every level of a hash tree."""
        return [self._plan(g, l) for l, g in enumerate(grids)]

    def _plan(self, grid: Grid, level: int):
        cfg = self.cfg
        return conv_plan(grid, dense_bounds=cfg.level_dense_bounds(level),
                         backend=cfg.conv_backend)

    # ------------------------------------------------------------------ enc
    def encode(self, grids: list[Grid], semantics: torch.Tensor,
               plans: list | None = None):
        """grids: hash tree [G0..G_L]; semantics int [B, C0] on G0. Returns
        (mu, logvar), dense [B, D, H, W, latent]. ``plans``: the conv plan
        of every level, shared with the teacher-forced decoder."""
        cfg = self.cfg
        plans = plans if plans is not None else self.level_plans(grids)
        h = self.featurizer(grids[0], semantics.to(self.device))
        for l, g in enumerate(grids):
            for blk in self.enc_blocks(l):
                h = blk(h.to(cfg.dtype), plans[l], g.mask)
            h = self._attend(h, g, l, "enc")
            if l < len(cfg.pooling_factors):
                _, h = max_pool(g, h, cfg.pooling_factors[l],
                                coarse=grids[l + 1])
        dense = to_dense(grids[-1], h.float(), cfg.neck_ijk_min,
                         cfg.neck_dims)
        return self.neck.encode(dense)

    @staticmethod
    def reparametrize(mu: torch.Tensor, logvar: torch.Tensor,
                      generator: torch.Generator | None = None,
                      noise: torch.Tensor | None = None) -> torch.Tensor:
        """mu + exp(logvar / 2) * noise; the noise is the given tensor or a
        standard-normal draw from ``generator``."""
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator,
                                device=mu.device, dtype=mu.dtype)
        return mu + torch.exp(0.5 * logvar) * noise.to(mu.device, mu.dtype)

    # ------------------------------------------------------------------ dec
    def decode(self, z: torch.Tensor, guide_grids: list[Grid] | None = None,
               guide_plans: list | None = None) -> dict:
        """Latents [B, D, H, W, latent] (the dense neck cube) -> dict with
        ``grid`` (finest Grid), ``grids`` (the grid of every level, coarsest
        first), ``semantic_logits`` [B, C0, num_semantic], ``features``
        [B, C0, f_maps] and ``struct``.

        Inference (``guide_grids`` None) runs under ``no_grad``: predicted
        masks grow the grid, and ``struct`` is empty. Training
        (``guide_grids`` = the hash tree) is teacher-forced and
        differentiable: the pruned grid at each level equals the hash
        tree's (every voxel's parent is in the tree), so its grids and
        their conv plans (``guide_plans``) are reused, and
        ``struct`` lists per level, coarsest first, (logits [B, Ck, 2],
        target bool, candidate mask)."""
        if guide_grids is None:
            with torch.no_grad():
                return self._decode(z, None, None)
        return self._decode(z, guide_grids, guide_plans)

    def _decode(self, z, guide_grids, guide_plans) -> dict:
        cfg = self.cfg
        L = cfg.tree_depth
        forced = guide_grids is not None
        z = z.to(self.device)
        B = z.shape[0]
        h_dense = self.neck.decode(z).float()
        logits_top = self.struct_head(L - 1)(h_dense)
        struct_out = []
        if forced:
            grid = guide_grids[L - 1]
            occ = to_dense(grid, grid.mask[..., None].float(),
                           cfg.neck_ijk_min, cfg.neck_dims)[..., 0] > 0
            struct_out.append((logits_top.reshape(B, -1, 2),
                               occ.reshape(B, -1),
                               torch.ones_like(occ.reshape(B, -1))))
        else:
            vs, org = self._level_voxel_size(L - 1)
            grid = compact_dense_to_grid(logits_top.argmax(-1) > 0, cfg,
                                         cfg.capacities[L - 1], vs, org)
        h = read_from_dense(grid, h_dense, cfg.neck_ijk_min)
        del h_dense, logits_top
        grids = [grid]
        for l in range(L - 1, -1, -1):
            plan = guide_plans[l] if forced and guide_plans is not None \
                else self._plan(grid, l)
            for blk in self.dec_blocks(l):
                h = blk(h.to(cfg.dtype), plan, grid.mask)
            h = self._attend(h, grid, l, "dec")
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
            if forced:
                # teacher forcing: the surviving set is the hash tree's grid
                new_grid = guide_grids[l - 1]
                member = index_map(cand, new_grid) >= 0
                struct_out.append((logits, member & cand.mask, cand.mask))
            else:
                new_grid = self._pruned_grid(logits, cand, l)
            move = index_map(new_grid, cand).long()
            h = torch.gather(h_cand, 1, move.clamp_min(0)[..., None].expand(
                -1, -1, h_cand.shape[-1]))
            h = torch.where((move >= 0)[..., None], h, torch.zeros_like(h))
            grid = new_grid
            grids.append(grid)
        out = {"grid": grid, "grids": grids,
               "semantic_logits": self.sem_head(h.float()), "features": h,
               "struct": struct_out}
        if cfg.use_normal_head:
            out["normals"] = self.normal_head(h.float())
        if cfg.use_color_head:
            out["colors"] = torch.sigmoid(self.color_head(h.float()))
        return out

    def _pruned_grid(self, logits: torch.Tensor, cand: Grid,
                     level: int) -> Grid:
        """The candidates of ``cand`` (the subdivision of level ``level``)
        that the struct head keeps, re-compacted to the next finer level's
        capacity."""
        cfg = self.cfg
        keep = (logits.argmax(-1) > 0) & cand.mask
        if cfg.unstable_cutoff:
            # runaway-structure guard: drop the decision where the
            # predicted occupancy exceeds the threshold share of the
            # dense bound at the candidate level
            bound = float(np.prod(cfg.neck_dims))
            for fac in cfg.pooling_factors[level - 1:]:
                bound *= float(np.prod(fac))
            ratio = keep.sum(dim=1) / bound
            keep = keep & (ratio[:, None] <= cfg.unstable_cutoff_threshold)
        kept = torch.where(keep, cand.keys,
                           torch.full_like(cand.keys, GK.INVALID_KEY))
        return grid_from_keys(kept, cfg.capacities[level - 1],
                              cand.voxel_size, cand.origin)

    # ------------------------------------------------------------- combined
    def forward(self, grids: list[Grid], semantics: torch.Tensor,
                generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None) -> dict:
        """Encode, reparametrize (``noise`` given, or drawn from
        ``generator``) and decode teacher-forced on the same grids and
        plans."""
        plans = self.level_plans(grids)
        mu, logvar = self.encode(grids, semantics, plans=plans)
        z = self.reparametrize(mu, logvar, generator, noise)
        dec = self.decode(z, guide_grids=grids, guide_plans=plans)
        return {"mu": mu, "logvar": logvar, "z": z, **dec}
