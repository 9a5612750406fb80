"""The fully sparse diffusion denoiser; counterpart of
``infinicube_tpu/models/diffusion/unet_sparse.py``.

The dense UNet's ResBlock / attention skeleton on a fixed grid pyramid
(``SparseUNetConfig``: 64 channels, mult (1, 2), attention at level 1):
``SparseTimestepResBlock`` (masked GroupNorm, SiLU, sparse conv, a
scale-shift from the time embedding, a second conv, a Dense skip where the
widths differ), ``SparseAttentionBlock`` (``nn.sparse.sparse_attention`` on
the normalized features), max pooling into the next level, nearest
upsampling back with the skips concatenated, and, where a context is given
(the crossattn variant), a cross-attention on it after the middle
attention. Used where the latent grid is not densified (the release's 64^3
latent uses ``unet3d.UNet3D``).

Submodule names are the flax names, so ``weights/from_jax.
sparse_unet_from_jax`` is a re-layout. The sparse convs are K4 on the card
(the bf16 twin where ``dtype`` is bf16), the attention ``flash_attn_f32``
(K2 in bf16); the cross-attention is an einsum in the reference and stays
plain PyTorch, with its softmax as the reference writes it (query rows of
masked voxels set to 0 before the max)."""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.grid.grid import Grid
from infinicube_tpu_torch.grid.ops import max_pool, upsample_nearest
from infinicube_tpu_torch.models.diffusion.unet3d import timestep_embedding
from infinicube_tpu_torch.nn.layers import Dense, lecun_normal_
from infinicube_tpu_torch.nn.sparse import (GroupNormSparse, SparseConv3d,
                                            conv_plan, sparse_attention)


@dataclasses.dataclass(frozen=True)
class SparseUNetConfig:
    out_channels: int = 8
    model_channels: int = 64
    channel_mult: Sequence[int] = (1, 2)
    num_res_blocks: int = 1
    attend_levels: Sequence[int] = (1,)
    num_heads: int = 4
    pooling_factor: tuple = (2, 2, 2)
    conv_backend: str = "auto"
    dtype: torch.dtype = torch.float32


def _dense(cin: int, cout: int, device) -> Dense:
    """flax ``nn.Dense`` without a dtype: computes in the promoted type."""
    return Dense(cin, cout, compute_dtype=None, device=device)


class SparseTimestepResBlock(nn.Module):
    def __init__(self, in_features: int, features: int, emb_ch: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.GroupNormSparse_0 = GroupNormSparse(in_features, device=device)
        self.conv1 = SparseConv3d(in_features, features, dtype=dtype,
                                  device=device)
        self.emb = _dense(emb_ch, 2 * features, device)
        self.gn2 = GroupNormSparse(features, device=device)
        self.conv2 = SparseConv3d(features, features, dtype=dtype,
                                  device=device)
        self.skip = _dense(in_features, features, device) \
            if in_features != features else None

    def forward(self, feats, emb, plan, mask):
        h = self.conv1(F.silu(self.GroupNormSparse_0(feats, mask)), plan)
        scale, shift = self.emb(F.silu(emb))[:, None, :].chunk(2, dim=-1)
        h = F.silu(self.gn2(h, mask) * (1 + scale) + shift)
        h = self.conv2(h, plan)
        if self.skip is not None:
            feats = self.skip(feats)
        out = feats + h
        return torch.where(mask[..., None], out, torch.zeros_like(out))


class SparseAttentionBlock(nn.Module):
    def __init__(self, features: int, num_heads: int, device=None):
        super().__init__()
        self.heads = num_heads
        self.GroupNormSparse_0 = GroupNormSparse(features, device=device)
        self.qkv = _dense(features, 3 * features, device)
        self.proj = _dense(features, features, device)

    def forward(self, feats, mask):
        h = self.GroupNormSparse_0(feats, mask)
        return sparse_attention(h, mask, self.heads, self.qkv, self.proj)


class SparseUNet(nn.Module):
    """Denoiser over (grid pyramid, per-voxel latents): ``forward(grids
    [G0 .. G_L] (structure fixed while denoising), x [B, C0, in_channels],
    t [B], context [B, L, context_dim] | None) -> [B, C0, out_channels]``.
    ``in_channels`` defaults to ``out_channels``; the crossattn variant's
    layers exist where ``context_dim`` is given. Built on the card unless
    ``device="cpu"``."""

    def __init__(self, cfg: SparseUNetConfig = SparseUNetConfig(),
                 in_channels: int | None = None,
                 context_dim: int | None = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.device = cfg, dev
        ch = cfg.model_channels
        emb = 4 * ch
        # flax numbers the outer Dense of ``Dense(Dense(emb))`` first
        self.Dense_0 = _dense(emb, emb, dev)
        self.Dense_1 = _dense(ch, emb, dev)
        self.in_proj = _dense(in_channels or cfg.out_channels, ch, dev)
        c, widths = ch, []
        for l, mult in enumerate(cfg.channel_mult):
            for i in range(cfg.num_res_blocks):
                setattr(self, f"enc{l}_{i}", SparseTimestepResBlock(
                    c, ch * mult, emb, cfg.dtype, dev))
                c = ch * mult
                if l in cfg.attend_levels:
                    setattr(self, f"enc_attn{l}_{i}",
                            SparseAttentionBlock(c, cfg.num_heads, dev))
            widths.append(c)
        self.mid1 = SparseTimestepResBlock(c, c, emb, cfg.dtype, dev)
        self.mid_attn = SparseAttentionBlock(c, cfg.num_heads, dev)
        self.cross = context_dim is not None
        if self.cross:
            self.xq = _dense(c, c, dev)
            self.xk = _dense(context_dim, c, dev)
            self.xv = _dense(context_dim, c, dev)
            self.xo = _dense(c, c, dev)
        self.mid2 = SparseTimestepResBlock(c, c, emb, cfg.dtype, dev)
        for l in range(len(cfg.channel_mult) - 2, -1, -1):
            setattr(self, f"dec{l}", SparseTimestepResBlock(
                c + widths[l], ch * cfg.channel_mult[l], emb, cfg.dtype,
                dev))
            c = ch * cfg.channel_mult[l]
        self.out_gn = GroupNormSparse(c, device=dev)
        self.out = _dense(c, cfg.out_channels, dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random weights with the JAX module's initializer scales; the
        layers it starts at zero (``proj``, ``xo``, ``out``) stay zero."""
        for name, m in self.named_modules():
            if isinstance(m, Dense):
                if name.rsplit(".", 1)[-1] in ("proj", "xo", "out"):
                    m.weight.zero_()
                else:
                    lecun_normal_(m.weight, m.in_features, generator)
                m.bias.zero_()
            elif isinstance(m, SparseConv3d):
                m.reset_parameters(generator)
            elif isinstance(m, GroupNormSparse):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def _cross_attention(self, h, context, mask):
        Fe = h.shape[-1]
        q = self.xq(h)
        k, v = self.xk(context), self.xv(context)
        a = torch.einsum("bcf,blf->bcl", q, k) / math.sqrt(Fe)
        a = torch.where(mask[..., None], a, torch.zeros_like(a))
        e = torch.exp(a - a.amax(dim=-1, keepdim=True))
        w = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-6)
        return h + self.xo(torch.einsum("bcl,blf->bcf", w, v))

    def forward(self, grids: list[Grid], x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        L = len(cfg.channel_mult)
        if len(grids) < L:
            raise ValueError(f"{len(grids)} grids for {L} levels")
        if (context is not None) != self.cross:
            raise ValueError("a context goes with context_dim, and only "
                             "with it")
        emb = self.Dense_0(F.silu(self.Dense_1(timestep_embedding(
            t.to(self.device), cfg.model_channels))))
        h = self.in_proj(x.to(self.device))
        skips = []
        plans = [conv_plan(g, backend=cfg.conv_backend) for g in grids[:L]]
        for l in range(L):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"enc{l}_{i}")(h, emb, plans[l],
                                                 grids[l].mask)
                if l in cfg.attend_levels:
                    h = getattr(self, f"enc_attn{l}_{i}")(h, grids[l].mask)
            skips.append(h)
            if l < L - 1:
                _, h = max_pool(grids[l], h, cfg.pooling_factor,
                                coarse=grids[l + 1])
        mask = grids[L - 1].mask
        h = self.mid1(h, emb, plans[L - 1], mask)
        h = self.mid_attn(h, mask)
        if context is not None:
            h = self._cross_attention(h, context.to(self.device), mask)
        h = self.mid2(h, emb, plans[L - 1], mask)
        for l in range(L - 2, -1, -1):
            _, h = upsample_nearest(grids[l + 1], h, cfg.pooling_factor,
                                    fine=grids[l])
            h = torch.cat([h, skips[l]], dim=-1)
            h = getattr(self, f"dec{l}")(h, emb, plans[l], grids[l].mask)
        h = F.silu(self.out_gn(h, grids[0].mask))
        out = self.out(h)
        return torch.where(grids[0].mask[..., None], out,
                           torch.zeros_like(out))
