"""Layers with flax's dtype semantics, shared by the port's models.

flax ``nn.Dense(dtype=...)`` casts input, kernel and bias to ``dtype`` and
returns ``dtype``; with ``dtype=None`` it computes in the result type of
the input and the parameters (``promote_dtype``: bf16 features into an
f32 layer compute in f32). ``nn.RMSNorm``/``nn.LayerNorm(dtype=float32)``
compute in f32 with eps 1e-6. These layers do the same, with torch's
[out, in] weight layout (``weights/from_jax.py`` transposes flax
kernels)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-6  # flax RMSNorm / LayerNorm default


def compute_dtype(x: torch.Tensor, param: torch.Tensor,
                  dtype: torch.dtype | None) -> torch.dtype:
    """flax's ``promote_dtype``: ``dtype`` where given, else the result
    type of the input and the parameter."""
    return dtype or torch.promote_types(x.dtype, param.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax ``Dense(dtype)``;
    ``None`` promotes as flax does)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype | None = torch.float32,
                 device=None, dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(x, self.weight, self.compute_dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(dtype=float32)``: ``x * rsqrt(mean(x^2) + 1e-6) *
    weight`` over the last dim, computed and returned in f32."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        y = x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + EPS)
        return y * self.weight.float()


def conv3d_ndhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 dtype: torch.dtype, stride: int = 1,
                 padding=0) -> torch.Tensor:
    """flax ``nn.Conv(dtype)`` on an NDHWC tensor: input, kernel [O, C, k,
    k, k] and bias cast to ``dtype``."""
    out = F.conv3d(x.to(dtype).permute(0, 4, 1, 2, 3), weight.to(dtype),
                   bias.to(dtype), stride=stride, padding=padding)
    return out.permute(0, 2, 3, 4, 1)


def layer_norm(x: torch.Tensor, weight=None, bias=None) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)`` over the last dim, in f32."""
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, EPS)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """Fill with N(0, 1/fan_in), the scale of flax's ``lecun_normal``."""
    with torch.no_grad():
        w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax ``padding="SAME"`` on one axis: (low, high) so that the output
    has ceil(size / stride) positions; the odd pixel goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """flax ``nn.Conv(dtype)`` in 2-D (SAME padding, or a symmetric
    ``padding`` given; ``feature_group_count``; ``use_bias``) on NCHW
    tensors, weight [O, I / groups, kh, kw] (``weights/from_jax.py``
    re-lays out flax's HWIO kernels), computing in ``dtype`` (``None``
    promotes as flax does)."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, groups: int = 1, device=None,
                 dtype: torch.dtype | None = None, bias: bool = True,
                 padding: int | None = None):
        super().__init__()
        self.stride, self.groups, self.dtype = stride, groups, dtype
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(
            (features, in_features // groups, kernel, kernel), device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) \
            if bias else None

    def same_pad(self, x: torch.Tensor):
        """(x, padding): SAME padding (or the ``padding`` given) as the
        conv's symmetric ``padding`` argument, or applied to x where it is
        uneven (padding 0 then)."""
        if self.padding is not None:
            return x, (self.padding, self.padding)
        k, s = self.weight.shape[-1], self.stride
        (hl, hh), (wl, wh) = (same_padding(n, k, s) for n in x.shape[-2:])
        if hl != hh or wl != wh:
            return F.pad(x, (wl, wh, hl, hh)), (0, 0)
        return x, (hl, wl)

    def operands(self, x: torch.Tensor):
        """x, weight and bias in the compute dtype."""
        dt = compute_dtype(x, self.weight, self.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return x.to(dt), self.weight.to(dt), bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = self.operands(x)
        x, padding = self.same_pad(x)
        return F.conv2d(x, weight, bias, stride=self.stride,
                        padding=padding, groups=self.groups)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (``nn.SelfAttention``) over
    x [B, L, E] computing in ``dtype`` (flax 0.12's
    ``force_fp32_for_softmax=False``): q, k, v and out projections (flax's
    [E, heads, d] kernels flattened to [E, E]), q scaled by 1/sqrt(d),
    the logits, their mask at the dtype's minimum and the softmax all in
    ``dtype`` (f32 or bf16). ``mask`` bool [B, L] marks the keys to attend
    to."""

    def __init__(self, dim: int, heads: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Dense(dim, dim, compute_dtype=dtype,
                                      device=device))

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        B, L, E = x.shape
        h = self.heads
        d = E // h
        # flax scales q in its dtype: sqrt(d) rounded to it first
        q = self.query(x).reshape(B, L, h, d)
        q = q / torch.tensor(math.sqrt(d), dtype=q.dtype)
        k = self.key(x).reshape(B, L, h, d)
        v = self.value(x).reshape(B, L, h, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = torch.where(mask[:, None, None, :], logits,
                                 torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, E)
        return self.out(o)
