"""Dense 3D UNet denoiser of the voxel latent diffusion model; counterpart
of ``infinicube_tpu/models/diffusion/unet3d.py``.

Submodules carry the flax auto-names (``ResBlock3D_{n}``,
``SelfAttention3D_{n}``, ``Dense_0/1``, ``GroupNorm32_0`` with a nested
``GroupNorm_0``, ``down{l}``, ``up{l}``, ``in_conv``, ``out_conv``,
``middle_transformer.blocks.{i}``, with a context ``cross_q/k/v/o``,
``y_proj`` with ``num_classes``) so that ``weights/from_jax.unet_from_jax``
is a re-layout. Layout is NDHWC throughout, as in JAX. With ``context_dim``
the middle transformer's blocks cross-attend to the context tokens (JAX
unrolls them into ``block{i}`` then, and the converter takes both
layouts); with ``num_classes`` the class one-hot's ``y_proj`` is added to
the time embedding.

Dtypes follow the reference: activations in ``dtype`` (bf16 at release)
with f32 parameters cast per call, GroupNorm and softmax in f32, the f32
``out_conv``. The 3x3x3 stride-1 convs are ``Conv3x3x3`` (kernel K3 on the
card, forward and input gradient) and the UNet's ``SelfAttention3D`` goes
through ``multi_head_attention`` (K2 forward, K5 backward, head dim 96 at
release). The stride-2 ``down{l}``, the 1x1 ``skip`` and ``out_conv`` were
flax ``nn.Conv`` (XLA) in JAX and are ``torch.nn.functional.conv3d`` here;
so are the Dense layers and the middle transformer's einsum attention
(self and cross).
``remat`` recomputes each ``ResBlock3D`` and the middle transformer in the
backward pass instead of keeping their activations (flax ``nn.remat`` over
the same two block kinds). ``conv_quant`` makes every ``Conv3x3x3`` int8
where ``int8_conv_applies`` holds for its input (K7 on the card);
``serving_twin`` gives that UNet on this one's parameters."""

from __future__ import annotations

import copy
import itertools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from infinicube_tpu_torch.nn.layers import (Dense, conv3d_ndhwc, layer_norm,
                                            lecun_normal_)
from infinicube_tpu_torch.ops.attention import multi_head_attention
from infinicube_tpu_torch.ops.dense_conv import Conv3x3x3


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding. t int/float[B] -> f32[B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) *
                      torch.arange(half, dtype=torch.float32,
                                   device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


class _GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` parameters (``scale`` -> weight, ``bias``)."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))


class GroupNorm32(nn.Module):
    """GroupNorm (eps 1e-5) over the channels-last tensor, computed in f32
    and returned in the input's dtype."""

    def __init__(self, ch: int, num_groups: int = 32, device=None):
        super().__init__()
        self.groups = math.gcd(min(num_groups, ch), ch)
        self.GroupNorm_0 = _GroupNorm(ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        g = self.groups
        xf = x.float().reshape(B, -1, g, C // g)
        var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True,
                                   correction=0)
        y = ((xf - mean) * torch.rsqrt(var + 1e-5)).reshape(x.shape)
        y = y * self.GroupNorm_0.weight + self.GroupNorm_0.bias
        return y.to(x.dtype)


class _ConvParams(nn.Module):
    """Parameters of a flax ``nn.Conv`` (weight OIDHW, bias)."""

    def __init__(self, cin: int, cout: int, k: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin, k, k, k),
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))


class ResBlock3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, emb_ch: int,
                 dtype: torch.dtype, device=None, conv_quant: bool = False):
        super().__init__()
        self.dtype = dtype
        self.GroupNorm32_0 = GroupNorm32(in_ch, device=device)
        self.conv1 = Conv3x3x3(in_ch, out_ch, dtype, device=device,
                               quant=conv_quant)
        self.emb_proj = Dense(emb_ch, 2 * out_ch, compute_dtype=dtype,
                              device=device)
        self.GroupNorm32_1 = GroupNorm32(out_ch, device=device)
        self.conv2 = Conv3x3x3(out_ch, out_ch, dtype, device=device,
                               quant=conv_quant)
        self.skip = _ConvParams(in_ch, out_ch, 1, device=device) \
            if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.GroupNorm32_0(x)))
        e = self.emb_proj(F.silu(emb))[:, None, None, None, :]
        scale, shift = e.chunk(2, dim=-1)
        h = F.silu(self.GroupNorm32_1(h) * (1 + scale) + shift)
        h = self.conv2(h)
        if self.skip is not None:
            x = conv3d_ndhwc(x, self.skip.weight, self.skip.bias,
                             self.dtype)
        return x + h


class SelfAttention3D(nn.Module):
    """Spatial self-attention over the flattened voxels."""

    def __init__(self, ch: int, num_heads: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.heads, self.dtype = num_heads, dtype
        self.GroupNorm32_0 = GroupNorm32(ch, device=device)
        self.qkv = Dense(ch, 3 * ch, compute_dtype=dtype, device=device)
        self.proj = Dense(ch, ch, compute_dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        h = self.GroupNorm32_0(x).reshape(B, -1, C)
        qkv = self.qkv(h).reshape(B, -1, 3, self.heads, C // self.heads)
        out = multi_head_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        out = self.proj(out.reshape(B, -1, C))
        return x + out.reshape(x.shape)


class _LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype)``: f32 statistics, output in dtype."""

    def __init__(self, ch: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias).to(self.dtype)


class TransformerBlock(nn.Module):
    """Pre-LN self-attention, with ``context_dim`` a cross-attention on the
    context tokens (``LayerNorm_2``, ``cross_q/k/v/o``; the MLP's norm is
    then ``LayerNorm_3``), and a GEGLU MLP. The einsum attention stays plain
    PyTorch, as it is an einsum in the reference."""

    def __init__(self, ch: int, num_heads: int, dtype: torch.dtype,
                 device=None, context_dim: int | None = None):
        super().__init__()
        self.heads, self.dtype = num_heads, dtype
        self.cross = context_dim is not None

        def dense(cin, cout):
            return Dense(cin, cout, compute_dtype=dtype, device=device)

        self.LayerNorm_0 = _LayerNorm(ch, dtype, device)
        self.LayerNorm_1 = _LayerNorm(ch, dtype, device)
        self.self_q, self.self_k, self.self_v, self.self_o = (
            dense(ch, ch) for _ in range(4))
        norms = 2
        if self.cross:
            self.LayerNorm_2 = _LayerNorm(ch, dtype, device)
            self.cross_q, self.cross_o = dense(ch, ch), dense(ch, ch)
            self.cross_k, self.cross_v = (dense(context_dim, ch)
                                          for _ in range(2))
            norms = 3
        self.mlp_norm = f"LayerNorm_{norms}"
        setattr(self, self.mlp_norm, _LayerNorm(ch, dtype, device))
        self.geglu = dense(ch, 8 * ch)
        self.mlp_out = dense(4 * ch, ch)

    def _mha(self, q_in: torch.Tensor, kv_in: torch.Tensor,
             name: str) -> torch.Tensor:
        B, N, C = q_in.shape
        hd = C // self.heads
        q = getattr(self, f"{name}_q")(q_in).reshape(B, N, self.heads, hd)
        k = getattr(self, f"{name}_k")(kv_in).reshape(B, -1, self.heads, hd)
        v = getattr(self, f"{name}_v")(kv_in).reshape(B, -1, self.heads, hd)
        a = torch.einsum("bqhc,bkhc->bhqk", q, k).float()
        a = torch.softmax(a / math.sqrt(hd), dim=-1).to(self.dtype)
        o = torch.einsum("bhqk,bkhc->bqhc", a, v).reshape(B, N, C)
        return getattr(self, f"{name}_o")(o)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self._mha(self.LayerNorm_0(x), self.LayerNorm_1(x), "self")
        if self.cross:
            if context is None:
                raise ValueError("this transformer block cross-attends: it "
                                 "needs a context")
            x = x + self._mha(self.LayerNorm_2(x), context, "cross")
        a, b = self.geglu(getattr(self, self.mlp_norm)(x)).chunk(2, dim=-1)
        return x + self.mlp_out(a * F.gelu(b, approximate="tanh"))


class SpatialTransformer3D(nn.Module):
    def __init__(self, ch: int, depth: int, num_heads: int,
                 dtype: torch.dtype, device=None,
                 context_dim: int | None = None):
        super().__init__()
        self.dtype = dtype
        self.GroupNorm32_0 = GroupNorm32(ch, device=device)
        self.proj_in = Dense(ch, ch, compute_dtype=dtype, device=device)
        self.blocks = nn.ModuleList(
            TransformerBlock(ch, num_heads, dtype, device, context_dim)
            for _ in range(depth))
        self.proj_out = Dense(ch, ch, compute_dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        h = self.proj_in(self.GroupNorm32_0(x).reshape(B, -1, C))
        for blk in self.blocks:
            h = blk(h, context)
        return x + self.proj_out(h).reshape(x.shape)


def _same_pad_stride2(dhw) -> tuple:
    """``F.pad`` spec (C, W, H, D order) of flax's SAME padding for a
    3-wide, stride-2 window: (0, 1) on an even size, (1, 1) on an odd one."""
    spec = [0, 0]
    for n in reversed(dhw):
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        spec += [total // 2, total - total // 2]
    return tuple(spec)


def _upsample2(h: torch.Tensor) -> torch.Tensor:
    """Nearest 2x resize along D, H and W of an NDHWC tensor."""
    return h.repeat_interleave(2, 1).repeat_interleave(2, 2) \
        .repeat_interleave(2, 3)


class UNet3D(nn.Module):
    """Dense voxel UNet, NDHWC in and out (f32 out). Release: in 16 ch
    (8 latent + 3 pos + 3 map + 2 box), out 8, model_channels 192,
    channel_mult (1, 2, 4, 4), attention at ds 4 and 8, middle transformer
    depth 12, 8 heads."""

    def __init__(self, in_channels: int = 16, out_channels: int = 8,
                 model_channels: int = 192, channel_mult=(1, 2, 4, 4),
                 num_res_blocks: int = 2, attention_ds=(4, 8),
                 num_heads: int = 8, transformer_depth: int = 12,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 device=None, conv_quant: bool = False,
                 context_dim: int | None = None, num_classes: int = 0):
        super().__init__()
        self.dtype, self.remat, self.conv_quant = dtype, remat, conv_quant
        self.channel_mult, self.num_res_blocks = channel_mult, num_res_blocks
        self.attention_ds = attention_ds
        ch = model_channels
        emb = 4 * ch
        self.Dense_0 = Dense(ch, emb, compute_dtype=dtype, device=device)
        self.Dense_1 = Dense(emb, emb, compute_dtype=dtype, device=device)
        # the adm class one-hot's projection, added to the time embedding
        self.y_proj = Dense(num_classes, emb, compute_dtype=dtype,
                            device=device) if num_classes else None
        self.in_conv = Conv3x3x3(in_channels, ch, dtype, device=device,
                                 quant=conv_quant)
        res, att = [], []

        def resblock(cin, cout):
            res.append(ResBlock3D(cin, cout, emb, dtype, device, conv_quant))

        def attn(c):
            att.append(SelfAttention3D(c, num_heads, dtype, device))

        skips, c, ds = [ch], ch, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                resblock(c, mult * ch)
                c = mult * ch
                if ds in attention_ds:
                    attn(c)
                skips.append(c)
            if level != len(channel_mult) - 1:
                setattr(self, f"down{level}",
                        _ConvParams(c, c, 3, device=device))
                ds *= 2
                skips.append(c)
        resblock(c, c)
        self.middle_transformer = SpatialTransformer3D(
            c, transformer_depth, num_heads, dtype, device, context_dim)
        resblock(c, c)
        for level, mult in reversed(list(enumerate(channel_mult))):
            for _ in range(num_res_blocks + 1):
                resblock(c + skips.pop(), mult * ch)
                c = mult * ch
                if ds in attention_ds:
                    attn(c)
            if level != 0:
                setattr(self, f"up{level}",
                        Conv3x3x3(c, c, dtype, device=device,
                                  quant=conv_quant))
                ds //= 2
        for i, m in enumerate(res):
            setattr(self, f"ResBlock3D_{i}", m)
        for i, m in enumerate(att):
            setattr(self, f"SelfAttention3D_{i}", m)
        self._counts = (len(res), len(att))
        self.GroupNorm32_0 = GroupNorm32(c, device=device)
        self.out_conv = _ConvParams(c, out_channels, 3, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator,
                    zero_init_layers: bool = True) -> None:
        """Random weights with the JAX module's initializer scales. The
        layers JAX starts at zero (each ResBlock's conv2, the attention
        ``proj``, ``proj_out`` and ``out_conv``) stay zero unless
        ``zero_init_layers`` is False; with them at zero the output is
        exactly 0, which hides the kernels from any check."""
        for m in self.modules():
            if isinstance(m, Dense):
                lecun_normal_(m.weight, m.in_features, generator)
                m.bias.zero_()
            elif isinstance(m, Conv3x3x3):
                m.reset_parameters(generator)
            elif isinstance(m, _ConvParams):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                m.bias.zero_()
            elif isinstance(m, (_GroupNorm, _LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            if zero_init_layers:
                if isinstance(m, ResBlock3D):
                    m.conv2.weight.zero_()
                elif isinstance(m, SelfAttention3D):
                    m.proj.weight.zero_()
                elif isinstance(m, SpatialTransformer3D):
                    m.proj_out.weight.zero_()
        if zero_init_layers:
            self.out_conv.weight.zero_()

    def serving_twin(self) -> "UNet3D":
        """This UNet with ``conv_quant`` on, holding the same parameter
        tensors (a load or an update of either reaches both): the
        reference's ``unet.clone(conv_quant=True)``."""
        shared = itertools.chain(self.parameters(), self.buffers())
        twin = copy.deepcopy(self, memo={id(t): t for t in shared})
        twin.conv_quant = True
        for m in twin.modules():
            if isinstance(m, Conv3x3x3):
                m.quant, m._packed = True, None
        return twin

    def _block(self, block: nn.Module):
        """``block``, rematerialized in the backward pass when ``remat``."""
        if self.remat and torch.is_grad_enabled():
            return lambda *a: checkpoint(block, *a, use_reentrant=False)
        return block

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor | None = None,
                y_emb: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, D, H, W, in] and timesteps t [B]; with the cross-attending
        middle transformer the context [B, L, context_dim], with
        ``num_classes`` the one-hot y_emb [B, num_classes] (left out, no
        class enters)."""
        dt = self.dtype
        ch = self.Dense_0.in_features
        emb = self.Dense_0(timestep_embedding(t, ch))
        emb = self.Dense_1(F.silu(emb))
        if y_emb is not None:
            emb = emb + self.y_proj(y_emb)
        n_res, n_att = self._counts
        res = (self._block(getattr(self, f"ResBlock3D_{i}"))
               for i in range(n_res))
        att = (getattr(self, f"SelfAttention3D_{i}") for i in range(n_att))
        h = self.in_conv(x.to(dt))
        skips, ds = [h], 1
        for level, _ in enumerate(self.channel_mult):
            for _ in range(self.num_res_blocks):
                h = next(res)(h, emb)
                if ds in self.attention_ds:
                    h = next(att)(h)
                skips.append(h)
            if level != len(self.channel_mult) - 1:
                down = getattr(self, f"down{level}")
                h = conv3d_ndhwc(F.pad(h, _same_pad_stride2(h.shape[1:4])),
                                 down.weight, down.bias, dt, stride=2)
                ds *= 2
                skips.append(h)
        h = next(res)(h, emb)
        h = self._block(self.middle_transformer)(h, context)
        h = next(res)(h, emb)
        for level, _ in reversed(list(enumerate(self.channel_mult))):
            for _ in range(self.num_res_blocks + 1):
                h = next(res)(torch.cat([h, skips.pop()], dim=-1), emb)
                if ds in self.attention_ds:
                    h = next(att)(h)
            if level != 0:
                h = getattr(self, f"up{level}")(_upsample2(h))
                ds //= 2
        h = F.silu(self.GroupNorm32_0(h))
        return conv3d_ndhwc(h, self.out_conv.weight, self.out_conv.bias,
                            torch.float32, padding=1)
