"""Causal 3D video VAE of Wan2.1; counterpart of
``infinicube_tpu/models/wan/vae3d.py`` (encode with its reparameterized
sample, decode, the feature-cache streaming decode and the tiled serving
paths).

Public tensors keep the reference's channels-last layout (videos and latents
``[B, T, H, W, C]``, the streaming cache's contexts ``[B, 2, H, W, C]``);
inside, the modules run channels-first (``[B, C, T, H, W]``), PyTorch's
layout for ``conv3d``. ``VideoVAEConfig.conv_impl`` picks the route of the
ResidualBlocks' (3, 3, 3) convs, as the reference's does:

- ``"xla"`` (the default, as the reference's): every conv is
  ``torch.nn.functional.conv3d``;
- ``"auto"`` / ``"pallas"``: a conv whose input and output widths are both
  at least 64 runs as the reference's Pallas route runs it, a SAME 3x3x3
  conv (``ops/dense_conv.Conv3x3x3``: K3 for bf16, ``conv3x3x3_f32`` for
  f32 on the card, with the weight packs made once per weight version; the
  plain version on the CPU) over the input with its 2 history frames,
  keeping frames 1 .. -1. A ResidualBlock with a routed conv converts its
  input to channels-last memory (``torch.channels_last_3d``) once, so the
  routed convs read their inputs as NDHWC views (the one copy is the
  causal pad, as in the reference), hand their NDHWC outputs back as
  channels-first views, and the residual add meets operands of one layout.

In the port ``"pallas"`` is an alias of ``"auto"``: both run the card's
kernel on a CUDA tensor and the plain version on a CPU one (the reference's
two differ only off the TPU, where ``"pallas"`` runs its kernel in
interpret mode).

The parameter tree is the same on both routes. T = 1 + 4k frames <-> 1 + k
latent frames; 8x spatial."""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.nn.layers import Dense, lecun_normal_
from infinicube_tpu_torch.ops.dense_conv import Conv3x3x3

# Published Wan2.1 per-channel latent statistics (wan/modules/vae.py)
WAN_LATENT_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
WAN_LATENT_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)


CONV_IMPLS = ("xla", "auto", "pallas")


@dataclasses.dataclass(frozen=True)
class VideoVAEConfig:
    latent_channels: int = 16                   # z_dim
    base_channels: int = 96                     # dim
    channel_mult: Sequence[int] = (1, 2, 4, 4)  # dim_mult
    num_res_blocks: int = 2
    temporal_down: Sequence[bool] = (False, True, True)
    dtype: torch.dtype = torch.bfloat16
    # the ResidualBlocks' (3, 3, 3) conv route: "xla" (F.conv3d), or
    # "auto" (the card's 3x3x3 conv kernel where both widths are at least
    # 64; see the module docstring); "pallas" is an alias of "auto"
    conv_impl: str = "xla"
    latent_mean: Sequence[float] | None = None
    latent_std: Sequence[float] | None = None

    def __post_init__(self):
        if self.conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl {self.conv_impl!r} is none of "
                             f"{CONV_IMPLS}")

    @staticmethod
    def wan21(**kw) -> "VideoVAEConfig":
        base = dict(latent_mean=WAN_LATENT_MEAN, latent_std=WAN_LATENT_STD)
        base.update(kw)
        return VideoVAEConfig(**base)

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.channel_mult) - 1)

    @property
    def temporal_scale(self) -> int:
        return 2 ** sum(self.temporal_down[: len(self.channel_mult) - 1])


# ---------------------------------------------------------------------------
# building blocks (channels-first inside)
# ---------------------------------------------------------------------------

class RMSNormCh(nn.Module):
    """Wan RMS_norm: x / max(||x||_C, 1e-12) * sqrt(C) * gamma per location
    (``F.normalize`` over channels), in f32, returned in x's dtype."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(ch, device=device))

    def forward(self, x):
        C = x.shape[1]
        xf = x.float()
        n = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True))
        y = xf / n.clamp_min(1e-12) * math.sqrt(C)
        return (y * self.gamma.float()[None, :, None, None, None]).to(x.dtype)


class Conv3d(nn.Module):
    """flax ``nn.Conv(dtype)`` over [B, C, T, H, W] with explicit padding
    ``(t_left, t_right, h, w)`` (zeros)."""

    def __init__(self, cin, cout, kernel, stride=(1, 1, 1), pad=(0, 0, 0, 0),
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel,
                                               device=device))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        self.stride, self.pad, self.dtype = tuple(stride), tuple(pad), dtype

    def forward(self, x):
        tl, tr, ph, pw = self.pad
        if any(self.pad):
            x = F.pad(x, (pw, pw, ph, ph, tl, tr))
        return self._conv(x)

    def _conv(self, x):
        return F.conv3d(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype), self.stride)


class CausalConv3d(Conv3d):
    """Temporal pad 2*(kt//2) on the left, SAME in space: zeros at the clip
    start, or mid-stream the carried history ``tctx`` [B, 2*(kt//2), H, W,
    C] (the reference's layout)."""

    def __init__(self, cin, cout, kernel=(3, 3, 3), dtype=torch.bfloat16,
                 device=None):
        kt, kh, kw = kernel
        super().__init__(cin, cout, kernel,
                         pad=(2 * (kt // 2), 0, kh // 2, kw // 2),
                         dtype=dtype, device=device)
        self.nctx = 2 * (kt // 2)

    def forward(self, x, tctx=None):
        if tctx is None or not self.nctx:
            return super().forward(x)
        _, _, ph, pw = self.pad
        x = torch.cat([tctx.to(x.dtype).permute(0, 4, 1, 2, 3), x], dim=2)
        return self._conv(F.pad(x, (pw, pw, ph, ph)))


class RoutedCausalConv3d(Conv3x3x3):
    """The reference's routed causal 3x3x3 conv (``conv_impl`` "auto" or
    "pallas"): the input [B, C, T, H, W] read as NDHWC with its 2 history
    frames prepended (zeros at the clip start, ``tctx`` mid-stream), one
    SAME conv through ``Conv3x3x3`` (promote-dtype arithmetic: weight and
    bias rounded to ``dtype``, f32 sums and bias, one rounding), frames
    1 .. -1 kept: SAME_out[t + 1] == causal_out[t]. Returns a channels-first
    view of the NDHWC result."""

    nctx = 2

    def forward(self, x, tctx=None):
        xl = x.permute(0, 2, 3, 4, 1)
        B, _, H, W, C = xl.shape
        ctx = xl.new_zeros((B, self.nctx, H, W, C)) if tctx is None \
            else tctx.to(x.dtype)
        y = super().forward(torch.cat([ctx, xl], dim=1))
        return y[:, 1:-1].permute(0, 4, 1, 2, 3)


def routes(impl: str, kernel, cin: int, cout: int) -> bool:
    """Whether the reference's ``causal_conv3d`` sends this conv through its
    Pallas conv: a (3, 3, 3) stride-1 conv with both widths >= 64, under a
    route other than "xla"."""
    return impl != "xla" and tuple(kernel) == (3, 3, 3) and cin >= 64 \
        and cout >= 64


def causal_conv3d(cin, cout, kernel=(3, 3, 3), dtype=torch.bfloat16,
                  device=None, impl: str = "xla") -> nn.Module:
    """The causal conv on ``impl``'s route for these widths."""
    if routes(impl, kernel, cin, cout):
        return RoutedCausalConv3d(cin, cout, dtype=dtype, device=device)
    return CausalConv3d(cin, cout, kernel, dtype, device)


def _stream(conv, x, cache, key):
    """``conv`` on a streaming chunk x [B, C, T, H, W] with the history
    ``cache[key]`` (None on the first chunk), and the next chunk's history:
    the last 2*(kt//2) frames of this layer's padded input, inherited
    frames included, so chunks of one frame work."""
    ctx = None if cache is None else cache.get(key)
    n = conv.nctx
    xl = x.permute(0, 2, 3, 4, 1)
    if xl.shape[1] < n:
        prev = xl.new_zeros((xl.shape[0], n) + xl.shape[2:]) \
            if ctx is None else ctx.to(xl.dtype)
        xl = torch.cat([prev, xl], dim=1)
    # a copy, so the cache holds no view of the chunk's activation
    new = xl[:, -n:].clone(memory_format=torch.contiguous_format)
    return conv(x, ctx), new


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, dtype=torch.bfloat16, device=None,
                 impl: str = "xla"):
        super().__init__()
        self.residual_0 = RMSNormCh(cin, device)
        self.residual_2 = causal_conv3d(cin, cout, dtype=dtype, device=device,
                                        impl=impl)
        self.residual_3 = RMSNormCh(cout, device)
        self.residual_6 = causal_conv3d(cout, cout, dtype=dtype,
                                        device=device, impl=impl)
        self.shortcut = causal_conv3d(cin, cout, (1, 1, 1), dtype,
                                      device) if cin != cout else None
        # a block with a routed conv runs channels-last in memory: its input
        # is converted once, the routed convs read NDHWC views, and the
        # residual add meets operands of one layout
        self.channels_last = any(isinstance(c, RoutedCausalConv3d) for c in
                                 (self.residual_2, self.residual_6))

    def forward(self, x, cache=None, streaming=False):
        """``streaming``: thread the per-conv history ``cache`` (None on the
        first chunk) and return the new one too."""
        if self.channels_last:
            x = x.contiguous(memory_format=torch.channels_last_3d)
        h = F.silu(self.residual_0(x))
        new = {}
        if streaming:
            h, new["residual_2"] = _stream(self.residual_2, h, cache,
                                           "residual_2")
            h = F.silu(self.residual_3(h))
            h, new["residual_6"] = _stream(self.residual_6, h, cache,
                                           "residual_6")
        else:
            h = self.residual_2(h)
            h = self.residual_6(F.silu(self.residual_3(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
            if self.channels_last:
                x = x.contiguous(memory_format=torch.channels_last_3d)
        return (x + h, new) if streaming else x + h


class AttentionBlock(nn.Module):
    """Per-frame single-head attention over H*W (Wan AttentionBlock), f32."""

    def __init__(self, ch, device=None):
        super().__init__()
        self.norm = RMSNormCh(ch, device)
        self.to_qkv = Dense(ch, 3 * ch, device=device)
        self.proj = Dense(ch, ch, device=device)

    def forward(self, x):
        B, C, T, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 4, 1).reshape(B * T, H * W, C)
        q, k, v = self.to_qkv(h.float()).chunk(3, dim=-1)
        logits = torch.bmm(q, k.transpose(1, 2)) / math.sqrt(C)
        o = self.proj(torch.bmm(torch.softmax(logits, dim=-1), v))
        o = o.reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)
        return x + o.to(x.dtype)


class Downsample2D(nn.Module):
    """ZeroPad2d((0,1,0,1)) + stride-2 conv (per frame)."""

    def __init__(self, ch, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.resample_1 = Conv3d(ch, ch, (1, 3, 3), (1, 2, 2), dtype=dtype,
                                 device=device)

    def forward(self, x):
        return self.resample_1(F.pad(x, (0, 1, 0, 1)))


class Downsample3D(Downsample2D):
    """Spatial stride-2, then temporal stride-2 with the first frame passed
    through: 1+2k -> 1+k frames."""

    def __init__(self, ch, dtype=torch.bfloat16, device=None):
        super().__init__(ch, dtype, device)
        self.time_conv = Conv3d(ch, ch, (3, 1, 1), (2, 1, 1), dtype=dtype,
                                device=device)

    def forward(self, x):
        x = super().forward(x)
        if x.shape[2] < 3:      # no whole window: flax's VALID conv is empty
            return x[:, :, :1]
        return torch.cat([x[:, :, :1], self.time_conv(x)], dim=2)


def _up2x(x):
    return x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)


class Upsample2D(nn.Module):
    """Nearest 2x + conv C -> C//2 (per frame)."""

    def __init__(self, ch, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.resample_1 = Conv3d(ch, ch // 2, (1, 3, 3), pad=(0, 0, 1, 1),
                                 dtype=dtype, device=device)

    def forward(self, x):
        return self.resample_1(_up2x(x))


class Upsample3D(Upsample2D):
    """Causal temporal conv C -> 2C interleaved to double the frames (first
    frame passed through at the clip start), then nearest 2x + conv
    C -> C//2."""

    def __init__(self, ch, dtype=torch.bfloat16, device=None):
        super().__init__(ch, dtype, device)
        self.time_conv = causal_conv3d(ch, 2 * ch, (3, 1, 1), dtype, device)

    def forward(self, x, cache=None, streaming=False):
        """``streaming``: mid-stream (``cache`` given) every frame is
        pair-expanded; returns the new cache too."""
        B, C, T, H, W = x.shape
        if streaming:
            t2, ctx = _stream(self.time_conv, x, cache, "time_conv")
        else:
            t2 = self.time_conv(x)
        if cache is None:               # clip start: first frame raw
            t2 = t2[:, :, 1:]
        n = t2.shape[2]
        pair = t2.reshape(B, 2, C, n, H, W).permute(0, 2, 3, 1, 4, 5)
        pair = pair.reshape(B, C, 2 * n, H, W)
        if cache is None:
            pair = torch.cat([x[:, :, :1], pair], dim=2)
        out = super().forward(pair)
        return (out, {"time_conv": ctx}) if streaming else out


# ---------------------------------------------------------------------------
# schedules (as the reference's, which its converter shares)
# ---------------------------------------------------------------------------

def encoder_schedule(cfg: VideoVAEConfig):
    """[(index, kind, features)] of encoder.downsamples entries."""
    dims = [cfg.base_channels * m for m in (1,) + tuple(cfg.channel_mult)]
    out, idx = [], 0
    for i, (_, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(cfg.num_res_blocks):
            out.append((idx, "res", d_out))
            idx += 1
        if i != len(cfg.channel_mult) - 1:
            kind = "down3d" if cfg.temporal_down[i] else "down2d"
            out.append((idx, kind, d_out))
            idx += 1
    return out


def decoder_schedule(cfg: VideoVAEConfig):
    """[(index, kind, features)] of decoder.upsamples entries."""
    mult = list(cfg.channel_mult)
    dims = [cfg.base_channels * m for m in [mult[-1]] + mult[::-1]]
    t_up = list(cfg.temporal_down[: len(mult) - 1])[::-1]
    out, idx = [], 0
    for i, (_, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        for _ in range(cfg.num_res_blocks + 1):
            out.append((idx, "res", d_out))
            idx += 1
        if i != len(mult) - 1:
            kind = "up3d" if t_up[i] else "up2d"
            out.append((idx, kind, d_out))
            idx += 1
    return out


_RESAMPLE = {"down2d": Downsample2D, "down3d": Downsample3D,
             "up2d": Upsample2D, "up3d": Upsample3D}


def _stage(schedule, cin, dtype, device, impl):
    """ModuleList of a schedule; returns it and the channels it ends at."""
    mods = []
    for _, kind, feat in schedule:
        if kind == "res":
            mods.append(ResidualBlock(cin, feat, dtype, device, impl))
            cin = feat
        else:
            mods.append(_RESAMPLE[kind](cin, dtype, device))
            cin = cin // 2 if kind.startswith("up") else cin
    return nn.ModuleList(mods), cin


class VideoEncoder(nn.Module):
    def __init__(self, cfg: VideoVAEConfig, device=None):
        super().__init__()
        dt, impl = cfg.dtype, cfg.conv_impl
        self.conv1 = causal_conv3d(3, cfg.base_channels, dtype=dt,
                                   device=device)
        self.downsamples, c = _stage(encoder_schedule(cfg), cfg.base_channels,
                                     dt, device, impl)
        self.middle_0 = ResidualBlock(c, c, dt, device, impl)
        self.middle_1 = AttentionBlock(c, device)
        self.middle_2 = ResidualBlock(c, c, dt, device, impl)
        self.head_0 = RMSNormCh(c, device)
        self.head_2 = causal_conv3d(c, 2 * cfg.latent_channels,
                                    dtype=torch.float32, device=device)
        self.dtype = dt

    def forward(self, video):
        """f32[B, 3, T, H, W] in [-1, 1] -> stats [B, 2z, 1+k, H/s, W/s]."""
        x = self.conv1(video.to(self.dtype))
        for m in self.downsamples:
            x = m(x)
        x = self.middle_2(self.middle_1(self.middle_0(x)))
        x = F.silu(self.head_0(x))
        return self.head_2(x.float())


class VideoDecoder(nn.Module):
    def __init__(self, cfg: VideoVAEConfig, device=None):
        super().__init__()
        dt, impl = cfg.dtype, cfg.conv_impl
        c = cfg.base_channels * cfg.channel_mult[-1]
        self.conv1 = causal_conv3d(cfg.latent_channels, c, dtype=dt,
                                   device=device)
        self.middle_0 = ResidualBlock(c, c, dt, device, impl)
        self.middle_1 = AttentionBlock(c, device)
        self.middle_2 = ResidualBlock(c, c, dt, device, impl)
        schedule = decoder_schedule(cfg)
        self.upsamples, c = _stage(schedule, c, dt, device, impl)
        self.names = [f"upsamples_{idx}" for idx, _, _ in schedule]
        self.head_0 = RMSNormCh(c, device)
        self.head_2 = causal_conv3d(c, 3, dtype=torch.float32, device=device)
        self.dtype = dt

    def forward(self, z, cache=None, streaming=False):
        """``streaming``: one chunk of the streaming decode, the per-conv
        history ``cache`` (None on the first chunk) keyed as the
        reference's; returns (frames, new cache). Only the kt = 3 causal
        convs carry state: norms, attention and the 2D resamples are per
        frame."""
        if not streaming:
            x = self.conv1(z.to(self.dtype))
            x = self.middle_2(self.middle_1(self.middle_0(x)))
            for m in self.upsamples:
                x = m(x)
            x = F.silu(self.head_0(x))
            return torch.clamp(self.head_2(x.float()), -1.0, 1.0)

        def sub(name):
            return None if cache is None else cache.get(name)

        new: dict = {}
        x, new["conv1"] = _stream(self.conv1, z.to(self.dtype), cache,
                                  "conv1")
        x, new["middle_0"] = self.middle_0(x, sub("middle_0"), True)
        x = self.middle_1(x)
        x, new["middle_2"] = self.middle_2(x, sub("middle_2"), True)
        for name, m in zip(self.names, self.upsamples):
            if isinstance(m, (ResidualBlock, Upsample3D)):
                x, new[name] = m(x, sub(name), True)
            else:
                x = m(x)
        x = F.silu(self.head_0(x))
        x, new["head_2"] = _stream(self.head_2, x.float(), cache, "head_2")
        return torch.clamp(x, -1.0, 1.0), new


class VideoVAE(nn.Module):
    def __init__(self, cfg: VideoVAEConfig = VideoVAEConfig(), device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        z = cfg.latent_channels
        self.encoder = VideoEncoder(cfg, dev)
        self.conv1 = Conv3d(2 * z, 2 * z, (1, 1, 1), dtype=torch.float32,
                            device=dev)                      # quant_conv
        self.conv2 = Conv3d(z, z, (1, 1, 1), dtype=torch.float32,
                            device=dev)                      # post_quant_conv
        self.decoder = VideoDecoder(cfg, dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """lecun-normal kernels, zero biases, unit norm gains."""
        for mod in self.modules():
            if isinstance(mod, (Conv3d, Conv3x3x3)):
                lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
                mod.bias.zero_()
            elif isinstance(mod, Dense):
                lecun_normal_(mod.weight, mod.in_features, generator)
                mod.bias.zero_()
            elif isinstance(mod, RMSNormCh):
                mod.gamma.fill_(1.0)

    def _scale(self, device):
        cfg = self.cfg
        if cfg.latent_mean is None:
            return None, None
        return (torch.tensor(cfg.latent_mean, dtype=torch.float32,
                             device=device),
                torch.tensor(cfg.latent_std, dtype=torch.float32,
                             device=device))

    def encode(self, video, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None):
        """[B, T, H, W, 3] in [-1, 1] -> normalized latents
        [B, 1+k, H/s, W/s, z]: the posterior mean (the Wan encode), or with
        ``generator`` or injected standard-normal ``noise`` (like the
        latents) the reparameterized sample mu + exp(logvar / 2) * noise,
        logvar clipped to [-30, 20]."""
        stats = self.conv1(self.encoder(video.permute(0, 4, 1, 2, 3).float()))
        mu, logvar = stats.permute(0, 2, 3, 4, 1).chunk(2, dim=-1)
        if generator is not None or noise is not None:
            if noise is None:
                noise = torch.randn(mu.shape, generator=generator,
                                    device=mu.device)
            logvar = logvar.clamp(-30.0, 20.0)
            mu = mu + torch.exp(0.5 * logvar) * noise.to(mu)
        mean, std = self._scale(mu.device)
        if mean is not None:
            mu = (mu - mean) / std
        return mu

    def _decoder_input(self, z):
        """Latents [B, T, h, w, z] un-normalized and through conv2 (the
        post-quant conv), channels-first."""
        mean, std = self._scale(z.device)
        if mean is not None:
            z = z * std + mean
        return self.conv2(z.float().permute(0, 4, 1, 2, 3))

    def decode(self, z):
        """[B, T', h, w, z] -> frames f32[B, T, H, W, 3] in [-1, 1]."""
        return self.decoder(self._decoder_input(z)).permute(0, 2, 3, 4, 1)

    def decode_step(self, z_chunk, cache: dict | None = None):
        """One chunk of the streaming decode (the Wan2.1 feature cache):
        latents [B, t, h, w, z] -> (frames [B, t', H, W, 3], the cache to
        pass with the next chunk). ``cache`` is None on the first chunk;
        chunk by chunk the frames equal the whole-clip ``decode``'s."""
        x, cache = self.decoder(self._decoder_input(z_chunk), cache,
                                streaming=True)
        return x.permute(0, 2, 3, 4, 1), cache

    def forward(self, video, generator: torch.Generator | None = None):
        return self.decode(self.encode(video, generator))


@torch.no_grad()
def decode_streaming_host(vae: VideoVAE, z: torch.Tensor,
                          chunk: int = 2) -> np.ndarray:
    """Streaming decode of latents [B, T, h, w, z]: chunks of ``chunk``
    latent frames (the last one ragged) through ``decode_step`` with the
    carried cache, so the activations held are a chunk's, not the clip's.
    Returns frames [B, 1 + ts*(T-1), H, W, 3] on the host."""
    T = z.shape[1]
    frames, cache, t = [], None, 0
    while t < T:
        c = min(chunk, T - t)
        out, cache = vae.decode_step(z[:, t:t + c], cache)
        frames.append(out.cpu().numpy())
        t += c
    return np.concatenate(frames, axis=1)


# ---------------------------------------------------------------------------
# tiled serving paths
# ---------------------------------------------------------------------------

def _blend_profile(n: int, ramp: int, device) -> torch.Tensor:
    w = torch.ones(n, device=device)
    r = min(ramp, n // 2)
    if r > 0:
        up = (torch.arange(r, device=device) + 1.0) / (r + 1.0)
        w[:r] = up
        w[-r:] = up.flip(0)
    return w


def _tiles(n: int, tile: int, overlap: int) -> list[int]:
    return list(range(0, max(n - overlap, 1), tile - overlap))


def _edge_pad(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Edge-replicate [B, T, H, W, C] up to h x w."""
    H, W = x.shape[2:4]
    iy = torch.arange(max(h, H), device=x.device).clamp_max(H - 1)
    ix = torch.arange(max(w, W), device=x.device).clamp_max(W - 1)
    return x.index_select(2, iy).index_select(3, ix)


@torch.no_grad()
def decode_tiled_host(vae: VideoVAE, z: torch.Tensor, tile=(64, 32),
                      overlap: int = 4, to_uint8: bool = False) -> np.ndarray:
    """Spatially tiled decode of latents [B, T, H, W, z]: one fixed tile
    extent (z edge-padded), tiles blended with linear ramps into an f32
    canvas on the device; an axis covered by one tile uses the exact extent.
    Returns frames [B, T_out, H*s, W*s, 3] on the host (uint8 when
    ``to_uint8``)."""
    B, T, H, W, _ = z.shape
    th, tw = (tile, tile) if isinstance(tile, int) else tile
    th, tw = min(th, H), min(tw, W)
    s = vae.cfg.spatial_scale
    t_out = 1 + vae.cfg.temporal_scale * (T - 1)
    ys, xs = _tiles(H, th, overlap), _tiles(W, tw, overlap)
    zp = _edge_pad(z, ys[-1] + th, xs[-1] + tw)
    Hp, Wp = (ys[-1] + th) * s, (xs[-1] + tw) * s
    dev = z.device
    wgt = (_blend_profile(th * s, overlap * s, dev)[:, None] *
           _blend_profile(tw * s, overlap * s, dev)[None, :])[None, None, :,
                                                              :, None]
    out = torch.zeros((B, t_out, Hp, Wp, 3), dtype=torch.float32, device=dev)
    acc = torch.zeros((1, 1, Hp, Wp, 1), dtype=torch.float32, device=dev)
    for i0 in ys:
        for j0 in xs:
            d = vae.decode(zp[:, :, i0:i0 + th, j0:j0 + tw])
            oy, ox = i0 * s, j0 * s
            out[:, :, oy:oy + th * s, ox:ox + tw * s] += d.float() * wgt
            acc[:, :, oy:oy + th * s, ox:ox + tw * s] += wgt
    final = out[:, :, :H * s, :W * s] / \
        acc[:, :, :H * s, :W * s].clamp_min(1e-6)
    if to_uint8:
        final = (torch.clamp(final * 0.5 + 0.5, 0, 1) * 255).to(torch.uint8)
    return final.cpu().numpy()


@torch.no_grad()
def encode_tiled_host(vae: VideoVAE, video: torch.Tensor, tile=(512, 256),
                      overlap: int = 32) -> torch.Tensor:
    """Spatially tiled encode of [B, T, H, W, 3] (pixel tiles, latent-space
    blend). ``tile``/``overlap`` are in pixels, multiples of the spatial
    scale. Returns latents [B, T', H/s, W/s, z] on the device."""
    B, T, H, W, _ = video.shape
    s = vae.cfg.spatial_scale
    th, tw = (tile, tile) if isinstance(tile, int) else tile
    th, tw = min(th, H), min(tw, W)
    if th % s or tw % s or overlap % s:
        raise ValueError("tile and overlap must be multiples of the "
                         f"spatial scale {s}")
    ys, xs = _tiles(H, th, overlap), _tiles(W, tw, overlap)
    vp = _edge_pad(video, ys[-1] + th, xs[-1] + tw)
    Hp, Wp = (ys[-1] + th) // s, (xs[-1] + tw) // s
    t_lat = 1 + (T - 1) // vae.cfg.temporal_scale
    zc = vae.cfg.latent_channels
    dev = video.device
    wgt = (_blend_profile(th // s, overlap // s, dev)[:, None] *
           _blend_profile(tw // s, overlap // s, dev)[None, :])[None, None, :,
                                                                :, None]
    out = torch.zeros((B, t_lat, Hp, Wp, zc), dtype=torch.float32, device=dev)
    acc = torch.zeros((1, 1, Hp, Wp, 1), dtype=torch.float32, device=dev)
    for i0 in ys:
        for j0 in xs:
            zt = vae.encode(vp[:, :, i0:i0 + th, j0:j0 + tw])
            oy, ox = i0 // s, j0 // s
            out[:, :, oy:oy + th // s, ox:ox + tw // s] += zt * wgt
            acc[:, :, oy:oy + th // s, ox:ox + tw // s] += wgt
    return out[:, :, :H // s, :W // s] / \
        acc[:, :, :H // s, :W // s].clamp_min(1e-6)
