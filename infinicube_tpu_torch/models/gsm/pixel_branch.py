"""GSM pixel branch: a 2D UNet over RGB + depth priors -> K gaussians per
pixel; counterpart of ``infinicube_tpu/models/gsm/pixel_branch.py``.

An XUnet-style 2D UNet consumes RGB concatenated with the depth prior and
its presence mask; each pixel decodes K gaussians placed along its ray at
depth znear + sigmoid(d) (zfar - znear), blended toward the provided depth
where there is one. ``decode_all`` makes every pixel emit gaussians (the
dynamic-object pass). The UNet computes in ``PixelBranchConfig.dtype``
(its convolutions and attention projections; GroupNorm in f32), as the
reference's. Its bottleneck attention goes through
``ops.attention.multi_head_attention``: ``flash_attn_f32`` on the card in
f32, K2 and K5 in bf16. The UNet runs ``view_chunk`` views at a time,
every chunk with the same parameters, which bounds its full-resolution
temporaries. Its convolutions take PyTorch's own algorithms instead of
cuDNN's, in the forward, the backward and the recompute alike
(``XConv2d``), in bf16 too. The head computes in the result type of the
UNet's features and its f32 parameters (flax's ``Dense(dtype=None)``):
f32."""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from infinicube_tpu_torch.camera import projection as proj
from infinicube_tpu_torch.models.gsm.encoders import nchw, nhwc, resize
from infinicube_tpu_torch.nn.layers import EPS, Conv2d, Dense
from infinicube_tpu_torch.ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class PixelBranchConfig:
    width: int = 32                     # XUnet dim / init_dim
    dims: tuple = (1, 2, 4, 8)          # XUnet dim_mults
    blocks_per_stage: tuple = (2, 2, 2, 2)
    self_attn_per_stage: tuple = (0, 0, 0, 0)
    out_dim: int = 24
    attn_heads: int = 4
    consolidate_upsample_fmaps: bool = True
    unet_remat: bool = True             # recompute blocks in the backward
    gs_per_pixel: int = 2
    view_chunk: int = 4                 # UNet views per chunk
    znear: float = 0.3
    zfar: float = 200.0
    max_scale: float = 0.4              # world units
    depth_dropout: float = 0.5          # masked-depth patch dropout (train)
    dtype: torch.dtype = torch.float32  # the UNet's compute dtype


@contextlib.contextmanager
def without_cudnn():
    """PyTorch's own convolutions (im2col and a cuBLAS product, in full f32
    with TF32 off) in place of cuDNN's within the context: for f32 with
    TF32 off cuDNN's heuristics pick FFT convolutions for some of the
    XUnet's shapes, many times slower (``chip_smoke.py`` phase 31 times a
    view chunk both ways, phase 33 a chunk's forward and backward)."""
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


# whether the XUnet's convolutions take cuDNN (``xunet_cudnn``)
_XUNET_CUDNN = [False]


@contextlib.contextmanager
def xunet_cudnn(enabled: bool = True):
    """Within the context the XUnet's convolutions (``XConv2d``) take
    whatever ``torch.backends.cudnn`` allows, forward and backward, as any
    ``Conv2d`` does; outside it they take PyTorch's own. For timing the two
    on the card."""
    prev = _XUNET_CUDNN[0]
    _XUNET_CUDNN[0] = enabled
    try:
        yield
    finally:
        _XUNET_CUDNN[0] = prev


class _Conv2dWithoutCudnn(torch.autograd.Function):
    """``F.conv2d`` (groups 1) whose forward and backward both run without
    cuDNN: the backward of a convolution chooses its algorithms when it
    runs, after a context around the forward has closed."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        with without_cudnn():
            y = F.conv2d(x, weight, bias, stride=stride, padding=padding)
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        stride, padding = ctx.conf
        need = ctx.needs_input_grad
        with without_cudnn():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gy, x, weight, [weight.shape[0]], [stride, stride],
                list(padding), [1, 1], False, [0, 0], 1,
                [need[0], need[1], need[2]])
        return gx, gw, gb, None, None


class XConv2d(Conv2d):
    """``Conv2d`` for the XUnet: PyTorch's own convolutions in its forward
    and its backward, unless within ``xunet_cudnn()``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _XUNET_CUDNN[0]:
            return super().forward(x)
        x, weight, bias = self.operands(x)
        x, padding = self.same_pad(x)
        return _Conv2dWithoutCudnn.apply(x, weight, bias, self.stride,
                                         padding)


class ResBlock2D(nn.Module):
    """XUnet ResnetBlock: GN (f32) -> silu -> 3x3 conv, twice, + skip (a
    1x1 conv when the widths differ), the convs in ``dtype``; NCHW."""

    def __init__(self, in_ch: int, out_ch: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.GroupNorm_0 = nn.GroupNorm(8, in_ch, eps=EPS, device=device)
        self.conv1 = XConv2d(in_ch, out_ch, 3, **kw)
        self.GroupNorm_1 = nn.GroupNorm(8, out_ch, eps=EPS, device=device)
        self.conv2 = XConv2d(out_ch, out_ch, 3, **kw)
        self.skip = XConv2d(in_ch, out_ch, 1, **kw) \
            if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.GroupNorm_0(x.float())))
        h = self.conv2(F.silu(self.GroupNorm_1(h.float())))
        return (x if self.skip is None else self.skip(x)) + h


class SelfAttn2D(nn.Module):
    """Spatial self-attention over the H*W tokens (GN in f32, the
    projections and the attention in ``dtype``); NCHW."""

    def __init__(self, ch: int, heads: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.GroupNorm_0 = nn.GroupNorm(8, ch, eps=EPS, device=device)
        self.qkv = Dense(ch, 3 * ch, compute_dtype=dtype, device=device)
        self.out = Dense(ch, ch, compute_dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        t = nhwc(self.GroupNorm_0(x.float())).reshape(B, H * W, C)
        q, k, v = (a.reshape(B, H * W, self.heads, C // self.heads)
                   for a in self.qkv(t).chunk(3, -1))
        o = multi_head_attention(q, k, v).reshape(B, H * W, C)
        return x + nchw(self.out(o).reshape(B, H, W, C))


class UNet2D(nn.Module):
    """XUnet-structured 2D UNet: 7x7 stem, per-stage ResBlock stacks, a
    ResBlock -> attention -> ResBlock bottleneck, and an FPN-style
    consolidation that upsamples every decoder stage's output to full
    resolution and fuses them. Channels-last in and out."""

    def __init__(self, cfg: PixelBranchConfig, in_ch: int = 5, device=None):
        super().__init__()
        self.cfg = cfg
        w, dims = cfg.width, cfg.dims
        n = len(dims)
        kw = dict(device=device, dtype=cfg.dtype)
        self.stem = XConv2d(in_ch, w, 7, **kw)
        ch = w
        skip_ch = []
        for i, m in enumerate(dims):
            for b in range(cfg.blocks_per_stage[i]):
                setattr(self, f"d{i}b{b}", ResBlock2D(ch, w * m, **kw))
                ch = w * m
            for a in range(cfg.self_attn_per_stage[i]):
                setattr(self, f"d{i}a{a}", SelfAttn2D(ch, cfg.attn_heads,
                                                      **kw))
            skip_ch.append(ch)
            if i < n - 1:
                setattr(self, f"down{i}", XConv2d(ch, w * dims[i + 1], 3,
                                                  stride=2, **kw))
                ch = w * dims[i + 1]
        self.mid1 = ResBlock2D(ch, ch, **kw)
        self.mid_attn = SelfAttn2D(ch, cfg.attn_heads, **kw)
        self.mid2 = ResBlock2D(ch, ch, **kw)
        stage_ch = []
        for i in range(n - 1, -1, -1):
            if i < n - 1:
                setattr(self, f"up{i}", XConv2d(ch, w * dims[i], 3, **kw))
                ch = w * dims[i]
            ch += skip_ch[i]
            for b in range(cfg.blocks_per_stage[i]):
                setattr(self, f"u{i}b{b}", ResBlock2D(ch, w * dims[i], **kw))
                ch = w * dims[i]
            for a in range(cfg.self_attn_per_stage[i]):
                setattr(self, f"u{i}a{a}", SelfAttn2D(ch, cfg.attn_heads,
                                                      **kw))
            stage_ch.append(ch)
        if cfg.consolidate_upsample_fmaps:
            for j, c in enumerate(stage_ch):
                setattr(self, f"cons{j}", XConv2d(c, w, 3, **kw))
            ch = w * len(stage_ch)
        self.GroupNorm_0 = nn.GroupNorm(8, ch, eps=EPS, device=device)
        self.final = XConv2d(ch, cfg.out_dim, 3, **kw)

    def _block(self, name: str, h: torch.Tensor) -> torch.Tensor:
        mod = getattr(self, name)
        if self.cfg.unet_remat and torch.is_grad_enabled() and \
                h.requires_grad:
            return checkpoint(mod, h, use_reentrant=False)
        return mod(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n = len(cfg.dims)
        h = self.stem(nchw(x))
        skips = []
        for i in range(n):
            for b in range(cfg.blocks_per_stage[i]):
                h = self._block(f"d{i}b{b}", h)
            for a in range(cfg.self_attn_per_stage[i]):
                h = self._block(f"d{i}a{a}", h)
            skips.append(h)
            if i < n - 1:
                h = getattr(self, f"down{i}")(h)
        for name in ("mid1", "mid_attn", "mid2"):
            h = self._block(name, h)
        stage_outs = []
        for i in range(n - 1, -1, -1):
            if i < n - 1:
                H, W = h.shape[-2:]
                h = getattr(self, f"up{i}")(resize(h, (2 * H, 2 * W),
                                                   "nearest"))
            h = torch.cat([h, skips[i]], 1)
            for b in range(cfg.blocks_per_stage[i]):
                h = self._block(f"u{i}b{b}", h)
            for a in range(cfg.self_attn_per_stage[i]):
                h = self._block(f"u{i}a{a}", h)
            stage_outs.append(h)
        if cfg.consolidate_upsample_fmaps:
            hw = stage_outs[-1].shape[-2:]
            h = torch.cat([getattr(self, f"cons{j}")(resize(s, hw, "nearest"))
                           for j, s in enumerate(stage_outs)], 1)
        h = F.silu(self.GroupNorm_0(h.float()))
        return nhwc(self.final(h))


class PixelBranch(nn.Module):
    def __init__(self, cfg: PixelBranchConfig = PixelBranchConfig(),
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.unet = UNet2D(cfg, device=device)
        self.head = Dense(cfg.out_dim, cfg.gs_per_pixel * 13,
                          compute_dtype=None, device=device)

    def forward(self, rgb: torch.Tensor, depth_prior: torch.Tensor,
                Ks: torch.Tensor, cam_to_worlds: torch.Tensor,
                pixel_mask: torch.Tensor | None = None,
                decode_all: bool = False) -> dict:
        """rgb f32 [V, H, W, 3]; depth_prior f32 [V, H, W, 1] (0 = unknown);
        pixel_mask bool [V, H, W] selects the pixels that emit gaussians
        (ignored with decode_all). Returns a flat gaussian dict (means
        [M, 3], ... valid [M]) with M = V*H*W*K, and depth [V, H, W, K]."""
        cfg = self.cfg
        V, H, W, _ = rgb.shape
        x = torch.cat([rgb, depth_prior, (depth_prior > 0).float()], -1)
        vc = cfg.view_chunk or V
        feats = torch.cat([self.unet(x[i:i + vc]) for i in range(0, V, vc)])
        K = cfg.gs_per_pixel
        out = self.head(feats).reshape(V, H, W, K, 13)
        del feats
        rays = [proj.posed_rays_from_intrinsics(Km, pose, (H, W),
                                                normalize=False)
                for Km, pose in zip(Ks, cam_to_worlds)]
        ro = torch.stack([r[0] for r in rays])              # [V, H, W, 3]
        rd = torch.stack([r[1] for r in rays])

        def ch(i):                                         # head ch -> [M]
            return out[..., i].reshape(-1)

        def perk(a):                                       # [V,H,W] -> [M]
            return a[..., None].expand(V, H, W, K).reshape(-1)

        depth = cfg.znear + torch.sigmoid(ch(0)) * (cfg.zfar - cfg.znear)
        # blend toward the provided prior where there is one
        prior = perk(depth_prior[..., 0])
        gate = torch.sigmoid(ch(1))
        depth = torch.where(prior > 0, prior * (1 - 0.25 * (gate - 0.5)),
                            depth)
        means = torch.stack([perk(ro[..., c]) + perk(rd[..., c]) * depth
                             for c in range(3)], -1)
        srad = cfg.max_scale * (depth / 10.0 + 0.1)
        scales = torch.stack([torch.exp(ch(2 + c).clamp(-10.0, 0.0)) * srad
                              for c in range(3)], -1)
        q = [ch(5 + c) + (1.0 if c == 0 else 0.0) for c in range(4)]
        qn = torch.sqrt(sum(x * x for x in q)).clamp_min(1e-6)
        quats = torch.stack([x / qn for x in q], -1)
        opacity = torch.sigmoid(ch(9))
        # rgb = input pixel color + bounded residual
        colors = torch.stack(
            [(perk(rgb[..., c]) + torch.sigmoid(ch(10 + c)) - 0.5).clamp(
                0.0, 1.0) for c in range(3)], -1)
        if decode_all or pixel_mask is None:
            valid = torch.ones((V * H * W * K,), dtype=torch.bool,
                               device=rgb.device)
        else:
            valid = perk(pixel_mask)
        return {"means": means, "scales": scales, "quats": quats,
                "opacities": torch.where(valid, opacity,
                                         torch.zeros_like(opacity)),
                "colors": colors, "valid": valid,
                "depth": depth.reshape(V, H, W, K)}
