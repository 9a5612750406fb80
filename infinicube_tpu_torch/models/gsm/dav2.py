"""Depth-Anything-V2 feature tower (the frozen GSM encoder) and the
standalone DINOv2 backbone; counterpart of
``infinicube_tpu/models/gsm/dav2.py``.

A DINOv2 ViT backbone taps 4 intermediate layers; the DPT neck reassembles
them into image-like maps (1x1 projection and a per-level resize), projects
them to the fusion width by 3x3 convs and runs the top-down feature fusion.
The GSM encoder takes the last fusion map (8x the patch grid) through a
small trainable refiner (``encoders.DAV2FeatureEncoder``).

Modules take and return channels-last tensors, as the JAX package's, and
their submodule names are the flax module's, so
``weights.from_jax.gsm_from_jax`` maps its parameters by name. The
attention is the plain dot product of flax's
``MultiHeadDotProductAttention`` (no Pallas kernel is involved in the
reference). ``convert_dinov2_hf`` and ``convert_dav2_hf`` map HuggingFace
``Dinov2Model`` / ``DepthAnythingForDepthEstimation`` state dicts straight
to this module's ``state_dict``."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch.models.gsm.encoders import nchw, nhwc, resize
from infinicube_tpu_torch.nn.layers import (Conv2d,
                                            MultiHeadDotProductAttention)


@dataclasses.dataclass(frozen=True)
class DAv2Config:
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    patch: int = 14
    out_indices: Sequence[int] = (3, 6, 9, 12)   # 1-based encoder layers
    neck_hidden_sizes: Sequence[int] = (48, 96, 192, 384)
    fusion_hidden_size: int = 64
    reassemble_factors: Sequence[float] = (4, 2, 1, 0.5)
    pos_tokens: int = (518 // 14) ** 2   # pretraining pos-embed grid
    layer_norm_eps: float = 1e-6

    @staticmethod
    def vits(**kw) -> "DAv2Config":
        return DAv2Config(**kw)

    @staticmethod
    def vitl(**kw) -> "DAv2Config":
        base = dict(hidden_size=1024, num_layers=24, num_heads=16,
                    out_indices=(5, 12, 18, 24),
                    neck_hidden_sizes=(256, 512, 1024, 1024),
                    fusion_hidden_size=256)
        base.update(kw)
        return DAv2Config(**base)

    @staticmethod
    def tiny(**kw) -> "DAv2Config":
        base = dict(hidden_size=32, num_layers=4, num_heads=2,
                    out_indices=(1, 2, 3, 4), pos_tokens=(70 // 14) ** 2,
                    neck_hidden_sizes=(8, 12, 16, 16), fusion_hidden_size=16)
        base.update(kw)
        return DAv2Config(**base)


def _resize_align_corners(x: torch.Tensor, size: tuple[int, int]
                          ) -> torch.Tensor:
    """Bilinear resize with align_corners=True (the DPT fusion upsample),
    NCHW; a one-texel output axis samples texel 0, as the reference's."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


class Dinov2Layer(nn.Module):
    def __init__(self, cfg: DAv2Config, device=None):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.norm1 = nn.LayerNorm(d, eps=eps, device=device)
        self.attention = MultiHeadDotProductAttention(d, cfg.num_heads,
                                                      device=device)
        self.layer_scale1 = nn.Parameter(torch.ones(d, device=device))
        self.norm2 = nn.LayerNorm(d, eps=eps, device=device)
        self.fc1 = nn.Linear(d, cfg.mlp_ratio * d, device=device)
        self.fc2 = nn.Linear(cfg.mlp_ratio * d, d, device=device)
        self.layer_scale2 = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.norm1(x)) * self.layer_scale1
        h = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + h * self.layer_scale2


class Dinov2Backbone(nn.Module):
    """Patch embedding, cls and position tokens, the encoder; returns the
    layer-normed hidden states [B, 1 + ph * pw, hidden] at
    ``cfg.out_indices`` (HF ``Dinov2Backbone`` with ``apply_layernorm``,
    cls token kept). The position table is resized to the patch grid by
    jax's antialiased bicubic where the grid differs from the table's."""

    def __init__(self, cfg: DAv2Config, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.patch_embed = Conv2d(3, d, cfg.patch, stride=cfg.patch,
                                  device=device)
        self.cls_token = nn.Parameter(torch.zeros((1, 1, d), device=device))
        self.position_embeddings = nn.Parameter(
            torch.zeros((1, 1 + cfg.pos_tokens, d), device=device))
        self.layers = nn.ModuleList(Dinov2Layer(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.layernorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps,
                                      device=device)

    def position_table(self, ph: int, pw: int) -> torch.Tensor:
        pos = self.position_embeddings
        n_ref = pos.shape[1] - 1
        if n_ref == ph * pw:
            return pos
        side = int(round(np.sqrt(n_ref)))
        grid = pos[:, 1:].reshape(1, side, side, -1)
        grid = nhwc(resize(nchw(grid), (ph, pw), "bicubic"))
        return torch.cat([pos[:, :1], grid.reshape(1, ph * pw, -1)], 1)

    def forward(self, pixels: torch.Tensor) -> list[torch.Tensor]:
        cfg = self.cfg
        B, H, W, _ = pixels.shape
        ph, pw = H // cfg.patch, W // cfg.patch
        x = nhwc(self.patch_embed(nchw(pixels))).reshape(B, ph * pw, -1)
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], 1) \
            + self.position_table(ph, pw)
        taps = []
        want = set(cfg.out_indices)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i + 1 in want:
                taps.append(x)
        return [self.layernorm(t) for t in taps]


class ConvTranspose2d(Conv2d):
    """flax ``nn.ConvTranspose`` with kernel = strides = f and VALID
    padding (the DPT neck's upsampling resize), NCHW. The weight
    [O, I, f, f] is flax's kernel re-laid out as a conv's; flax does not
    flip the kernel, so output pixel (i f + r, j f + s) takes tap
    (f - 1 - r, f - 1 - s), which is torch's transposed conv with the
    kernel flipped."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = self.operands(x)
        w = weight.flip(-2, -1).transpose(0, 1)
        return F.conv_transpose2d(x, w, bias, stride=self.stride)


class ReassembleLayer(nn.Module):
    def __init__(self, cfg: DAv2Config, channels: int, factor: float,
                 device=None):
        super().__init__()
        self.projection = Conv2d(cfg.hidden_size, channels, 1, device=device)
        if factor > 1:
            f = int(factor)
            self.resize = ConvTranspose2d(channels, channels, f, stride=f,
                                          device=device)
        elif factor < 1:
            s = int(round(1 / factor))
            self.resize = Conv2d(channels, channels, 3, stride=s, padding=1,
                                 device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NCHW
        x = self.projection(x)
        return self.resize(x) if hasattr(self, "resize") else x


class PreActResidual(nn.Module):
    def __init__(self, cfg: DAv2Config, device=None):
        super().__init__()
        c = cfg.fusion_hidden_size
        self.convolution1 = Conv2d(c, c, 3, device=device)
        self.convolution2 = Conv2d(c, c, 3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.convolution1(F.relu(x))
        return x + self.convolution2(F.relu(h))


class FeatureFusionLayer(nn.Module):
    """``residual``: whether the layer takes a skip map (the first fusion
    layer does not, and flax creates no ``residual_layer1`` for it)."""

    def __init__(self, cfg: DAv2Config, residual: bool = True, device=None):
        super().__init__()
        c = cfg.fusion_hidden_size
        if residual:
            self.residual_layer1 = PreActResidual(cfg, device=device)
        self.residual_layer2 = PreActResidual(cfg, device=device)
        self.projection = Conv2d(c, c, 1, device=device)

    def forward(self, x, residual=None, size=None):
        if residual is not None:
            if residual.shape != x.shape:
                residual = resize(residual, tuple(x.shape[-2:]), "bilinear")
            x = x + self.residual_layer1(residual)
        x = self.residual_layer2(x)
        out = size if size is not None else (x.shape[-2] * 2,
                                             x.shape[-1] * 2)
        return self.projection(_resize_align_corners(x, tuple(out)))


class DepthAnythingFeatures(nn.Module):
    """pixels NHWC (imagenet-normalized) -> the 4 fusion maps NCHW, the
    last at (8 ph, 8 pw)."""

    def __init__(self, cfg: DAv2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = Dinov2Backbone(cfg, device=device)
        for i, (c, f) in enumerate(zip(cfg.neck_hidden_sizes,
                                       cfg.reassemble_factors)):
            setattr(self, f"reassemble{i}",
                    ReassembleLayer(cfg, c, f, device=device))
            setattr(self, f"neck_conv{i}",
                    Conv2d(c, cfg.fusion_hidden_size, 3, bias=False,
                           device=device))
        for i in range(len(cfg.neck_hidden_sizes)):
            setattr(self, f"fusion{i}",
                    FeatureFusionLayer(cfg, residual=i > 0, device=device))

    def forward(self, pixels: torch.Tensor) -> list[torch.Tensor]:
        cfg = self.cfg
        B, H, W, _ = pixels.shape
        ph, pw = H // cfg.patch, W // cfg.patch
        feats = []
        for i, t in enumerate(self.backbone(pixels)):
            t = nchw(t[:, 1:].reshape(B, ph, pw, cfg.hidden_size))
            t = getattr(self, f"reassemble{i}")(t)
            feats.append(getattr(self, f"neck_conv{i}")(t))
        feats = feats[::-1]                      # deepest first
        h = self.fusion0(feats[0], size=tuple(feats[1].shape[-2:]))
        fused = [h]
        for idx, skip in enumerate(feats[1:]):
            size = tuple(feats[idx + 2].shape[-2:]) \
                if idx != len(feats) - 2 else None
            h = getattr(self, f"fusion{idx + 1}")(h, skip, size=size)
            fused.append(h)
        return fused


# ---------------------------------------------------------------------------
# HuggingFace checkpoints
# ---------------------------------------------------------------------------

def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x.detach().cpu().numpy()
                                    if hasattr(x, "detach") else x))


def _dinov2_layers(sd, prefix: str, cfg: DAv2Config, out: dict,
                   to: str) -> None:
    """The encoder layers, layer norm and embeddings of an HF DINOv2 under
    ``prefix`` into ``out`` under ``to``. The HF q / k / v / out linears
    are the port's attention Dense layers as they are."""
    def copy(src, dst):
        out[f"{to}{dst}"] = _t(sd[f"{prefix}{src}"])

    copy("embeddings.patch_embeddings.projection.weight",
         "patch_embed.weight")
    copy("embeddings.patch_embeddings.projection.bias", "patch_embed.bias")
    copy("embeddings.cls_token", "cls_token")
    copy("embeddings.position_embeddings", "position_embeddings")
    copy("layernorm.weight", "layernorm.weight")
    copy("layernorm.bias", "layernorm.bias")
    for i in range(cfg.num_layers):
        p, q = f"encoder.layer.{i}.", f"layers.{i}."
        for n in ("norm1", "norm2", "mlp.fc1", "mlp.fc2"):
            for leaf in ("weight", "bias"):
                copy(f"{p}{n}.{leaf}", f"{q}{n.split('.')[-1]}.{leaf}")
        for n, m in (("attention.attention.query", "query"),
                     ("attention.attention.key", "key"),
                     ("attention.attention.value", "value"),
                     ("attention.output.dense", "out")):
            for leaf in ("weight", "bias"):
                copy(f"{p}{n}.{leaf}", f"{q}attention.{m}.{leaf}")
        copy(f"{p}layer_scale1.lambda1", f"{q}layer_scale1")
        copy(f"{p}layer_scale2.lambda1", f"{q}layer_scale2")


def convert_dinov2_hf(sd, cfg: DAv2Config) -> dict[str, torch.Tensor]:
    """HuggingFace ``Dinov2Model`` state dict -> ``Dinov2Backbone``
    ``state_dict`` (the standalone DINOv2 encoder's tower)."""
    out: dict = {}
    _dinov2_layers(sd, "", cfg, out, "")
    return out


def convert_dav2_hf(sd, cfg: DAv2Config) -> dict[str, torch.Tensor]:
    """HuggingFace ``DepthAnythingForDepthEstimation`` state dict ->
    ``DepthAnythingFeatures`` ``state_dict``. HF's first fusion layer has a
    ``residual_layer1`` that its forward never calls (it gets no skip map);
    it is left out, as flax creates none."""
    out: dict = {}
    _dinov2_layers(sd, "backbone.", cfg, out, "backbone.")

    def copy(src, dst, bias=True):
        out[f"{dst}.weight"] = _t(sd[f"{src}.weight"])
        if bias:
            out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])

    for i, factor in enumerate(cfg.reassemble_factors):
        p = f"neck.reassemble_stage.layers.{i}"
        copy(f"{p}.projection", f"reassemble{i}.projection")
        if factor > 1:
            # torch [in, out, f, f], a transposed conv -> the flax kernel's
            # conv layout [out, in, f, f], flipped (ConvTranspose2d above)
            w = _t(sd[f"{p}.resize.weight"])
            out[f"reassemble{i}.resize.weight"] = \
                w.flip(-2, -1).transpose(0, 1).contiguous()
            out[f"reassemble{i}.resize.bias"] = _t(sd[f"{p}.resize.bias"])
        elif factor < 1:
            copy(f"{p}.resize", f"reassemble{i}.resize")
        copy(f"neck.convs.{i}", f"neck_conv{i}", bias=False)
    for i in range(len(cfg.neck_hidden_sizes)):
        p, q = f"neck.fusion_stage.layers.{i}", f"fusion{i}"
        copy(f"{p}.projection", f"{q}.projection")
        for r in ("residual_layer1", "residual_layer2")[i == 0:]:
            for c in ("convolution1", "convolution2"):
                copy(f"{p}.{r}.{c}", f"{q}.{r}.{c}")
    return out
