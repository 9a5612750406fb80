"""SegFormer semantic segmenter for the GSM's sky masks; counterpart of
``infinicube_tpu/models/gsm/segformer.py``.

The cityscapes SegFormer whose 'sky' class gives the sky masks. MiT
encoder: overlapped patch embeddings per stage; transformer blocks with
spatial-reduction attention (a strided conv and LayerNorm on the keys and
values) and a Mix-FFN (dense, 3x3 depthwise conv, exact GELU, dense); a
LayerNorm at the end of each stage. All-MLP decode head: a linear per stage,
upsampled to stage 0's resolution by jax's bilinear, concatenated deepest
first, a 1x1 fuse, BatchNorm with its running statistics, ReLU, the
classifier.

Modules take and return channels-last tensors, as the JAX package's, and
their submodule names are the flax module's, so
``weights.from_jax.gsm_from_jax`` maps its parameters by name;
``convert_segformer_hf`` maps a HuggingFace
``SegformerForSemanticSegmentation`` state dict straight to this module's
``state_dict``. ``make_segformer_sky_segmenter`` is the counterpart of
``infinicube_tpu/data_process/generate_additional_attributes.py``'s."""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch.models.gsm.encoders import (IMAGENET_MEAN,
                                                      IMAGENET_STD, nchw,
                                                      nhwc, resize)
from infinicube_tpu_torch.nn.layers import Conv2d

CITYSCAPES_SKY_ID = 10


@dataclasses.dataclass(frozen=True)
class SegformerConfig:
    hidden_sizes: Sequence[int] = (32, 64, 160, 256)     # MiT-b0
    depths: Sequence[int] = (2, 2, 2, 2)
    num_heads: Sequence[int] = (1, 2, 5, 8)
    sr_ratios: Sequence[int] = (8, 4, 2, 1)
    patch_sizes: Sequence[int] = (7, 3, 3, 3)
    strides: Sequence[int] = (4, 2, 2, 2)
    mlp_ratios: Sequence[int] = (4, 4, 4, 4)
    decoder_hidden: int = 256
    num_labels: int = 19                                  # cityscapes
    layer_norm_eps: float = 1e-6

    @staticmethod
    def b0(**kw) -> "SegformerConfig":
        return SegformerConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "SegformerConfig":
        base = dict(hidden_sizes=(8, 16, 24, 32), depths=(1, 1, 1, 1),
                    num_heads=(1, 2, 3, 4), decoder_hidden=16)
        base.update(kw)
        return SegformerConfig(**base)


class EfficientAttention(nn.Module):
    """Self-attention with spatial reduction of the keys and values."""

    def __init__(self, dim: int, heads: int, sr: int, eps: float,
                 device=None):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr
        for name in ("query", "key", "value", "out"):
            setattr(self, name, nn.Linear(dim, dim, device=device))
        if sr > 1:
            self.sr = Conv2d(dim, dim, sr, stride=sr, device=device)
            self.sr_norm = nn.LayerNorm(dim, eps=eps, device=device)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        B, N, C = x.shape
        kv = x
        if self.sr_ratio > 1:
            sp = self.sr(nchw(x.reshape(B, *hw, C)))
            kv = self.sr_norm(nhwc(sp).reshape(B, -1, C))
        hd = C // self.heads
        q = self.query(x).reshape(B, N, self.heads, hd)
        k = self.key(kv).reshape(B, -1, self.heads, hd)
        v = self.value(kv).reshape(B, -1, self.heads, hd)
        a = torch.einsum("bqhc,bkhc->bhqk", q, k) / np.sqrt(hd)
        a = torch.softmax(a, dim=-1)
        out = torch.einsum("bhqk,bkhc->bqhc", a, v).reshape(B, N, C)
        return self.out(out)


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.dense1 = nn.Linear(dim, hidden, device=device)
        self.dwconv = Conv2d(hidden, hidden, 3, groups=hidden, device=device)
        self.dense2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        B, N, _ = x.shape
        x = self.dense1(x)
        sp = self.dwconv(nchw(x.reshape(B, *hw, -1)))
        return self.dense2(F.gelu(nhwc(sp).reshape(B, N, -1)))


class SegformerBlock(nn.Module):
    def __init__(self, cfg: SegformerConfig, stage: int, device=None):
        super().__init__()
        d, eps = cfg.hidden_sizes[stage], cfg.layer_norm_eps
        self.norm1 = nn.LayerNorm(d, eps=eps, device=device)
        self.attn = EfficientAttention(d, cfg.num_heads[stage],
                                       cfg.sr_ratios[stage], eps,
                                       device=device)
        self.norm2 = nn.LayerNorm(d, eps=eps, device=device)
        self.mlp = MixFFN(d, d * cfg.mlp_ratios[stage], device=device)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), hw)
        return x + self.mlp(self.norm2(x), hw)


class Segformer(nn.Module):
    """pixels NHWC (imagenet-normalized) -> logits [B, H/4, W/4, labels]."""

    def __init__(self, cfg: SegformerConfig = SegformerConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        c, eps, dh = cfg, cfg.layer_norm_eps, cfg.decoder_hidden
        cin = 3
        for s in range(4):
            d, p = c.hidden_sizes[s], c.patch_sizes[s]
            setattr(self, f"patch_embed{s}",
                    Conv2d(cin, d, p, stride=c.strides[s], padding=p // 2,
                           device=device))
            setattr(self, f"patch_norm{s}",
                    nn.LayerNorm(d, eps=eps, device=device))
            for b in range(c.depths[s]):
                setattr(self, f"block{s}_{b}",
                        SegformerBlock(c, s, device=device))
            setattr(self, f"stage_norm{s}",
                    nn.LayerNorm(d, eps=eps, device=device))
            setattr(self, f"linear_c{s}", nn.Linear(d, dh, device=device))
            cin = d
        self.linear_fuse = Conv2d(4 * dh, dh, 1, bias=False, device=device)
        self.bn_mean = nn.Parameter(torch.zeros(dh, device=device))
        self.bn_var = nn.Parameter(torch.ones(dh, device=device))
        self.bn_scale = nn.Parameter(torch.ones(dh, device=device))
        self.bn_bias = nn.Parameter(torch.zeros(dh, device=device))
        self.classifier = Conv2d(dh, c.num_labels, 1, device=device)

    def init_params(self, generator: torch.Generator) -> None:
        """Random weights in the manner of flax's defaults: kernels
        N(0, 1/fan_in), biases 0, norm scales 1, BatchNorm statistics 0 and
        1."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, Conv2d)):
                    m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()),
                                     generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B = pixels.shape[0]
        x, feats = pixels, []
        for s in range(4):
            x = getattr(self, f"patch_embed{s}")(nchw(x))
            hw = tuple(x.shape[-2:])
            x = getattr(self, f"patch_norm{s}")(nhwc(x).reshape(B, -1,
                                                                x.shape[1]))
            for b in range(c.depths[s]):
                x = getattr(self, f"block{s}_{b}")(x, hw)
            x = getattr(self, f"stage_norm{s}")(x).reshape(B, *hw, -1)
            feats.append(x)
        th, tw = feats[0].shape[1:3]
        ups = [resize(nchw(getattr(self, f"linear_c{s}")(f)), (th, tw),
                      "bilinear") for s, f in enumerate(feats)]
        fused = self.linear_fuse(torch.cat(ups[::-1], 1))
        shape = (1, -1, 1, 1)
        fused = (fused - self.bn_mean.view(shape)) \
            * torch.rsqrt(self.bn_var.view(shape) + 1e-5) \
            * self.bn_scale.view(shape) + self.bn_bias.view(shape)
        return nhwc(self.classifier(F.relu(fused)))


def sky_mask_from_logits(logits: torch.Tensor, hw: tuple[int, int],
                         sky_id: int = CITYSCAPES_SKY_ID) -> torch.Tensor:
    """logits [B, H/4, W/4, L] -> uint8 sky mask [B, H, W] (1 = sky), the
    layout the skymask tars hold; the logits upsampled by jax's
    bilinear."""
    up = resize(nchw(logits), tuple(hw), "bilinear")
    return (up.argmax(1) == sky_id).to(torch.uint8)


def convert_segformer_hf(sd, cfg: SegformerConfig) -> dict[str, torch.Tensor]:
    """HuggingFace ``SegformerForSemanticSegmentation`` state dict ->
    ``Segformer`` ``state_dict``; torch's layouts are the port's as they
    are."""
    def t(k):
        x = sd[k]
        return torch.as_tensor(np.array(x.detach().cpu().numpy()
                                        if hasattr(x, "detach") else x))

    out: dict = {}

    def copy(src, dst, bias=True):
        out[f"{dst}.weight"] = t(f"{src}.weight")
        if bias:
            out[f"{dst}.bias"] = t(f"{src}.bias")

    enc = "segformer.encoder"
    for s in range(4):
        copy(f"{enc}.patch_embeddings.{s}.proj", f"patch_embed{s}")
        copy(f"{enc}.patch_embeddings.{s}.layer_norm", f"patch_norm{s}")
        copy(f"{enc}.layer_norm.{s}", f"stage_norm{s}")
        for b in range(cfg.depths[s]):
            p, q = f"{enc}.block.{s}.{b}", f"block{s}_{b}"
            for n in ("query", "key", "value"):
                copy(f"{p}.attention.self.{n}", f"{q}.attn.{n}")
            copy(f"{p}.attention.output.dense", f"{q}.attn.out")
            if cfg.sr_ratios[s] > 1:
                copy(f"{p}.attention.self.sr", f"{q}.attn.sr")
                copy(f"{p}.attention.self.layer_norm", f"{q}.attn.sr_norm")
            copy(f"{p}.layer_norm_1", f"{q}.norm1")
            copy(f"{p}.layer_norm_2", f"{q}.norm2")
            copy(f"{p}.mlp.dense1", f"{q}.mlp.dense1")
            copy(f"{p}.mlp.dwconv.dwconv", f"{q}.mlp.dwconv")
            copy(f"{p}.mlp.dense2", f"{q}.mlp.dense2")
        copy(f"decode_head.linear_c.{s}.proj", f"linear_c{s}")
    copy("decode_head.linear_fuse", "linear_fuse", bias=False)
    out["bn_mean"] = t("decode_head.batch_norm.running_mean")
    out["bn_var"] = t("decode_head.batch_norm.running_var")
    out["bn_scale"] = t("decode_head.batch_norm.weight")
    out["bn_bias"] = t("decode_head.batch_norm.bias")
    copy("decode_head.classifier", "classifier")
    return out


def make_segformer_sky_segmenter(params: dict,
                                 cfg: SegformerConfig | None = None,
                                 device="cuda"):
    """A sky segmenter from a ``Segformer`` ``state_dict``: image [H, W, 3]
    (uint8, or float in [0, 1]) -> uint8 sky mask [H, W];
    ``segment.batch(frames [V, H, W, 3])`` runs V frames in one call. Runs
    on ``device`` under ``torch.inference_mode``."""
    from infinicube_tpu_torch.device import resolve_device
    device = resolve_device(device)
    model = Segformer(cfg or SegformerConfig.b0(), device=device)
    model.load_state_dict(params)
    model.eval()
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)

    def batch(frames: np.ndarray) -> np.ndarray:
        x = np.asarray(frames, np.float32)
        bright = x.reshape(len(x), -1).max(1) > 1.5     # uint8 range
        x = np.where(bright[:, None, None, None], x / 255.0, x)
        with torch.inference_mode():
            x = (torch.as_tensor(x, device=device) - mean) / std
            m = sky_mask_from_logits(model(x), tuple(x.shape[1:3]))
        return m.cpu().numpy()

    def segment(image: np.ndarray) -> np.ndarray:
        return batch(np.asarray(image)[None])[0]

    segment.batch = batch
    return segment
