"""ConvNeXt feature tower (a GSM encoder option); counterpart of
``infinicube_tpu/models/gsm/convnext.py``: a frozen ConvNeXt backbone whose
last-stage features feed a trainable conv refiner, resized back to the
pixel grid. Submodule names are the flax module's (which follow the
HuggingFace ``ConvNextModel`` layout); ``convert_convnext_hf`` maps an HF
``ConvNextModel`` state dict straight to ``ConvNextTower``'s
``state_dict``."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch.models.gsm.encoders import (IMAGENET_MEAN,
                                                      IMAGENET_STD, Refiner,
                                                      nchw, nhwc, resize)
from infinicube_tpu_torch.nn.layers import Conv2d


@dataclasses.dataclass(frozen=True)
class ConvNextConfig:
    depths: Sequence[int] = (3, 3, 9, 3)
    hidden_sizes: Sequence[int] = (96, 192, 384, 768)   # convnext-tiny
    layer_norm_eps: float = 1e-6

    @staticmethod
    def tiny_test(**kw) -> "ConvNextConfig":
        base = dict(depths=(1, 1, 2, 1), hidden_sizes=(8, 12, 16, 24))
        base.update(kw)
        return ConvNextConfig(**base)


class ConvNextBlock(nn.Module):
    """Depthwise 7x7 conv, LayerNorm, 4x MLP with exact GELU, layer scale,
    residual; NCHW in and out."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, groups=dim, device=device)
        self.layernorm = nn.LayerNorm(dim, eps=eps, device=device)
        self.pwconv1 = nn.Linear(dim, 4 * dim, device=device)
        self.pwconv2 = nn.Linear(4 * dim, dim, device=device)
        self.layer_scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.layernorm(nhwc(self.dwconv(x)))
        h = self.pwconv2(F.gelu(self.pwconv1(h)))
        return x + nchw(h * self.layer_scale)


class ConvNextTower(nn.Module):
    """Patch embedding + 4 stages; NCHW in, the last stage's map
    [B, C_last, H/32, W/32] out."""

    def __init__(self, cfg: ConvNextConfig = ConvNextConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        hs, eps = cfg.hidden_sizes, cfg.layer_norm_eps
        self.patch_embed = Conv2d(3, hs[0], 4, stride=4, device=device)
        self.embed_ln = nn.LayerNorm(hs[0], eps=eps, device=device)
        for s, (depth, dim) in enumerate(zip(cfg.depths, hs)):
            if s > 0:
                setattr(self, f"down_ln{s}",
                        nn.LayerNorm(hs[s - 1], eps=eps, device=device))
                setattr(self, f"down_conv{s}",
                        Conv2d(hs[s - 1], dim, 2, stride=2, device=device))
            for i in range(depth):
                setattr(self, f"stage{s}_block{i}",
                        ConvNextBlock(dim, eps, device=device))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = nchw(self.embed_ln(nhwc(self.patch_embed(pixels))))
        for s, depth in enumerate(cfg.depths):
            if s > 0:
                x = nchw(getattr(self, f"down_ln{s}")(nhwc(x)))
                x = getattr(self, f"down_conv{s}")(x)
            for i in range(depth):
                x = getattr(self, f"stage{s}_block{i}")(x)
        return x


class ConvNextFeatureEncoder(Refiner):
    """Frozen ConvNeXt tower (no gradient) + trainable conv refiner,
    resized back to the pixel grid; channels-last in and out."""

    def __init__(self, width: int = 64, cfg: ConvNextConfig = ConvNextConfig(),
                 device=None):
        super().__init__(cfg.hidden_sizes[-1], width, device=device)
        self.tower = ConvNextTower(cfg, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:  # [B, H, W, 3]
        B, H, W, _ = images.shape
        mean = images.new_tensor(IMAGENET_MEAN)
        std = images.new_tensor(IMAGENET_STD)
        f = self.tower(nchw((images - mean) / std)).detach()
        return nhwc(resize(self.refine(f), (H, W), "bilinear"))


def convert_convnext_hf(sd, cfg: ConvNextConfig) -> dict[str, torch.Tensor]:
    """HuggingFace ``ConvNextModel`` state dict -> ``ConvNextTower``
    ``state_dict`` (HF's final pooled LayerNorm is not part of the tower)."""
    out: dict = {}

    def copy(src, dst):
        for leaf in ("weight", "bias"):
            x = sd[f"{src}.{leaf}"]
            out[f"{dst}.{leaf}"] = torch.as_tensor(np.array(
                x.detach().cpu().numpy() if hasattr(x, "detach") else x))

    copy("embeddings.patch_embeddings", "patch_embed")
    copy("embeddings.layernorm", "embed_ln")
    for s, depth in enumerate(cfg.depths):
        if s > 0:
            p = f"encoder.stages.{s}.downsampling_layer"
            copy(f"{p}.0", f"down_ln{s}")
            copy(f"{p}.1", f"down_conv{s}")
        for i in range(depth):
            p, q = f"encoder.stages.{s}.layers.{i}", f"stage{s}_block{i}"
            for n in ("dwconv", "layernorm", "pwconv1", "pwconv2"):
                copy(f"{p}.{n}", f"{q}.{n}")
            x = sd[f"{p}.layer_scale_parameter"]
            out[f"{q}.layer_scale"] = torch.as_tensor(np.array(
                x.detach().cpu().numpy() if hasattr(x, "detach") else x))
    return out
