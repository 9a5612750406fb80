"""Checkpoint-shaped LPIPS (VGG16) perceptual distance; counterpart of
``infinicube_tpu/models/gsm/lpips.py``.

lpips.LPIPS(net='vgg'): a frozen VGG16 feature tower tapped at relu1_2,
relu2_2, relu3_3, relu4_3 and relu5_3, the channel-unit-normalized feature
differences squared, per-tap linear heads, spatial means, summed. The
modules run NCHW; ``LPIPS`` takes NHWC images in [-1, 1] as the
reference's does (``from_unit_range`` maps [0, 1] there). Parameters are
frozen: gradients reach the images, never the weights. ``convert_lpips``
maps the lpips library's state dict (the torchvision VGG16 weights under
``net.sliceN.<idx>`` and the heads under ``linK.model.1``) onto it, so the
released checkpoint converts mechanically."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# lpips.ScalingLayer constants (inputs in [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# VGG16 conv layout: (features index, out channels) per slice
VGG_SLICES = (
    ((0, 64), (2, 64)),
    ((5, 128), (7, 128)),
    ((10, 256), (12, 256), (14, 256)),
    ((17, 512), (19, 512), (21, 512)),
    ((24, 512), (26, 512), (28, 512)),
)
TAP_CHANNELS = tuple(convs[-1][1] for convs in VGG_SLICES)


class VGG16Features(nn.Module):
    """VGG16's feature tower, NCHW, returning the five LPIPS taps; 3x3
    convs with SAME padding, 2x2 max pools between the slices."""

    def __init__(self, device=None, dtype=torch.float32):
        super().__init__()
        ch = 3
        for convs in VGG_SLICES:
            for idx, out in convs:
                setattr(self, f"conv{idx}", nn.Conv2d(
                    ch, out, 3, padding=1, device=device, dtype=dtype))
                ch = out

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for s, convs in enumerate(VGG_SLICES):
            if s > 0:
                x = F.max_pool2d(x, 2, 2)
            for idx, _ in convs:
                x = F.relu(getattr(self, f"conv{idx}")(x))
            taps.append(x)
        return taps


class LPIPS(nn.Module):
    """lpips.LPIPS(net='vgg') forward: x, y NHWC in [-1, 1] -> per-sample
    distances [N], computed in the parameters' dtype (inputs are cast)."""

    def __init__(self, device=None, dtype=torch.float32):
        super().__init__()
        self.net = VGG16Features(device=device, dtype=dtype)
        for k, ch in enumerate(TAP_CHANNELS):
            setattr(self, f"lin{k}", nn.Parameter(
                torch.ones(ch, device=device, dtype=dtype)))
        self.requires_grad_(False)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random weights in the manner of flax's defaults: conv kernels
        N(0, 1/fan_in), biases 0, the heads 1."""
        for m in self.net.children():
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()),
                             generator=generator)
            m.bias.zero_()

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        dtype = self.lin0.dtype
        shift = torch.tensor(_SHIFT, dtype=dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=dtype, device=x.device)

        def tower(img):
            img = (img.to(dtype) - shift) / scale
            return self.net(img.permute(0, 3, 1, 2))

        total = 0.0
        for k, (a, b) in enumerate(zip(tower(x), tower(y))):
            a = a / torch.linalg.vector_norm(a, dim=1, keepdim=True) \
                .clamp_min(1e-10)
            b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True) \
                .clamp_min(1e-10)
            d = (a - b) ** 2
            w = getattr(self, f"lin{k}")
            total = total + torch.einsum("nchw,c->nhw", d, w).mean(
                dim=(1, 2))
        return total

    @staticmethod
    def from_unit_range(img: torch.Tensor) -> torch.Tensor:
        return img * 2.0 - 1.0


def convert_lpips(sd) -> dict[str, torch.Tensor]:
    """The lpips library's state dict (torch tensors or numpy arrays) ->
    the ``state_dict`` of ``LPIPS``."""
    def t(x):
        return torch.as_tensor(np.asarray(
            x.detach().cpu().numpy() if hasattr(x, "detach") else x))

    out = {}
    for s, convs in enumerate(VGG_SLICES):
        for idx, _ in convs:
            for leaf in ("weight", "bias"):
                out[f"net.conv{idx}.{leaf}"] = t(
                    sd[f"net.slice{s + 1}.{idx}.{leaf}"])
    for k in range(len(VGG_SLICES)):
        out[f"lin{k}"] = t(sd[f"lin{k}.model.1.weight"]).reshape(-1)
    return out


def load_lpips(checkpoint: str, device=None) -> LPIPS:
    """A frozen ``LPIPS``: ``"random"`` gives checkpoint-shaped random
    weights (``init_params`` from seed 7, for plumbing and timing: the
    released weights are a download), anything else is the path of an
    ``.npz`` of the lpips library's state dict."""
    lpips = LPIPS(device=device)
    if checkpoint == "random":
        lpips.init_params(torch.Generator(device=device).manual_seed(7))
    else:
        lpips.load_state_dict(convert_lpips(dict(np.load(checkpoint))))
    return lpips
