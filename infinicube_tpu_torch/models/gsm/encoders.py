"""GSM image encoders; counterpart of
``infinicube_tpu/models/gsm/encoders.py``.

Per-frame image encoders whose features are concatenated per pixel, plus
the 4-channel GSM input-mask semantics:
  ch0: foreground (0 = sky)  ch1: non-dynamic  ch2: hood/pad crop
  ch3: foreground from the voxel grid
sky_mask = ch0 == 0; effective_mask = ch1 * ch2; midground = ch0 > 0 and
ch3 == 0 (the region the pixel branch covers).

Kinds: "conv" (the release encoder), "vit" (a generic patch ViT), "plucker"
(a conv patchifier over rgb and Plucker-ray channels) and "convnext" (a
frozen ConvNeXt tower with a trainable refiner). "dav2" and "dino" need the
frozen towers, which are not ported yet.

Modules take and return channels-last tensors, as the JAX package's; the
convolutions run on NCHW views of them. Submodule names are the flax
module's, so ``weights.from_jax.gsm_from_jax`` maps its parameters by
name."""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch.camera import projection as proj
from infinicube_tpu_torch.nn.layers import (EPS, Conv2d,
                                            MultiHeadDotProductAttention)

_FROZEN_TOWERS = {"dav2", "dino"}   # need the frozen towers, not ported


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def resize(x: torch.Tensor, hw: tuple[int, int], method: str) -> torch.Tensor:
    """``jax.image.resize`` of an NCHW tensor to a larger or equal size
    (half-pixel centers; "bilinear" or "nearest"): no antialiasing is
    involved when upsampling, and the edge rows take the edge texel as
    jax's renormalized kernel does."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    if method == "nearest":
        return F.interpolate(x, size=hw, mode="nearest-exact")
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)


class ConvEncoder(nn.Module):
    """Small residual CNN 3 -> width."""

    def __init__(self, width: int = 64, device=None):
        super().__init__()
        self.Conv_0 = Conv2d(3, width, 3, device=device)
        for i in range(4):
            setattr(self, f"GroupNorm_{i}",
                    nn.GroupNorm(8, width, eps=EPS, device=device))
        for i in range(2):
            setattr(self, f"res{i}_c1", Conv2d(width, width, 3,
                                               device=device))
            setattr(self, f"res{i}_c2", Conv2d(width, width, 3,
                                               device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:  # [B, H, W, 3]
        x = self.Conv_0(nchw(images))
        for i in range(2):
            h = F.silu(getattr(self, f"GroupNorm_{2 * i}")(x))
            h = getattr(self, f"res{i}_c1")(h)
            h = F.silu(getattr(self, f"GroupNorm_{2 * i + 1}")(h))
            x = x + getattr(self, f"res{i}_c2")(h)
        return nhwc(x)


class PatchViTEncoder(nn.Module):
    """Generic patch ViT feature tower, upsampled back to the pixel grid."""

    def __init__(self, width: int = 128, patch: int = 14, depth: int = 4,
                 num_heads: int = 4, num_patches: int | None = None,
                 device=None):
        super().__init__()
        self.width, self.patch, self.depth = width, patch, depth
        self.Conv_0 = Conv2d(3, width, patch, stride=patch, device=device)
        self.pos = nn.Parameter(torch.zeros((1, num_patches or 1, width),
                                            device=device))
        for i in range(depth):
            setattr(self, f"attn{i}", MultiHeadDotProductAttention(
                width, num_heads, device=device))
            setattr(self, f"LayerNorm_{2 * i}",
                    nn.LayerNorm(width, eps=EPS, device=device))
            setattr(self, f"LayerNorm_{2 * i + 1}",
                    nn.LayerNorm(width, eps=EPS, device=device))
            setattr(self, f"Dense_{2 * i}",
                    nn.Linear(width, 4 * width, device=device))
            setattr(self, f"Dense_{2 * i + 1}",
                    nn.Linear(4 * width, width, device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = images.shape
        ph, pw = H // self.patch, W // self.patch
        x = nhwc(self.Conv_0(nchw(images))).reshape(B, ph * pw, self.width)
        x = x + self.pos
        for i in range(self.depth):
            h = getattr(self, f"LayerNorm_{2 * i}")(x)
            x = x + getattr(self, f"attn{i}")(h)
            h = getattr(self, f"LayerNorm_{2 * i + 1}")(x)
            h = getattr(self, f"Dense_{2 * i}")(h)
            x = x + getattr(self, f"Dense_{2 * i + 1}")(
                F.gelu(h, approximate="tanh"))
        x = x.reshape(B, ph, pw, self.width)
        return nhwc(resize(nchw(x), (H, W), "bilinear"))


class PluckerConvPatchEncoder(nn.Module):
    """Conv patchifier over [rgb | Plucker rays | depth] channels: per-pixel
    Plucker coordinates (d, o x d) from the camera, optional metric depth,
    a stride-patch conv and LayerNorm, resized back to the pixel grid."""

    def __init__(self, width: int = 64, patch: int = 8,
                 concat_plucker: bool = True, concat_depth: bool = False,
                 device=None):
        super().__init__()
        self.patch = patch
        self.concat_plucker, self.concat_depth = concat_plucker, concat_depth
        cin = 3 + 6 * concat_plucker + concat_depth
        self.conv_patchify = Conv2d(cin, width, patch, stride=patch,
                                    device=device)
        self.ln = nn.LayerNorm(width, eps=EPS, device=device)

    def forward(self, images, Ks=None, cam_to_worlds=None, depth=None):
        B, H, W, _ = images.shape
        parts = [images]
        if self.concat_plucker and Ks is not None:
            ro, rd = zip(*(proj.posed_rays_from_intrinsics(K, p, (H, W))
                           for K, p in zip(Ks, cam_to_worlds)))
            ro, rd = torch.stack(ro), torch.stack(rd)
            parts += [rd, torch.cross(ro, rd, dim=-1)]
        if self.concat_depth and depth is not None:
            parts.append(depth)
        x = self.conv_patchify(nchw(torch.cat(parts, -1)))
        x = self.ln(nhwc(x))
        return nhwc(resize(nchw(x), (H, W), "bilinear"))


@dataclasses.dataclass(frozen=True)
class UnifiedEncoderConfig:
    # + "vit" / "plucker" / "convnext"; "dav2" / "dino" not ported yet
    encoders: Sequence[str] = ("conv",)
    conv_width: int = 64
    vit_width: int = 128
    dav2_width: int = 64
    dav2_target_hw: tuple = (252, 336)
    dav2_config: Any = None
    plucker_width: int = 64
    plucker_patch: int = 8
    dino_width: int = 64
    dino_target_hw: tuple = (252, 336)
    dino_config: Any = None
    convnext_width: int = 64
    convnext_config: Any = None             # ConvNextConfig override


class UnifiedEncoder(nn.Module):
    """``vit_patches``: the patch count of the "vit" kind's learned position
    table (flax sizes it from the first input; here from the image size
    the model serves)."""

    def __init__(self, cfg: UnifiedEncoderConfig = UnifiedEncoderConfig(),
                 vit_patches: int | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        kinds = set(cfg.encoders)
        if kinds & _FROZEN_TOWERS:
            raise NotImplementedError(
                f"encoder kinds {sorted(kinds & _FROZEN_TOWERS)}: the frozen "
                "DAv2 / DINOv2 towers are not ported yet (ROADMAP section 1 "
                "item 4)")
        unknown = kinds - {"conv", "vit", "plucker", "convnext"}
        if unknown:
            raise ValueError(f"unknown encoder kinds {sorted(unknown)}")
        if "conv" in kinds:
            self.conv = ConvEncoder(cfg.conv_width, device=device)
        if "vit" in kinds:
            self.vit = PatchViTEncoder(cfg.vit_width,
                                       num_patches=vit_patches,
                                       device=device)
        if "convnext" in kinds:
            from infinicube_tpu_torch.models.gsm.convnext import (
                ConvNextConfig, ConvNextFeatureEncoder)
            self.convnext = ConvNextFeatureEncoder(
                cfg.convnext_width, cfg.convnext_config or ConvNextConfig(),
                device=device)
        if "plucker" in kinds:
            self.plucker = PluckerConvPatchEncoder(
                cfg.plucker_width, cfg.plucker_patch, device=device)

    def forward(self, images: torch.Tensor, masks: torch.Tensor,
                Ks: torch.Tensor | None = None,
                cam_to_worlds: torch.Tensor | None = None,
                depth: torch.Tensor | None = None) -> dict:
        """images f32 [B, V, H, W, 3] in [0, 1]; masks f32 [B, V, H, W, 4];
        Ks / cam_to_worlds [B, V, ...] (the "plucker" kind needs them).
        Returns dict: features [B, V, H, W, F], sky_mask, effective_mask,
        midground, original_rgb."""
        B, V, H, W, _ = images.shape
        flat = images.reshape(B * V, H, W, 3)
        kinds = self.cfg.encoders
        feats = []
        if "conv" in kinds:
            feats.append(self.conv(flat))
        if "vit" in kinds:
            feats.append(self.vit(flat))
        if "convnext" in kinds:
            feats.append(self.convnext(flat))
        if "plucker" in kinds:
            feats.append(self.plucker(
                flat,
                None if Ks is None else Ks.reshape(B * V, 3, 3),
                None if cam_to_worlds is None
                else cam_to_worlds.reshape(B * V, 4, 4),
                None if depth is None else depth.reshape(B * V, H, W, -1)))
        f = feats[0] if len(feats) == 1 else torch.cat(feats, -1)
        f = f.reshape(B, V, H, W, -1)
        return {"features": f, "sky_mask": masks[..., 0] == 0,
                "effective_mask": masks[..., 1] * masks[..., 2],
                "midground": (masks[..., 0] > 0) & (masks[..., 3] == 0),
                "original_rgb": images}
