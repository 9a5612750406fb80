"""GSM image encoders; counterpart of
``infinicube_tpu/models/gsm/encoders.py``.

Per-frame image encoders whose features are concatenated per pixel, plus
the 4-channel GSM input-mask semantics:
  ch0: foreground (0 = sky)  ch1: non-dynamic  ch2: hood/pad crop
  ch3: foreground from the voxel grid
sky_mask = ch0 == 0; effective_mask = ch1 * ch2; midground = ch0 > 0 and
ch3 == 0 (the region the pixel branch covers).

Kinds: "conv" (the release encoder), "dav2" (the frozen Depth-Anything-V2
tower of ``models/gsm/dav2.py`` with a trainable refiner), "dino" (the
frozen DINOv2 backbone with a trainable refiner), "vit" (a generic patch
ViT), "plucker" (a conv patchifier over rgb and Plucker-ray channels) and
"convnext" (a frozen ConvNeXt tower with a trainable refiner). No
gradient reaches a frozen tower, as ``jax.lax.stop_gradient`` makes it:
the DAv2 and DINOv2 towers run under ``torch.no_grad()``, the ConvNeXt
tower's output is detached.

Modules take and return channels-last tensors, as the JAX package's; the
convolutions run on NCHW views of them. Submodule names are the flax
module's, so ``weights.from_jax.gsm_from_jax`` maps its parameters by
name."""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch.camera import projection as proj
from infinicube_tpu_torch.nn.layers import (EPS, Conv2d,
                                            MultiHeadDotProductAttention)

IMAGENET_MEAN = (0.485, 0.456, 0.406)   # the frozen towers' input norm
IMAGENET_STD = (0.229, 0.224, 0.225)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel with a = -0.5, as ``jax.image.resize`` takes it
    (torch's bicubic uses a = -0.75)."""
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1.0, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x
                   + f(2.0), out)
    return np.where(x >= 2.0, f(0.0), out)


_KERNELS = {"bilinear": lambda x: np.maximum(np.float32(0.0),
                                             np.float32(1.0) - np.abs(x)),
            "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def resize_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """The [n_in, n_out] weight matrix of ``jax.image.resize`` along one
    axis (``jax._src.image.scale.compute_weight_mat`` with antialias and no
    translation), computed in f32 step by step as jax computes it (at 832
    texels an f64 sample point moves a weight by 4e-5): half-pixel sample
    points, the kernel stretched by n_in / n_out when downsampling, each
    column normalized to sum 1, which takes the edge texel at the
    borders."""
    f = np.float32
    inv = f(1.0 / (n_out / n_in))
    kernel_scale = max(inv, f(1.0))
    sample = (np.arange(n_out, dtype=f) + f(0.5)) * inv - f(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f)[:, None]) \
        / kernel_scale
    w = _KERNELS[method](x.astype(f)).astype(f)
    total = w.sum(0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f(0.0)).astype(f)


def resize(x: torch.Tensor, hw: tuple[int, int], method: str) -> torch.Tensor:
    """``jax.image.resize`` of an NCHW tensor (half-pixel centers;
    "bilinear", "bicubic" or "nearest"). A bilinear upsample is
    ``F.interpolate``: no antialiasing is involved, and the edge rows take
    the edge texel as jax's renormalized kernel does. A downsample along
    either axis, and bicubic (jax's Keys kernel, a = -0.5), apply jax's
    per-axis weight matrices (``resize_weights``): antialiased, so a
    downsample averages over n_in / n_out texels as jax's does."""
    H, W = x.shape[-2:]
    if (H, W) == tuple(hw):
        return x
    if method == "nearest":
        return F.interpolate(x, size=hw, mode="nearest-exact")
    if method == "bilinear" and hw[0] >= H and hw[1] >= W:
        return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)
    if hw[0] != H:
        w = torch.from_numpy(resize_weights(H, hw[0], method))
        x = torch.einsum("...hw,hH->...Hw", x, w.to(x.device, x.dtype))
    if hw[1] != W:
        w = torch.from_numpy(resize_weights(W, hw[1], method))
        x = torch.einsum("...hw,wW->...hW", x, w.to(x.device, x.dtype))
    return x


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


class Refiner(nn.Module):
    """The frozen towers' trainable neck: conv, residual conv pair, NCHW in
    and out (``up0``-``up2`` of the flax modules)."""

    def __init__(self, in_features: int, width: int, device=None):
        super().__init__()
        self.up0 = Conv2d(in_features, width, 3, device=device)
        self.up1 = Conv2d(width, width, 3, device=device)
        self.up2 = Conv2d(width, width, 3, device=device)

    def refine(self, f: torch.Tensor) -> torch.Tensor:
        h = self.up0(f)
        r = F.relu(self.up1(F.relu(h)))
        return h + self.up2(r)


def imagenet_input(images: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """images [B, H, W, 3] in [0, 1] -> resized to ``hw`` by jax's
    antialiased bilinear and imagenet-normalized, channels-last."""
    x = nhwc(resize(nchw(images), hw, "bilinear"))
    return (x - x.new_tensor(IMAGENET_MEAN)) / x.new_tensor(IMAGENET_STD)


class DAV2FeatureEncoder(Refiner):
    """The frozen Depth-Anything-V2 tower and its trainable refiner: resize
    to the target grid, imagenet-normalize, take the last DPT fusion map
    (frozen), refine, resize back to the pixel grid."""

    def __init__(self, width: int = 64, target_hw: tuple = (252, 336),
                 dav2=None, device=None):
        from infinicube_tpu_torch.models.gsm.dav2 import (
            DAv2Config, DepthAnythingFeatures)
        cfg = dav2 or DAv2Config.vits()
        super().__init__(cfg.fusion_hidden_size, width, device=device)
        self.target_hw = tuple(target_hw)
        self.features = DepthAnythingFeatures(cfg, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:  # [B, H, W, 3]
        B, H, W, _ = images.shape
        with torch.no_grad():                       # frozen tower
            fused = self.features(imagenet_input(images,
                                                 self.target_hw))[-1]
        return nhwc(resize(self.refine(fused), (H, W), "bilinear"))


class DinoFeatureEncoder(Refiner):
    """The frozen standalone DINOv2 backbone and its trainable refiner: its
    last tap without the cls token (frozen) on the patch grid, refined,
    resized back to the pixel grid. HF ``Dinov2Model`` checkpoints load
    through ``dav2.convert_dinov2_hf`` under ``backbone.``."""

    def __init__(self, width: int = 64, target_hw: tuple = (252, 336),
                 dino=None, device=None):
        from infinicube_tpu_torch.models.gsm.dav2 import (DAv2Config,
                                                          Dinov2Backbone)
        cfg = dino or DAv2Config.vits()
        super().__init__(cfg.hidden_size, width, device=device)
        self.cfg, self.target_hw = cfg, tuple(target_hw)
        self.backbone = Dinov2Backbone(cfg, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = images.shape
        th, tw = self.target_hw
        p = self.cfg.patch
        with torch.no_grad():                       # frozen tower
            tap = self.backbone(imagenet_input(images, self.target_hw))[-1]
        f = nchw(tap[:, 1:].reshape(B, th // p, tw // p, -1))
        return nhwc(resize(self.refine(f), (H, W), "bilinear"))


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
    # + "dav2" / "vit" / "plucker" / "dino" / "convnext"
    encoders: Sequence[str] = ("conv",)
    conv_width: int = 64
    vit_width: int = 128
    dav2_width: int = 64
    dav2_target_hw: tuple = (252, 336)
    dav2_config: Any = None                 # DAv2Config override (tests)
    plucker_width: int = 64
    plucker_patch: int = 8
    dino_width: int = 64
    dino_target_hw: tuple = (252, 336)
    dino_config: Any = None                 # DAv2Config override (tests)
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
        unknown = kinds - {"conv", "vit", "dav2", "dino", "plucker",
                           "convnext"}
        if unknown:
            raise ValueError(f"unknown encoder kinds {sorted(unknown)}")
        if "conv" in kinds:
            self.conv = ConvEncoder(cfg.conv_width, device=device)
        if "vit" in kinds:
            self.vit = PatchViTEncoder(cfg.vit_width,
                                       num_patches=vit_patches,
                                       device=device)
        if "dav2" in kinds:
            self.dav2 = DAV2FeatureEncoder(cfg.dav2_width, cfg.dav2_target_hw,
                                           cfg.dav2_config, device=device)
        if "dino" in kinds:
            self.dino = DinoFeatureEncoder(cfg.dino_width, cfg.dino_target_hw,
                                           cfg.dino_config, device=device)
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
        if "dav2" in kinds:
            feats.append(self.dav2(flat))
        if "dino" in kinds:
            feats.append(self.dino(flat))
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
