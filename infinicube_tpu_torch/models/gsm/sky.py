"""Learned sky models; counterpart of ``infinicube_tpu/models/gsm/sky.py``.

- **SkyboxMlpModulator**: sky pixels are patch-embedded, the skyest
  ``max_sky_tokens`` patches are kept (a stable descending sort of the
  patches' sky ratios: among equal ratios the lower index first, as
  ``lax.top_k`` keeps them), ray directions are pos-encoded, and a small
  transformer with a learned sky query produces a per-scene sky token;
  sampling is an MLP over ray directions FiLM-modulated by the token.
- **SkyboxPanorama**: an explicit equirectangular panorama, sampled by
  lat-long lookup.
- **SkyboxNull**: constant background.

The attention is plain PyTorch (XLA einsums in the reference). The
modulator computes in ``SkyConfig.dtype`` as the reference does: its convs,
Denses and attention in that dtype (flax's attention semantics there: the
logits, mask and softmax too), its LayerNorms in f32, and the sampled sky
back in f32."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch.models.gsm.encoders import nchw, nhwc
from infinicube_tpu_torch.nn.layers import (EPS, Conv2d, Dense,
                                            MultiHeadDotProductAttention)
from infinicube_tpu_torch.utils.sky_math import direction_to_latlong_uv


def posenc_dir(d: torch.Tensor, freqs: int = 4) -> torch.Tensor:
    out = [d]
    for i in range(freqs):
        out += [torch.sin(d * 2.0 ** i), torch.cos(d * 2.0 ** i)]
    return torch.cat(out, -1)


@dataclasses.dataclass(frozen=True)
class SkyConfig:
    kind: str = "mlp_modulator"        # mlp_modulator | panorama | null
    embed_dim: int = 192
    num_layers: int = 3
    num_heads: int = 4
    patch: int = 8
    sky_ratio_threshold: float = 0.75
    max_sky_tokens: int = 1024         # top-K sky patches kept
    pano_hw: tuple = (128, 256)
    dtype: torch.dtype = torch.float32  # the modulator's compute dtype


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of a 1-D tensor, equal
    values in ascending index order (``lax.top_k``'s order;
    ``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


class SkyboxMlpModulator(nn.Module):
    # the submodules ``sample`` uses
    SAMPLE_PARTS = ("in", "mod0", "mod1", "mod2", "ln0", "ln1", "ln2", "fc0",
                    "fc1", "fc2", "out")

    def __init__(self, cfg: SkyConfig = SkyConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        E, dt = cfg.embed_dim, cfg.dtype
        pe = 3 + 3 * 2 * 4                       # posenc_dir of a direction

        def dense(i, o):
            return Dense(i, o, compute_dtype=dt, device=device)

        self.patch_embed = Conv2d(3 + pe, E, cfg.patch, stride=cfg.patch,
                                  device=device, dtype=dt)
        self.sky_query = nn.Parameter(torch.zeros((1, 1, E), device=device))
        for i in range(cfg.num_layers):
            setattr(self, f"attn{i}", MultiHeadDotProductAttention(
                E, cfg.num_heads, device=device, dtype=dt))
            for j in (2 * i, 2 * i + 1):
                setattr(self, f"LayerNorm_{j}",
                        nn.LayerNorm(E, eps=EPS, device=device))
            setattr(self, f"Dense_{2 * i}", dense(E, 4 * E))
            setattr(self, f"Dense_{2 * i + 1}", dense(4 * E, E))
        self.add_module("in", dense(pe, E))
        for i in range(3):
            setattr(self, f"mod{i}", dense(E, 2 * E))
            setattr(self, f"ln{i}", nn.LayerNorm(E, eps=EPS, device=device))
            setattr(self, f"fc{i}", dense(E, E))
        self.out = dense(E, 3)

    def encode(self, images: torch.Tensor, sky_mask: torch.Tensor,
               ray_dirs: torch.Tensor) -> torch.Tensor:
        """images f32 [V, H, W, 3]; sky_mask bool [V, H, W]; ray_dirs
        [V, H, W, 3] -> sky token f32 [embed_dim]."""
        cfg = self.cfg
        p, E = cfg.patch, cfg.embed_dim
        x = torch.cat([images, posenc_dir(ray_dirs)], -1)
        x = nhwc(self.patch_embed(nchw(x)))                 # [V, ph, pw, E]
        ratio = F.avg_pool2d(sky_mask[:, None].float(), p, p)[:, 0]
        tokens = x.reshape(-1, E)
        K = min(cfg.max_sky_tokens, tokens.shape[0])
        top_ratio, top_idx = top_k_stable(ratio.reshape(-1), K)
        # the f32 query promotes the sequence to f32, as in the reference
        seq = torch.cat([self.sky_query, tokens[top_idx][None]], 1)
        mask = torch.cat([torch.ones((1, 1), dtype=torch.bool,
                                     device=x.device),
                          (top_ratio > cfg.sky_ratio_threshold)[None]], 1)
        for i in range(cfg.num_layers):
            h = getattr(self, f"LayerNorm_{2 * i}")(seq)
            seq = seq + getattr(self, f"attn{i}")(h, mask)
            h = getattr(self, f"LayerNorm_{2 * i + 1}")(seq)
            h = getattr(self, f"Dense_{2 * i}")(h)
            seq = seq + getattr(self, f"Dense_{2 * i + 1}")(
                F.gelu(h, approximate="tanh"))
        return seq[0, 0]

    def sample(self, token: torch.Tensor,
               ray_dirs: torch.Tensor) -> torch.Tensor:
        """token [E]; ray_dirs (..., 3) -> sky rgb (..., 3) in [0, 1]."""
        h = getattr(self, "in")(posenc_dir(ray_dirs))
        for i in range(3):
            scale, shift = getattr(self, f"mod{i}")(token).chunk(2, -1)
            h = F.silu(getattr(self, f"ln{i}")(h.float()) * (1 + scale) +
                       shift).to(self.cfg.dtype)
            h = getattr(self, f"fc{i}")(h)
        return torch.sigmoid(self.out(h).float())

    def forward(self, images, sky_mask, ray_dirs, sample_dirs):
        token = self.encode(images, sky_mask, ray_dirs)
        return self.sample(token, sample_dirs), token


class SkyboxPanorama(nn.Module):
    """Explicit equirect panorama (an optimized parameter map)."""

    def __init__(self, cfg: SkyConfig = SkyConfig(), device=None):
        super().__init__()
        self.pano = nn.Parameter(torch.full((*cfg.pano_hw, 3), 0.5,
                                            device=device))

    def forward(self, sample_dirs: torch.Tensor) -> torch.Tensor:
        H, W = self.pano.shape[:2]
        pano = self.pano
        uv = direction_to_latlong_uv(sample_dirs)
        u = uv[..., 0].mul(W - 1).clamp(0, W - 1.001)
        v = uv[..., 1].mul(H - 1).clamp(0, H - 1.001)
        u0, v0 = torch.floor(u).long(), torch.floor(v).long()
        du, dv = (u - u0)[..., None], (v - v0)[..., None]
        u1, v1 = (u0 + 1).clamp_max(W - 1), (v0 + 1).clamp_max(H - 1)
        c = (pano[v0, u0] * (1 - du) * (1 - dv) +
             pano[v0, u1] * du * (1 - dv) +
             pano[v1, u0] * (1 - du) * dv + pano[v1, u1] * du * dv)
        return c.clamp(0.0, 1.0)


class SkyboxNull(nn.Module):
    """Constant background color."""

    def __init__(self, color: tuple = (0.0, 0.0, 0.0)):
        super().__init__()
        self.color = color

    def forward(self, sample_dirs: torch.Tensor) -> torch.Tensor:
        c = sample_dirs.new_tensor(self.color)
        return c.expand(sample_dirs.shape[:-1] + (3,))
