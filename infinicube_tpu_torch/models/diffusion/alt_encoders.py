"""The alternative conditioning encoders; counterpart of
``infinicube_tpu/models/diffusion/alt_encoders.py``.

``ClassEmbedder`` (adm class ids), ``SemanticEncoder`` (per-voxel semantic
embedding), ``PointNetEncoder`` (one lidar scan -> a global feature by a
masked max), ``Lift3DEncoder`` (image features gathered at the projected
latent-cube centres, averaged over the views that see them), ``LssEncoder``
(lift-splat-shoot: per-pixel depth distribution times features added into
the cube, with ``depth_distribution_loss``, its focal loss against binned
lidar depth) and ``StructEncoder`` (a coarse occupancy cube -> concat
channels).

Modules take channels-last tensors as the JAX package's; the flax convs
(NHWC, SAME padding) run as ``nn.layers.Conv2d`` on NCHW views and the 3-D
ones as ``conv3d_ndhwc``. Submodule names are the flax names, so
``weights/from_jax.py`` maps the parameters by name. Plain PyTorch: the
reference computes these with XLA, outside any Pallas kernel."""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch.camera import projection as proj
from infinicube_tpu_torch.nn.layers import (Conv2d, Dense, conv3d_ndhwc,
                                            lecun_normal_)
from infinicube_tpu_torch.utils.casts import saturating_int32


def _conv_nhwc(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A flax ``nn.Conv`` on an NHWC tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ClassEmbedder(nn.Module):
    """Class id -> embedding (adm conditioning)."""

    def __init__(self, num_classes: int, embed_dim: int, device=None):
        super().__init__()
        self.Embed_0 = nn.Embedding(num_classes, embed_dim, device=device)

    def forward(self, class_ids: torch.Tensor) -> torch.Tensor:
        return self.Embed_0(class_ids.long())


class SemanticEncoder(nn.Module):
    """Per-voxel semantic embedding (ids clipped into the table)."""

    def __init__(self, num_classes: int = 23, embed_dim: int = 32,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.Embed_0 = nn.Embedding(num_classes, embed_dim, device=device)

    def forward(self, semantics: torch.Tensor) -> torch.Tensor:
        return self.Embed_0(semantics.long().clamp(0, self.num_classes - 1))


class PointNetEncoder(nn.Module):
    """Per-point MLP, a masked max over the points, a Dense: points f32
    [B, N, 3], mask bool [B, N] -> f32 [B, out_dim]. A sample with no
    point takes 0 for its pooled feature (the max is -inf there)."""

    def __init__(self, width: int = 128, out_dim: int = 256, device=None):
        super().__init__()
        self.Dense_0 = Dense(3, width, device=device)
        self.Dense_1 = Dense(width, width, device=device)
        self.Dense_2 = Dense(width, out_dim, device=device)

    def forward(self, points: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.Dense_1(F.relu(self.Dense_0(points))))
        h = torch.where(mask[..., None], h,
                        torch.full((), -math.inf, device=h.device))
        g = h.amax(dim=1)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        return self.Dense_2(g)


class Lift3DEncoder(nn.Module):
    """Image features lifted to a dense cube: every cube centre is
    projected into each view, takes the feature of the pixel it lands in
    (truncated coordinates, clipped into the image) where it is visible,
    and the features are averaged over the views that see it."""

    def __init__(self, feat_dim: int = 32, device=None):
        super().__init__()
        self.feat_dim = feat_dim
        self.conv = Conv2d(3, feat_dim, 3, device=device)

    def forward(self, images: torch.Tensor, Ks: torch.Tensor,
                cam_to_worlds: torch.Tensor,
                cube_centers: torch.Tensor) -> torch.Tensor:
        """images f32 [V, H, W, 3]; cube_centers f32 [D, H', W', 3] world.
        Returns f32 [D, H', W', feat_dim]."""
        V, H, W, _ = images.shape
        feats = _conv_nhwc(self.conv, images)
        pts = cube_centers.reshape(-1, 3)
        total, seen = 0.0, 0.0
        for K, pose, f in zip(Ks, cam_to_worlds, feats):
            uv, _, valid = proj.project_points(pts, pose, K, (H, W))
            u = saturating_int32(uv[:, 0]).clamp(0, W - 1).long()
            v = saturating_int32(uv[:, 1]).clamp(0, H - 1).long()
            g = f[v, u]
            total = total + torch.where(valid[:, None], g,
                                        torch.zeros_like(g))
            seen = seen + valid.float()
        out = total / torch.as_tensor(seen).clamp_min(1.0)[:, None]
        return out.reshape(cube_centers.shape[:-1] + (self.feat_dim,))


@dataclasses.dataclass(frozen=True)
class LssConfig:
    feat_dim: int = 32
    depth_bins: int = 32
    d_min: float = 1.0
    d_max: float = 40.0


class LssEncoder(nn.Module):
    """Lift-splat-shoot: a stride-2 stem, a head giving each pixel features
    and depth logits; each pixel's features times its depth probability
    are added into the cube cell of every depth bin's point (points outside
    the cube are dropped, not clamped), and the sums are divided by the
    summed probabilities."""

    def __init__(self, cfg: LssConfig = LssConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.stem = Conv2d(3, 64, 3, stride=2, device=device)
        self.head = Conv2d(64, cfg.feat_dim + cfg.depth_bins, 3,
                           device=device)

    def forward(self, images: torch.Tensor, Ks: torch.Tensor,
                cam_to_worlds: torch.Tensor, cube_dims, ijk_min, voxel_size,
                origin):
        """-> (cube f32 [D, H', W', feat_dim], depth logits
        [V, H/2, W/2, bins]). The views are splatted one at a time."""
        cfg = self.cfg
        V, H, W, _ = images.shape
        dev = images.device
        h = _conv_nhwc(self.head, F.relu(_conv_nhwc(self.stem, images)))
        feats, dlog = h[..., :cfg.feat_dim], h[..., cfg.feat_dim:]
        dprob = torch.softmax(dlog, dim=-1)
        Hs, Ws = feats.shape[1:3]
        depths = torch.linspace(cfg.d_min, cfg.d_max, cfg.depth_bins,
                                device=dev)
        D, Hc, Wc = cube_dims
        vs = torch.as_tensor(voxel_size, dtype=torch.float32, device=dev)
        org = torch.as_tensor(origin, dtype=torch.float32, device=dev)
        lo = torch.as_tensor(ijk_min, dtype=torch.int32, device=dev)
        dims = torch.tensor((D, Hc, Wc), dtype=torch.int32, device=dev)
        flat_n = D * Hc * Wc
        acc = torch.zeros((flat_n + 1, cfg.feat_dim), device=dev)
        cnt = torch.zeros((flat_n + 1,), device=dev)
        for K, pose, f, dp in zip(Ks, cam_to_worlds, feats, dprob):
            K_half = torch.cat([K[:2] * (Hs / H), K[2:]])
            rays = proj.rays_from_intrinsics(K_half, (Hs, Ws),
                                             normalize=False)
            pts = rays[None] * depths[:, None, None, None]  # [bins, Hs, Ws, 3]
            world = torch.einsum("ij,bhwj->bhwi", pose[:3, :3], pts) + \
                pose[:3, 3]
            w = dp.permute(2, 0, 1)[..., None]              # [bins, Hs, Ws, 1]
            contrib = f[None] * w
            ijk = saturating_int32(torch.round((world - org) / vs)) - lo
            ok = ((ijk >= 0) & (ijk < dims)).all(dim=-1)
            flat = (ijk[..., 0].long() * Hc + ijk[..., 1]) * Wc + ijk[..., 2]
            flat = torch.where(ok, flat, flat_n).reshape(-1)
            acc = acc.index_add(0, flat, contrib.reshape(-1, cfg.feat_dim))
            cnt = cnt.index_add(0, flat, torch.where(
                ok, w[..., 0], torch.zeros_like(w[..., 0])).reshape(-1))
        cube = acc[:-1] / cnt[:-1].clamp_min(1e-6)[:, None]
        return cube.reshape(D, Hc, Wc, cfg.feat_dim), dlog


def _resize_nearest_hw(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (N, h, w), "nearest")`` of x [N, H, W]: output
    pixel i takes input floor((i + 0.5) * in / out)."""
    out = x
    for axis, n_out in ((1, hw[0]), (2, hw[1])):
        n_in = out.shape[axis]
        src = torch.floor((torch.arange(n_out, dtype=torch.float32,
                                        device=x.device) + 0.5) *
                          (n_in / n_out)).long().clamp(0, n_in - 1)
        out = out.index_select(axis, src)
    return out


def depth_distribution_loss(depth_logits: torch.Tensor,
                            gt_depth: torch.Tensor, cfg: LssConfig,
                            gamma: float = 2.0) -> torch.Tensor:
    """Focal cross-entropy of the LSS depth distribution [V, Hs, Ws, bins]
    against lidar depth [V, H, W] (nearest-resized, binned linearly over
    [d_min, d_max]; pixels without depth, gt <= 0, are left out)."""
    Hs, Ws = depth_logits.shape[1:3]
    gt = _resize_nearest_hw(gt_depth, (Hs, Ws))
    valid = gt > 0
    bins = ((gt - cfg.d_min) / (cfg.d_max - cfg.d_min) *
            (cfg.depth_bins - 1)).clamp(0, cfg.depth_bins - 1)
    bins = saturating_int32(bins).long()
    lp = torch.log_softmax(depth_logits, dim=-1)
    pt = torch.gather(lp, -1, bins[..., None])[..., 0]
    focal = -((1 - torch.exp(pt)) ** gamma) * pt
    return (focal * valid).sum() / valid.sum().clamp_min(1).float()


class StructEncoder(nn.Module):
    """A partial or coarse occupancy cube [B, D, H, W, 1] -> [B, D, H, W,
    feat_dim] concat channels: two 3x3x3 convs with a ReLU between."""

    def __init__(self, feat_dim: int = 16, device=None):
        super().__init__()
        self.c1 = nn.Conv3d(1, feat_dim, 3, device=device)
        self.c2 = nn.Conv3d(feat_dim, feat_dim, 3, device=device)

    def forward(self, occupancy: torch.Tensor) -> torch.Tensor:
        h = conv3d_ndhwc(occupancy, self.c1.weight, self.c1.bias,
                         torch.float32, padding=1)
        return conv3d_ndhwc(F.relu(h), self.c2.weight, self.c2.bias,
                            torch.float32, padding=1)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights with flax's initializer scales for these encoders:
    Dense and conv kernels lecun-normal over their fan-in, biases zero,
    embeddings N(0, 1 / embed_dim) (as the sparse VAE's)."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv2d, nn.Conv3d)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                             generator=generator)
