"""GSM voxel branch: a guided sparse UNet over the scene grid -> K gaussians
per voxel; counterpart of ``infinicube_tpu/models/gsm/voxel_branch.py``.

Lifted image features run through a sparse UNet whose structure is given
(the grid pyramid is known); its ``SparseResBlock``s compute in
``VoxelBranchConfig.dtype`` and run K4 (``sparse_conv_f32``) on the card,
or its bf16 twins in bf16. The input projection and the heads compute in
the result type of their input and their f32 parameters (flax's
``Dense(dtype=None)``), as in the reference. Camera-visible voxels are
subdivided x2 and their children also max-pool the projected multi-view
image features; occluded voxels keep their base resolution and 3D
features. Every voxel
decodes K gaussians: an offset bounded by ``gs_free_space`` voxels, an exp
scale clamped to ``max_scaling`` voxels, a normalized quaternion, sigmoid
opacity and color."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from infinicube_tpu_torch.grid.build import subdivided_grid
from infinicube_tpu_torch.grid.grid import Grid
from infinicube_tpu_torch.grid.ops import max_pool, upsample_nearest
from infinicube_tpu_torch.models.gsm.lifter import sample_image_features
from infinicube_tpu_torch.nn.layers import Dense
from infinicube_tpu_torch.nn.sparse import SparseResBlock, conv_plan


@dataclasses.dataclass(frozen=True)
class VoxelBranchConfig:
    f_maps: int = 64
    levels: int = 3
    pooling_factor: tuple = (2, 2, 2)
    gaussians_per_voxel: int = 4       # release gsplat_upsample=4
    gs_free_space: float = 1.5         # offset bound in voxel units
    max_scaling: float = 12.0          # scale clamp (x voxel size)
    vis_subdiv: int = 2                # visible voxels' subdivision
    vis_subdiv_capacity_mult: int = 4  # subdivided-grid capacity / base
    # Optional (ijk_min, dims) cube covering the level-0 scene grid: the
    # conv plans look neighbours up in a dense slot volume instead of a
    # binary search per tap (``nn.sparse.conv_plan``); voxels outside it
    # NaN-poison the convs.
    dense_lookup_bounds: tuple | None = None
    dtype: torch.dtype = torch.float32  # the SparseResBlocks' compute dtype

    def level_dense_bounds(self, level: int):
        """Level-``level`` cube: level-0 bounds through the floor-div
        coarsening by pooling_factor."""
        if self.dense_lookup_bounds is None:
            return None
        mn0, dm0 = self.dense_lookup_bounds
        mn = np.asarray(mn0, np.int64)
        mx = mn + np.asarray(dm0, np.int64) - 1
        f = np.asarray(self.pooling_factor, np.int64)
        for _ in range(level):
            mn = np.floor_divide(mn, f)
            mx = np.floor_divide(mx, f)
        return (tuple(int(v) for v in mn),
                tuple(int(v) for v in (mx - mn + 1)))


class GaussianHead(nn.Module):
    """features -> K gaussians per voxel: (dpos 3, scale 3, quat 4, op 1,
    rgb 3) x K."""

    def __init__(self, cfg: VoxelBranchConfig, in_features: int,
                 name_prefix: str = "head", device=None):
        super().__init__()
        self.cfg = cfg
        self.name_prefix = name_prefix
        self.add_module(f"{name_prefix}_out", Dense(
            in_features, cfg.gaussians_per_voxel * 14, compute_dtype=None,
            device=device))

    def forward(self, feats: torch.Tensor, grid: Grid,
                mask: torch.Tensor) -> dict:
        cfg = self.cfg
        K = cfg.gaussians_per_voxel
        out = getattr(self, f"{self.name_prefix}_out")(feats)
        B, C = feats.shape[:2]
        out = out.reshape(B, C, K, 14)
        centers = grid.voxel_centers()[:, :, None, :]
        vs = grid.voxel_size
        means = centers + torch.tanh(out[..., 0:3]) * cfg.gs_free_space * vs
        scales = torch.exp(out[..., 3:6].clamp(-10.0, 2.5)) * torch.minimum(
            vs * cfg.max_scaling, vs * float(np.exp(2.5)))
        quats = out[..., 6:10] + out.new_tensor([1.0, 0.0, 0.0, 0.0])
        quats = quats / torch.linalg.vector_norm(
            quats, dim=-1, keepdim=True).clamp_min(1e-6)
        opacity = torch.sigmoid(out[..., 10])
        valid = mask[:, :, None].expand(B, C, K)
        return {"means": means, "scales": scales, "quats": quats,
                "opacities": torch.where(valid, opacity,
                                         torch.zeros_like(opacity)),
                "colors": torch.sigmoid(out[..., 11:14]), "valid": valid}


class VoxelBranch(nn.Module):
    """``in_features``: the lifted features' width (the encoder's);
    ``image_features``: the width of the image features the visible head
    samples (the same)."""

    def __init__(self, cfg: VoxelBranchConfig = VoxelBranchConfig(),
                 in_features: int = 64, image_features: int | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        fm, L = cfg.f_maps, cfg.levels
        self.in_proj = Dense(in_features, fm, compute_dtype=None,
                             device=device)
        widths = [fm * 2 ** l for l in range(L)]
        kw = dict(dtype=cfg.dtype, device=device)
        for l in range(L):
            setattr(self, f"enc{l}", SparseResBlock(
                widths[l - 1] if l else fm, widths[l], **kw))
        for l in range(L - 2, -1, -1):
            setattr(self, f"dec{l}", SparseResBlock(
                widths[l + 1] + widths[l], widths[l], **kw))
        fi = in_features if image_features is None else image_features
        self.head_vis = GaussianHead(cfg, fi + fm, "vis", device=device)
        self.head_occ = GaussianHead(cfg, fm, "occ", device=device)

    def forward(self, grids: list[Grid], feats: torch.Tensor,
                visible: torch.Tensor, image_feats: torch.Tensor,
                Ks: torch.Tensor, cam_to_worlds: torch.Tensor) -> dict:
        """grids: guided pyramid [G0 (scene grid) .. G_L]; feats [1, C0, F]
        lifted features on G0; visible bool [1, C0]; image_feats
        [V, H, W, Fi]."""
        cfg = self.cfg
        L = min(cfg.levels, len(grids))
        plans = [conv_plan(grids[l], dense_bounds=cfg.level_dense_bounds(l))
                 for l in range(L)]
        h = self.in_proj(feats)
        skips = []
        for l in range(L):             # encoder: guided pooling down
            h = getattr(self, f"enc{l}")(h, plans[l], grids[l].mask)
            skips.append(h)
            if l < L - 1:
                _, h = max_pool(grids[l], h, cfg.pooling_factor,
                                coarse=grids[l + 1])
        for l in range(L - 2, -1, -1):  # decoder: the fine grid is known
            _, h = upsample_nearest(grids[l + 1], h, cfg.pooling_factor,
                                    fine=grids[l])
            h = torch.cat([h, skips[l]], -1)
            h = getattr(self, f"dec{l}")(h, plans[l], grids[l].mask)

        g0 = grids[0]
        # visible voxels are subdivided before the hybrid head: children
        # inherit their parent's features and concatenate the multi-view
        # image features sampled at their centers
        sub = subdivided_grid(g0, cfg.vis_subdiv, submask=visible & g0.mask,
                              capacity=g0.capacity *
                              cfg.vis_subdiv_capacity_mult)
        _, h_sub = upsample_nearest(g0, h, cfg.vis_subdiv, fine=sub)
        mv = sample_image_features(sub.voxel_centers()[0], image_feats, Ks,
                                   cam_to_worlds)[None]
        mv = torch.where(sub.mask[..., None], mv, torch.zeros_like(mv))
        gs_vis = self.head_vis(torch.cat([mv, h_sub], -1), sub, sub.mask)
        gs_occ = self.head_occ(h, g0, g0.mask & ~visible)
        return {k: torch.cat([gs_vis[k], gs_occ[k]], 1) for k in gs_vis}
