"""Lifter and visibility for the GSM voxel branch; counterpart of
``infinicube_tpu/models/gsm/lifter.py``.

Each pixel's feature goes to the first voxel its ray meets, averaged over
all rays that land in a voxel (a scatter mean); the voxels some camera
sees first form the visible set. Two implementations, chosen by ``impl``:

- "splat" (default): the packed-splat z-buffer
  (``utils.buffers.splat_winner_slots``) resolves each pixel's front voxel
  with one scatter-min;
- "dda": the exact first-hit ray march (``ops.raycast.dda_first_hit``).

Views run one after another, as the reference's vmap would hold them all
at once. The scatter-adds on the card sum in no fixed order, so the card
agrees with the CPU to rounding, not bit for bit."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from infinicube_tpu_torch.camera import projection as proj
from infinicube_tpu_torch.grid.grid import Grid
from infinicube_tpu_torch.grid.ops import occupancy_dense
from infinicube_tpu_torch.ops.raycast import (dda_first_hit,
                                              manhattan_distance_transform)
from infinicube_tpu_torch.utils.buffers import splat_winner_slots

# finite masked-max sentinel (grid.ops uses the same): a -inf would tie
# with -inf and NaN the max's gradient split
_NEG = -7.0e37


def _dense_occupancy(grid: Grid, ijk_min, dense_dims):
    """(occupancy, its distance transform, ijk_min) of the crop the DDA
    route marches through."""
    occ = occupancy_dense(grid, ijk_min, dense_dims)[0]
    return occ, manhattan_distance_transform(occ), ijk_min


def _hit_indices(grid: Grid, occ, skip, ijk_min, ray_o, ray_d):
    hit = dda_first_hit(occ, ray_o, ray_d, grid.voxel_size, grid.origin,
                        ijk_min, skip_dist=skip)
    idx = grid.ijk_to_index(hit.ijk[None], hit.hit[None])[0]
    return torch.where(hit.hit, idx, -1).long()


def _splat_winners(grid: Grid, K, pose, hw):
    centers = grid.voxel_centers()[0]
    # 0.75 * vs (> half the diagonal of a voxel face): adjacent voxels'
    # footprints overlap by >= 1 px, so surfaces splat without pinholes
    radius = (0.75 * grid.voxel_size.max()).expand(grid.capacity)
    win, _ = splat_winner_slots(centers, grid.mask[0], radius, K, pose, hw)
    return win.reshape(-1)


def _front_voxels(grid, K, pose, hw, impl, dense):
    """int64 [h * w] slot of the first voxel each pixel's ray meets, -1
    where none."""
    if impl == "splat":
        return _splat_winners(grid, K, pose, hw)
    ro, rd = proj.posed_rays_from_intrinsics(K, pose, hw)
    return _hit_indices(grid, *dense, ro.reshape(-1, 3), rd.reshape(-1, 3))


def lift_features(grid: Grid, feats: torch.Tensor, Ks: torch.Tensor,
                  cam_to_worlds: torch.Tensor, ijk_min, dense_dims,
                  impl: str = "splat") -> torch.Tensor:
    """Unproject per-pixel features onto first-hit voxels, averaged over
    all rays landing in a voxel. Batch-1 grid.

    feats f32 [V, H, W, F]; Ks f32 [V, 3, 3]; cam_to_worlds f32 [V, 4, 4].
    Returns f32 [1, C, F] voxel features."""
    V, H, W, F = feats.shape
    dense = None if impl == "splat" else \
        _dense_occupancy(grid, ijk_min, dense_dims)
    C = grid.capacity
    s = feats.new_zeros((C + 1, F))
    cnt = feats.new_zeros((C + 1,))
    for K, pose, f in zip(Ks, cam_to_worlds, feats):
        idx = _front_voxels(grid, K, pose, (H, W), impl, dense)
        hit = idx >= 0
        safe = torch.where(hit, idx, C)
        fl = f.reshape(-1, F)
        s = s.index_add(0, safe, torch.where(hit[:, None], fl,
                                             torch.zeros_like(fl)))
        cnt = cnt.index_add(0, safe, hit.to(cnt.dtype))
    s, cnt = s[:C], cnt[:C]
    out = s / cnt[:, None].clamp_min(1.0)
    keep = (grid.mask[0] & (cnt > 0))[:, None]
    return torch.where(keep, out, torch.zeros_like(out))[None]


def visible_voxel_mask(grid: Grid, Ks: torch.Tensor,
                       cam_to_worlds: torch.Tensor, ijk_min, dense_dims,
                       ray_hw: tuple[int, int] = (192, 320),
                       impl: str = "splat") -> torch.Tensor:
    """bool [1, C]: voxels hit first by any camera ray, cast at ``ray_hw``
    (each camera's intrinsics rescaled to it)."""
    dense = None if impl == "splat" else \
        _dense_occupancy(grid, ijk_min, dense_dims)
    h, w = ray_hw
    C = grid.capacity
    vis = torch.zeros((C + 1,), dtype=torch.bool, device=grid.ijk.device)
    for K, pose in zip(Ks, cam_to_worlds):
        Ks_scaled = K.clone()
        Ks_scaled[0] = K[0] * (w / (2.0 * K[0, 2]))
        Ks_scaled[1] = K[1] * (h / (2.0 * K[1, 2]))
        idx = _front_voxels(grid, Ks_scaled, pose, ray_hw, impl, dense)
        vis[torch.where(idx >= 0, idx, C)] = True
    return (vis[:C] & grid.mask[0])[None]


def voxel_depth_prior(grid: Grid, Ks: torch.Tensor,
                      cam_to_worlds: torch.Tensor, ijk_min, dense_dims,
                      image_hw, impl: str = "splat") -> torch.Tensor:
    """Per-view z-depth rendered from the voxel grid, the pixel branch's
    depth prior. Returns f32 [V, H, W, 1] (0 = no hit)."""
    h, w = image_hw
    out = []
    if impl == "splat":
        centers = grid.voxel_centers()[0]
        radius = (0.75 * grid.voxel_size.max()).expand(grid.capacity)
        for K, pose in zip(Ks, cam_to_worlds):
            _, zd = splat_winner_slots(centers, grid.mask[0], radius, K,
                                       pose, image_hw)
            out.append(zd[..., None])
        return torch.stack(out)
    occ, skip, _ = _dense_occupancy(grid, ijk_min, dense_dims)
    for K, pose in zip(Ks, cam_to_worlds):
        ro, rd = proj.posed_rays_from_intrinsics(K, pose, image_hw)
        hit = dda_first_hit(occ, ro.reshape(-1, 3), rd.reshape(-1, 3),
                            grid.voxel_size, grid.origin, ijk_min,
                            skip_dist=skip)
        cos = rd.reshape(-1, 3) @ pose[:3, 2]
        out.append(torch.where(hit.hit, hit.t_entry * cos,
                               torch.zeros_like(cos)).reshape(h, w, 1))
    return torch.stack(out)


def sample_image_features(points: torch.Tensor, feats: torch.Tensor,
                          Ks: torch.Tensor,
                          cam_to_worlds: torch.Tensor) -> torch.Tensor:
    """Project world points into every view and max-pool bilinear features
    over the views that see them.

    points f32 [P, 3]; feats f32 [V, H, W, F] -> f32 [P, F] (0 where no
    view sees a point). Views run one after another with a running max, so
    the peak is one view's [P, F]."""
    V, H, W, F = feats.shape

    def per_view(best, K, pose, f):
        uv, _, valid = proj.project_points(points, pose, K, (H, W))
        # sanitize before any arithmetic: behind-camera points project to
        # inf / NaN uv, and their NaN bilinear weights would reach the
        # feature gradients through the masked branch (0 * NaN)
        zero = torch.zeros_like(uv[:, 0])
        u = torch.where(valid, uv[:, 0], zero).clamp(0.0, W - 1.001)
        v = torch.where(valid, uv[:, 1], zero).clamp(0.0, H - 1.001)
        u0, v0 = torch.floor(u).long(), torch.floor(v).long()
        du, dv = (u - u0)[:, None], (v - v0)[:, None]
        g = (f[v0, u0] * (1 - du) * (1 - dv) + f[v0, u0 + 1] * du * (1 - dv)
             + f[v0 + 1, u0] * (1 - du) * dv + f[v0 + 1, u0 + 1] * du * dv)
        g = torch.where(valid[:, None], g, torch.full_like(g, _NEG))
        return torch.maximum(best, g)

    best = feats.new_full((points.shape[0], F), _NEG)
    # with a gradient to record, each view is recomputed in the backward
    # (the reference's jax.checkpoint of its per-view step), so one view's
    # bilinear temporaries are live at a time there too
    recompute = torch.is_grad_enabled() and \
        (feats.requires_grad or points.requires_grad)
    for K, pose, f in zip(Ks, cam_to_worlds, feats):
        best = checkpoint(per_view, best, K, pose, f, use_reentrant=False) \
            if recompute else per_view(best, K, pose, f)
    return torch.where(best > _NEG / 2, best, torch.zeros_like(best))
