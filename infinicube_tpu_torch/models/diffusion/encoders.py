"""Condition encoders of the voxel latent diffusion model; counterpart of
``infinicube_tpu/models/diffusion/encoders.py`` (the release's concat
conditions: pos-embed, map cube, box cube). All outputs are dense NDHWC
f32 cubes."""

from __future__ import annotations

import torch

from infinicube_tpu_torch.utils.bbox import points_in_obb


def latent_cube_centers(cube_dims, ijk_min, voxel_size, origin,
                        device=None) -> torch.Tensor:
    """f32 [D, H, W, 3] world centers of the dense latent cube voxels."""
    D, H, W = cube_dims
    ii, jj, kk = torch.meshgrid(torch.arange(D, device=device),
                                torch.arange(H, device=device),
                                torch.arange(W, device=device), indexing="ij")
    ijk = torch.stack([ii, jj, kk], dim=-1).float() + \
        torch.tensor(ijk_min, dtype=torch.float32, device=device)
    return ijk * torch.tensor(voxel_size, dtype=torch.float32,
                              device=device) + \
        torch.tensor(origin, dtype=torch.float32, device=device)


def pos_embed_cube(cube_dims, device=None) -> torch.Tensor:
    """f32 [D, H, W, 3] normalized coordinates in [-1, 1]."""
    D, H, W = cube_dims
    ii, jj, kk = torch.meshgrid(
        *(torch.linspace(-1, 1, n, device=device) for n in (D, H, W)),
        indexing="ij")
    return torch.stack([ii, jj, kk], dim=-1).float()


def encode_map(map_points: torch.Tensor, map_mask: torch.Tensor, cube_dims,
               ijk_min, voxel_size, origin) -> torch.Tensor:
    """Rasterize map polyline points into per-type occupancy cubes.
    map_points f32 [B, T, N, 3] (chunk frame), map_mask bool [B, T, N]
    -> f32 [B, D, H, W, T] in {0, 1}."""
    D, H, W = cube_dims
    B, T, N, _ = map_points.shape
    dev = map_points.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    org = torch.tensor(origin, dtype=torch.float32, device=dev)
    ijk = torch.round((map_points - org) / vs).to(torch.int64) - \
        torch.tensor(ijk_min, dtype=torch.int64, device=dev)
    hi = torch.tensor((D, H, W), device=dev)
    ok = map_mask & ((ijk >= 0) & (ijk < hi)).all(dim=-1)
    flat = (ijk[..., 0] * H + ijk[..., 1]) * W + ijk[..., 2]
    flat = torch.where(ok, flat, torch.full_like(flat, D * H * W))
    occ = torch.zeros((B, T, D * H * W + 1), dtype=torch.float32, device=dev)
    occ.scatter_(2, flat, torch.ones_like(flat, dtype=torch.float32))
    return occ[..., :-1].reshape(B, T, D, H, W).permute(0, 2, 3, 4, 1) \
        .contiguous()


def encode_boxes(box_poses: torch.Tensor, box_lwhs: torch.Tensor,
                 box_mask: torch.Tensor, cube_dims, ijk_min, voxel_size,
                 origin, add_occupancy_flag: bool = False) -> torch.Tensor:
    """Stamp oriented boxes into (sin, cos[, occ]) heading cubes. Voxel
    centres inside a box take its heading; later boxes overwrite earlier
    ones. box_poses f32 [B, M, 4, 4]; box_lwhs f32 [B, M, 3]; box_mask bool
    [B, M] -> f32 [B, D, H, W, 2 or 3]."""
    D, H, W = cube_dims
    dev = box_poses.device
    centers = latent_cube_centers(cube_dims, ijk_min, voxel_size, origin,
                                  device=dev).reshape(-1, 3)
    B, M = box_mask.shape
    inside = points_in_obb(centers[None, None], box_poses, box_lwhs) & \
        box_mask[..., None]                                   # [B, M, N]
    yaw = torch.atan2(box_poses[..., 1, 0], box_poses[..., 0, 0])
    enc = [torch.sin(yaw), torch.cos(yaw)]
    if add_occupancy_flag:
        enc.append(torch.ones_like(yaw))
    enc = torch.stack(enc, dim=-1)                            # [B, M, C]
    order = torch.arange(1, M + 1, device=dev)[None, :, None]
    last = torch.where(inside, order, torch.zeros_like(order)).amax(dim=1)
    got = torch.gather(enc, 1, (last - 1).clamp_min(0)[..., None].expand(
        -1, -1, enc.shape[-1]))
    out = torch.where((last > 0)[..., None], got, torch.zeros_like(got))
    return out.reshape(B, D, H, W, enc.shape[-1])


def classifier_free_drop(cond: torch.Tensor, prob: float,
                         generator: torch.Generator | None = None,
                         drop: torch.Tensor | None = None) -> torch.Tensor:
    """Zero the condition per sample with probability ``prob`` (the
    training-time dropout of classifier-free guidance). ``drop`` bool [B] is
    the per-sample mask; it is drawn from ``generator`` (uniform < prob)
    when not given."""
    B = cond.shape[0]
    if drop is None:
        drop = torch.rand((B,), generator=generator,
                          device=cond.device) < prob
    drop = drop.to(cond.device).reshape((-1,) + (1,) * (cond.dim() - 1))
    return torch.where(drop, torch.zeros_like(cond), cond)
