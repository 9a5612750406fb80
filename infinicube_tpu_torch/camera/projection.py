"""Functional projection ops (intrinsics and poses as tensors); counterpart
of ``infinicube_tpu/camera/projection.py``: point projection, z-depth maps
from point clouds by a per-pixel min, point drawing, posed rays and depth
unprojection."""

from __future__ import annotations

import torch

from infinicube_tpu_torch.camera.conventions import (invert_pose,
                                                     transform_points)
from infinicube_tpu_torch.utils.casts import saturating_int32


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once, as the reference's compiled projection
    computes it (XLA contracts the multiply-add into an FMA; the separate
    product and sum differ in the last bit for about a tenth of points,
    which moves points that project to pixel centers). The f32 product is
    exact in f64, so the only rounding left is the f64 sum's, negligible."""
    return (a.double() * b.double() + c.double()).float()


def project_points(points: torch.Tensor, cam_to_world: torch.Tensor,
                   K: torch.Tensor, image_hw: tuple[int, int]):
    """Project world points into a camera.

    points f32 [N, 3]; cam_to_world f32 [4, 4] (OpenCV camera frame); K f32
    [3, 3]. Returns (uv f32 [N, 2], z f32 [N], valid bool [N]) with valid =
    in front of the camera and inside the image."""
    h, w = image_hw
    pc = transform_points(points, invert_pose(cam_to_world))
    z = pc[..., 2]
    inv_z = torch.where(z > 1e-6, 1.0 / z.clamp_min(1e-6),
                        torch.zeros_like(z))
    u = _fma(pc[..., 0] * inv_z, K[0, 0], K[0, 2])
    v = _fma(pc[..., 1] * inv_z, K[1, 1], K[1, 2])
    uv = torch.stack([u, v], dim=-1)
    valid = (z > 1e-6) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return uv, z, valid


def _pixel_index(uv, valid, h, w):
    px = saturating_int32(uv[..., 0]).clamp(0, w - 1)
    py = saturating_int32(uv[..., 1]).clamp(0, h - 1)
    flat = (py * w + px).long()
    return torch.where(valid, flat, torch.full_like(flat, h * w))


def zdepth_map_from_points(points: torch.Tensor, point_mask: torch.Tensor,
                           cam_to_world: torch.Tensor, K: torch.Tensor,
                           image_hw: tuple[int, int]) -> torch.Tensor:
    """Per-pixel minimum z of projected points; 0 where empty."""
    h, w = image_hw
    uv, z, valid = project_points(points, cam_to_world, K, (h, w))
    valid = valid & point_mask
    flat = _pixel_index(uv, valid, h, w)
    zmap = torch.full((h * w + 1,), float("inf"), device=points.device)
    zmap.scatter_reduce_(0, flat, torch.where(valid, z, float("inf")),
                         "amin")
    zmap = zmap[:-1]
    return torch.where(torch.isfinite(zmap), zmap,
                       torch.zeros_like(zmap)).reshape(h, w)


def draw_points(values: torch.Tensor, points: torch.Tensor,
                point_mask: torch.Tensor, cam_to_world: torch.Tensor,
                K: torch.Tensor, image_hw: tuple[int, int], background=0.0):
    """Painter's-algorithm point drawing (the nearest point wins a pixel).
    values [N, F] -> image [H, W, F]. Where several points tie at a
    pixel's nearest z, which one is drawn is unspecified, as in the
    reference's scatter."""
    h, w = image_hw
    uv, z, valid = project_points(points, cam_to_world, K, (h, w))
    valid = valid & point_mask
    flat = _pixel_index(uv, valid, h, w)
    zmin = torch.full((h * w + 1,), float("inf"), device=points.device)
    zmin.scatter_reduce_(0, flat, torch.where(valid, z, float("inf")),
                         "amin")
    is_winner = valid & (z <= zmin[flat.clamp(0, h * w - 1)] + 1e-6)
    img = torch.full((h * w + 1, values.shape[-1]), background,
                     dtype=values.dtype, device=values.device)
    img[torch.where(is_winner, flat, torch.full_like(flat, h * w))] = values
    return img[:-1].reshape(h, w, values.shape[-1])


def polyline_to_points(polyline: torch.Tensor,
                       n_per_seg: int = 16) -> torch.Tensor:
    """Densify a polyline [M, 3] into [M-1, n_per_seg, 3] sampled points."""
    a, b = polyline[:-1], polyline[1:]
    t = torch.linspace(0.0, 1.0, n_per_seg, device=polyline.device)[
        None, :, None]
    return a[:, None, :] * (1 - t) + b[:, None, :] * t


def rays_from_intrinsics(K: torch.Tensor, image_hw: tuple[int, int],
                         normalize: bool = True) -> torch.Tensor:
    """f32 [H, W, 3] camera-frame rays from an intrinsics tensor."""
    h, w = image_hw
    vv, uu = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=K.device),
        torch.arange(w, dtype=torch.float32, device=K.device), indexing="ij")
    d = torch.stack([(uu - K[0, 2]) / K[0, 0], (vv - K[1, 2]) / K[1, 1],
                     torch.ones_like(uu)], dim=-1)
    if normalize:
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d


def posed_rays_from_intrinsics(K: torch.Tensor, cam_to_world: torch.Tensor,
                               image_hw: tuple[int, int],
                               normalize: bool = True):
    """(ray_o, ray_d) [H, W, 3] world-space rays for one camera."""
    rays = rays_from_intrinsics(K, image_hw, normalize)
    ray_d = torch.einsum("ij,hwj->hwi", cam_to_world[:3, :3], rays)
    ray_o = cam_to_world[:3, 3].expand(ray_d.shape)
    return ray_o, ray_d


def unproject_depth(zdepth: torch.Tensor, K: torch.Tensor,
                    cam_to_world: torch.Tensor) -> torch.Tensor:
    """z-depth [..., H, W] -> world points [..., H, W, 3] (the coordinate
    buffer's unprojection); cam_to_world [..., 4, 4] with the same leading
    axes, e.g. [T, H, W] depths with [T, 4, 4] poses."""
    h, w = zdepth.shape[-2:]
    rays = rays_from_intrinsics(K, (h, w), normalize=False)  # z=1 rays
    pc = rays * zdepth[..., None]
    return torch.einsum("...ij,...hwj->...hwi", cam_to_world[..., :3, :3],
                        pc) + cam_to_world[..., None, None, :3, 3]
