"""Pinhole camera: a host-side config object and the ray and projection
math on tensors; counterpart of ``infinicube_tpu/camera/pinhole.py``.

OpenCV camera frame; rays go through integer pixel coordinates and are
L2-normalized, so "distance" maps are Euclidean and z-depth = distance *
cos(angle to the optical axis). Intrinsics are Python floats; the
functional variants that take intrinsics as tensors are in
``camera.projection``. Tensors are made on ``device`` (the CPU by
default)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s correctly rounded on every device (on the card PyTorch divides
    by a Python scalar as a product with its rounded reciprocal)."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    fx: float
    fy: float
    cx: float
    cy: float
    w: int
    h: int

    @classmethod
    def from_intrinsics_matrix(cls, K, w: int, h: int) -> "PinholeCamera":
        K = np.asarray(K.cpu() if isinstance(K, torch.Tensor) else K)
        return cls(float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                   float(K[1, 2]), int(w), int(h))

    @property
    def width(self) -> int:
        return self.w

    @property
    def height(self) -> int:
        return self.h

    def intrinsics_matrix(self, device=None) -> torch.Tensor:
        return torch.tensor([[self.fx, 0.0, self.cx],
                             [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32,
                            device=device)

    def rescale(self, scale: float | None = None, *, w: int | None = None,
                h: int | None = None) -> "PinholeCamera":
        """A camera for a resized image."""
        if scale is not None:
            w, h = round(self.w * scale), round(self.h * scale)
        sx, sy = w / self.w, h / self.h
        return PinholeCamera(self.fx * sx, self.fy * sy, self.cx * sx,
                             self.cy * sy, w, h)

    # ---- rays -------------------------------------------------------------
    def get_rays(self, device=None) -> torch.Tensor:
        """f32 [H, W, 3] normalized camera-frame ray directions (OpenCV)."""
        u = torch.arange(self.w, dtype=torch.float32, device=device)
        v = torch.arange(self.h, dtype=torch.float32, device=device)
        vv, uu = torch.meshgrid(v, u, indexing="ij")
        d = torch.stack([_div(uu - self.cx, self.fx),
                         _div(vv - self.cy, self.fy), torch.ones_like(uu)],
                        dim=-1)
        return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)

    def get_rays_posed(self, poses: torch.Tensor):
        """poses f32 [N, 4, 4] camera-to-world (OpenCV camera frame) ->
        (ray_o [N, H, W, 3], ray_d [N, H, W, 3]) in world."""
        rays = self.get_rays(poses.device)
        ray_d = torch.einsum("nij,hwj->nhwi", poses[:, :3, :3], rays)
        ray_o = poses[:, None, None, :3, 3].expand(ray_d.shape)
        return ray_o, ray_d

    # ---- pixel <-> ray ----------------------------------------------------
    def pixel2ray(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (..., 2) -> un-normalized rays (..., 3) at z=1."""
        x = _div(pixels[..., 0] - self.cx, self.fx)
        y = _div(pixels[..., 1] - self.cy, self.fy)
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def ray2pixel(self, rays: torch.Tensor) -> torch.Tensor:
        """rays (..., 3) camera frame -> pixel coords (..., 2)."""
        z = rays[..., 2]
        return torch.stack([rays[..., 0] / z * self.fx + self.cx,
                            rays[..., 1] / z * self.fy + self.cy], dim=-1)

    # ---- depth conversions -------------------------------------------------
    def distance_to_zdepth(self, distance: torch.Tensor) -> torch.Tensor:
        """distance [H, W] (Euclidean along normalized ray) -> z-depth."""
        return distance * self.get_rays(distance.device)[..., 2]

    def zdepth_to_distance(self, zdepth: torch.Tensor) -> torch.Tensor:
        return zdepth / self.get_rays(zdepth.device)[..., 2]
