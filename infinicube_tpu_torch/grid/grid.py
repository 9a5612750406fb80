"""The sparse voxel grid container; counterpart of
``infinicube_tpu/grid/grid.py``.

A ``Grid`` is a capacity-padded, sorted-coordinate set:

- ``ijk``   : int32 [B, C, 3], sorted per batch row by packed key;
- ``mask``  : bool [B, C], True for active voxels (contiguous at the front);
- ``keys``  : int64 [B, C], packed keys, padding = INVALID_KEY, ascending;
- ``voxel_size``, ``origin`` : f32 [3], shared across the batch;
- ``num_dropped`` : int32 [B] voxels dropped by capacity overflow, or None.

World/grid conventions are the JAX package's (fvdb's):
``ijk = round((p - origin) / voxel_size)``, center = ``ijk * vs + origin``.
"""

from __future__ import annotations

import dataclasses

import torch

from infinicube_tpu_torch.grid import keys as K
from infinicube_tpu_torch.utils.casts import saturating_int32


@dataclasses.dataclass(frozen=True)
class Grid:
    ijk: torch.Tensor
    mask: torch.Tensor
    keys: torch.Tensor
    voxel_size: torch.Tensor
    origin: torch.Tensor
    num_dropped: torch.Tensor | None = None

    @property
    def batch_size(self) -> int:
        return self.ijk.shape[0]

    @property
    def capacity(self) -> int:
        return self.ijk.shape[1]

    def world_to_grid(self, points: torch.Tensor) -> torch.Tensor:
        """Continuous grid coordinates of world points (..., 3)."""
        return (points - self.origin) / self.voxel_size

    def grid_to_world(self, ijk: torch.Tensor) -> torch.Tensor:
        return ijk * self.voxel_size + self.origin

    def world_to_ijk(self, points: torch.Tensor) -> torch.Tensor:
        """Voxel coordinates containing world points (..., 3): round half to
        even, as ``jnp.round``, of the f32 grid coordinates, cast to int32
        as XLA casts (saturating)."""
        return saturating_int32(torch.round(self.world_to_grid(points)))

    def voxel_centers(self) -> torch.Tensor:
        """f32 [B, C, 3] world centers of all slots (padding included)."""
        return self.grid_to_world(self.ijk.float())

    def ijk_to_index(self, ijk: torch.Tensor,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
        """Per-batch slot index of each query ijk [B, N, 3], -1 if inactive
        -> int32 [B, N]."""
        return self.key_to_index(K.pack(ijk, valid))

    def key_to_index(self, qkeys: torch.Tensor) -> torch.Tensor:
        """Packed-key lookup: int64 [B, N] -> int32 [B, N] (-1 = miss)."""
        pos = torch.searchsorted(self.keys, qkeys.contiguous())
        pos_c = pos.clamp(0, self.capacity - 1)
        hit = (torch.gather(self.keys, 1, pos_c) == qkeys) & \
            (qkeys != K.INVALID_KEY)
        return torch.where(hit, pos_c, torch.full_like(pos_c, -1)).to(
            torch.int32)

    def points_in_active_voxel(self, points: torch.Tensor,
                               valid: torch.Tensor | None = None
                               ) -> torch.Tensor:
        """bool [B, N]: whether each world point [B, N, 3] lies in an
        active voxel."""
        return self.ijk_to_index(self.world_to_ijk(points), valid) >= 0

    def bbox_ijk(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(min_ijk, max_ijk) int32 [B, 3] over active voxels (inclusive)."""
        big = 1 << 20
        m = self.mask[..., None]
        mn = torch.where(m, self.ijk, big).amin(dim=1)
        mx = torch.where(m, self.ijk, -big).amax(dim=1)
        return mn.to(torch.int32), mx.to(torch.int32)


def as_vec3(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).expand(
        3).clone()


def make_grid(ijk: torch.Tensor, mask: torch.Tensor, voxel_size,
              origin) -> Grid:
    """Grid from already sorted, unique (ijk, mask); recomputes keys."""
    return Grid(ijk=ijk.to(torch.int32), mask=mask, keys=K.pack(ijk, mask),
                voxel_size=as_vec3(voxel_size, ijk.device),
                origin=as_vec3(origin, ijk.device))
