"""Grid constructors; counterpart of ``infinicube_tpu/grid/build.py``: from
keys, points, the 8 voxels nearest each point, ijk and dense blocks, the
coarsened and subdivided grids, and the union of two grids.

Output capacity is fixed by the caller; overflow drops the HIGHEST keys, in
the JAX package's key order, and reports the count in ``Grid.num_dropped``.
"""

from __future__ import annotations

import itertools

import torch

from infinicube_tpu_torch.grid import keys as K
from infinicube_tpu_torch.grid.grid import Grid, as_vec3
from infinicube_tpu_torch.utils.casts import saturating_int32

# the 8 corners of the trilinear stencil, (0, 0, 0) to (1, 1, 1) row-major
CORNERS = tuple(itertools.product((0, 1), repeat=3))


def _unique_sorted_keys(qkeys: torch.Tensor, capacity: int):
    """Per-row sort + dedup into a fixed-capacity row.

    qkeys int64 [B, N] (invalid = INVALID_KEY) -> (int64 [B, capacity]
    ascending with INVALID_KEY padding, int32 [B] dropped count)."""
    B, N = qkeys.shape
    rk = torch.sort(qkeys, dim=1).values
    first = torch.ones_like(rk, dtype=torch.bool)
    first[:, 1:] = rk[:, 1:] != rk[:, :-1]
    first &= rk != K.INVALID_KEY
    pos = torch.cumsum(first, dim=1) - 1
    dst = torch.where(first & (pos < capacity), pos,
                      torch.full_like(pos, capacity))
    out = torch.full((B, capacity + 1), K.INVALID_KEY, dtype=torch.int64,
                     device=qkeys.device)
    out.scatter_(1, dst, rk)
    n_unique = first.sum(dim=1)
    return out[:, :capacity].contiguous(), \
        (n_unique - capacity).clamp_min(0).to(torch.int32)


def grid_from_keys(qkeys: torch.Tensor, capacity: int, voxel_size,
                   origin) -> Grid:
    """int64 [B, N] possibly duplicated keys -> deduplicated sorted Grid."""
    ukeys, dropped = _unique_sorted_keys(qkeys, capacity)
    mask = ukeys != K.INVALID_KEY
    ijk = torch.where(mask[..., None], K.unpack(ukeys),
                      torch.zeros((), dtype=torch.int32, device=ukeys.device))
    return Grid(ijk=ijk, mask=mask, keys=ukeys,
                voxel_size=as_vec3(voxel_size, qkeys.device),
                origin=as_vec3(origin, qkeys.device), num_dropped=dropped)


def grid_from_points(points: torch.Tensor, point_mask: torch.Tensor,
                     voxel_size, origin, capacity: int) -> Grid:
    """fvdb gridbatch_from_points: one voxel per occupied cell. points f32
    [B, N, 3]; point_mask bool [B, N]; ijk = round((p - origin) / vs) in
    f32, half to even."""
    vs, org = as_vec3(voxel_size, points.device), \
        as_vec3(origin, points.device)
    ijk = torch.round((points - org) / vs).to(torch.int32)
    return grid_from_keys(K.pack(ijk, point_mask), capacity, vs, org)


def grid_from_ijk(ijk: torch.Tensor, mask: torch.Tensor, voxel_size, origin,
                  capacity: int) -> Grid:
    """fvdb gridbatch_from_ijk. ijk int [B, N, 3], mask bool [B, N]."""
    return grid_from_keys(K.pack(ijk, mask), capacity, voxel_size, origin)


def grid_from_nearest_voxels_to_points(points: torch.Tensor,
                                       point_mask: torch.Tensor, voxel_size,
                                       origin, capacity: int) -> Grid:
    """fvdb gridbatch_from_nearest_voxels_to_points: the 8 voxels nearest
    to each point (the trilinear-splat stencil) are active."""
    vs, org = as_vec3(voxel_size, points.device), \
        as_vec3(origin, points.device)
    base = saturating_int32(torch.floor((points - org) / vs))
    corners = torch.tensor(CORNERS, dtype=torch.int32, device=points.device)
    ijk8 = base[:, :, None, :] + corners[None, None]        # [B, N, 8, 3]
    mask8 = point_mask[:, :, None].expand(ijk8.shape[:3])
    B = points.shape[0]
    return grid_from_keys(K.pack(ijk8, mask8).reshape(B, -1), capacity, vs,
                          org)


def dense_ijk(dense_dims, ijk_min, device=None) -> torch.Tensor:
    """int32 [D*H*W, 3] row-major coordinates of a dense block."""
    D, H, W = dense_dims
    ii, jj, kk = torch.meshgrid(torch.arange(D, device=device),
                                torch.arange(H, device=device),
                                torch.arange(W, device=device),
                                indexing="ij")
    ijk = torch.stack([ii, jj, kk], dim=-1).reshape(-1, 3)
    return (ijk + torch.as_tensor(ijk_min, device=device)).to(torch.int32)


def grid_from_dense(batch_size: int, dense_dims, ijk_min, voxel_size, origin,
                    occupancy: torch.Tensor | None = None,
                    capacity: int | None = None, device=None) -> Grid:
    """fvdb gridbatch_from_dense: the whole dense block active, or the
    voxels where ``occupancy`` (bool [B, D, H, W]) holds."""
    D, H, W = dense_dims
    n = D * H * W
    if occupancy is not None:
        device = occupancy.device
    ijk = dense_ijk(dense_dims, ijk_min, device)[None].expand(batch_size, n,
                                                              3)
    mask = torch.ones((batch_size, n), dtype=torch.bool, device=device) \
        if occupancy is None else occupancy.reshape(batch_size, n)
    return grid_from_ijk(ijk, mask, voxel_size, origin,
                         capacity=capacity or n)


def merge_grids(a: Grid, b: Grid, capacity: int | None = None) -> Grid:
    """Union of two grids with the same voxel_size and origin (overflow
    drops the highest keys)."""
    inv = torch.full_like(a.keys, K.INVALID_KEY)
    qkeys = torch.cat([torch.where(a.mask, a.keys, inv),
                       torch.where(b.mask, b.keys,
                                   torch.full_like(b.keys, K.INVALID_KEY))],
                      dim=1)
    return grid_from_keys(qkeys, capacity or (a.capacity + b.capacity),
                          a.voxel_size, a.origin)


def _factor3(factor) -> tuple[int, int, int]:
    fx, fy, fz = (int(f) for f in torch.as_tensor(factor).expand(3))
    return fx, fy, fz


def coarsened_grid(grid: Grid, factor, capacity: int | None = None) -> Grid:
    """fvdb coarsened_grid: parent ijk = floor(ijk / factor) (voxel
    coordinates go negative) at voxel_size * factor; the origin shifts by
    vs * (factor - 1) / 2 so that a parent's centre is the centre of its
    children."""
    f = torch.tensor(_factor3(factor), dtype=torch.int32,
                     device=grid.ijk.device)
    cijk = torch.div(grid.ijk, f, rounding_mode="floor")
    vs = grid.voxel_size * f.float()
    org = grid.origin + grid.voxel_size * (f.float() - 1.0) / 2.0
    return grid_from_keys(K.pack(cijk, grid.mask), capacity or grid.capacity,
                          vs, org)


def subdivided_grid(grid: Grid, factor, submask: torch.Tensor | None = None,
                    capacity: int | None = None) -> Grid:
    """Each (optionally masked) voxel spawns prod(factor) children."""
    fx, fy, fz = _factor3(factor)
    nch = fx * fy * fz
    capacity = capacity or grid.capacity * nch
    dev = grid.ijk.device
    offs = torch.tensor(list(itertools.product(range(fx), range(fy),
                                               range(fz))),
                        dtype=torch.int32, device=dev)
    f = torch.tensor((fx, fy, fz), dtype=torch.int32, device=dev)
    child = grid.ijk[:, :, None, :] * f + offs[None, None]   # [B, C, nch, 3]
    m = grid.mask if submask is None else (grid.mask & submask)
    cmask = m[:, :, None].expand(child.shape[:3])
    vs = grid.voxel_size / f.float()
    org = grid.origin - (grid.voxel_size - vs) / 2.0
    B = grid.batch_size
    return grid_from_keys(K.pack(child, cmask).reshape(B, -1), capacity, vs,
                          org)
