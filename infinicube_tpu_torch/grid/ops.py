"""Data-carrying grid ops; counterpart of ``infinicube_tpu/grid/ops.py`` for
what the structure decoder and the sparse convs use: dense <-> sparse
gathers and scatters, same-position index maps, the 3x3x3 neighbour table
and nearest upsampling onto a subdivided grid. Parent indices are floor
divisions, since voxel coordinates go negative."""

from __future__ import annotations

import itertools

import numpy as np
import torch

from infinicube_tpu_torch.grid import keys as K
from infinicube_tpu_torch.grid.build import subdivided_grid
from infinicube_tpu_torch.grid.grid import Grid


def _flat_in_bounds(ijk: torch.Tensor, valid: torch.Tensor, ijk_min,
                    dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-major flat index of ijk - ijk_min in a dims box, and whether it
    lies inside (and is valid)."""
    X, Y, Z = (int(d) for d in dims)
    rel = ijk.long() - torch.as_tensor(ijk_min, dtype=torch.int64,
                                       device=ijk.device)
    hi = torch.tensor((X, Y, Z), dtype=torch.int64, device=ijk.device)
    ok = valid & ((rel >= 0) & (rel < hi)).all(dim=-1)
    flat = (rel[..., 0] * Y + rel[..., 1]) * Z + rel[..., 2]
    return torch.where(ok, flat, torch.full_like(flat, X * Y * Z)), ok


def to_dense(grid: Grid, data: torch.Tensor, ijk_min,
             dense_dims) -> torch.Tensor:
    """Scatter sparse data [B, C, F] into a dense block [B, D, H, W, F];
    voxels outside the block are dropped."""
    D, H, W = dense_dims
    flat, _ = _flat_in_bounds(grid.ijk, grid.mask, ijk_min, dense_dims)
    B, F = grid.batch_size, data.shape[-1]
    out = torch.zeros((B, D * H * W + 1, F), dtype=data.dtype,
                      device=data.device)
    out.scatter_(1, flat[..., None].expand(-1, -1, F), data)
    return out[:, :-1].reshape(B, D, H, W, F)


def read_from_dense(grid: Grid, dense: torch.Tensor,
                    ijk_min) -> torch.Tensor:
    """Gather dense [B, D, H, W, F] at the grid's voxels -> [B, C, F]
    (zeros for padding and out-of-block voxels)."""
    B, D, H, W, F = dense.shape
    flat, ok = _flat_in_bounds(grid.ijk, grid.mask, ijk_min, (D, H, W))
    flat = torch.where(ok, flat, torch.zeros_like(flat))
    out = torch.gather(dense.reshape(B, D * H * W, F), 1,
                       flat[..., None].expand(-1, -1, F))
    return torch.where(ok[..., None], out, torch.zeros_like(out))


def index_map(dst: Grid, src: Grid) -> torch.Tensor:
    """int32 [B, C_dst] index into src rows of the same-position voxels
    (equal voxel_size/origin assumed); -1 where missing."""
    return src.key_to_index(torch.where(
        dst.mask, dst.keys, torch.full_like(dst.keys, K.INVALID_KEY)))


def neighbor_offsets(kernel_size=3) -> np.ndarray:
    """int32 [K, 3] kernel tap offsets, row-major over the window, centred."""
    ks = np.broadcast_to(np.asarray(kernel_size), (3,))
    r = [range(-(k // 2), k - k // 2) for k in ks]
    return np.asarray(list(itertools.product(*r)), np.int32)


def neighbor_indexes(grid: Grid, kernel_size=3,
                     dense_bounds=None) -> torch.Tensor:
    """int32 [B, C, K] slot index of each kernel-tap neighbour (-1 = absent).

    Without ``dense_bounds`` each tap is a binary search over the sorted
    keys; with ``dense_bounds=(ijk_min, dims)`` the lookup goes through a
    dense slot volume over the declared crop: one scatter and one gather.
    Active voxels outside the bounds make that lookup wrong;
    ``dense_bounds_violations`` counts them and the sparse conv NaN-poisons
    their batch element."""
    offs = torch.as_tensor(neighbor_offsets(kernel_size),
                           device=grid.ijk.device)
    nijk = grid.ijk[:, :, None, :] + offs[None, None]        # [B, C, K, 3]
    B, C, Kn = nijk.shape[:3]
    valid = grid.mask[:, :, None].expand(B, C, Kn)
    if dense_bounds is None:
        idx = grid.ijk_to_index(nijk.reshape(B, -1, 3), valid.reshape(B, -1))
        return idx.reshape(B, C, Kn)
    ijk_min, dims = dense_bounds
    n = int(np.prod(dims))
    flat, _ = _flat_in_bounds(grid.ijk, grid.mask, ijk_min, dims)
    vol = torch.full((B, n + 1), -1, dtype=torch.int32,
                     device=grid.ijk.device)
    slot = torch.arange(C, dtype=torch.int32,
                        device=grid.ijk.device).expand(B, C)
    # padding and out-of-bounds voxels land in the dump cell, which invalid
    # queries also read: reset it to -1 after the scatter
    vol.scatter_(1, flat, slot)
    vol[:, n] = -1
    nflat, _ = _flat_in_bounds(nijk, valid, ijk_min, dims)
    return torch.gather(vol, 1, nflat.reshape(B, -1)).reshape(B, C, Kn)


def dense_bounds_violations(grid: Grid, ijk_min, dims) -> torch.Tensor:
    """int32 [B]: active voxels outside the declared dense bounds."""
    _, ok = _flat_in_bounds(grid.ijk, grid.mask, ijk_min, dims)
    return (grid.mask & ~ok).sum(dim=-1).to(torch.int32)


def upsample_nearest(grid: Grid, data: torch.Tensor, factor,
                     fine: Grid | None = None,
                     submask: torch.Tensor | None = None,
                     capacity: int | None = None):
    """Children copy their parent's features. Without ``fine`` the children
    grid is ``subdivided_grid(grid, factor, submask, capacity)``. Returns
    (fine grid, fine data [B, C_fine, F])."""
    f3 = tuple(int(x) for x in np.broadcast_to(np.asarray(factor), (3,)))
    if fine is None:
        fine = subdivided_grid(grid, f3, submask=submask,
                               capacity=capacity or grid.capacity *
                               int(np.prod(f3)))
    f = torch.tensor(f3, dtype=torch.int32, device=fine.ijk.device)
    pidx = grid.ijk_to_index(torch.div(fine.ijk, f, rounding_mode="floor"),
                             fine.mask).long()
    F = data.shape[-1]
    got = torch.gather(data, 1, pidx.clamp_min(0)[..., None].expand(
        -1, -1, F))
    ok = (pidx >= 0) & fine.mask
    return fine, torch.where(ok[..., None], got, torch.zeros_like(got))
