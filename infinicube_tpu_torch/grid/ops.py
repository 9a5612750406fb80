"""Data-carrying grid ops; counterpart of ``infinicube_tpu/grid/ops.py``:
dense <-> sparse gathers and scatters, same-position index maps, filling
one grid from another through world space, trilinear splats and samples,
the 3x3x3 neighbour table, point -> voxel reductions, max and average
pooling into a coarser grid and nearest upsampling onto a subdivided grid.
Parent indices are floor divisions, since voxel coordinates go negative."""

from __future__ import annotations

import itertools

import numpy as np
import torch

from infinicube_tpu_torch.grid import keys as K
from infinicube_tpu_torch.grid.build import (CORNERS, coarsened_grid,
                                             subdivided_grid)
from infinicube_tpu_torch.grid.grid import Grid
from infinicube_tpu_torch.utils.casts import saturating_int32


# Masked-max sentinel. Finite, so that no arithmetic on an empty row makes a
# NaN; large enough that no feature value reaches it.
_NEG_SENTINEL = -7.0e37


class _ScatterMaxSafe(torch.autograd.Function):
    """Masked scatter-max with a NaN-safe backward (the reference's
    ``_scatter_max_safe``). ``flat`` int64 [B, N] target rows (== C drops
    the entry); ``vals`` f32 [B, N, F], sentinel-filled on masked rows.
    Returns f32 [B, C, F]; empty rows hold the sentinel. The backward sends
    each row's gradient to the entries that attain the maximum, split evenly
    among ties with a guarded division, and nothing to the others."""

    @staticmethod
    def forward(ctx, flat, vals, C):
        B, _, F = vals.shape
        idx = flat[..., None].expand(-1, -1, F)
        out = torch.full((B, C + 1, F), _NEG_SENTINEL, dtype=vals.dtype,
                         device=vals.device)
        out.scatter_reduce_(1, idx, vals, "amax", include_self=True)
        out = out[:, :C].contiguous()
        ctx.save_for_backward(flat, vals, out)
        return out

    @staticmethod
    def backward(ctx, g):
        flat, vals, out = ctx.saved_tensors
        C, F = out.shape[1], out.shape[2]
        safe = flat.clamp(0, C - 1)[..., None].expand(-1, -1, F)
        hit = (vals == torch.gather(out, 1, safe)) & (flat < C)[..., None]
        ties = torch.zeros((out.shape[0], C + 1, F), dtype=vals.dtype,
                           device=vals.device)
        ties.scatter_add_(1, flat[..., None].expand(-1, -1, F),
                          hit.to(vals.dtype))
        share = torch.gather(g, 1, safe) / \
            torch.gather(ties, 1, safe).clamp_min(1.0)
        return None, torch.where(hit, share, torch.zeros_like(share)), None


def _masked_max(flat: torch.Tensor, ok: torch.Tensor, data: torch.Tensor,
                C: int) -> torch.Tensor:
    """Max of data [B, N, F] over the entries (ok) that target each of C
    rows, in f32; 0 for rows that no entry targets."""
    vals = torch.where(ok[..., None], data.float(),
                       torch.full((), _NEG_SENTINEL, device=data.device))
    out = _ScatterMaxSafe.apply(flat, vals, C)
    return torch.where(out > _NEG_SENTINEL / 2, out, torch.zeros_like(out))


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


def occupancy_dense(grid: Grid, ijk_min, dense_dims) -> torch.Tensor:
    """bool [B, D, H, W] occupancy block."""
    occ = to_dense(grid, grid.mask[..., None].to(torch.int32), ijk_min,
                   dense_dims)
    return occ[..., 0] > 0


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


def _gather_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data [B, C, F] at rows idx [B, N] (-1 -> 0) -> [B, N, F]."""
    idx = idx.long()
    got = torch.gather(data, 1, idx.clamp_min(0)[..., None].expand(
        -1, -1, data.shape[-1]))
    return torch.where((idx >= 0)[..., None], got, torch.zeros_like(got))


def fill_from_grid(dst: Grid, src: Grid, src_data: torch.Tensor
                   ) -> torch.Tensor:
    """fvnn.FillFromGrid: each dst voxel takes the data of the src voxel
    whose cell holds the dst voxel's centre (0 where none), through world
    space, so the two grids may differ in voxel size and origin."""
    idx = src.ijk_to_index(src.world_to_ijk(dst.voxel_centers()), dst.mask)
    return _gather_rows(src_data, idx)


def _trilinear_stencil(grid: Grid, points: torch.Tensor,
                       point_mask: torch.Tensor):
    """The 8 voxels around each point [B, N, 3]: their slots int32
    [B, N, 8] (-1 absent) and trilinear weights [B, N, 8]."""
    gc = grid.world_to_grid(points)
    base = saturating_int32(torch.floor(gc))
    frac = gc - base
    corners = torch.tensor(CORNERS, dtype=torch.int32, device=points.device)
    ijk8 = base[:, :, None, :] + corners[None, None]          # [B, N, 8, 3]
    w = torch.where(corners[None, None].bool(), frac[:, :, None, :],
                    1.0 - frac[:, :, None, :]).prod(dim=-1)
    B = grid.batch_size
    idx = grid.ijk_to_index(ijk8.reshape(B, -1, 3),
                            point_mask.repeat_interleave(8, dim=-1))
    return idx.reshape(ijk8.shape[:3]), w


def splat_trilinear(grid: Grid, points: torch.Tensor,
                    point_feats: torch.Tensor,
                    point_mask: torch.Tensor) -> torch.Tensor:
    """fvdb splat_trilinear: point features [B, N, F] added to the 8
    nearest voxel centres with trilinear weights -> [B, C, F]."""
    idx, w = _trilinear_stencil(grid, points, point_mask)
    w = torch.where((idx >= 0) & point_mask[:, :, None], w,
                    torch.zeros_like(w))
    B, F = grid.batch_size, point_feats.shape[-1]
    contrib = (w[..., None] * point_feats[:, :, None, :]).reshape(B, -1, F)
    flat = torch.where(idx >= 0, idx, grid.capacity).reshape(B, -1).long()
    return _scatter_sum(flat, contrib.to(point_feats.dtype), grid.capacity)


def sample_trilinear(grid: Grid, data: torch.Tensor, points: torch.Tensor,
                     point_mask: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of voxel data [B, C, F] at world points
    -> [B, N, F]; absent neighbours contribute 0 (fvdb
    sample_trilinear)."""
    idx, w = _trilinear_stencil(grid, points, point_mask)
    B, N = idx.shape[:2]
    got = _gather_rows(data, idx.reshape(B, -1)).reshape(B, N, 8, -1)
    w = torch.where(idx >= 0, w, torch.zeros_like(w))
    return (w[..., None] * got).sum(dim=2)


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


def _scatter_sum(flat: torch.Tensor, values: torch.Tensor,
                 C: int) -> torch.Tensor:
    """Sum of values [B, N, F] into C rows by flat [B, N] (== C drops)."""
    out = torch.zeros((values.shape[0], C + 1, values.shape[-1]),
                      dtype=values.dtype, device=values.device)
    out = out.scatter_add(1, flat[..., None].expand(-1, -1,
                                                    values.shape[-1]), values)
    return out[:, :C]


def scatter_to_grid(grid: Grid, points: torch.Tensor, values: torch.Tensor,
                    point_mask: torch.Tensor,
                    reduce: str = "sum") -> torch.Tensor:
    """Reduce per-point values [B, N, F] into the voxel containing each
    point -> [B, C, F]; reduce in {sum, max, mean}."""
    idx = grid.ijk_to_index(grid.world_to_ijk(points), point_mask).long()
    ok = (idx >= 0) & point_mask
    C = grid.capacity
    flat = torch.where(ok, idx, torch.full_like(idx, C))
    if reduce in ("sum", "mean"):
        out = _scatter_sum(flat, torch.where(ok[..., None], values,
                                             torch.zeros_like(values)), C)
        if reduce == "mean":
            cnt = _scatter_sum(flat, ok[..., None].float(), C)
            out = out / cnt.clamp_min(1.0)
        return out
    if reduce == "max":
        return _masked_max(flat, ok, values, C).to(values.dtype)
    raise ValueError(f"unknown reduce {reduce}")


def majority_label(grid: Grid, points: torch.Tensor, labels: torch.Tensor,
                   point_mask: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-voxel argmax over one-hot label counts: labels int [B, N] ->
    int32 [B, C]. Among tied classes the first wins, on every device (the
    counts are whole numbers, so their sums are exact)."""
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes).float()
    votes = scatter_to_grid(grid, points, onehot, point_mask, reduce="sum")
    best = votes == votes.amax(dim=-1, keepdim=True)
    cls = torch.arange(num_classes, device=votes.device)
    return torch.where(best, cls, torch.full_like(cls, num_classes)).amin(
        dim=-1).to(torch.int32)


def max_pool(grid: Grid, data: torch.Tensor, factor,
             coarse: Grid | None = None, capacity: int | None = None):
    """fvnn.MaxPool: coarsen the grid and max child data [B, C, F] into the
    parents. Returns (coarse grid, coarse data). With ``coarse`` (the hash
    tree's next level) it pools into that grid instead of deriving one.
    Differentiable in data: the gradient goes to each parent's maximal
    children, split evenly among ties, and is finite everywhere."""
    f3 = tuple(int(x) for x in np.broadcast_to(np.asarray(factor), (3,)))
    if coarse is None:
        coarse = coarsened_grid(grid, f3, capacity=capacity or grid.capacity)
    f = torch.tensor(f3, dtype=torch.int32, device=grid.ijk.device)
    pidx = coarse.ijk_to_index(torch.div(grid.ijk, f, rounding_mode="floor"),
                               grid.mask).long()
    ok = (pidx >= 0) & grid.mask
    flat = torch.where(ok, pidx, torch.full_like(pidx, coarse.capacity))
    out = _masked_max(flat, ok, data, coarse.capacity).to(data.dtype)
    return coarse, torch.where(coarse.mask[..., None], out,
                               torch.zeros_like(out))


def avg_pool(grid: Grid, data: torch.Tensor, factor,
             coarse: Grid | None = None, capacity: int | None = None):
    """fvnn.AvgPool: coarsen the grid and average child data [B, C, F] over
    each parent's present children, in f32, returned in data's dtype.
    Returns (coarse grid, coarse data)."""
    f3 = tuple(int(x) for x in np.broadcast_to(np.asarray(factor), (3,)))
    if coarse is None:
        coarse = coarsened_grid(grid, f3, capacity=capacity or grid.capacity)
    f = torch.tensor(f3, dtype=torch.int32, device=grid.ijk.device)
    pidx = coarse.ijk_to_index(torch.div(grid.ijk, f, rounding_mode="floor"),
                               grid.mask).long()
    ok = (pidx >= 0) & grid.mask
    Cc = coarse.capacity
    flat = torch.where(ok, pidx, torch.full_like(pidx, Cc))
    vals = torch.where(ok[..., None], data.float(),
                       torch.zeros((), device=data.device))
    total = _scatter_sum(flat, vals, Cc)
    cnt = _scatter_sum(flat, ok[..., None].float(), Cc)
    out = (total / cnt.clamp_min(1.0)).to(data.dtype)
    return coarse, torch.where(coarse.mask[..., None], out,
                               torch.zeros_like(out))
