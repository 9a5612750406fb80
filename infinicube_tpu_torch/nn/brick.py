"""Brick-dense sparse convolution; counterpart of
``infinicube_tpu/nn/brick.py``.

The active voxels are partitioned into fixed bricks (4x4x4 by default):
``build_brick_plan`` keys each brick by ``ijk // brick_shape`` and carries
the voxel <-> dense-slot maps and a 27-neighbour brick table, once per
grid. ``to_bricks`` / ``from_bricks`` move voxel rows to the bricks' dense
slots and back, ``halo_pad`` adds each brick's one-voxel halo from its 26
neighbours, and the 27-tap conv runs on the padded bricks as static slices
and matrix products (``brick_conv_taps``) or as a VALID 3-D convolution
(``brick_conv_xla``). Empty slots inside an occupied brick carry zeros, so
the result on active voxels is the submanifold conv's. A brick past
``brick_capacity`` loses its voxels, counted in ``num_dropped``
(``nn.sparse.conv_plan(..., backend="brick")`` raises on them).

The reference computes these products with XLA, outside any Pallas kernel,
so the port's are plain ``torch`` products on every device."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from infinicube_tpu_torch.grid import keys as K
from infinicube_tpu_torch.grid.build import _unique_sorted_keys
from infinicube_tpu_torch.grid.grid import Grid
from infinicube_tpu_torch.grid.ops import neighbor_offsets


@dataclasses.dataclass(frozen=True)
class BrickPlan:
    """The brick decomposition of a Grid (see the module docstring)."""
    brick_keys: torch.Tensor   # int64 [B, NB] sorted brick keys
    brick_mask: torch.Tensor   # bool [B, NB]
    dense_src: torch.Tensor    # int32 [B, NB*V] voxel row per slot (-1)
    voxel_dst: torch.Tensor    # int32 [B, C] slot per voxel row (-1)
    nbr_brick: torch.Tensor    # int32 [B, NB, 27] neighbour brick (-1)
    num_dropped: torch.Tensor  # int32 [B] voxels lost to brick overflow
    brick_shape: tuple = (4, 4, 4)

    @property
    def dense_mask(self) -> torch.Tensor:
        """bool [B, NB*V]: which dense slots hold a real voxel."""
        return self.dense_src >= 0


def _row_searchsorted(sorted_keys: torch.Tensor, queries: torch.Tensor,
                      qvalid: torch.Tensor) -> torch.Tensor:
    """Slot of each query key [B, N] in its row of sorted_keys [B, NB], -1
    where absent or invalid."""
    NB = sorted_keys.shape[1]
    pos = torch.searchsorted(sorted_keys, queries.contiguous()).clamp(
        0, NB - 1)
    hit = torch.gather(sorted_keys, 1, pos) == queries
    ok = hit & qvalid & (queries != K.INVALID_KEY)
    return torch.where(ok, pos, torch.full_like(pos, -1)).to(torch.int32)


def build_brick_plan(grid: Grid, brick_shape: tuple = (4, 4, 4),
                     brick_capacity: int | None = None) -> BrickPlan:
    """The brick decomposition of ``grid``: at most ``brick_capacity``
    bricks per batch element (default max(8, C // 8), at least 8 active
    voxels a brick on average); voxels of bricks past it are dropped and
    counted."""
    dev = grid.ijk.device
    bs = torch.tensor(brick_shape, dtype=torch.int32, device=dev)
    V = int(np.prod(brick_shape))
    B, C = grid.mask.shape
    NB = brick_capacity or max(8, C // 8)

    bijk = torch.div(grid.ijk, bs, rounding_mode="floor")
    bq = K.pack(bijk, grid.mask)
    ukeys, _ = _unique_sorted_keys(bq, NB)
    bmask = ukeys != K.INVALID_KEY

    # voxel -> dense slot
    slot = _row_searchsorted(ukeys, bq, grid.mask)
    local = grid.ijk - bijk * bs
    lf = (local[..., 0] * brick_shape[1] + local[..., 1]) * brick_shape[2] \
        + local[..., 2]
    voxel_dst = torch.where((slot >= 0) & grid.mask, slot * V + lf,
                            torch.full_like(slot, -1)).to(torch.int32)
    num_dropped = (grid.mask & (slot < 0)).sum(dim=-1).to(torch.int32)

    # dense slot -> voxel (slots are unique by construction)
    rows = torch.arange(C, dtype=torch.int32, device=dev).expand(B, C)
    dst = torch.where(voxel_dst >= 0, voxel_dst,
                      torch.full_like(voxel_dst, NB * V)).long()
    dense_src = torch.full((B, NB * V + 1), -1, dtype=torch.int32,
                           device=dev)
    dense_src.scatter_(1, dst, rows)
    dense_src = dense_src[:, :-1].contiguous()

    # 27-neighbour brick table, in neighbor_offsets(3)'s tap order
    offs = torch.as_tensor(neighbor_offsets(3), device=dev)
    b_of_bricks = torch.where(bmask[..., None], K.unpack(ukeys),
                              torch.zeros((), dtype=torch.int32, device=dev))
    nijk = b_of_bricks[:, :, None, :] + offs[None, None]     # [B, NB, 27, 3]
    nq = K.pack(nijk, bmask[:, :, None].expand(nijk.shape[:3]))
    nbr = _row_searchsorted(ukeys, nq.reshape(B, -1),
                            torch.ones((B, NB * 27), dtype=torch.bool,
                                       device=dev)).reshape(B, NB, 27)
    return BrickPlan(brick_keys=ukeys, brick_mask=bmask, dense_src=dense_src,
                     voxel_dst=voxel_dst, nbr_brick=nbr,
                     num_dropped=num_dropped, brick_shape=tuple(brick_shape))


def _take_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data [B, N, F] at rows idx [B, M] (-1 -> zeros)."""
    got = torch.gather(data, 1, idx.long().clamp_min(0)[..., None].expand(
        -1, -1, data.shape[-1]))
    return torch.where((idx >= 0)[..., None], got, torch.zeros_like(got))


def to_bricks(plan: BrickPlan, feats: torch.Tensor) -> torch.Tensor:
    """[B, C, F] voxel rows -> [B, NB*V, F] brick-dense (zeros at the empty
    slots)."""
    return _take_rows(feats, plan.dense_src)


def from_bricks(plan: BrickPlan, bricks: torch.Tensor) -> torch.Tensor:
    """[B, NB*V, F] brick-dense -> [B, C, F] voxel rows (zeros where the
    voxel's brick overflowed)."""
    return _take_rows(bricks, plan.voxel_dst)


def _src(d: int, n: int) -> slice:
    """The slab of a neighbour brick that borders along an axis."""
    return {1: slice(0, 1), -1: slice(n - 1, n), 0: slice(0, n)}[d]


def _dst(d: int, n: int) -> slice:
    """Where that slab lands in the padded brick."""
    return {1: slice(n + 1, n + 2), -1: slice(0, 1), 0: slice(1, n + 1)}[d]


def halo_pad(plan: BrickPlan, bricks: torch.Tensor) -> torch.Tensor:
    """[B, NB*V, F] -> [B, NB, b0+2, b1+2, b2+2, F] with one-voxel halos
    from the 26 neighbour bricks (zeros where a neighbour is absent)."""
    b0, b1, b2 = plan.brick_shape
    B, NB = plan.brick_mask.shape
    Fe = bricks.shape[-1]
    x5 = bricks.reshape(B, NB, b0, b1, b2, Fe)
    padded = bricks.new_zeros((B, NB, b0 + 2, b1 + 2, b2 + 2, Fe))
    padded[:, :, 1:-1, 1:-1, 1:-1] = x5
    for t, (di, dj, dk) in enumerate(neighbor_offsets(3).tolist()):
        if di == dj == dk == 0:
            continue
        nb = plan.nbr_brick[:, :, t].long()                   # [B, NB]
        slab = x5[:, :, _src(di, b0), _src(dj, b1), _src(dk, b2)]
        got = torch.gather(slab, 1, nb.clamp_min(0).view(
            B, NB, 1, 1, 1, 1).expand((B, NB) + slab.shape[2:]))
        got = torch.where((nb >= 0).view(B, NB, 1, 1, 1, 1), got,
                          torch.zeros_like(got))
        padded[:, :, _dst(di, b0), _dst(dj, b1), _dst(dk, b2)] = got
    return padded


def brick_conv_taps(padded: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 27-tap conv as static slices and matrix products: padded
    [B, NB, b0+2, b1+2, b2+2, F_in], w [27, F_in, F_out] in
    neighbor_offsets(3) tap order -> [B, NB*V, F_out]."""
    B, NB, p0, p1, p2, Fin = padded.shape
    b0, b1, b2 = p0 - 2, p1 - 2, p2 - 2
    out = None
    for t, (di, dj, dk) in enumerate(neighbor_offsets(3).tolist()):
        tap = padded[:, :, 1 + di:1 + di + b0, 1 + dj:1 + dj + b1,
                     1 + dk:1 + dk + b2].reshape(B, NB * b0 * b1 * b2, Fin)
        contrib = torch.matmul(tap, w[t])
        out = contrib if out is None else out + contrib
    return out


def brick_conv_xla(padded: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same contraction as one VALID 3-D convolution."""
    B, NB, p0, p1, p2, Fin = padded.shape
    Fout = w.shape[-1]
    x = padded.reshape(B * NB, p0, p1, p2, Fin).permute(0, 4, 1, 2, 3)
    kern = w.reshape(3, 3, 3, Fin, Fout).permute(4, 3, 0, 1, 2)
    y = F.conv3d(x, kern)
    return y.permute(0, 2, 3, 4, 1).reshape(B, -1, Fout)

