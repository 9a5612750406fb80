"""Vectorized voxel DDA raycasting; counterpart of
``infinicube_tpu/ops/raycast.py``.

The voxel world is densified into a crop-box occupancy block (bool
[D, H, W]) and rays march it with an Amanatides-Woo DDA, vectorized over
rays. Every consumer needs only the first hit per ray, so the op returns
the first-hit cell and its entry and exit distances.

Cell convention as the grid's: voxel ijk spans grid coords
[ijk - 0.5, ijk + 0.5), i.e. cell = floor((p - origin)/vs + 0.5).

The reference marches in a ``lax.while_loop`` that exits once no ray is
alive. Here the loop is a Python loop of tensor steps; dead rays do not
change state, so testing for live rays only every ``_SYNC_EVERY`` steps
(each test is a host sync on the card) gives the same result."""

from __future__ import annotations

from typing import NamedTuple

import torch

from infinicube_tpu_torch.grid.grid import Grid
from infinicube_tpu_torch.grid.ops import occupancy_dense, to_dense
from infinicube_tpu_torch.utils.casts import saturating_int32

# DDA steps between two tests for live rays
_SYNC_EVERY = 16


class RayHit(NamedTuple):
    hit: torch.Tensor      # bool [N]
    t_entry: torch.Tensor  # f32  [N] distance (units of |ray_d|) at entry
    t_exit: torch.Tensor   # f32  [N]
    ijk: torch.Tensor      # int32 [N, 3] world voxel coordinate of the hit


def manhattan_distance_transform(occ: torch.Tensor,
                                 max_dist: int = 255) -> torch.Tensor:
    """Exact L1 distance-to-occupied transform, uint8 [D, H, W].

    Separable: per axis a forward and a backward min-plus pass,
    d'_i = min_{j <= i} (d_j + i - j) = i + cummin(d_j - j), exact in
    integers (the reference's log-depth ``associative_scan`` of the same
    operator)."""
    d = torch.where(occ, 0, 1 << 14).to(torch.int32)
    for axis in range(3):
        n = d.shape[axis]
        shape = [1, 1, 1]
        shape[axis] = n
        idx = torch.arange(n, dtype=torch.int32, device=d.device).reshape(
            shape)
        for rev in (False, True):
            arr = torch.flip(d, (axis,)) if rev else d
            m = torch.cummin(arr - idx, dim=axis).values + idx
            d = torch.flip(m, (axis,)) if rev else m
    return d.clamp_max(max_dist).to(torch.uint8)


def _vec3(v, device) -> torch.Tensor:
    """A voxel size, origin or ijk_min as f32 [3] or per-ray [N, 3]."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    return t.expand(3) if t.dim() <= 1 else t


def dda_first_hit(occ: torch.Tensor, ray_o: torch.Tensor,
                  ray_d: torch.Tensor, voxel_size, origin, ijk_min,
                  max_steps: int | None = None, t_far: float = 1e9,
                  skip_dist: torch.Tensor | None = None) -> RayHit:
    """March rays through a dense occupancy block; return the first occupied
    cell.

    occ bool [D, H, W]: occupancy of the crop [ijk_min, ijk_min + dims).
    ray_o / ray_d f32 [N, 3] world-space. t is measured in units of |ray_d|
    (pass normalized directions for Euclidean distance). voxel_size and
    origin are scalars, [3] or per-ray [N, 3] (several objects' rays in one
    march); ijk_min is [3].

    skip_dist: optional uint8 [D, H, W] Manhattan distance-to-occupied
    (``manhattan_distance_transform``). With it, rays in empty space jump
    ``(dist-1)`` L1 cells per iteration instead of stepping one boundary.
    The loop ends after ``max_steps`` steps or once no ray is alive."""
    dev = ray_o.device
    D, H, W = occ.shape
    dims_i = torch.tensor([D, H, W], dtype=torch.int32, device=dev)
    dims = dims_i.float()
    if max_steps is None:
        max_steps = D + H + W + 3
    vs = _vec3(voxel_size, dev)
    org = _vec3(origin, dev)
    imn = torch.as_tensor(ijk_min, dtype=torch.int32, device=dev)

    # ray in cell units: cell c spans [c, c+1)
    o = (ray_o - org) / vs + 0.5 - imn.float()                 # [N, 3]
    d = ray_d / vs
    eps = 1e-9
    d_safe = torch.where(d.abs() < eps,
                         torch.where(d < 0, -eps, eps).to(d.dtype), d)
    inv_d = 1.0 / d_safe

    # slab clip to [0, dims]
    tt0 = (0.0 - o) * inv_d
    tt1 = (dims - o) * inv_d
    t_lo = torch.minimum(tt0, tt1)
    t_hi = torch.maximum(tt0, tt1)
    t_enter = t_lo.amax(dim=-1).clamp_min(0.0)                # [N]
    t_leave = t_hi.amin(dim=-1).clamp_max(t_far)
    alive = t_enter < t_leave

    start = o + d * (t_enter[:, None] + 1e-5)
    cell = torch.minimum(saturating_int32(torch.floor(start)).clamp_min(0),
                         dims_i - 1)
    step = torch.where(d >= 0, 1, -1).to(torch.int32)
    pos_step = (step > 0).float()
    t_delta = inv_d.abs()
    l1_speed = d.abs().sum(dim=-1)                            # cells per t

    def t_max_of(c):
        return (c.float() + pos_step - o) * inv_d

    occ_flat = occ.reshape(-1)
    sd_flat = skip_dist.reshape(-1) if skip_dist is not None else None
    n = ray_o.shape[0]
    t_max = t_max_of(cell)
    t_cur = t_enter
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    hit_cell = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    axes = torch.arange(3, device=dev)

    for it in range(max_steps):
        if it % _SYNC_EVERY == 0 and not bool(alive.any()):
            break
        in_box = ((cell >= 0) & (cell < dims_i)).all(dim=-1)
        flat = ((cell[:, 0] * H + cell[:, 1]) * W + cell[:, 2]).clamp(
            0, D * H * W - 1).long()
        new_hit = alive & occ_flat[flat] & in_box & ~hit
        hit = hit | new_hit
        hit_cell = torch.where(new_hit[:, None], cell, hit_cell)
        adv = alive & ~hit

        # standard DDA step (argmin takes the first minimal axis)
        onehot = (t_max.argmin(dim=-1)[:, None] == axes).to(torch.int32)
        t_next = t_max.amin(dim=-1)
        cell_new = cell + onehot * step
        t_max_new = t_max + onehot.float() * t_delta
        t_cur_new = t_next

        if sd_flat is not None:
            # empty-space skip: jump (dist-1) L1 cells parametrically
            sdist = sd_flat[flat].float()
            can_jump = adv & (sdist >= 2.0) & in_box
            t_jump = t_cur + (sdist - 1.0) / l1_speed.clamp_min(1e-9)
            pos_j = o + d * (t_jump[:, None] + 1e-5)
            cell_j = saturating_int32(torch.floor(pos_j))
            cell_new = torch.where(can_jump[:, None], cell_j, cell_new)
            t_max_new = torch.where(can_jump[:, None], t_max_of(cell_new),
                                    t_max_new)
            t_cur_new = torch.where(can_jump, t_jump, t_cur_new)

        cell = torch.where(adv[:, None], cell_new, cell)
        t_max = torch.where(adv[:, None], t_max_new, t_max)
        t_cur = torch.where(adv, t_cur_new, t_cur)
        alive = adv & (t_cur < t_leave) & \
            ((cell >= 0) & (cell < dims_i)).all(dim=-1)

    lo_b = hit_cell.float() + (step < 0).float()
    hi_b = hit_cell.float() + pos_step
    t_entry = ((lo_b - o) * inv_d).amax(dim=-1).clamp_min(0.0)
    t_exit = torch.minimum(((hi_b - o) * inv_d).amin(dim=-1), t_leave)
    zero = torch.zeros_like(t_entry)
    return RayHit(hit=hit, t_entry=torch.where(hit, t_entry, zero),
                  t_exit=torch.where(hit, t_exit, zero), ijk=hit_cell + imn)


def raycast_grid(grid: Grid, batch_idx: int, ray_o: torch.Tensor,
                 ray_d: torch.Tensor, ijk_min, dense_dims,
                 attributes: dict[str, torch.Tensor] | None = None,
                 max_steps: int | None = None):
    """First-hit raycast against one batch element of a sparse Grid.

    Densifies the crop [ijk_min, ijk_min + dense_dims) and marches it.
    Returns (RayHit, attrs) where attrs maps each attribute name to its
    value at the hit voxel (0 where missed); attribute values are [C, F]
    slot-aligned."""
    sub = Grid(ijk=grid.ijk[batch_idx:batch_idx + 1],
               mask=grid.mask[batch_idx:batch_idx + 1],
               keys=grid.keys[batch_idx:batch_idx + 1],
               voxel_size=grid.voxel_size, origin=grid.origin)
    occ = occupancy_dense(sub, ijk_min, dense_dims)[0]
    hitres = dda_first_hit(occ, ray_o, ray_d, grid.voxel_size, grid.origin,
                           ijk_min, max_steps=max_steps)
    attrs = {}
    if attributes:
        idx = sub.ijk_to_index(hitres.ijk[None], hitres.hit[None])[0].long()
        for name, val in attributes.items():
            got = val[idx.clamp_min(0)]
            ok = (idx >= 0)[:, None] if got.dim() > 1 else idx >= 0
            attrs[name] = torch.where(ok, got, torch.zeros_like(got))
    return hitres, attrs


def dense_attribute_lookup(grid: Grid, data: torch.Tensor, ijk_min,
                           dense_dims) -> torch.Tensor:
    """A dense attribute block, built once for repeated per-frame raycasts."""
    return to_dense(grid, data, ijk_min, dense_dims)
