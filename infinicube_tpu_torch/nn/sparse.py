"""Sparse-voxel layers; counterpart of ``infinicube_tpu/nn/sparse.py``.

- ``SparseConv3d``: 3x3x3 submanifold conv with kernel [27, F_in, F_out] in
  ``neighbor_offsets`` tap order, the JAX parameter layout, computing in its
  ``dtype`` (the parameters stay f32), dispatched on its plan: on a
  ``ConvPlan`` K4 (and K4 again and K6 for its gradients) on the card, or
  their bf16 twins in bf16, the gather versions on the CPU; on a
  ``BrickPlan`` (``nn/brick.py``) the brick-dense products, which the
  reference computes with XLA and the port with plain ``torch``.
- ``GroupNormSparse``: masked per-sample statistics over active voxels, in
  f32, out in the input's dtype.
- ``SparseResBlock``: GroupNorm -> SiLU -> conv, twice, with a skip (a
  ``Dense`` in the block's dtype where the widths differ); on a
  ``BrickPlan`` the whole block stays brick-dense between its convs.
- ``sparse_attention``: masked per-sample self-attention over the active
  voxels. On the CPU the reference's einsum; on the card each sample's
  active rows, compacted, through ``ops/attention.multi_head_attention``
  (``flash_attn_f32`` / K2 and their backward kernels), never the
  [B, h, C, C] logits.
- ``conv_plan``: the plan of a grid for a ``conv_backend``.
Padding rows stay exactly zero through every layer."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch.grid.grid import Grid
from infinicube_tpu_torch.grid.ops import (dense_bounds_violations,
                                           neighbor_indexes)
from infinicube_tpu_torch.nn.brick import (BrickPlan, brick_conv_taps,
                                           build_brick_plan, from_bricks,
                                           halo_pad, to_bricks)
from infinicube_tpu_torch.nn.layers import Dense
from infinicube_tpu_torch.ops.attention import multi_head_attention
from infinicube_tpu_torch.ops.window_conv import (ConvPlan,
                                                  pack_sparse_weight,
                                                  window_sparse_conv)


class SparseConv3d(nn.Module):
    def __init__(self, in_features: int, features: int,
                 kernel_volume: int = 27, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            (kernel_volume, in_features, features), device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self._packed: tuple | None = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """U(-s, s) with s = 1/sqrt(27 * F_in), as the JAX module."""
        K, F_in = self.kernel.shape[:2]
        s = 1.0 / math.sqrt(K * F_in)
        with torch.no_grad():
            self.kernel.uniform_(-s, s, generator=generator)
            self.bias.zero_()

    def _packed_weight(self, dgrad: bool = False) -> torch.Tensor:
        """The card kernel's forward or input-gradient pack of the current
        kernel in the layer's dtype (``pack_sparse_weight``), cached against
        the kernel's address and version (an optimizer step or
        ``load_state_dict`` raises the version)."""
        w = self.kernel
        key = (w.data_ptr(), w._version, w.device, self.dtype)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, {})
        packs = self._packed[1]
        if dgrad not in packs:
            packs[dgrad] = pack_sparse_weight(w.detach().to(self.dtype),
                                              dgrad)
        return packs[dgrad]

    def forward(self, feats: torch.Tensor, plan,
                brick_resident: bool = False) -> torch.Tensor:
        """feats [B, C, F_in] (with ``brick_resident`` on a ``BrickPlan``
        already brick-dense, [B, NB*V, F_in], and so is the output, its
        empty slots zero)."""
        dt = self.dtype
        feats, w = feats.to(dt), self.kernel.to(dt)
        if isinstance(plan, BrickPlan):
            bricks = feats if brick_resident else to_bricks(plan, feats)
            out = brick_conv_taps(halo_pad(plan, bricks), w)
            if not brick_resident:
                return from_bricks(plan, out) + self.bias.to(dt)
            out = out + self.bias.to(dt)
            return torch.where(plan.dense_mask[..., None], out,
                               torch.zeros_like(out))
        if feats.is_cuda:
            need_dx = torch.is_grad_enabled() and feats.requires_grad
            out = window_sparse_conv(
                plan, feats, w, self._packed_weight(),
                self._packed_weight(dgrad=True) if need_dx else None)
        else:
            out = window_sparse_conv(plan, feats, w)
        return out + self.bias.to(dt)


class GroupNormSparse(nn.Module):
    """Masked GroupNorm over active voxels (per sample, per group), in f32;
    padding rows come out as 0."""

    def __init__(self, features: int, num_groups: int = 32,
                 epsilon: float = 1e-5, device=None):
        super().__init__()
        self.groups = math.gcd(min(num_groups, features), features)
        self.eps = epsilon
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, C, Fe = feats.shape
        g = self.groups
        x = feats.float().reshape(B, C, g, Fe // g)
        m = mask[:, :, None, None].float()
        n = (m.sum(dim=(1, 3), keepdim=True) * (Fe // g)).clamp_min(1.0)
        mean = (x * m).sum(dim=(1, 3), keepdim=True) / n
        var = ((x - mean).square() * m).sum(dim=(1, 3), keepdim=True) / n
        x = ((x - mean) * torch.rsqrt(var + self.eps)).reshape(B, C, Fe)
        out = x * self.weight + self.bias
        return torch.where(mask[..., None], out,
                           torch.zeros_like(out)).to(feats.dtype)


class SparseResBlock(nn.Module):
    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.GroupNormSparse_0 = GroupNormSparse(in_features, device=device)
        self.conv1 = SparseConv3d(in_features, features, dtype=dtype,
                                  device=device)
        self.GroupNormSparse_1 = GroupNormSparse(features, device=device)
        self.conv2 = SparseConv3d(features, features, dtype=dtype,
                                  device=device)
        self.skip = Dense(in_features, features, compute_dtype=dtype,
                          device=device) if in_features != features else None

    def forward(self, feats: torch.Tensor, plan,
                mask: torch.Tensor) -> torch.Tensor:
        if isinstance(plan, BrickPlan):
            # brick-resident: converted once, every op on the dense slots
            # with their occupancy as the mask (the same active set)
            dm = plan.dense_mask
            xb = to_bricks(plan, feats)
            h = F.silu(self.GroupNormSparse_0(xb, dm))
            h = self.conv1(h, plan, brick_resident=True)
            h = F.silu(self.GroupNormSparse_1(h, dm))
            h = self.conv2(h, plan, brick_resident=True)
            if self.skip is not None:
                xb = self.skip(xb)
            out = from_bricks(plan, xb + h)
            return torch.where(mask[..., None], out, torch.zeros_like(out))
        h = F.silu(self.GroupNormSparse_0(feats, mask))
        h = self.conv1(h, plan)
        h = F.silu(self.GroupNormSparse_1(h, mask))
        h = self.conv2(h, plan)
        if self.skip is not None:
            feats = self.skip(feats)
        out = feats + h
        return torch.where(mask[..., None], out, torch.zeros_like(out))


def _on_card(x: torch.Tensor) -> bool:
    """Whether x goes to the card's route (the tests route CPU tensors
    through it with the plain attention in the kernels' place)."""
    return x.is_cuda


def _attention_plain(q, k, v, mask, dtype):
    """The reference's einsum: f32 logits, -1e9 on masked keys, a softmax,
    the weights in ``dtype``."""
    logits = torch.einsum("bqhc,bkhc->bhqk", q, k).float() / \
        math.sqrt(q.shape[-1])
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full((), -1e9, device=q.device))
    attn = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhc->bqhc", attn, v.to(dtype))


def _attention_compacted(q, k, v, mask):
    """Each sample's active rows (in their order) through the card's
    attention, scattered back; masked rows and samples without an active
    row come out as zero and launch nothing. A masked key's weight in the
    einsum, exp(-1e9 - max), is exactly 0 in f32, so this is the same
    function."""
    out = q.new_zeros(q.shape)
    for b in range(q.shape[0]):
        rows = mask[b].nonzero()[:, 0]
        if rows.numel():
            sel = (t[b, rows][None] for t in (q, k, v))
            out = out.index_put((torch.full_like(rows, b), rows),
                                multi_head_attention(*sel)[0])
    return out


def sparse_attention(feats: torch.Tensor, mask: torch.Tensor,
                     num_heads: int, qkv, proj) -> torch.Tensor:
    """Masked per-sample full self-attention over the active voxels of
    feats [B, C, F]: ``qkv`` and ``proj`` are the caller's Dense layers;
    returns feats + proj(attention) on active rows, 0 elsewhere."""
    B, C, Fe = feats.shape
    q, k, v = qkv(feats).reshape(B, C, 3, num_heads,
                                 Fe // num_heads).unbind(2)
    if _on_card(feats):
        out = _attention_compacted(q, k, v, mask)
    else:
        if feats.device.type != "cpu":
            raise ValueError(f"unsupported device {feats.device}")
        out = _attention_plain(q, k, v, mask, feats.dtype)
    out = proj(out.reshape(B, C, Fe))
    return torch.where(mask[..., None], feats + out, torch.zeros_like(out))


BACKENDS = ("auto", "window", "gather", "brick")


def conv_plan(grid: Grid, dense_bounds=None, backend: str = "auto"):
    """The plan every SparseConv3d on ``grid`` shares, by ``backend`` (the
    reference's ``conv_backend`` values). ``"auto"``, ``"window"`` and
    ``"gather"`` compute the same function and give the ``ConvPlan``: the
    neighbour table (through the dense slot volume over
    ``dense_bounds=(ijk_min, dims)`` when given) and the dense-bounds
    violation count per batch element. ``"brick"`` gives the
    ``BrickPlan`` and raises where voxels were dropped past the brick
    capacity (their convs would read zeros and skew the masked GroupNorm
    statistics)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown conv backend {backend!r}, not one of "
                         f"{BACKENDS}")
    if backend == "brick":
        plan = build_brick_plan(grid)
        dropped = int(plan.num_dropped.max())
        if dropped:
            raise ValueError(
                f"brick plan dropped {dropped} voxels (brick-capacity "
                "overflow): convs on this plan would silently read zeros "
                "and skew masked GroupNorm stats; raise brick_capacity or "
                "use another conv backend")
        return plan
    nbr = neighbor_indexes(grid, 3, dense_bounds=dense_bounds)
    if dense_bounds is None:
        viol = torch.zeros((grid.batch_size,), dtype=torch.int32,
                           device=nbr.device)
    else:
        viol = dense_bounds_violations(grid, *dense_bounds)
    return ConvPlan(nbr=nbr.contiguous(), violations=viol)
