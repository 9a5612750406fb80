"""Sparse-voxel layers; counterpart of ``infinicube_tpu/nn/sparse.py`` for
the window/gather contract (the brick backend is not ported).

- ``SparseConv3d``: 3x3x3 submanifold conv with kernel [27, F_in, F_out] in
  ``neighbor_offsets`` tap order, the JAX parameter layout, on a
  ``ConvPlan``, computing in its ``dtype`` (the parameters stay f32); K4
  (and K4 again and K6 for its gradients) on the card, or their bf16 twins
  in bf16, the gather versions on the CPU.
- ``GroupNormSparse``: masked per-sample statistics over active voxels, in
  f32, out in the input's dtype.
- ``SparseResBlock``: GroupNorm -> SiLU -> conv, twice, with a skip (a
  ``Dense`` in the block's dtype where the widths differ).
Padding rows stay exactly zero through every layer."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch.grid.grid import Grid
from infinicube_tpu_torch.grid.ops import (dense_bounds_violations,
                                           neighbor_indexes)
from infinicube_tpu_torch.nn.layers import Dense
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

    def forward(self, feats: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
        dt = self.dtype
        feats, w = feats.to(dt), self.kernel.to(dt)
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

    def forward(self, feats: torch.Tensor, plan: ConvPlan,
                mask: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.GroupNormSparse_0(feats, mask))
        h = self.conv1(h, plan)
        h = F.silu(self.GroupNormSparse_1(h, mask))
        h = self.conv2(h, plan)
        if self.skip is not None:
            feats = self.skip(feats)
        out = feats + h
        return torch.where(mask[..., None], out, torch.zeros_like(out))


def conv_plan(grid: Grid, dense_bounds=None) -> ConvPlan:
    """The plan every SparseConv3d on ``grid`` shares: the neighbour table
    (through the dense slot volume over ``dense_bounds=(ijk_min, dims)``
    when given) and the dense-bounds violation count per batch element."""
    nbr = neighbor_indexes(grid, 3, dense_bounds=dense_bounds)
    if dense_bounds is None:
        viol = torch.zeros((grid.batch_size,), dtype=torch.int32,
                           device=nbr.device)
    else:
        viol = dense_bounds_violations(grid, *dense_bounds)
    return ConvPlan(nbr=nbr.contiguous(), violations=viol)
