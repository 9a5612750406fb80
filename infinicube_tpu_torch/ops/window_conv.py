"""Sparse submanifold 3x3x3 convolution on voxel rows: kernel K4 on the
card, the plain gather version on the CPU.

Counterpart of ``window_sparse_conv`` in ``infinicube_tpu/ops/window_conv.py``
(forward). There a window plan (directional windows, one-hot selection
matmuls and a miss list replayed by an exact fallback) works around the
TPU's slow gathers. Here the plan is the neighbour table itself: ``ConvPlan``
holds ``int32 [B, C, 27]`` slot indices from ``grid.ops.neighbor_indexes``
(built on the card over the declared dense bounds) and the per-batch count of
active voxels outside those bounds. K4 (``sparse_conv_f32``,
csrc/sparse_conv.cu) gathers the neighbour rows itself, so nothing is missed
and there is no fallback.

The loud policy stays: a batch element whose active voxels fall outside the
declared dense bounds (its lookup would be wrong) gets NaN in every row, as
an overflowed window plan does in JAX."""

from __future__ import annotations

import dataclasses

import torch

from infinicube_tpu_torch import kernels


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Per-grid sparse-conv plan (build once per grid, reuse per conv)."""
    nbr: torch.Tensor         # int32 [B, C, 27] slot of each tap, -1 absent
    violations: torch.Tensor  # int32 [B] active voxels outside dense bounds

    @property
    def overflowed(self) -> torch.Tensor:
        """bool [B]: True where the lookup is inexact (NaN-poisoned conv)."""
        return self.violations > 0


def gather_neighbor_features(feats: torch.Tensor, nbr: torch.Tensor,
                             tap: int) -> torch.Tensor:
    """feats [B, C, F], nbr int32 [B, C, K] -> tap features [B, C, F]
    (zeros where the neighbour is absent)."""
    idx = nbr[:, :, tap].long()
    got = torch.gather(feats, 1, idx.clamp_min(0)[..., None].expand(
        -1, -1, feats.shape[-1]))
    return torch.where((idx >= 0)[..., None], got, torch.zeros_like(got))


def sparse_conv_plain(plan: ConvPlan, feats: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """The reference's gather-GEMM: 27 row gathers and matmuls."""
    out = torch.zeros(feats.shape[:2] + (w.shape[-1],), dtype=feats.dtype,
                      device=feats.device)
    for t in range(w.shape[0]):
        out = out + gather_neighbor_features(feats, plan.nbr, t) @ w[t]
    return torch.where(plan.overflowed[:, None, None],
                       torch.full_like(out, float("nan")), out)


def window_sparse_conv(plan: ConvPlan, feats: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """Sparse submanifold 3^3 conv: feats [B, C, F], w [27, F, Fo]
    (``neighbor_offsets`` tap order, SparseConv3d's kernel layout) ->
    [B, C, Fo]. Rows of a batch element with dense-bounds violations are NaN.
    On the card feats and w must be f32."""
    if feats.is_cuda:
        return kernels.sparse_conv_f32(
            feats.contiguous(), plan.nbr.contiguous(), w.contiguous(),
            plan.violations.to(torch.int32).contiguous())
    if feats.device.type != "cpu":
        raise ValueError(f"unsupported device {feats.device}")
    return sparse_conv_plain(plan, feats, w)
