"""Segment reductions; counterpart of ``infinicube_tpu/ops/segment.py``.

``values [N, ...]`` reduced into ``num_segments`` rows by ``idx int [N]``;
a negative index drops its row. Sums go through ``index_add_`` and maxima
through ``scatter_reduce``, on the caller's device."""

from __future__ import annotations

import torch


def segment_sum(values: torch.Tensor, idx: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values [N, F], idx int [N] (negative = drop) -> [num_segments, F]."""
    keep = idx >= 0
    out = torch.zeros((num_segments,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, idx[keep].long(), values[keep])


def segment_mean(values: torch.Tensor, idx: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    s = segment_sum(values, idx, num_segments)
    cnt = segment_sum(torch.ones((values.shape[0], 1), dtype=torch.float32,
                                 device=values.device), idx, num_segments)
    return s / cnt.clamp_min(1.0)


def segment_max(values: torch.Tensor, idx: torch.Tensor, num_segments: int,
                fill=0.0) -> torch.Tensor:
    """Per-segment maximum in f32, ``fill`` where a segment has no row (or
    only infinite ones), cast back to the values' dtype."""
    safe = torch.where(idx >= 0, idx.long(), num_segments)
    safe = safe.reshape((-1,) + (1,) * (values.dim() - 1)).expand(
        values.shape)
    keep = (idx >= 0).reshape((-1,) + (1,) * (values.dim() - 1))
    vals = torch.where(keep, values.float(),
                       torch.tensor(-torch.inf, device=values.device))
    out = torch.full((num_segments + 1,) + values.shape[1:], -torch.inf,
                     dtype=torch.float32, device=values.device)
    out = out.scatter_reduce(0, safe, vals, "amax")[:num_segments]
    return torch.where(torch.isfinite(out), out,
                       torch.tensor(float(fill), device=values.device)
                       ).to(values.dtype)
