"""Oriented-box helpers the port needs; counterpart of
``infinicube_tpu/utils/bbox.py`` (``points_in_obb``)."""

from __future__ import annotations

import torch


def points_in_obb(points: torch.Tensor, object_to_world: torch.Tensor,
                  lwh: torch.Tensor, enlarge: float = 1.0) -> torch.Tensor:
    """bool mask of points (..., N, 3) inside the oriented box(es)
    object_to_world (..., 4, 4) with sizes lwh (..., 3): points go into the
    object frame and are tested against |p| <= lwh / 2 * enlarge."""
    R = object_to_world[..., :3, :3]
    t = object_to_world[..., :3, 3]
    local = (points - t[..., None, :]) @ R   # R^T applied from the right
    half = lwh * 0.5 * enlarge
    return (local.abs() <= half[..., None, :]).all(dim=-1)
