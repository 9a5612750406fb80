"""Float -> int32 casts as XLA makes them.

XLA's cast saturates: values past int32's range go to its ends and NaN goes
to 0. torch's cast gives INT32_MIN for all of them (``torch.tensor([5e9,
nan, inf]).to(torch.int32)``), so a far voxel's quantized depth, clipped
afterwards, would come out 0 instead of the top of the range. Every such
cast in the port clamps in float first."""

from __future__ import annotations

import torch

# the largest float32 below 2^31: int32's top end as far as float32 holds it
_TOP = 2147483520.0


def saturating_int32(x: torch.Tensor) -> torch.Tensor:
    """x (float) truncated toward zero to int32, NaN -> 0 and values past
    the range clamped to its ends, as XLA's cast: a float at or above 2^31
    gives 2^31 - 1 (it is clamped to the largest float32 below 2^31 for
    the cast, then put at the top)."""
    x = torch.nan_to_num(x, nan=0.0)
    out = x.clamp(-2147483648.0, _TOP).to(torch.int32)
    return torch.where(x > _TOP, torch.full_like(out, 2147483647), out)
