"""Packed spatial keys for the sparse voxel grid; counterpart of
``infinicube_tpu/grid/keys.py``.

The same 11/11/10-bit layout: ijk is offset so i, j in [-1024, 1024) and
k in [-512, 512) pack into ``(i << 21) | (j << 10) | k``. The port keeps the
keys in int64 (torch has no uint32 arithmetic on every device) with the same
numeric values, so sorted-key order is the JAX package's order, and
``INVALID_KEY`` = 2^32 - 1 sorts after every valid key as it does there.
"""

from __future__ import annotations

import torch

I_BITS, J_BITS, K_BITS = 11, 11, 10
I_OFF, J_OFF, K_OFF = 1 << (I_BITS - 1), 1 << (J_BITS - 1), 1 << (K_BITS - 1)
INVALID_KEY = (1 << 32) - 1

IJK_MIN = (-I_OFF, -J_OFF, -K_OFF)
IJK_MAX = (I_OFF - 1, J_OFF - 1, K_OFF - 1)


def in_domain(ijk: torch.Tensor) -> torch.Tensor:
    """Whether each ijk (..., 3) fits the static packing domain."""
    lo = torch.tensor(IJK_MIN, dtype=ijk.dtype, device=ijk.device)
    hi = torch.tensor(IJK_MAX, dtype=ijk.dtype, device=ijk.device)
    return ((ijk >= lo) & (ijk <= hi)).all(dim=-1)


def pack(ijk: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Pack ijk (..., 3) -> int64 keys; invalid or out-of-domain entries get
    INVALID_KEY."""
    ijk = ijk.long()
    ok = in_domain(ijk)
    if valid is not None:
        ok = ok & valid
    key = ((ijk[..., 0] + I_OFF) << (J_BITS + K_BITS)) | \
        ((ijk[..., 1] + J_OFF) << K_BITS) | (ijk[..., 2] + K_OFF)
    return torch.where(ok, key, torch.full_like(key, INVALID_KEY))


def unpack(keys: torch.Tensor) -> torch.Tensor:
    """int64 keys (...,) -> ijk (..., 3) int32. INVALID_KEY unpacks
    arbitrarily; callers consult the validity mask."""
    keys = keys.long()
    i = (keys >> (J_BITS + K_BITS)) - I_OFF
    j = ((keys >> K_BITS) & ((1 << J_BITS) - 1)) - J_OFF
    k = (keys & ((1 << K_BITS) - 1)) - K_OFF
    return torch.stack([i, j, k], dim=-1).to(torch.int32)
