"""SDEdit overlap consistency for chunked world generation; counterpart of
``infinicube_tpu/models/diffusion/sdedit.py``.

The previous chunk's latents are resampled (nearest) into the current
chunk's cube once; at every sampler step the overlap entries are overwritten
by those latents re-noised to the step's timestep. The per-step noise comes
from ``noise_fn(i, shape)``: a ``torch.Generator`` by default, or numbers a
caller injects (the tests hand in the JAX package's)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from infinicube_tpu_torch.models.diffusion.schedulers import NoiseSchedule


@dataclasses.dataclass(frozen=True)
class SDEditState:
    warped_latents: torch.Tensor  # f32 [B, D, H, W, C]
    overlap_mask: torch.Tensor    # bool [B, D, H, W]


def warp_prev_latents(prev_latents: torch.Tensor, prev_valid: torch.Tensor,
                      rel_transform: torch.Tensor, ijk_min, voxel_size,
                      origin) -> SDEditState:
    """Resample previous-chunk latents [B, D, H, W, C] into the current
    chunk's cube; rel_transform f32 [4, 4] maps the CURRENT chunk frame to
    the PREVIOUS one."""
    B, D, H, W, C = prev_latents.shape
    dev = prev_latents.device
    ii, jj, kk = torch.meshgrid(torch.arange(D, device=dev),
                                torch.arange(H, device=dev),
                                torch.arange(W, device=dev), indexing="ij")
    ijk = torch.stack([ii, jj, kk], -1).float() + \
        torch.tensor(ijk_min, dtype=torch.float32, device=dev)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    org = torch.tensor(origin, dtype=torch.float32, device=dev)
    rel = rel_transform.to(device=dev, dtype=torch.float32)
    cur_world = ijk * vs + org
    prev_world = cur_world @ rel[:3, :3].T + rel[:3, 3]
    prev_ijk = torch.round((prev_world - org) / vs).to(torch.int64) - \
        torch.tensor(ijk_min, dtype=torch.int64, device=dev)
    hi = torch.tensor((D, H, W), device=dev)
    ok = ((prev_ijk >= 0) & (prev_ijk < hi)).all(dim=-1)
    pi = prev_ijk[..., 0].clamp(0, D - 1)
    pj = prev_ijk[..., 1].clamp(0, H - 1)
    pk = prev_ijk[..., 2].clamp(0, W - 1)
    warped = prev_latents[:, pi, pj, pk, :]
    mask = ok[None] & prev_valid[:, pi, pj, pk]
    return SDEditState(
        warped_latents=torch.where(mask[..., None], warped,
                                   torch.zeros_like(warped)),
        overlap_mask=mask)


def make_sdedit_callback(state: SDEditState, schedule: NoiseSchedule,
                         noise_fn: Callable[[int, tuple], torch.Tensor]):
    """step_callback(x, t, i) for the samplers: overlap entries become the
    previous latents re-noised to timestep t with ``noise_fn(i, x.shape)``."""
    def callback(x, t, i):
        noise = noise_fn(i, tuple(x.shape)).to(device=x.device,
                                                 dtype=x.dtype)
        a = schedule.alphas_cumprod[t]
        noised = a.sqrt() * state.warped_latents + (1 - a).sqrt() * noise
        return torch.where(state.overlap_mask[..., None], noised, x)
    return callback
