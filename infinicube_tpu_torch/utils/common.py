"""Small shared helpers; counterpart of ``infinicube_tpu/utils/common.py``:
model-from-config construction, ``batch2device`` and
``mask_image_patches`` (the GSM pixel branch's depth patch-dropout)."""

from __future__ import annotations

import torch

from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.training.loop import move_batch


def create_model_from_config(cfg, device="cuda"):
    """(params, loss_fn) of the trainer that the ``model:`` key of ``cfg``
    names (``train.BUILDERS``), built on ``device`` (the card unless the
    caller asks for the CPU). Checkpoints load through
    ``training.checkpoint.CheckpointManager`` / ``partial_restore``."""
    from infinicube_tpu_torch.train import BUILDERS
    kind = cfg.get_path("model", "diffusion")
    params, loss_fn, _ = BUILDERS[kind](cfg, resolve_device(device))
    return params, loss_fn


def batch2device(batch, device="cuda"):
    """Every tensor of a host batch (tensors, tuples, lists and dicts of
    them, dataclasses of tensors) on ``device``."""
    return move_batch(batch, resolve_device(device))


def mask_image_patches(image: torch.Tensor, patch: int = 32,
                       drop_prob: float = 0.5,
                       generator: torch.Generator | None = None,
                       draws: torch.Tensor | None = None) -> torch.Tensor:
    """image [..., H, W, C] with random patch x patch squares zeroed, each
    with probability ``drop_prob``. The uniform draws [..., ceil(H/patch),
    ceil(W/patch)] come from ``generator`` or are given as ``draws``."""
    h, w = image.shape[-3:-1]
    shape = image.shape[:-3] + (-(-h // patch), -(-w // patch))
    if draws is None:
        draws = torch.rand(shape, generator=generator, device=image.device)
    if tuple(draws.shape) != tuple(shape):
        raise ValueError(f"draws of shape {tuple(draws.shape)}, the patches "
                         f"are {tuple(shape)}")
    keep = draws.to(image.device) >= drop_prob
    keep = keep.repeat_interleave(patch, -1).repeat_interleave(patch, -2)
    return image * keep[..., :h, :w, None]
