"""Exponential moving average of a set of named parameters; counterpart of
``infinicube_tpu/models/diffusion/ema.py``: decay 0.9999 with the warm-up
decay ``min(decay, (1 + step) / (10 + step))``. The shadow is updated in
place (the JAX version returns a new tree)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class EmaState:
    params: dict[str, torch.Tensor]   # the shadow, detached clones
    step: int = 0

    @staticmethod
    def create(params: dict[str, torch.Tensor]) -> "EmaState":
        return EmaState({k: v.detach().clone() for k, v in params.items()})

    @staticmethod
    def decay_at(step: int, decay: float) -> float:
        """The decay of the update that brings the counter to ``step``."""
        return min(decay, (1.0 + step) / (10.0 + step))

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor],
               decay: float = 0.9999, apply: bool = True) -> "EmaState":
        """shadow = shadow * d + (1 - d) * params, and the counter advances.
        With ``apply=False`` only the counter advances (a skipped step)."""
        self.step += 1
        if apply:
            d = self.decay_at(self.step, decay)
            shadow = list(self.params.values())
            torch._foreach_mul_(shadow, d)
            torch._foreach_add_(shadow, [params[k].detach()
                                         for k in self.params], alpha=1.0 - d)
        return self
