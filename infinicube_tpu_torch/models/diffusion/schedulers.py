"""Noise schedule, the training targets and the DDIM sampler; counterpart of
``infinicube_tpu/models/diffusion/schedulers.py`` (the release's linear
betas, v-prediction and deterministic DDIM). ``lax.scan`` becomes a Python
loop over the static timestep list; the schedule stays f32 as in JAX."""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    betas: torch.Tensor            # f32 [T]
    alphas_cumprod: torch.Tensor   # f32 [T]

    @staticmethod
    def linear(num_train_timesteps: int = 1000, beta_start: float = 1e-4,
               beta_end: float = 0.02, device=None) -> "NoiseSchedule":
        betas = torch.linspace(beta_start, beta_end, num_train_timesteps,
                               dtype=torch.float32, device=device)
        return NoiseSchedule(betas=betas,
                             alphas_cumprod=torch.cumprod(1.0 - betas, 0))

    @property
    def num_train_timesteps(self) -> int:
        return self.betas.shape[0]

    def _ab(self, t: torch.Tensor, ndim: int):
        a = self.alphas_cumprod[t]
        shape = (-1,) + (1,) * (ndim - 1)
        return a.sqrt().reshape(shape), (1.0 - a).sqrt().reshape(shape)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0). t int [B], per sample."""
        sa, sb = self._ab(t, x0.dim())
        return sa * x0 + sb * noise

    def v_target(self, x0: torch.Tensor, noise: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
        """v-prediction target: sqrt(a) * eps - sqrt(1 - a) * x0."""
        sa, sb = self._ab(t, x0.dim())
        return sa * noise - sb * x0

    def to_eps_x0(self, model_out: torch.Tensor, x_t: torch.Tensor,
                  t: torch.Tensor, prediction_type: str = "v_prediction"):
        """Model output -> (eps, x0) estimates. t int [B]."""
        sa, sb = self._ab(t, x_t.dim())
        if prediction_type == "v_prediction":
            return sa * model_out + sb * x_t, sa * x_t - sb * model_out
        if prediction_type == "epsilon":
            return model_out, (x_t - sb * model_out) / sa
        if prediction_type == "sample":
            return (x_t - sa * model_out) / sb, model_out
        raise ValueError(prediction_type)


def sampling_timesteps(num_train_timesteps: int, num_steps: int) -> np.ndarray:
    """Evenly spaced descending timesteps (diffusers leading spacing)."""
    step = num_train_timesteps // num_steps
    return (np.arange(num_steps) * step).round().astype(np.int64)[::-1].copy()


ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def ddim_sample(schedule: NoiseSchedule, model_fn: ModelFn,
                x_T: torch.Tensor, num_steps: int = 100,
                prediction_type: str = "v_prediction",
                step_callback=None) -> torch.Tensor:
    """Deterministic (eta = 0) DDIM. ``step_callback(x, t, i) -> x`` runs
    before each model call (the SDEdit injection point)."""
    ts = sampling_timesteps(schedule.num_train_timesteps, num_steps)
    ac = schedule.alphas_cumprod
    B = x_T.shape[0]
    x = x_T
    one = torch.ones((), dtype=torch.float32, device=ac.device)
    for i, t in enumerate(ts.tolist()):
        tp = int(ts[i + 1]) if i + 1 < len(ts) else -1
        if step_callback is not None:
            x = step_callback(x, t, i)
        tb = torch.full((B,), t, dtype=torch.int64, device=x.device)
        out = model_fn(x, tb)
        eps, x0 = schedule.to_eps_x0(out, x, tb, prediction_type)
        a_prev = ac[tp] if tp >= 0 else one
        x = a_prev.sqrt() * x0 + (1 - a_prev).clamp_min(0.0).sqrt() * eps
    return x
