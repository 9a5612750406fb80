"""Flow-matching (rectified flow) schedule and Euler sampler for the video
DiT; counterpart of ``infinicube_tpu/models/wan/flow_match.py``.

x_t = (1 - sigma) x0 + sigma eps, the model predicts v = eps - x0, and the
sigmas are warped by a shift factor."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    num_train_timesteps: int = 1000
    shift: float = 5.0

    def sigmas(self, num_steps: int, device=None) -> torch.Tensor:
        """Descending f32 sigmas in (0, 1], shifted; length num_steps + 1
        with a terminal 0."""
        s = torch.linspace(1.0, 1.0 / num_steps, num_steps,
                           dtype=torch.float32, device=device)
        s = self.shift * s / (1.0 + (self.shift - 1.0) * s)
        return torch.cat([s, s.new_zeros(1)])

    def timesteps(self, num_steps: int, device=None) -> torch.Tensor:
        return self.sigmas(num_steps, device)[:-1] * self.num_train_timesteps

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  sigma: torch.Tensor) -> torch.Tensor:
        """x_t = (1 - sigma) x0 + sigma noise, one sigma per batch row."""
        sigma = sigma.reshape((-1,) + (1,) * (x0.dim() - 1))
        return (1.0 - sigma) * x0 + sigma * noise

    def velocity_target(self, x0: torch.Tensor,
                        noise: torch.Tensor) -> torch.Tensor:
        return noise - x0


def euler_sample(schedule: FlowMatchSchedule,
                 model_fn: Callable[[torch.Tensor, torch.Tensor],
                                    torch.Tensor],
                 x_T: torch.Tensor, num_steps: int = 50) -> torch.Tensor:
    """model_fn(x, t[B]) -> velocity. Euler integration x <- x + (s' - s) v."""
    sig = schedule.sigmas(num_steps, x_T.device)
    ts = sig[:-1] * schedule.num_train_timesteps
    x = x_T
    for i in range(num_steps):
        v = model_fn(x, ts[i].expand(x.shape[0]))
        x = x + (sig[i + 1] - sig[i]) * v
    return x
