"""Noise schedules, the training targets and the DDIM, DDPM and DPM-Solver++
(2M) samplers; counterpart of ``infinicube_tpu/models/diffusion/
schedulers.py`` (the release's linear betas, v-prediction). ``lax.scan``
becomes a Python loop over the static timestep list; the schedule stays f32
as in JAX. DDPM's per-step noise comes from a ``torch.Generator`` unless the
caller passes it in (the tests hand in the JAX sampler's draws)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

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

    @staticmethod
    def scaled_linear(num_train_timesteps: int = 1000,
                      beta_start: float = 0.00085, beta_end: float = 0.012,
                      device=None) -> "NoiseSchedule":
        """Stable-diffusion style schedule, linear in sqrt(beta)."""
        betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5,
                               num_train_timesteps, dtype=torch.float32,
                               device=device) ** 2
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


def ddpm_sample(schedule: NoiseSchedule, model_fn: ModelFn,
                x_T: torch.Tensor, num_steps: int | None = None,
                prediction_type: str = "v_prediction",
                step_callback=None,
                generator: torch.Generator | None = None,
                step_noise: Sequence[torch.Tensor] | None = None
                ) -> torch.Tensor:
    """Ancestral DDPM over the full or a strided schedule. Step i adds
    ``step_noise[i]`` (drawn from ``generator`` when not given) scaled by
    the posterior's standard deviation; the last step returns x0."""
    T = schedule.num_train_timesteps
    ts = sampling_timesteps(T, num_steps or T)
    ac = schedule.alphas_cumprod
    B = x_T.shape[0]
    x = x_T
    for i, t in enumerate(ts.tolist()):
        tp = int(ts[i + 1]) if i + 1 < len(ts) else -1
        if step_callback is not None:
            x = step_callback(x, t, i)
        tb = torch.full((B,), t, dtype=torch.int64, device=x.device)
        out = model_fn(x, tb)
        _, x0 = schedule.to_eps_x0(out, x, tb, prediction_type)
        if tp < 0:
            x = x0
            continue
        a_t, a_prev = ac[t], ac[tp]
        beta_eff = 1.0 - a_t / a_prev
        mean = a_prev.sqrt() * beta_eff / (1 - a_t) * x0 + \
            (a_t / a_prev).sqrt() * (1 - a_prev) / (1 - a_t) * x
        var = beta_eff * (1 - a_prev) / (1 - a_t)
        noise = step_noise[i].to(x.device, torch.float32) \
            if step_noise is not None else \
            torch.randn(x.shape, generator=generator, device=x.device)
        x = mean + var.clamp_min(0.0).sqrt() * noise
    return x


def karras_timesteps(schedule: NoiseSchedule, num_steps: int,
                     rho: float = 7.0) -> np.ndarray:
    """Karras et al.'s sigma spacing mapped back to the schedule's discrete
    timesteps (nearest sigma), unique and descending."""
    a = schedule.alphas_cumprod.cpu().numpy()
    sigmas = np.sqrt((1 - a) / a)
    s_min, s_max = sigmas[0], sigmas[-1]
    ramp = np.linspace(0, 1, num_steps)
    ks = (s_max ** (1 / rho) + ramp * (s_min ** (1 / rho) -
                                       s_max ** (1 / rho))) ** rho
    ts = np.array([int(np.abs(sigmas - s).argmin()) for s in ks[::-1]])
    return np.unique(ts)[::-1].copy()


def dpmpp_sample(schedule: NoiseSchedule, model_fn: ModelFn,
                 x_T: torch.Tensor, num_steps: int = 25,
                 prediction_type: str = "v_prediction", step_callback=None,
                 use_karras_sigmas: bool = False) -> torch.Tensor:
    """DPM-Solver++(2M) in log-SNR space, data prediction: first order on
    the first and the final step, second-order multistep in between. The
    final step (t = -1) targets alpha^2 = 1 - 1e-6."""
    ts = karras_timesteps(schedule, num_steps) if use_karras_sigmas else \
        sampling_timesteps(schedule.num_train_timesteps, num_steps)
    ac = schedule.alphas_cumprod
    B = x_T.shape[0]
    a_end = torch.tensor(1.0 - 1e-3 ** 2, dtype=torch.float32,
                         device=ac.device)

    def alpha(t):
        return ac[t] if t >= 0 else a_end

    def lam(t):  # half the log-SNR
        at = alpha(t)
        return 0.5 * torch.log(at / (1 - at))

    x, x0_prev, h_prev = x_T, None, None
    for i, t in enumerate(ts.tolist()):
        tp = int(ts[i + 1]) if i + 1 < len(ts) else -1
        if step_callback is not None:
            x = step_callback(x, t, i)
        tb = torch.full((B,), t, dtype=torch.int64, device=x.device)
        _, x0 = schedule.to_eps_x0(model_fn(x, tb), x, tb, prediction_type)
        h = lam(tp) - lam(t)
        al_p, sg_p = alpha(tp).sqrt(), (1 - alpha(tp)).sqrt()
        sg_t = (1 - alpha(t)).sqrt()
        x_new = (sg_p / sg_t) * x - al_p * torch.expm1(-h) * x0
        if x0_prev is not None and tp >= 0:
            r = h_prev / h.clamp_min(1e-12)
            d = (x0 - x0_prev) / r.clamp_min(1e-12) * 0.5
            x_new = x_new - al_p * torch.expm1(-h) * d
        x, x0_prev, h_prev = x_new, x0, h
    return x
