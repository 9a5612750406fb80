"""Train state, optimizer construction and the generic train step;
counterpart of ``infinicube_tpu/training/state.py``.

The step keeps the JAX step's semantics: clip-by-value, then AdamW (b1 0.9,
b2 0.999, eps 1e-8, decoupled weight decay) at a stepped exponential
learning rate floored at ``lr_clip``; a step whose gradients are not all
finite leaves the parameters, the Adam moments and Adam's count alone and
advances ``step``, ``num_nan_skips`` and the EMA's counter (not its shadow);
parameters whose name matches no ``trainable_substrings`` get no update.

PyTorch idiom inside: parameters are a dict of named leaf tensors updated in
place by ``torch.optim.AdamW`` (the state object is returned, not copied),
and the NaN guard reads one fused finiteness reduction back to the host and
skips ``optimizer.step()``, one host synchronisation per step where the JAX
step selects with ``jnp.where`` on the device. With a data-parallel group
the gradients are averaged over it right after the backward (the JAX step's
global-batch gradient, which XLA sums over the mesh), so every rank takes the
same NaN skip, clip, AdamW and EMA step."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from infinicube_tpu_torch.models.diffusion.ema import EmaState
from infinicube_tpu_torch.parallel.mesh import all_reduce_grads

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-5
    lr_decay_mult: float = 1.0          # per decay_step multiplicative decay
    lr_decay_step: int = 2_000_000_000  # effectively constant (release cfg)
    lr_clip: float = 1e-6
    weight_decay: float = 0.0
    grad_clip_value: float = 0.5        # clip-by-value
    ema_decay: float = 0.9999
    use_ema: bool = True
    # finetune only the parameters whose name contains one of these
    # substrings; None = train everything
    trainable_substrings: tuple | None = None


def learning_rate_at(cfg: TrainConfig, count: int) -> float:
    """The rate of the update after ``count`` applied updates."""
    lr = cfg.learning_rate * cfg.lr_decay_mult ** (count // cfg.lr_decay_step)
    return max(lr, cfg.lr_clip)


def trainable_names(cfg: TrainConfig, params: Params) -> list[str]:
    subs = cfg.trainable_substrings
    return [k for k in params if not subs or any(s in k for s in subs)]


def make_optimizer(cfg: TrainConfig, params: Params) -> torch.optim.AdamW:
    """AdamW over the trainable parameters (the others get no update); the
    step sets the learning rate and clips the gradients by value first."""
    return torch.optim.AdamW(
        [params[k] for k in trainable_names(cfg, params)],
        lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.weight_decay)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params                 # named leaf tensors, updated in place
    opt: torch.optim.AdamW
    ema: EmaState | None
    num_nan_skips: int
    trainable: list[str]           # names the optimizer updates, in order
    # the generator the steps draw from; its state is saved and restored
    # with the rest, so a resumed run draws what the uninterrupted one would
    generator: torch.Generator | None = None
    # this rank's index on the data axis: a data-parallel checkpoint holds
    # every data rank's generator state (``rng_states``) and each takes its own
    data_rank: int = 0

    @staticmethod
    def create(cfg: TrainConfig, params: Params,
               generator: torch.Generator | None = None) -> "TrainState":
        return TrainState(
            step=0, params=params, opt=make_optimizer(cfg, params),
            ema=EmaState.create(params) if cfg.use_ema else None,
            num_nan_skips=0, trainable=trainable_names(cfg, params),
            generator=generator)

    @property
    def opt_count(self) -> int:
        """Updates applied so far (Adam's count)."""
        return self.step - self.num_nan_skips

    def moments(self) -> tuple[Params, Params]:
        """Adam's first and second moments by parameter name (zeros before
        the first update)."""
        mu, nu = {}, {}
        for k in self.trainable:
            st = self.opt.state.get(self.params[k], {})
            mu[k] = st.get("exp_avg", torch.zeros_like(self.params[k]))
            nu[k] = st.get("exp_avg_sq", torch.zeros_like(self.params[k]))
        return mu, nu

    def state_dict(self) -> dict:
        mu, nu = self.moments()
        return {"step": self.step, "num_nan_skips": self.num_nan_skips,
                "params": dict(self.params), "mu": mu, "nu": nu,
                "ema": None if self.ema is None else
                {"params": dict(self.ema.params), "step": self.ema.step},
                "rng_state": None if self.generator is None else
                self.generator.get_state()}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy a ``state_dict`` into this state, in place."""
        for k, p in self.params.items():
            p.copy_(sd["params"][k])
        self.step, self.num_nan_skips = int(sd["step"]), \
            int(sd["num_nan_skips"])
        for k in self.trainable:
            p = self.params[k]
            self.opt.state[p] = {
                "step": torch.tensor(float(self.opt_count)),
                "exp_avg": sd["mu"][k].to(p.device, p.dtype).clone(),
                "exp_avg_sq": sd["nu"][k].to(p.device, p.dtype).clone()}
        if self.ema is not None and sd.get("ema") is not None:
            for k, e in self.ema.params.items():
                e.copy_(sd["ema"]["params"][k])
            self.ema.step = int(sd["ema"]["step"])
        rng = sd["rng_states"][self.data_rank] if sd.get("rng_states") \
            else sd.get("rng_state")
        if self.generator is not None and rng is not None:
            self.generator.set_state(rng.cpu())


def grads_finite(grads: list[torch.Tensor]) -> bool:
    """True when every element of every gradient is finite: the largest
    absolute value of each tensor, reduced on the device and read once."""
    if not grads:
        return True
    peaks = torch._foreach_norm(grads, float("inf"))
    return bool(torch.isfinite(torch.stack(peaks)).all())


def make_train_step(cfg: TrainConfig,
                    loss_fn: Callable[[Params, torch.Generator, object],
                                      tuple], group=None):
    """loss_fn(params, generator, batch) -> (loss, metrics). Returns
    step(state, generator, batch) -> (state, metrics) with ``loss``,
    ``grad_finite`` and the loss function's metrics (this rank's); ``state``
    is updated in place. ``group``: the data-parallel group the gradients
    are averaged over (None: no other rank)."""

    def step(state: TrainState, generator: torch.Generator | None, batch):
        params = state.params
        for p in params.values():
            p.grad = None
        loss, metrics = loss_fn(params, generator, batch)
        loss.backward()
        grads = [p.grad for p in params.values() if p.grad is not None]
        all_reduce_grads(grads, group)
        finite = grads_finite(grads)
        if finite:
            trained = [params[k] for k in state.trainable]
            torch.nn.utils.clip_grad_value_(trained, cfg.grad_clip_value)
            for pg in state.opt.param_groups:
                pg["lr"] = learning_rate_at(cfg, state.opt_count)
            state.opt.step()
        else:
            state.num_nan_skips += 1
        if state.ema is not None:
            state.ema.update(params, cfg.ema_decay, apply=finite)
        state.step += 1
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_finite"] = float(finite)
        return state, metrics

    return step
