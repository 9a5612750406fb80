"""Generic training loop: metrics, logging, validation, checkpoint cadence;
counterpart of ``infinicube_tpu/training/loop.py``.

The loop consumes an iterable of host batches and, on a mesh whose data
axis has more than one rank (``parallel/mesh.py``), is data-parallel as the
JAX loop is over its mesh: the parameters are broadcast from data rank 0 at
the start, each rank takes its rows of every batch (``shard_batch``, in
validation too), the gradients are averaged over the data group before the
NaN guard, and the metrics are the global mean. It runs the train step,
tracks running means with a NaN assertion, logs scalars, and saves
checkpoints every N steps with keep-last-k or top-k-on-metric retention;
only global rank 0 logs and writes, with a barrier around each write, and
every rank restores on resume. The random numbers of the steps come from
one ``torch.Generator`` per rank (seeded from the seed and the data rank,
``rank_seed``, so a 2-rank run draws other numbers than a 1-rank one) whose
states are saved with every checkpoint, so a resumed run continues as the
uninterrupted one would."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import torch
import torch.distributed as dist

from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.parallel.mesh import (all_reduce_mean,
                                                data_parallel_sharding,
                                                is_lead, make_mesh,
                                                map_tensors, rank_seed,
                                                shard_batch,
                                                shard_params_replicated)
from infinicube_tpu_torch.training.checkpoint import CheckpointManager
from infinicube_tpu_torch.training.state import (TrainConfig, TrainState,
                                                 make_train_step)


class LossMeter:
    """Weighted running means with a NaN assertion."""

    def __init__(self):
        self.sums: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def update(self, metrics: dict):
        for k, v in metrics.items():
            v = float(v)
            assert v == v, f"metric {k} is NaN"
            self.sums[k] = self.sums.get(k, 0.0) + v
            self.counts[k] = self.counts.get(k, 0) + 1

    def means(self) -> dict:
        return {k: self.sums[k] / self.counts[k] for k in self.sums}

    def reset(self):
        self.sums.clear()
        self.counts.clear()


@dataclasses.dataclass
class LoopConfig:
    max_steps: int = 1000
    log_every: int = 50
    val_every: int = 500
    val_batches: int = 4        # batches per default validation pass
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    ckpt_keep: int = 2
    ckpt_monitor: str | None = None   # e.g. "val_loss": top-k-on-metric
    ckpt_monitor_mode: str = "min"
    resume: bool = True


def move_batch(batch, device: torch.device):
    """Every tensor of a batch (tensors, tuples, lists or dicts of them, and
    dataclasses of tensors such as ``CondCubes``) to ``device``; anything
    else passes through."""
    return map_tensors(lambda t: t.to(device), batch)


def _scalars(metrics: dict) -> dict:
    return {k: v for k, v in metrics.items()
            if not isinstance(v, torch.Tensor) or v.dim() == 0}


def make_default_val_fn(loss_fn: Callable, val_data: Iterable,
                        num_batches: int, device: torch.device,
                        mesh=None) -> Callable:
    """Default validation: run ``loss_fn`` on held-out batches with the EMA
    parameters when present, each rank on its rows, the metrics the global
    mean. Returns mean metrics incl. ``val_loss``.

    ``val_data`` may be a re-iterable (list, Dataset) or a zero-arg factory
    returning a fresh iterator (plain generators exhaust after one pass)."""
    mesh = mesh or make_mesh(device=device)
    group = data_parallel_sharding(mesh).group

    @torch.no_grad()
    def val_fn(state, step):
        params = state.ema.params if getattr(state, "ema", None) is not None \
            else state.params
        meter = LossMeter()
        it = iter(val_data() if callable(val_data) else val_data)
        for i in range(num_batches):
            try:
                batch = next(it)
            except StopIteration:
                break
            gen = torch.Generator(device=device).manual_seed(
                rank_seed(i, mesh))
            loss, metrics = loss_fn(params, gen,
                                    shard_batch(mesh, batch, device))
            meter.update(all_reduce_mean(
                {"val_loss": loss, **_scalars(metrics)}, group, device))
        return meter.means()

    return val_fn


def train(loop_cfg: LoopConfig, train_cfg: TrainConfig, params: dict,
          loss_fn: Callable, batches: Iterable,
          generator: torch.Generator | None = None,
          logger: Callable[[int, dict], None] | None = None,
          val_fn: Callable | None = None, val_data: Iterable | None = None,
          device="cuda", mesh=None) -> TrainState:
    """loss_fn(params, generator, batch) -> (loss, metrics); ``params`` is a
    dict of named leaf tensors on ``device`` (the card unless the caller
    asks for the CPU), updated in place. ``mesh``: the ``make_mesh`` the
    run is data-parallel over (None: the one the process group gives, world
    1 without one); ``batches`` yields the global batch on every rank.

    If ``val_data`` is given without an explicit ``val_fn``, a default
    validation (EMA params, mean loss/metrics over held-out batches) runs
    every ``val_every`` steps; its metrics feed the checkpoint manager's
    top-k-on-metric retention when ``ckpt_monitor`` is set."""
    device = resolve_device(device)
    for name, p in params.items():
        if p.device.type != device.type:
            raise ValueError(f"parameter {name} is on {p.device}, the loop "
                             f"runs on {device}")
    mesh = mesh or make_mesh(device=device)
    sh = data_parallel_sharding(mesh)
    lead = is_lead()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            rank_seed(0, mesh))
    shard_params_replicated(mesh, params)
    state = TrainState.create(train_cfg, params, generator)
    state.data_rank = sh.rank
    if val_fn is None and val_data is not None:
        val_fn = make_default_val_fn(loss_fn, val_data,
                                     loop_cfg.val_batches, device, mesh)
    monitor = loop_cfg.ckpt_monitor
    if monitor and val_fn is None:
        # With a monitor but no validation metrics, save() would skip every
        # unranked periodic checkpoint and a crash would lose the whole run:
        # fall back to keep-last-k retention instead.
        if lead:
            print(f"[train] WARNING: ckpt_monitor={monitor!r} but no val_fn/"
                  "val_data produces metrics; falling back to keep-last-k "
                  "checkpoint retention")
        monitor = None
    mgr = CheckpointManager(loop_cfg.ckpt_dir, loop_cfg.ckpt_keep,
                            loop_cfg.ckpt_every, monitor=monitor,
                            mode=loop_cfg.ckpt_monitor_mode)
    if loop_cfg.resume and mgr.latest_step() is not None:
        mgr.restore(state)
        if lead:
            print(f"[train] resumed from step {state.step}")

    def save(step, force=False, metrics=None):
        # every rank asks the policy (the directory is the same for all
        # since the last barrier); rank 0 writes every data rank's generator
        if not mgr.due(step, force, metrics):
            return
        extra = None
        if sh.group is not None:
            states = [None] * sh.size
            dist.all_gather_object(states, generator.get_state(),
                                   group=sh.group)
            extra = {"rng_states": states}
        if dist.is_initialized():
            dist.barrier()
        if lead:
            mgr.save(step, state, force=force, metrics=metrics, extra=extra)
        if dist.is_initialized():
            dist.barrier()

    step_fn = make_train_step(train_cfg, loss_fn, sh.group)
    meter = LossMeter()
    t0 = time.perf_counter()
    it = iter(batches)
    step = state.step
    last_val = None
    while step < loop_cfg.max_steps:
        try:
            batch = next(it)
        except StopIteration:
            it = iter(batches)
            continue
        state, metrics = step_fn(state, generator,
                                 shard_batch(mesh, batch, device))
        step = state.step
        meter.update(all_reduce_mean(_scalars(metrics), sh.group, device))
        if step % loop_cfg.log_every == 0:
            means = meter.means()
            means["steps_per_sec"] = loop_cfg.log_every / \
                max(time.perf_counter() - t0, 1e-9)
            t0 = time.perf_counter()
            if logger and lead:
                logger(step, means)
            elif lead:
                print(f"[train] step {step}: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in means.items()))
            meter.reset()
        if val_fn is not None and step % loop_cfg.val_every == 0:
            val_metrics = val_fn(state, step) or {}
            last_val = val_metrics
            if logger and val_metrics and lead:
                logger(step, {f"val/{k}": v for k, v in val_metrics.items()})
            elif val_metrics and lead:
                print(f"[val] step {step}: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in val_metrics.items()))
        save(step, metrics=last_val)
    save(step, force=True)
    mgr.wait()
    return state
