"""Checkpointing with a retention policy and resume; counterpart of
``infinicube_tpu/training/checkpoint.py`` on ``torch.save`` /
``torch.load``. The port's checkpoints are its own format: one
``ckpt_{step}.pt`` per saved step holding ``TrainState.state_dict()``, and a
``metrics.json`` with the monitored metric of each saved step.

Retention: keep the last ``max_to_keep`` steps, or with ``monitor`` the
``max_to_keep`` best by that metric (``mode`` "min" or "max"); a save
without metrics is then skipped unless forced, and the latest forced save is
always kept. Saves are synchronous, so ``wait`` has nothing to wait for."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import torch


class CheckpointManager:
    def __init__(self, directory: str | Path, max_to_keep: int = 2,
                 save_interval_steps: int = 50,
                 monitor: str | None = None, mode: str = "min"):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.monitor, self.mode = monitor, mode
        self._interval = save_interval_steps
        self._metrics_path = self.directory / "metrics.json"

    def _path(self, step: int) -> Path:
        return self.directory / f"ckpt_{step}.pt"

    def all_steps(self) -> list[int]:
        return sorted(int(p.stem.split("_")[1])
                      for p in self.directory.glob("ckpt_*.pt"))

    def _read_metrics(self) -> dict[int, float]:
        if not self._metrics_path.exists():
            return {}
        return {int(k): v for k, v in
                json.loads(self._metrics_path.read_text()).items()}

    def due(self, step: int, force: bool = False,
            metrics: dict | None = None) -> bool:
        """Whether the policy saves at ``step``."""
        if step in self.all_steps():
            return False             # already saved (final save after loop)
        if not force and step % self._interval:
            return False
        if self.monitor is not None and metrics is None and not force:
            return False             # top-k-on-metric: unranked saves skipped
        return True

    def save(self, step: int, state: Any, force: bool = False,
             metrics: dict | None = None, extra: dict | None = None) -> bool:
        """Save ``state.state_dict()`` (with ``extra``'s entries) at ``step``
        when the policy asks for it. Returns whether it did."""
        if not self.due(step, force, metrics):
            return False
        tmp = self._path(step).with_suffix(".tmp")
        torch.save({**state.state_dict(), **(extra or {})}, tmp)
        tmp.replace(self._path(step))
        ranks = self._read_metrics()
        if self.monitor is not None and metrics and self.monitor in metrics:
            ranks[step] = float(metrics[self.monitor])
        self._prune(ranks, keep=step if force else None)
        return True

    def _prune(self, ranks: dict[int, float], keep: int | None) -> None:
        steps = self.all_steps()
        if self.monitor is None:
            kept = steps[-self.max_to_keep:]
        else:
            worst = float("inf") if self.mode == "min" else float("-inf")
            sign = 1.0 if self.mode == "min" else -1.0
            kept = sorted(steps, key=lambda s: (sign * ranks.get(s, worst),
                                                -s))[:self.max_to_keep]
        for s in steps:
            if s not in kept and s != keep:
                self._path(s).unlink()
                ranks.pop(s, None)
        self._metrics_path.write_text(json.dumps(ranks))

    def wait(self) -> None:
        """Saves are synchronous."""

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: Any = None, step: int | None = None) -> Any:
        """Load the checkpoint of ``step`` (default: the latest). With a
        ``TrainState`` the values are copied into it, on its device, and it
        is returned; without one the saved dict is returned."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        device = None if state is None else \
            next(iter(state.params.values())).device
        sd = torch.load(self._path(step), map_location=device,
                        weights_only=True)
        if state is None:
            return sd
        state.load_state_dict(sd)
        return state


def partial_restore(params: Any, loaded: Any) -> Any:
    """Merge loaded parameters into ``params`` (nested dicts of tensors),
    skipping missing keys and shape mismatches."""
    def merge(p, l):
        if isinstance(p, dict):
            return {k: merge(v, l.get(k, v)) if isinstance(l, dict) else v
                    for k, v in p.items()}
        if hasattr(l, "shape") and tuple(l.shape) == tuple(p.shape):
            return l
        return p
    return merge(params, loaded)
