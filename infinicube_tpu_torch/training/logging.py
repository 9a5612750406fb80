"""Metric logging backends; counterpart of
``infinicube_tpu/training/logging.py``: JSONL always, TensorBoard and wandb
when installed."""

from __future__ import annotations

import json
import time
from pathlib import Path


class JsonlLogger:
    """Always-available structured logger (one JSON line per log call)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def __call__(self, step: int, metrics: dict):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()


def make_logger(kind: str, logdir: str, run_name: str = "run"):
    """kind in {none, jsonl, tb, wandb}; a backend that is not installed
    falls back to jsonl."""
    logdir = Path(logdir)
    if kind == "tb":
        try:
            from torch.utils.tensorboard import SummaryWriter
            w = SummaryWriter(str(logdir / run_name))

            def log(step, metrics):
                for k, v in metrics.items():
                    w.add_scalar(k, float(v), step)
            return log
        except Exception:
            kind = "jsonl"
    if kind == "wandb":
        try:
            import wandb
            wandb.init(project="infinicube-tpu", name=run_name,
                       dir=str(logdir), resume="allow")
            return lambda step, metrics: wandb.log(dict(metrics), step=step)
        except Exception:
            kind = "jsonl"
    if kind == "none":
        return lambda step, metrics: None
    return JsonlLogger(logdir / f"{run_name}.jsonl")
