"""Run and checkpoint reference resolution; counterpart of
``infinicube_tpu/utils/run_resolve.py``.

A plain path resolves to itself; ``tb:<folder>`` to the latest checkpoint
under a log folder; ``wdb:entity/project/run[:version]`` to a downloaded
wandb model artifact, where the ``wandb`` package is installed (it raises,
naming it, where not)."""

from __future__ import annotations

from pathlib import Path


def resolve_checkpoint(ref: str) -> Path:
    """A checkpoint reference -> a local file or directory. Under ``tb:``
    the candidates are the JAX trainer's ``ckpt_*.npz`` files and Orbax step
    directories (digit names), each group sorted by path as the JAX resolver
    sorts, then the port's ``ckpt_{step}.pt`` files by step; the last one
    wins."""
    if ref.startswith("wdb:"):
        return _resolve_wandb(ref[4:])
    if ref.startswith("tb:"):
        root = Path(ref[3:])
        cands = sorted(root.rglob("ckpt_*.npz")) + \
            sorted(d for d in root.rglob("*") if d.is_dir() and
                   d.name.isdigit()) + \
            sorted((p for p in root.rglob("ckpt_*.pt")
                    if p.stem[5:].isdigit()), key=lambda p: int(p.stem[5:]))
        if not cands:
            raise FileNotFoundError(f"no checkpoints under {root}")
        return cands[-1]
    return Path(ref)


def _resolve_wandb(spec: str) -> Path:
    run_path, _, version = spec.partition(":")
    try:
        import wandb
    except ImportError as e:
        raise RuntimeError("wandb not available; pass a local path") from e
    api = wandb.Api()
    run = api.run(run_path)
    arts = [a for a in run.logged_artifacts() if a.type == "model"]
    if version:
        arts = [a for a in arts if a.version == version]
    if not arts:
        raise FileNotFoundError(f"no model artifacts on {run_path}")
    return Path(arts[-1].download())
