"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point builds on. Defaults to the card; the CPU is
    used only when asked for. A CUDA device without a card raises instead of
    carrying on on the CPU. ``"meta"`` builds a module's parameters without
    storage (their names, shapes and dtypes only)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
