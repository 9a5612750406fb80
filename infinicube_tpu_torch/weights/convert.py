"""Upstream checkpoint files -> state dicts; counterpart of
``infinicube_tpu/weights/convert.py``'s ``load_torch_state_dict``. The
per-model converters of HuggingFace layouts live beside their modules
(``models/gsm/dav2.py``, ``segformer.py``, ``convnext.py``)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch


def load_torch_state_dict(path: str | Path) -> dict:
    """A ``.pth`` / ``.pt`` / ``.ckpt`` / ``.safetensors`` state dict on the
    CPU (a ``{"state_dict": ...}`` wrapper is unwrapped). Pickles load with
    ``weights_only=True``: tensors and plain containers only. A flax
    ``.msgpack`` holds JAX parameters, which the port takes through
    ``weights.from_jax``; ``.safetensors`` needs the ``safetensors``
    package."""
    path = str(path)
    if path.endswith(".msgpack"):
        raise ValueError(
            f"{path}: a flax .msgpack holds JAX parameters; restore it with "
            "flax and convert the tree with infinicube_tpu_torch.weights."
            "from_jax.gsm_from_jax, or pass an HF-layout "
            ".pth")
    if path.endswith(".safetensors"):
        if importlib.util.find_spec("safetensors") is None:
            raise ModuleNotFoundError(
                f"{path}: reading .safetensors needs the 'safetensors' "
                "package, which is not installed; save the state dict with "
                "torch.save as a .pth instead")
        from safetensors.torch import load_file
        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd
