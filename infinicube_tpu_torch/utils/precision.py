"""The float32 precision of the port's entry points.

On the card PyTorch runs f32 matrix products in full f32 by default but
lets cuDNN round f32 convolution operands to TF32 (about three decimal
digits). The JAX package's reference runs are f32 throughout, and
``chip_smoke.py`` and the ``cuda`` tests hold the card against the CPU with
both switches off. Every entry point (``train.main``, the stage-1
single-chunk CLI, the VAE reconstruction CLI) calls
``set_float32_precision`` first, so its f32 work, such as the sparse VAE's
dense-neck convolutions, runs at the precision it was checked at."""

from __future__ import annotations

import torch


def set_float32_precision() -> None:
    """Turn TF32 off for f32 matrix products
    (``torch.backends.cuda.matmul.allow_tf32``) and for cuDNN's f32
    convolutions (``torch.backends.cudnn.allow_tf32``), and print it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[precision] f32 matmul TF32 off, cuDNN conv TF32 off")
