"""3x3x3 stride-1 SAME convolution on NDHWC tensors: kernel K3 on the card,
the plain version on the CPU.

Counterpart of ``infinicube_tpu/ops/dense_conv.py`` (forward). There the
Pallas implicit-GEMM kernel serves the UNet's convs on the TPU where its plan
fits and XLA's conv the rest; here every CUDA tensor goes to the hand-written
``conv3x3x3_bf16`` (csrc/dense_conv.cu), whatever its width, and a CPU tensor
goes to the plain version. A CUDA call the kernel does not take raises.

Weights keep torch's conv layout [O, C, 3, 3, 3] (``weights/from_jax.py``
turns flax's DHWIO into it). The kernel reads them as [O, 27*C] bf16, which
``Conv3x3x3`` packs once per weight and caches, not on every call."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch import kernels


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """[O, C, 3, 3, 3] -> bf16 [O, 27*C] with k = (dz*9 + dy*3 + dx)*C + c,
    the layout K3 reads."""
    O, C = w.shape[:2]
    return w.permute(0, 2, 3, 4, 1).reshape(O, 27 * C).to(
        torch.bfloat16).contiguous()


def conv3x3x3_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The reference's ``_xla_conv``: f32 accumulation of x's values against
    w, plus the f32 bias, cast back to x's dtype. x [B, D, H, W, C],
    w [O, C, 3, 3, 3], bias [O]."""
    out = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), w.float(), padding=1)
    out = out.permute(0, 2, 3, 4, 1) + bias.float()
    return out.to(x.dtype)


def conv3x3x3(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              w_packed: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, D, H, W, C] @ w [O, C, 3, 3, 3] + bias [O], SAME padding.
    On the card x must be bf16 and the kernel reads ``w_packed``
    (``pack_conv_weight(w)``, packed once by the caller); on the CPU the
    plain version runs."""
    if x.is_cuda:
        if w_packed is None:
            raise ValueError("the card's conv3x3x3 needs w_packed "
                             "(pack_conv_weight(w), packed once)")
        return kernels.conv3x3x3_bf16(x.contiguous(), w_packed,
                                      bias.float().contiguous())
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return conv3x3x3_plain(x, w, bias)


class Conv3x3x3(nn.Module):
    """flax ``nn.Conv(features, (3, 3, 3))`` with promote-dtype semantics
    (input, kernel and bias cast to ``dtype``; the bias then enters in f32),
    the counterpart of the JAX ``Conv3x3x3`` module. Parameters ``weight``
    [O, C, 3, 3, 3] and ``bias`` [O] stay f32."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty((out_ch, in_ch, 3, 3, 3),
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))
        self._packed: tuple | None = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun_normal over the full receptive field, as the JAX module."""
        fan_in = 27 * self.weight.shape[1]
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                generator=generator)
            self.bias.zero_()

    def _packed_weight(self) -> torch.Tensor:
        w = self.weight
        key = (w.data_ptr(), w._version, w.device)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_conv_weight(w.detach()))
        return self._packed[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = self.bias.to(dt).float()
        if x.is_cuda:
            if dt != torch.bfloat16:
                raise ValueError("the card's conv3x3x3 kernel takes bf16; "
                                 f"this module computes in {dt}")
            return conv3x3x3(x.to(dt), self.weight, bias,
                             self._packed_weight())
        return conv3x3x3(x.to(dt), self.weight.to(dt), bias)
