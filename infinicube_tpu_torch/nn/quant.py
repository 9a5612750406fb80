"""Dynamic int8 linear for the serving DiT.

Counterpart of ``infinicube_tpu/nn/quant.py``: activations get one scale per
row, weights one per output channel, both ``max(amax, 1e-8) / 127`` with
round-half-to-even, and ``out = int32(x8 w8^T) * sx * sw (+ bias)``. The
scales sit outside the contraction, so dequantization is exact. Weights are
quantized on the fly from the stored (bf16 or f32) parameters, as in JAX.

The int32 product is a plain large matrix product, as XLA's dot is in JAX:
``torch._int_mm`` on the card, an exact integer product on the CPU."""

from __future__ import annotations

import torch

from infinicube_tpu_torch.nn.layers import Dense


def amax_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127``, the scale the reference's int8 attention
    and conv give a block or a channel, as a correctly rounded division. The
    divisor is a tensor: on the card PyTorch divides by a Python scalar as a
    product with the scalar's rounded reciprocal, which differs in the last
    bit for about 4 % of values (the CPU and the reference divide)."""
    return amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)


def _quantize_rows(x: torch.Tensor):
    """Per-row int8 of a 2-D tensor: (int8 values, f32 scales [rows, 1])."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    return torch.round(xf / s).to(torch.int8), s


def _int_matmul(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """int32 a8 [M, K] @ b8[N, K]^T."""
    if a8.is_cuda:
        m = a8.shape[0]
        if m <= 16:  # cuBLASLt's int8 GEMM wants M > 16: pad with zero rows
            a8 = torch.nn.functional.pad(a8, (0, 0, 0, 32 - m))
        return torch._int_mm(a8, b8.t())[:m]
    # |sum| <= 127^2 K < 2^53: the f64 product is the exact integer
    return (a8.double() @ b8.double().t()).to(torch.int32)


def int8_matmul(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., K] @ weight[N, K]^T with per-row / per-output-channel int8
    scales. Returns x.dtype."""
    K = x.shape[-1]
    x8, sx = _quantize_rows(x.reshape(-1, K))
    w8, sw = _quantize_rows(weight)
    out = _int_matmul(x8, w8).float() * sx * sw.reshape(1, -1)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype).reshape(*x.shape[:-1], weight.shape[0])


class QuantLinear(Dense):
    """Drop-in ``Dense`` on the int8 path: same parameters, input cast to
    ``compute_dtype`` first (the reference's ``QuantDense``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x.to(self.compute_dtype), self.weight, self.bias)
