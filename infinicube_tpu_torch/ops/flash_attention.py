"""Int8 attention of the serving DiT: kernels K1 (int8 QK^T) and K8 (int8
QK^T and PV) on the card, the plain versions on the CPU.

Counterpart of ``mha_quantized`` in ``infinicube_tpu/ops/flash_attention.py``
with the same quantization contract: heads are folded into the batch, N is
zero-padded to a multiple of the block (``np2 = max(128, next pow2 >= N)``,
``block = min(1536, np2)``), and q and k get one f32 scale per (batch*head,
block of rows), ``scale = max(amax, 1e-8) / 127`` and ``round(x / scale)``
(half to even, as ``jnp.round``). That prologue is plain PyTorch, as it is
XLA outside the Pallas call in JAX, so the int8 inputs of K1 are the JAX
function's int8 inputs bit for bit. K1 (``flash_attn_int8qk``,
csrc/flash_attention.cu) then computes softmax over the N real keys of
``int32(q8 k8^T) * sq * sk * sm_scale`` and a bf16 PV with f32 accumulation.

``quant="qkv"`` quantizes v as well, with one scale per (batch*head,
channel) (``channel_quantize``), and runs PV in int8: the softmax keeps a
running base-2 max, P is rounded to int8 at the fixed scale 127 against that
max (``int8(p * 127 + 0.5)``), the denominator sums the f32 P, and the int32
P8 V8 sums are dequantized by ``sv / 127``. K8 (``flash_attn_int8qkv``,
csrc/flash_attention.cu) keeps its running max over 128-key tiles where the
reference keeps it over 1,536-key blocks, so P rounds at other maxima: the
two agree to the repo's int8 gate (cosine >= 0.999), not bit for bit. K8
takes V8 transposed with its keys permuted within each 16 (``pack_v8``,
the one copy that transposes V), so that P goes from its QK^T sums
straight into the int8 operand of PV.

K1 and K8 take head dims 64 and 128; the reference's kernel takes any. On
the card a head dim below 128 that is not one of them is zero-padded to the
next (``pad_head_dim``) before the quantization and the output sliced back,
with the scale of the true head dim. This is exact: the zero columns leave
every amax, and so every scale, as it was, quantize to zero and add nothing
to QK^T or to the output's real columns. A head dim above 128 raises.
"""

from __future__ import annotations

import math

import torch

from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.nn.quant import amax_scale
from infinicube_tpu_torch.ops.attention import _row_chunk, \
    multi_head_attention, pad_head_dim

# The head dims of K1 and K8.
INT8_HEAD_DIMS = (64, 128)


def block_quantize(x: torch.Tensor, block: int):
    """x [BH, N, d] -> int8 values and f32 per-(BH, block) scales
    [BH, N // block] (the reference's ``_block_quantize``)."""
    BH, N, d = x.shape
    xb = x.float().reshape(BH, N // block, block * d)
    scale = amax_scale(xb.abs().amax(dim=-1))
    q = torch.round(xb / scale[..., None]).to(torch.int8)
    return q.reshape(BH, N, d), scale


_QUANT_BLOCK = 1536


def quant_blocks(n: int):
    """(block, padded N) as the reference chooses them for q and k alike."""
    block = min(_QUANT_BLOCK, max(128, 1 << (n - 1).bit_length()))
    return block, n + (-n) % block


def fold_heads(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """[B, N, h, d] -> [B*h, n_pad, d], zero rows past N."""
    B, N, h, d = x.shape
    x = x.permute(0, 2, 1, 3).reshape(B * h, N, d)
    return torch.nn.functional.pad(x, (0, 0, 0, n_pad - N))


def int8qk_attention_plain(q8, k8, qscale, kscale, v, block: int,
                           sm_scale: float) -> torch.Tensor:
    """What K1 computes, in plain PyTorch: the same int8 inputs and scales,
    exact integer logits (|q8 k8| <= 127^2 d is exact in f32), softmax over
    the N real keys in f32, P rounded to v's dtype for PV, f32 accumulation.
    Chunked over query rows so the logits stay bounded."""
    B, N, h, d = v.shape
    BH = B * h
    rows_q = qscale.repeat_interleave(block, dim=1)[:, :N]   # [BH, N]
    cols_k = kscale.repeat_interleave(block, dim=1)[:, :N]
    qf, kf = q8[:, :N].float(), k8[:, :N].float()
    vf = v.permute(0, 2, 1, 3).reshape(BH, N, d).float()
    step = _row_chunk(N, BH * N)
    outs = []
    for i in range(0, N, step):
        s = torch.bmm(qf[:, i:i + step], kf.transpose(1, 2))
        s = s * rows_q[:, i:i + step, None] * cols_k[:, None, :] * sm_scale
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.bmm(p.to(v.dtype).float(), vf) / l.clamp_min(1e-37)
        outs.append(o.to(v.dtype))
    out = torch.cat(outs, dim=1)
    return out.reshape(B, h, N, d).permute(0, 2, 1, 3)


def channel_quantize(x: torch.Tensor):
    """x [BH, N, d] -> int8 values and f32 per-(BH, channel) scales [BH, d]
    (the reference's ``_channel_quantize``)."""
    xf = x.float()
    scale = amax_scale(xf.abs().amax(dim=1))
    return torch.round(xf / scale[:, None, :]).to(torch.int8), scale


def pack_v8(v8: torch.Tensor) -> torch.Tensor:
    """K8's V operand: v8 int8 [BH, Npad, d] (Npad a multiple of 16) ->
    [BH, d, Npad], transposed so that each channel's keys are contiguous and
    permuted within each 16 (position 4q + i holds key 2q + i % 2 +
    8 (i // 2): 0, 1, 8, 9, 2, 3, 10, 11, ...), in one copy."""
    BH, npad, d = v8.shape
    # key 16 c + 8 a + 2 q + b goes to position 16 c + 4 q + 2 a + b
    return v8.reshape(BH, npad // 16, 2, 4, 2, d).permute(
        0, 5, 1, 3, 2, 4).reshape(BH, d, npad)


# f32 sums of int8 products stay exact below 2^24: 1,024 keys of 127^2
_EXACT_KEYS = 1024
_LOG2E = 1.4426950408889634


def int8qkv_attention_plain(q8, k8, qscale, kscale, v8, vscale, n: int,
                            block: int, sm_scale: float,
                            out_dtype: torch.dtype) -> torch.Tensor:
    """What the reference's int8-PV kernel computes, with its blocking:
    q8/k8/v8 int8 [BH, Npad, d], q/k scales per (BH, block of rows), v
    scales [BH, d]. For each block of ``block`` keys: exact integer logits
    times sq * sk * sm_scale * log2(e), keys >= n at -1e30, a running
    base-2 max m, p = 2^(s - m), l = l * 2^(m_old - m) + sum p, and the
    numerator rescaled likewise plus int32(int8(p * 127 + 0.5) v8) *
    sv / 127 (exact integer sums, rounded to f32). Returns [BH, n, d] in
    ``out_dtype``; chunked over query rows so the logits stay bounded."""
    BH, npad, d = q8.shape
    nkb = npad // block
    qf, kf, vf = q8.float(), k8.float(), v8.float()
    rows_q = qscale.repeat_interleave(block, dim=1)[:, :n]
    sv127 = vscale * (1.0 / 127.0)
    step = _row_chunk(n, BH * block)
    outs = []
    for i in range(0, n, step):
        rows = min(step, n - i)
        m = torch.full((BH, rows, 1), -1e30, device=q8.device)
        l = torch.zeros((BH, rows, 1), device=q8.device)
        acc = torch.zeros((BH, rows, d), device=q8.device)
        for j in range(nkb):
            ks = slice(j * block, (j + 1) * block)
            scale = rows_q[:, i:i + rows, None] * \
                kscale[:, j, None, None] * (sm_scale * _LOG2E)
            s = torch.bmm(qf[:, i:i + rows], kf[:, ks].transpose(1, 2)) * \
                scale
            if (j + 1) * block > n:
                s[..., max(n - j * block, 0):] = -1e30
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            p8 = torch.trunc(p * 127.0 + 0.5)
            pv = torch.zeros((BH, rows, d), dtype=torch.float64,
                             device=q8.device)
            for k0 in range(0, block, _EXACT_KEYS):
                kk = slice(j * block + k0,
                           j * block + min(k0 + _EXACT_KEYS, block))
                pv += torch.bmm(p8[..., k0:k0 + _EXACT_KEYS],
                                vf[:, kk]).double()
            acc = acc * alpha + pv.float() * sv127[:, None, :]
            m = m_new
        outs.append((acc / l.clamp_min(1e-37)).to(out_dtype))
    return torch.cat(outs, dim=1)


def mha_quantized(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  quant: str = "qk") -> torch.Tensor:
    """[B, N, h, d] self-attention with int8 QK^T (``"qk"``) or int8 QK^T
    and PV (``"qkv"``). ``quant="none"`` computes the same function in bf16
    through ``multi_head_attention`` (K2)."""
    if quant == "none":
        return multi_head_attention(q, k, v)
    if quant not in ("qk", "qkv"):
        raise ValueError(f"unknown quant {quant!r}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")
    B, N, h, d = q.shape
    sm_scale = 1.0 / math.sqrt(d)
    if q.is_cuda:
        qp, kp, vp = (pad_head_dim(t, INT8_HEAD_DIMS) for t in (q, k, v))
        out = _int8_attention(qp, kp, vp, quant, sm_scale)
        return out if qp is q else out[..., :d]
    return _int8_attention(q, k, v, quant, sm_scale)


def _int8_attention(q, k, v, quant: str, sm_scale: float) -> torch.Tensor:
    B, N, h, d = q.shape
    block, n_pad = quant_blocks(N)
    q8, sq = block_quantize(fold_heads(q, n_pad), block)
    k8, sk = block_quantize(fold_heads(k, n_pad), block)
    if quant == "qkv":
        v8, sv = channel_quantize(fold_heads(v, n_pad))
        if q.is_cuda:
            return kernels.flash_attn_int8qkv(
                q8, k8, sq, sk, pack_v8(v8), sv, B, N, block, sm_scale)
        out = int8qkv_attention_plain(q8, k8, sq, sk, v8, sv, N, block,
                                      sm_scale, q.dtype)
        return out.reshape(B, h, N, d).permute(0, 2, 1, 3)
    if q.is_cuda:
        return kernels.flash_attn_int8qk(q8, k8, sq, sk, v, block, sm_scale)
    return int8qk_attention_plain(q8, k8, sq, sk, v, block, sm_scale)
