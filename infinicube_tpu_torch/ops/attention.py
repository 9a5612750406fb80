"""Attention for [B, N, heads, head_dim] tensors, forward and backward:
kernels K2 and K5 (bf16) and ``flash_attn_f32`` and ``flash_attn_f32_bwd``
(f32) on the card, the plain einsum versions on the CPU.

Counterpart of ``infinicube_tpu/ops/attention.py``. There the library Pallas
flash kernel serves long sequences on the TPU in the inputs' dtype, and its
fused backward (a dK/dV and a dQ kernel) their gradients; the einsum path
serves the rest with an f32 softmax. Here a bf16 CUDA tensor goes to the
hand-written ``flash_attn_bf16`` (csrc/flash_attention.cu) and, when a
gradient is asked for, through a ``torch.autograd.Function`` whose forward
also takes the rows' log-sum-exp from K2 and whose backward launches
``flash_attn_bf16_bwd`` (csrc/flash_attention_bwd.cu). An f32 CUDA tensor
goes to ``flash_attn_f32`` (csrc/flash_attention_f32.cu: f32 logits, softmax
and output, its products f32-accurate on the tensor cores by the 3xTF32
split, its own arithmetic while PyTorch's library calls keep TF32 off) and,
when a gradient is asked for, through ``_FlashAttentionF32``, whose forward
also takes the rows' log-sum-exp from that kernel and whose backward
launches ``flash_attn_f32_bwd`` (csrc/flash_attention_f32_bwd.cu, 3xTF32
too, a dK/dV and a dQ pass). The kernels take head dims 64, 96 and
128; on the card a smaller head dim is zero-padded to the next of these
(``pad_head_dim``) and the output sliced back, with the scale of the true
head dim: the zero columns add nothing to QK^T and give zero output
columns, and their gradients are zero and dropped, so this is exact forward
and backward. A head dim above 128 raises. A CPU tensor goes to the plain
version and autograd, at any head dim. Nothing falls back: a CUDA call the
kernels do not take raises."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from infinicube_tpu_torch import kernels

# The head dims of K2, K5 and ``flash_attn_f32``.
CARD_HEAD_DIMS = (64, 96, 128)

# Logit elements per query chunk of the plain versions: keeps the
# materialized [B, h, rows, Nk] f32 logits near 1 GB at release sizes.
_PLAIN_CHUNK_ELEMS = 1 << 28


def _row_chunk(n_q: int, per_row: int) -> int:
    return max(1, min(n_q, _PLAIN_CHUNK_ELEMS // max(per_row, 1)))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, return_lse: bool = False):
    """The einsum attention of the reference with the logits of its flash
    kernel: the logits of bf16 (or f32) inputs taken in f32, as K2 and the
    TPU library's kernel take them (the reference's einsum route rounds
    bf16 logits to bf16 first), an f32 softmax and the probabilities in
    v's dtype; computed in chunks of query rows so the logits stay bounded.
    With ``return_lse`` also the natural log-sum-exp of each row's scaled
    logits, f32 [B, h, Nq]."""
    B, nq, h, _ = q.shape
    nk = k.shape[1]
    step = _row_chunk(nq, B * h * nk)
    outs, lses = [], []
    for i in range(0, nq, step):
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, i:i + step].float(),
                              k.float()) * scale
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", attn, v))
        if return_lse:
            lses.append(torch.logsumexp(logits, dim=-1))
    out = torch.cat(outs, dim=1)
    return (out, torch.cat(lses, dim=2)) if return_lse else out


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D_i = sum_d o_i * do_i, f32 [B, h, Nq], the row term of the softmax
    gradient (the TPU library computes it outside its kernels too)."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        scale: float):
    """(dq, dk, dv) of ``attention_plain`` written out from the formulas K5
    follows, in f32, in chunks of query rows: P = exp(S - lse), dV = P^T dO,
    dP = dO V^T, dS = P o (dP - D), dQ = dS K * scale, dK = dS^T Q * scale.
    Results come back in the inputs' dtypes."""
    B, nq, h, _ = q.shape
    nk = k.shape[1]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = attention_delta(o, do)                       # [B, h, Nq]
    step = _row_chunk(nq, B * h * nk)
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i in range(0, nq, step):
        sl = slice(i, i + step)
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, sl], kf) * scale
        p = torch.exp(s - lse[:, :, sl, None])
        dv += torch.einsum("bhqk,bqhd->bkhd", p, dof[:, sl])
        dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, sl], vf)
        ds = p * (dp - delta[:, :, sl, None])
        dq[:, sl] = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qf[:, sl]) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """K2 forward (keeping q, k, v, o and the log-sum-exp), K5 backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = kernels.flash_attn_bf16(q, k, v, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = kernels.flash_attn_bf16_bwd(
            q, k, v, do, lse, attention_delta(o, do), ctx.scale)
        return dq, dk, dv, None


class _FlashAttentionF32(torch.autograd.Function):
    """``flash_attn_f32`` forward (keeping q, k, v, o and the log-sum-exp),
    ``flash_attn_f32_bwd`` backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = kernels.flash_attn_f32(q, k, v, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = kernels.flash_attn_f32_bwd(
            q, k, v, do, lse, attention_delta(o, do), ctx.scale)
        return dq, dk, dv, None


def pad_head_dim(x: torch.Tensor, dims=CARD_HEAD_DIMS) -> torch.Tensor:
    """x [..., d] zero-padded on its last axis to the smallest of ``dims``
    that holds d (x itself where d is one of them); raises above the
    largest."""
    d = x.shape[-1]
    dp = next((c for c in dims if c >= d), None)
    if dp is None:
        raise ValueError(f"head dim {d} above {dims[-1]}, the largest the "
                         "card's attention kernels take")
    return x if dp == d else F.pad(x, (0, dp - d))


def _on_card(x: torch.Tensor) -> bool:
    """Whether x goes to the card's kernels (the tests route CPU tensors
    through this branch with the kernels' plain versions in their place)."""
    return x.is_cuda


def multi_head_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """q [B, Nq, h, d], k/v [B, Nk, h, d] -> [B, Nq, h, d], non-causal,
    differentiable in q, k and v (on the card in bf16 and f32, d <= 128)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    if _on_card(q):
        grad = torch.is_grad_enabled() and \
            (q.requires_grad or k.requires_grad or v.requires_grad)
        # the padding is differentiable: its backward drops the zero
        # columns' gradients, and the output's gradient reaches the
        # backward kernel with zero columns
        qp, kp, vp = (pad_head_dim(t) for t in (q, k, v))
        f32 = q.dtype == torch.float32
        if grad:
            fn = _FlashAttentionF32 if f32 else _FlashAttention
            out = fn.apply(qp, kp, vp, scale)
        elif f32:
            out = kernels.flash_attn_f32(qp, kp, vp, scale)
        else:
            out = kernels.flash_attn_bf16(qp, kp, vp, scale)
        return out if qp is q else out[..., :d]
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return attention_plain(q, k, v, scale)
