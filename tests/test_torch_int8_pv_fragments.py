"""The arithmetic of K8 (the int8-PV attention on the card) on the CPU.

K8 takes P from the s32 accumulators of its QK^T ``wgmma`` straight into the
s8 A fragment of its PV ``wgmma``. A thread's accumulators hold keys 2q and
2q + 1 of each 8 (q = lane % 4) where the A fragment wants keys 4q .. 4q + 3
of each 16, so V's keys are stored permuted within each 16 (``pack_v8``)
and the contraction pairs them up. Here a Python model of
the two register layouts (as ``csrc/hopper.cuh`` documents them) and of the
kernel's packing rule shows that the product is P V exactly, in integers, at
d = 64 and 128; and a model of the kernel's blocking (a running max per
128-key tile, 127 P rounded to int8 against it, fresh int32 sums a tile,
the output scaled by sv once) agrees with ``int8qkv_attention_plain``,
whose running max is per 1,536-key block, at the repo's int8 gate, cosine
>= 0.999, at N that cross a block. Nothing here imports JAX; the link to
the JAX kernel is ``test_int8qkv_matches_jax``."""

import math

import numpy as np
import pytest
import torch

from infinicube_tpu_torch.ops.flash_attention import (block_quantize,
                                                      channel_quantize,
                                                      fold_heads,
                                                      int8qkv_attention_plain,
                                                      pack_v8, quant_blocks)

KEYS = 128     # keys a tile
# K8's order of the keys within each 16: position 4q + i holds key
# 2q + i % 2 + 8 (i // 2)
K8_KEY_ORDER = (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15)


def acc_position(lane, i):
    """Accumulator register i of a warp's lane in the m64nNk* s32 (and f32)
    layout: its (row of the warp's 16, column)."""
    g, q, j, e = lane // 4, lane % 4, i // 4, i % 4
    return g + 8 * (e // 2), 8 * j + 2 * q + e % 2


def a_fragment_position(lane, r, byte):
    """Byte ``byte`` of register r of the s8 A fragment of a k32 step: its
    (row of the warp's 16, key of the step's 32)."""
    g, q = lane // 4, lane % 4
    return g + 8 * (r % 2), 16 * (r // 2) + 4 * q + byte


def kernel_pack(acc, kk, r):
    """The kernel's packing rule for register r of k32 step kk, from one
    lane's accumulator values ``acc`` (already rounded to int8): byte i is
    element 2 (r % 2) + i % 2 of accumulator column block 4 kk + 2 (r / 2) +
    i / 2 (bytes a[e], a[e + 1], a[4 + e], a[5 + e] in that order, with
    a = s + 4 (4 kk + 2 (r / 2)) and e = 2 (r % 2))."""
    base, e = 4 * (4 * kk + 2 * (r // 2)), 2 * (r % 2)
    return [acc[base + e], acc[base + e + 1], acc[base + 4 + e],
            acc[base + 5 + e]]


@pytest.mark.parametrize("d", [64, 128])
def test_p_from_the_accumulators_times_permuted_v_is_pv(d):
    rng = np.random.default_rng(d)
    p8 = torch.from_numpy(rng.integers(0, 128, (16, KEYS))).long()
    v8 = torch.from_numpy(rng.integers(-127, 128, (1, KEYS, d)).astype(
        np.int8))
    # what each lane holds after QK^T: P at its accumulator positions
    held = [[p8[acc_position(lane, i)] for i in range(KEYS // 2)]
            for lane in range(32)]
    # the A operand the tensor cores read from the packed registers
    a = torch.full((16, KEYS), -1, dtype=torch.long)
    for lane in range(32):
        for kk in range(KEYS // 32):
            for r in range(4):
                for byte, val in enumerate(kernel_pack(held[lane], kk, r)):
                    row, col = a_fragment_position(lane, r, byte)
                    assert a[row, 32 * kk + col] == -1
                    a[row, 32 * kk + col] = val
    assert (a >= 0).all()
    # B: V8 K-major as the kernel loads it, keys permuted by pack_v8
    b = pack_v8(v8)[0].long().t()                      # [KEYS, d]
    assert torch.equal(a @ b, p8 @ v8[0].long())
    # the permutation is the one the packing implies, and no other order is
    assert not torch.equal(a @ v8[0].long(), p8 @ v8[0].long())


def test_pack_v8_is_the_kernel_key_order():
    """V transposed to [BH, d, Npad], key 16 c + K8_KEY_ORDER[p] at
    position 16 c + p, in one copy; the order is the one the accumulator
    and fragment layouts give."""
    for lane in range(4):
        for byte in range(4):
            _, pos = a_fragment_position(lane, 0, byte)
            _, key = acc_position(lane, 4 * (byte // 2) + byte % 2)
            assert K8_KEY_ORDER[pos] == key
    v8 = torch.arange(3 * 48 * 5, dtype=torch.int32).reshape(3, 48, 5)
    packed = pack_v8(v8)
    assert packed.shape == (3, 5, 48) and packed.is_contiguous()
    for pos in range(48):
        key = 16 * (pos // 16) + K8_KEY_ORDER[pos % 16]
        assert torch.equal(packed[:, :, pos], v8[:, key, :])


def k8_model(q8, k8, qscale, kscale, v8, vscale, n, block, sm_scale):
    """K8's blocking: key tiles of 128 (inside one quantization block), the
    base-2 running max over each, e = 127 * 2^(s - m) (P at the int8 scale)
    rounded to the nearest integer for P8, fresh int32 P8 V8 sums a tile
    (exact in f32) added to the output before its rescale, the denominator
    of the e, the output scaled by sv and 1 / l at the end. Returns f32
    [BH, n, d]."""
    BH, npad, d = q8.shape
    qf = q8[:, :n].float()
    rows_q = qscale.repeat_interleave(block, dim=1)[:, :n, None]
    m = torch.full((BH, n, 1), -math.inf)
    l = torch.zeros((BH, n, 1))
    o = torch.zeros((BH, n, d))
    for t0 in range(0, n, KEYS):
        ks = slice(t0, t0 + KEYS)
        s = qf @ k8[:, ks].float().transpose(1, 2) * rows_q * \
            kscale[:, t0 // block, None, None] * (sm_scale * math.log2(math.e))
        s[..., max(n - t0, 0):] = -math.inf
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        e = 127.0 * torch.exp2(s - m_new)
        l = l * alpha + e.sum(dim=-1, keepdim=True)
        pv = torch.round(e) @ v8[:, ks].float()
        o = o * alpha + pv
        m = m_new
    return o * vscale[:, None, :] / l


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.parametrize("n", [1700, 3100])
def test_k8_blocking_agrees_with_plain(n):
    """N past one and two 1,536-key blocks, every block of q and k at its
    own scale, every channel of v at its own range."""
    g = torch.Generator().manual_seed(n)
    h, d = 2, 64
    block, npad = quant_blocks(n)
    assert block == 1536 and npad > block
    f = torch.logspace(-0.6, 0.6, -(-n // block)).repeat_interleave(
        block)[:n, None, None]
    q = torch.randn((1, n, h, d), generator=g) * f
    k = torch.randn((1, n, h, d), generator=g) / f
    v = torch.randn((1, n, h, d), generator=g) * torch.logspace(-1, 1, d)
    q8, sq = block_quantize(fold_heads(q, npad), block)
    k8, sk = block_quantize(fold_heads(k, npad), block)
    v8, sv = channel_quantize(fold_heads(v, npad))
    got = k8_model(q8, k8, sq, sk, v8, sv, n, block, d ** -0.5)
    ref = int8qkv_attention_plain(q8, k8, sq, sk, v8, sv, n, block,
                                  d ** -0.5, torch.float32)
    assert torch.isfinite(got).all()
    assert _cos(got, ref) >= 0.999
