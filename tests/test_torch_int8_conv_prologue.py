"""Port parity: the operands of the int8 dense conv (K7) as the card's
quantize-prologue kernels write them, through their plain versions on the
CPU (``int8_conv_operands``: x8 at the width padded to 32, the dx-major
padded weight pack and the padded scales), against the JAX package's
``_quantize_for_conv`` repacked; the plain amax against the reference's
own expression where x holds NaN, inf and -0.0; models of the amax
kernel's plan and reduction (``kernels.amax_plan``) and of the weight
pass's index arithmetic against the plain versions; and a model of K7's
accumulation order (int32 partial sums of any K split, added as integers,
each dx group scaled and added t0, t1, t2) against
``conv3x3x3_int8_plain``, bit for bit. Nothing here runs the JAX side's
Pallas kernel."""

import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu_torch import kernels

from infinicube_tpu.ops.dense_conv import _quantize_for_conv
from infinicube_tpu_torch.nn import quant
from infinicube_tpu_torch.ops import dense_conv, flash_attention
from infinicube_tpu_torch.ops.dense_conv import (K7_MULTIPLE,
                                                 conv3x3x3_int8_plain,
                                                 int8_conv_amax_plain,
                                                 int8_conv_operands,
                                                 int8_conv_quantize_w_plain,
                                                 int8_conv_quantize_x_plain,
                                                 pack_int8_weight,
                                                 pad_channels,
                                                 quantize_for_conv)


def _case(B, D, H, W, C, O, seed, cfg_ratio=1.0):
    """bf16 x with a different range in every channel, one all-zero channel
    (the 1e-8 floor) and, for a CFG pair, its second half scaled by
    cfg_ratio; the f32 weight parameter [O, C, 3, 3, 3]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D, H, W, C)) * np.geomspace(0.05, 5.0, C)
    x[..., 1] = 0.0
    x[B // 2:] *= cfg_ratio
    w = rng.standard_normal((O, C, 3, 3, 3)) / np.sqrt(27 * C)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return xt, torch.from_numpy(w.astype(np.float32))


def _reference_operands(x, w):
    """JAX's _quantize_for_conv on bf16 x and the bf16-rounded weights,
    repacked as K7 takes them (padded to 32, dx-major)."""
    wj = w.permute(2, 3, 4, 1, 0).to(torch.bfloat16).float().numpy()
    x8, w8, sw = _quantize_for_conv(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        jnp.asarray(wj, jnp.bfloat16))
    x8 = torch.from_numpy(np.asarray(x8))
    w8 = torch.from_numpy(np.asarray(w8)).permute(4, 3, 0, 1, 2)
    sw = torch.from_numpy(np.asarray(sw))
    m = K7_MULTIPLE
    return (pad_channels(x8, m, -1), pack_int8_weight(pad_channels(w8, m, 0,
                                                                   1)),
            pad_channels(sw, m, 1))


@pytest.mark.parametrize("shape,cfg_ratio", [
    ((2, 3, 4, 8, 192, 192), 1.0),    # a release width, no padding
    ((2, 2, 4, 8, 384, 96), 8.0),     # a CFG pair with unequal ranges
    ((2, 3, 4, 8, 72, 104), 0.25),    # 8 mod 32: padded to 96 -> 128
    ((2, 2, 3, 8, 40, 72), 1.0),      # 8 mod 32: padded to 64 -> 96
    ((2, 2, 4, 8, 8, 40), 1.0),       # C = 8, the narrowest the card takes
    ((2, 3, 4, 8, 64, 1), -1.0)])     # O = 1; the CFG half negated, so the
                                      # zero channel holds -0.0 there
def test_card_prologue_contract_equals_reference(shape, cfg_ratio):
    x, w = _case(*shape, seed=sum(shape), cfg_ratio=cfg_ratio)
    got = int8_conv_operands(x, w)
    ref = _reference_operands(x, w)
    B, D, H, W, C, O = shape
    Cp, Op = -(-C // 32) * 32, -(-O // 32) * 32
    assert got[0].shape == (B, D, H, W, Cp) and got[0].dtype == torch.int8
    assert got[1].shape == (Op, 27 * Cp) and got[1].dtype == torch.int8
    assert got[2].shape == (3, Op) and got[2].dtype == torch.float32
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    # the padding is zeros, and a CFG pair shares its channel scales
    assert (got[0][..., C:] == 0).all() and (got[1][O:] == 0).all()
    assert (got[2][:, O:] == 0).all()
    # each pass alone equals its share of quantize_for_conv + pad + pack
    x8, w8, sw = quantize_for_conv(x, w.to(torch.bfloat16))
    amax = int8_conv_amax_plain(x)
    assert torch.equal(int8_conv_quantize_x_plain(x, amax),
                       pad_channels(x8, K7_MULTIPLE, -1))
    w8p, swp = int8_conv_quantize_w_plain(w, amax)
    assert torch.equal(w8p, pack_int8_weight(
        pad_channels(w8, K7_MULTIPLE, 0, 1)))
    assert torch.equal(swp, pad_channels(sw, K7_MULTIPLE, 1))


def test_weight_pass_rounds_the_f32_parameter_to_bf16_first():
    """The weight pass reads the f32 parameter; its result equals the
    plain prologue on the parameter cast to bf16 (the module's
    promote_dtype), not on the f32 values."""
    x, w = _case(2, 2, 4, 8, 64, 64, seed=5)
    amax = int8_conv_amax_plain(x)
    assert torch.equal(int8_conv_quantize_w_plain(w, amax)[0],
                       int8_conv_quantize_w_plain(w.to(torch.bfloat16),
                                                  amax)[0])
    unrounded = quantize_for_conv(x, w)[1]
    assert not torch.equal(pack_int8_weight(unrounded),
                           int8_conv_quantize_w_plain(w, amax)[0])


def test_plain_amax_equals_the_reference_expression():
    """``int8_conv_amax_plain`` against the reference's own amax,
    ``jnp.max(jnp.abs(xf), axis=(0, 1, 2, 3))``, on an x that holds NaN,
    +-inf and -0.0: NaN at the same channels, every other value bit-equal
    (NaN and inf leave the reference's int8 casts undefined, so nothing
    past the amax is compared for them)."""
    x, _ = _case(2, 3, 4, 8, 64, 1, seed=21, cfg_ratio=-1.0)
    x[0, 1, 2, 3, 5] = float("nan")
    x[1, 0, 0, 0, 6] = -float("nan")
    x[1, 2, 3, 4, 7] = float("inf")
    x[0, 2, 1, 0, 8] = -float("inf")
    x[..., 9] = -0.0
    x[0, 0, 0, 0, 10] = float("nan")           # NaN beside inf: NaN wins
    x[1, 1, 1, 1, 10] = float("inf")
    xf = jnp.asarray(x.float().numpy(), jnp.bfloat16).astype(jnp.float32)
    ref = torch.from_numpy(np.asarray(jnp.max(jnp.abs(xf),
                                              axis=(0, 1, 2, 3))))
    got = int8_conv_amax_plain(x)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.isnan(got[[5, 6, 10]]).all()
    keep = ~torch.isnan(ref)
    assert torch.equal(got[keep].view(torch.int32),
                       ref[keep].view(torch.int32))
    assert got[7] == got[8] == float("inf")
    assert got[1].view(torch.int32) == 0 and got[9].view(torch.int32) == 0


_AMAX_SHAPES = [(2 * 64 ** 3, 192), (2 * 64 ** 3, 576), (2 * 32 ** 3, 384),
                (2 * 32 ** 3, 1152), (2 * 32 ** 3, 768), (2 * 16 ** 3, 384),
                (1, 8), (105, 192), (420, 384), (30, 12288), (7, 2400),
                (2048, 64)]


@pytest.mark.parametrize("M,C", _AMAX_SHAPES)
def test_amax_plan_covers_x_in_one_wave_with_every_lane_busy(M, C):
    """``kernels.amax_plan``, the grid ``int8_conv_amax`` launches: every
    row in exactly one block's range and every 16-byte channel vector in
    exactly one slab; at most AMAX_THREADS threads a block, a whole number
    of warps wherever 32 / gcd(vs, 32) rows fit (every K7 width); one wave
    of at most two blocks an SM, at least one an SM where x has the rows;
    the counters of the tree fit."""
    sms = 132
    p = kernels.amax_plan(M, C, sms)
    vpr = C // 8
    assert (p.slabs - 1) * p.vs < vpr <= p.slabs * p.vs
    assert (p.blocks - 1) * p.rows < M <= p.blocks * p.rows
    threads = p.vs * p.rpb
    assert threads <= kernels.AMAX_THREADS
    if p.vs * 32 // np.gcd(p.vs, 32) <= kernels.AMAX_THREADS:
        assert threads % 32 == 0
    if C in (192, 384, 576, 768, 1152, 12288):
        assert threads % 32 == 0 and p.vs * p.slabs == vpr
    assert p.blocks * p.slabs <= 2 * sms + p.slabs
    if M >= 2 * sms * p.rpb:
        assert p.blocks * p.slabs >= sms
    groups = -(-p.blocks // kernels.AMAX_GROUP)
    assert p.slabs * (groups + 1) <= kernels.AMAX_COUNTERS


def _amax_kernel_model(x, sms):
    """What ``int8_conv_amax``'s kernel computes, step by step, in numpy:
    the sign-cleared f32 bits of each bf16 value, their unsigned max over
    each block's rows of each slab's channels, then the tree (the max of
    each group of AMAX_GROUP partial rows, then of the group maxima)."""
    M, C = x.numel() // x.shape[-1], x.shape[-1]
    p = kernels.amax_plan(M, C, sms)
    bits = x.reshape(M, C).view(torch.int16).numpy().astype(np.uint32)
    bits = (bits << 16) & 0x7fffffff
    part = np.zeros((p.blocks, C), np.uint32)
    for b in range(p.blocks):
        for s in range(p.slabs):
            cs = slice(s * p.vs * 8, min(C, (s + 1) * p.vs * 8))
            part[b, cs] = bits[b * p.rows:(b + 1) * p.rows, cs].max(0)
    groups = [part[g:g + kernels.AMAX_GROUP].max(0)
              for g in range(0, p.blocks, kernels.AMAX_GROUP)]
    return torch.from_numpy(np.max(groups, 0).astype(np.int64)
                            .astype(np.int32)).view(torch.float32)


@pytest.mark.parametrize("B,D,H,W,C,sms", [
    (2, 4, 8, 8, 192, 132), (2, 4, 8, 8, 192, 4), (1, 3, 5, 7, 64, 132),
    (1, 1, 1, 1, 8, 132), (1, 2, 2, 3, 4104, 8)])
def test_amax_kernel_model_equals_plain(B, D, H, W, C, sms):
    """The kernel's order-free reduction (the unsigned max of the
    sign-cleared bits, by blocks, slabs and the tree) equals
    ``int8_conv_amax_plain`` bit for bit, NaN and inf included: a NaN's
    bits lie above inf's, so it wins as in the reference's max."""
    x, _ = _case(B, D, H, W, C, 1, seed=C + sms, cfg_ratio=-1.0)
    flat = x.view(-1, C)
    flat[-1, 0] = float("nan")
    flat[0, C - 1] = -float("inf")
    flat[flat.shape[0] // 2, C // 2] = float("inf")
    got = _amax_kernel_model(x, sms)
    ref = int8_conv_amax_plain(x)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    keep = ~torch.isnan(ref)
    assert torch.equal(got[keep].view(torch.int32),
                       ref[keep].view(torch.int32))


# csrc/dense_conv.cu: kQwThreads, kQwChunk (27 * 128 == 3 * 288 * 4)
_QW_THREADS, _QW_CHUNK = 288, 128


@pytest.mark.parametrize("C,cpb", [(8, 32), (13, 32), (6, 32), (300, 64),
                                   (576, 160), (192, 64), (1152, 384)])
def test_weight_pass_index_model_equals_the_pack(C, cpb):
    """The weight pass's index arithmetic, as its kernel walks a row: a
    cluster's blocks each take a slab of cpb channels (a multiple of 32),
    walked in chunks of _QW_CHUNK channels; in a chunk each thread takes
    the four elements at (tid + u*_QW_THREADS) * 4, u = 0, 1, 2 (27 * 128 =
    3 * 288 * 4 of them), so that each element's tap t = e % 27, its
    staging row (t % 3)*9 + t // 3, its channel in the chunk and its dx =
    (tid*4 + j) % 3 are the same in every chunk and fixed before the loops;
    elements past the slab's last channel are masked. Together they place
    every weight where ``pack_int8_weight`` of the padded weights does,
    once."""
    O, Cp, T = 2, -(-C // 32) * 32, _QW_THREADS
    assert 27 * _QW_CHUNK == 3 * T * 4
    w = torch.arange(1, O * C * 27 + 1, dtype=torch.int64).reshape(O, C, 3,
                                                                   3, 3)
    pack = torch.zeros((O, 27 * Cp), dtype=torch.int64)
    for o in range(O):
        row = w[o].reshape(-1)
        for tid in range(T):
            fixed = []                   # (channel, staging row) by (u, j)
            for u in range(3):
                c, t0 = divmod((tid + u * T) * 4, 27)
                fixed.append([(c + (t0 + j >= 27),
                               (t0 + j) % 27 % 3 * 9 + (t0 + j) % 27 // 3)
                              for j in range(4)])
            for c_lo in range(0, Cp, cpb):           # the cluster's blocks
                assert c_lo < C
                cn_slab = min(cpb, C - c_lo)
                for c0 in range(0, min(cpb, Cp - c_lo), _QW_CHUNK):
                    end = 27 * min(_QW_CHUNK, cn_slab - c0)
                    for u in range(3):
                        e = (tid + u * T) * 4
                        for j in range(4):
                            if e + j >= end:
                                continue
                            ch, srow = fixed[u][j]
                            cj, t = divmod(e + j, 27)
                            assert cj == ch
                            assert srow == t % 3 * 9 + t // 3
                            assert t % 3 == (tid * 4 + j) % 3
                            k = srow * Cp + c_lo + c0 + cj
                            assert pack[o, k] == 0
                            pack[o, k] = row[27 * (c_lo + c0) + e + j]
    ref = pack_int8_weight(pad_channels(w, K7_MULTIPLE, 1))
    assert torch.equal(pack, ref)


def _rn32(x):
    """x (a Fraction) rounded to the nearest f32, ties to even (normal
    range), as a Fraction: one IEEE rounding, no double rounding."""
    if x == 0:
        return Fraction(0)
    a = abs(x)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if a < Fraction(2) ** e:
        e -= 1
    m = a / Fraction(2) ** (e - 23)          # in [2^23, 2^24)
    n, rest = divmod(m.numerator, m.denominator)
    twice = 2 * rest
    if twice > m.denominator or (twice == m.denominator and n % 2):
        n += 1
    return (1 if x > 0 else -1) * n * Fraction(2) ** (e - 23)


def _rint(x):
    """Round half to even, as rintf."""
    n = math.floor(x)
    d = x - n
    return n + (d > Fraction(1, 2) or (d == Fraction(1, 2) and n % 2))


def test_weight_pass_fast_rounding_equals_the_ieee_quotient():
    """The weight pass quantizes without a division where it can
    (``quantize4``, csrc/dense_conv.cu): r = RN(1/s), q0 = RN(f r), q1 =
    RN(q0 + RN(f - q0 s) r) (two FMAs), each rounding emulated exactly
    here; wherever q1 lies further than 2^-10 from a half-integer, its
    rounding to the nearest integer (ties to even) equals that of the IEEE
    quotient RN(f / s), which the plain version rounds. Values f with s =
    RN(max|f| / 127) as the kernel has them, and values placed within a
    few ulps of every half-integer the int8 range holds."""
    rng = np.random.default_rng(3)
    cases = []
    for _ in range(6):
        f = (rng.standard_normal(700) * 10.0 ** rng.uniform(-6, 2)).astype(
            np.float32)
        s = _rn32(Fraction(float(np.abs(f).max())) / 127)
        cases += [(Fraction(float(v)), s) for v in f]
        # within a few ulps of k + 1/2 for every k the int8 range holds
        for k in range(-128, 128):
            near = float(_rn32((k + Fraction(1, 2)) * s))
            for ulps in (-2, -1, 0, 1, 2):
                v = np.nextafter(np.float32(near), np.float32(np.inf * ulps)
                                 if ulps else np.float32(near))
                for _ in range(abs(ulps) - 1):
                    v = np.nextafter(v, np.float32(np.inf * ulps))
                cases.append((Fraction(float(v)), s))
    fast = 0
    for f, s in cases:
        r = _rn32(1 / s)
        q0 = _rn32(f * r)
        q1 = _rn32(q0 + _rn32(f - q0 * s) * r)
        if abs(q1 - math.floor(q1) - Fraction(1, 2)) > Fraction(1, 1024):
            fast += 1
            assert _rint(q1) == _rint(_rn32(f / s)), (f, s)
    assert fast >= 0.99 * 6 * 700       # the random values go fast


def _k7_model(x8, w8p, sw, bias, slices):
    """K7's accumulation order: each dx group's K range (the third of the
    dx-major pack) cut into `slices` contiguous pieces, each summed exactly
    (int32 in the kernel: every partial is checked to fit), the pieces added
    as integers, converted to f32 once, times sw[dx]; then t0, + t1, + t2, +
    bias, each rounded to f32, and bf16 at the end."""
    B, D, H, W, C = x8.shape
    O = w8p.shape[0]
    xp = torch.nn.functional.pad(x8.double(), (0, 0, 1, 1, 1, 1, 1, 1))
    total = torch.zeros((B * D * H * W, O), dtype=torch.float32)
    for dx in range(3):
        cols = torch.cat([xp[:, dz:dz + D, dy:dy + H, dx:dx + W]
                          .reshape(-1, C)
                          for dz in range(3) for dy in range(3)], 1)
        wg = w8p[:, dx * 9 * C:(dx + 1) * 9 * C].double()
        bounds = np.linspace(0, 9 * C, slices + 1).astype(int)
        s = torch.zeros((B * D * H * W, O), dtype=torch.int64)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            part = (cols[:, lo:hi] @ wg[:, lo:hi].t()).round().long()
            assert part.abs().max() < 2 ** 31
            s += part
        total = total + s.to(torch.float32) * sw[dx]
    out = total + bias
    return out.reshape(B, D, H, W, O).to(torch.bfloat16)


@pytest.mark.parametrize("shape,slices", [
    ((2, 3, 4, 8, 64, 32), 1), ((2, 3, 4, 8, 64, 32), 4),
    ((1, 3, 3, 8, 1152, 32), 3),       # group sums past 2^24
    ((2, 2, 4, 8, 96, 64), 7)])
def test_k7_accumulation_order_is_bit_equal_to_plain(shape, slices):
    B, D, H, W, C, O = shape
    x, w = _case(B, D, H, W, C, O, seed=C + slices)
    bias = torch.from_numpy(np.random.default_rng(slices).standard_normal(
        O).astype(np.float32))
    x8, w8, sw = quantize_for_conv(x, w.to(torch.bfloat16))
    if C == 1152:   # near-saturated integer sums, past f32's exact range
        x8 = torch.full_like(x8, 127)
        x8[..., ::7] = -113
        w8 = torch.full_like(w8, 127)
        w8[:, ::5] = 101
    ref = conv3x3x3_int8_plain(x8, w8, sw, bias, torch.bfloat16)
    got = _k7_model(x8, pack_int8_weight(w8), sw, bias, slices)
    assert torch.equal(got, ref)


def test_int8_scales_are_true_divisions(monkeypatch):
    """The int8 scales are max(amax, 1e-8) / 127 as the reference divides,
    not products with the rounded reciprocal of 127, which is what PyTorch
    computes on the card for a Python-scalar divisor and which differs in
    the last bit for some values (so the card's int8 operands differed from
    the reference's): ``amax_scale`` equals the correctly rounded quotient,
    and every int8 quantizer of the port takes its scales from it."""
    a = torch.rand(100_000, generator=torch.Generator().manual_seed(0)) * 9
    true = (a.double() / 127.0).float()
    assert torch.equal(quant.amax_scale(a), true)
    reciprocal = a * (torch.tensor(1.0) / 127.0)
    assert not torch.equal(reciprocal, true)
    calls = []

    def recorded(amax):
        calls.append(tuple(amax.shape))
        return quant.amax_scale(amax)
    monkeypatch.setattr(dense_conv, "amax_scale", recorded)
    monkeypatch.setattr(flash_attention, "amax_scale", recorded)
    x, w = _case(1, 2, 3, 8, 32, 32, seed=9)
    quantize_for_conv(x, w)
    amax = int8_conv_amax_plain(x)
    int8_conv_quantize_x_plain(x, amax)
    int8_conv_quantize_w_plain(w, amax)
    q = torch.randn((2, 256, 8), generator=torch.Generator().manual_seed(1))
    flash_attention.block_quantize(q, 128)
    flash_attention.channel_quantize(q)
    assert calls == [(32,), (32, 3), (32,), (32,), (32, 3), (2, 2), (2, 8)]
