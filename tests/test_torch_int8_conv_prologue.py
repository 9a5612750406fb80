"""Port parity: the operands of the int8 dense conv (K7) as the card's
quantize-prologue kernels write them, through their plain versions on the
CPU (``int8_conv_operands``: x8 at the width padded to 32, the dx-major
padded weight pack and the padded scales), against the JAX package's
``_quantize_for_conv`` repacked; and a model of K7's accumulation order
(int32 partial sums of any K split, added as integers, each dx group
scaled and added t0, t1, t2) against ``conv3x3x3_int8_plain``, bit for
bit. Nothing here runs the JAX side's Pallas kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    ((2, 2, 3, 8, 40, 72), 1.0)])     # 8 mod 32: padded to 64 -> 96
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
