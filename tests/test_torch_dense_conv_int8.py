"""Port parity: the int8 serving conv of ``infinicube_tpu_torch.ops.
dense_conv`` (its quantization, the rule that decides which convs are int8,
the plain version of K7 and the module's routing) against the JAX op, whose
int8 path is its Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.ops.dense_conv import _quantize_for_conv
from infinicube_tpu.ops.dense_conv import conv3x3x3 as jax_conv3x3x3
from infinicube_tpu.ops.dense_conv import conv_plan_feasible
from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.models.diffusion.model import DiffusionConfig
from infinicube_tpu_torch.ops.dense_conv import (Conv3x3x3, conv3x3x3_plain,
                                                 conv3x3x3_int8_plain,
                                                 int8_conv_applies,
                                                 pack_int8_weight,
                                                 quantize_for_conv)


def release_conv_shapes(ch=192, mult=(1, 2, 4, 4), n_res=2, cube=64,
                        in_ch=16):
    """(cube edge, C, O) of the release UNet's 48 Conv3x3x3 calls, in call
    order (in_conv, the down path, the middle, the up path with up{l})."""
    shapes, skips, c, s = [(cube, in_ch, ch)], [ch], ch, cube
    for level, m in enumerate(mult):
        for _ in range(n_res):
            shapes += [(s, c, m * ch), (s, m * ch, m * ch)]
            c = m * ch
            skips.append(c)
        if level != len(mult) - 1:
            s //= 2
            skips.append(c)
    shapes += [(s, c, c)] * 4
    for level, m in reversed(list(enumerate(mult))):
        for _ in range(n_res + 1):
            shapes += [(s, c + skips.pop(), m * ch), (s, m * ch, m * ch)]
            c = m * ch
        if level:
            s *= 2
            shapes.append((s, c, c))
    return shapes


def _case(shape, seed=0, dtype=np.float32):
    """x with a different range in every input channel (so a wrong channel
    scale shows) and one all-zero channel (the 1e-8 floor)."""
    B, D, H, W, C, O = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D, H, W, C)) * np.geomspace(0.05, 5.0, C)
    x[..., 3] = 0.0
    w = rng.standard_normal((3, 3, 3, C, O)) / np.sqrt(27 * C)
    b = 0.1 * rng.standard_normal(O)
    return (x.astype(np.float32), w.astype(np.float32), b.astype(np.float32))


def _torch_w(w):
    return torch.from_numpy(w).permute(4, 3, 0, 1, 2)      # DHWIO -> OIDHW


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_for_conv_equals_reference(dtype):
    """Same x8, w8 and sw, bit for bit, from f32 and from bf16 inputs."""
    x, w, _ = _case((2, 3, 4, 8, 16, 24), seed=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x8r, w8r, swr = _quantize_for_conv(jnp.asarray(x, jdt),
                                       jnp.asarray(w, jdt))
    xt = torch.from_numpy(x).to(dtype)
    x8, w8, sw = quantize_for_conv(xt, _torch_w(w).to(dtype))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(x8r))
    np.testing.assert_array_equal(w8.permute(2, 3, 4, 1, 0).numpy(),
                                  np.asarray(w8r))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(swr))
    assert sw.shape == (3, 24) and (x8[..., 3] == 0).all()


@pytest.mark.parametrize("batch", [1, 2])
def test_int8_rule_matches_reference_on_the_release_unet(batch):
    """The reference's plan predicate on all 48 convs of the release UNet
    (23 int8: every 64^3 and 32^3 conv but in_conv, and 16^3 384 -> 768)."""
    shapes = release_conv_shapes()
    assert len(shapes) == 48
    got = [int8_conv_applies((batch, s, s, s), C, O) for s, C, O in shapes]
    ref = [conv_plan_feasible((batch, s, s, s), C, O, jnp.bfloat16,
                              quant=True) is not None for s, C, O in shapes]
    assert got == ref and sum(got) == 23
    int8 = sorted({(s, C, O) for (s, C, O), q in zip(shapes, got) if q})
    assert int8 == [(16, 384, 768), (32, 192, 384), (32, 384, 384),
                    (32, 576, 384), (32, 768, 384), (32, 768, 768),
                    (32, 1152, 384), (64, 192, 192), (64, 384, 192),
                    (64, 384, 384), (64, 576, 192)]


@pytest.mark.parametrize("batch", [1, 2])
def test_int8_rule_matches_reference_on_the_alt_conditioned_unet(batch):
    """The release UNet with every alternative condition on: in_conv takes
    the latent, the 16 release condition channels and the extra cube's 24
    (40 in all); the reference's plan predicate decides all 48 convs as the
    port's rule does, and the int8 set stays the release one (23; in_conv
    bf16)."""
    cfg = DiffusionConfig(use_semantic_cond=True, use_single_scan_cond=True,
                          use_image_cond="lss", num_classes=10,
                          context_dim=768)
    in_ch = cfg.latent_channels + cfg.cond_channels
    assert in_ch == 40
    shapes = release_conv_shapes(in_ch=in_ch)
    got = [int8_conv_applies((batch, s, s, s), C, O) for s, C, O in shapes]
    ref = [conv_plan_feasible((batch, s, s, s), C, O, jnp.bfloat16,
                              quant=True) is not None for s, C, O in shapes]
    assert got == ref and sum(got) == 23 and not got[0]


@pytest.mark.parametrize("shape", [(1, 4, 8, 16, 64, 64),
                                   (2, 3, 4, 32, 64, 128),
                                   (1, 4, 4, 4, 64, 64),
                                   (1, 8, 8, 8, 32, 64),
                                   (1, 8, 16, 8, 96, 64)])
def test_int8_rule_matches_reference_on_test_shapes(shape):
    B, D, H, W, C, O = shape
    assert int8_conv_applies((B, D, H, W), C, O) == \
        (conv_plan_feasible((B, D, H, W), C, O, jnp.float32, quant=True)
         is not None)


@pytest.mark.parametrize("shape", [(1, 4, 8, 16, 64, 64),
                                   (2, 3, 4, 32, 128, 64)])
def test_int8_plain_matches_the_pallas_kernel(shape):
    """bf16 in, bf16 out, the int8 integer sums exact on both sides: the
    outputs agree to one bf16 ulp (the f32 dequantized sums may differ in
    their last bit before the cast)."""
    x, w, b = _case(shape, seed=2)
    B, D, H, W, C, O = shape
    plan = conv_plan_feasible((B, D, H, W), C, O, jnp.bfloat16, quant=True)
    assert plan is not None
    ref = np.asarray(jax_conv3x3x3(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b), plan, True, True).astype(jnp.float32))
    x8, w8, sw = quantize_for_conv(torch.from_numpy(x).to(torch.bfloat16),
                                   _torch_w(w).to(torch.bfloat16))
    out = conv3x3x3_int8_plain(x8, w8, sw, torch.from_numpy(b),
                               torch.bfloat16).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(out - ref) <= ulp)
    assert np.mean(out == ref) > 0.99


def test_int8_plain_sums_exactly_above_two_to_the_24():
    """A dx group of 9 * 1,536 products of 127 * 127 sums to 2.2e8, past
    f32's exact integers: the plain version still gets the exact sum
    (rounded once to f32, as the reference's int32 -> f32)."""
    C, O = 1536, 32
    x8 = torch.full((1, 3, 3, 8, C), 127, dtype=torch.int8)
    x8[..., ::7] = -113
    w8 = torch.full((O, C, 3, 3, 3), 127, dtype=torch.int8)
    w8[:, ::5] = 101
    sw = torch.ones((3, O))
    out = conv3x3x3_int8_plain(x8, w8, sw, torch.zeros(O), torch.float32)
    # the centre voxel sees all 27 taps; the exact sum per dx group in int64
    group = (x8[0, 0, 0, 0].long() * w8[0, :, 0, 0, 0].long()).sum() * 9
    assert abs(int(group)) > 2 ** 24
    assert out[0, 1, 1, 1, 0].item() == np.float32(
        np.float32(np.float32(group) + np.float32(group)) +
        np.float32(group))


def test_packed_int8_weight_is_dx_major():
    w8 = torch.arange(2 * 3 * 27, dtype=torch.int8).reshape(2, 3, 3, 3, 3)
    p = pack_int8_weight(w8)
    assert p.shape == (2, 81) and p.dtype == torch.int8
    for dx in range(3):
        for dz in range(3):
            for dy in range(3):
                k = (dx * 9 + dz * 3 + dy) * 3
                assert torch.equal(p[:, k:k + 3], w8[:, :, dz, dy, dx])


def test_module_takes_int8_only_where_the_rule_holds():
    """Conv3x3x3(quant=True): the int8 plain version where
    int8_conv_applies holds, the full-precision one elsewhere (C = 16, or a
    4^3 cube); no kernel on CPU tensors."""
    torch.manual_seed(0)
    for shape in [(1, 4, 8, 16, 64, 64), (1, 4, 8, 16, 16, 64),
                  (1, 4, 4, 4, 64, 64)]:
        B, D, H, W, C, O = shape
        x = torch.randn((B, D, H, W, C)).to(torch.bfloat16)
        m = Conv3x3x3(C, O, dtype=torch.bfloat16, quant=True)
        m.reset_parameters(torch.Generator().manual_seed(1))
        with torch.no_grad():
            m.bias.normal_()
            out = m(x)
        wq = m.weight.to(torch.bfloat16)
        bias = m.bias.to(torch.bfloat16).float()
        if int8_conv_applies((B, D, H, W), C, O):
            ref = conv3x3x3_int8_plain(*quantize_for_conv(x, wq), bias,
                                       torch.bfloat16)
            assert shape == (1, 4, 8, 16, 64, 64)
        else:
            ref = conv3x3x3_plain(x, wq, bias)
        assert torch.equal(out, ref)
    assert all(v == 0 for v in kernels.launches.values())


def test_int8_conv_serves_only():
    x = torch.randn((1, 4, 8, 16, 64), requires_grad=True)
    m = Conv3x3x3(64, 64, quant=True)
    m.reset_parameters(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="serves only"):
        m(x)
