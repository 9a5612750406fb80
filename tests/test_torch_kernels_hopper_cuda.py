"""The edges of the wgmma / TMA kernels (K3 with its split K, K2, K1, K5,
K7 with its split K and its quantize prologue, K4 and K6, the f32 conv and
the f32 attention on 3xTF32, K8), of the widths and dtypes the card's dense
conv serves, against their plain PyTorch versions on the card. Needs an NVIDIA
GPU and skips without one; imports no JAX (the card's machine has none):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_hopper_cuda.py -m cuda -q
"""

import math

import pytest
import torch

from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.models.diffusion.unet3d import UNet3D
from infinicube_tpu_torch.ops.attention import (attention_bwd_plain,
                                                attention_delta,
                                                attention_plain,
                                                multi_head_attention)
from infinicube_tpu_torch.ops.flash_attention import (block_quantize,
                                                      channel_quantize,
                                                      fold_heads,
                                                      int8qk_attention_plain,
                                                      int8qkv_attention_plain,
                                                      mha_quantized,
                                                      pack_v8, quant_blocks)
from infinicube_tpu_torch.grid.build import grid_from_ijk
from infinicube_tpu_torch.nn.sparse import conv_plan
from infinicube_tpu_torch.ops.dense_conv import (K7_MULTIPLE, Conv3x3x3,
                                                 conv3x3x3,
                                                 conv3x3x3_bwd_plain,
                                                 conv3x3x3_int8_plain,
                                                 conv3x3x3_plain,
                                                 dgrad_weight,
                                                 int8_conv_amax_plain,
                                                 int8_conv_quantize_w_plain,
                                                 int8_conv_quantize_x_plain,
                                                 pack_conv_weight,
                                                 pack_int8_weight,
                                                 pad_channels,
                                                 quantize_for_conv)
from infinicube_tpu_torch.ops.window_conv import (ConvPlan,
                                                  pack_sparse_weight,
                                                  rev_w,
                                                  sparse_conv_bwd_plain,
                                                  sparse_conv_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(shape, g, dtype=torch.bfloat16):
    return torch.randn(shape, generator=g, device="cuda", dtype=dtype)


def _gate(got, ref, rel=2e-2):
    """K3's gate: cosine >= 0.9999 and max-abs <= rel * max|ref|."""
    got, ref = got.double().flatten(), ref.double().flatten()
    cos = float(got @ ref / (got.norm() * ref.norm() + 1e-30))
    assert cos >= 0.9999
    assert (got - ref).abs().max().item() <= rel * ref.abs().max().item()


def _conv_case(g, B, D, H, W, C, O):
    x = _rand((B, D, H, W, C), g)
    w = (_rand((O, C, 3, 3, 3), g).float() / (27 * C) ** 0.5).to(
        torch.bfloat16)
    b = torch.randn(O, generator=g, device="cuda")
    return x, w, b


def _splits(shape, O):
    B, D, H, W, C = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return kernels.k3_splits(B, D, H, W, C, O, sms)


@pytest.mark.parametrize("shape", [
    (2, 5, 7, 9, 64, 72),       # M not a multiple of the 128-voxel patch
    (1, 6, 6, 6, 8, 8), (1, 6, 6, 6, 16, 24), (2, 5, 7, 9, 24, 8),
    (1, 12, 20, 24, 16, 192),   # in_conv's widths, 16-channel boxes
    (1, 8, 8, 8, 1536, 768),    # split K at 8^3
    (1, 4, 4, 4, 1536, 768),    # split K at 4^3
    (2, 3, 17, 33, 96, 384)])   # two N tiles of 192, ragged patches
def test_k3_forward_and_dgrad_at_the_edges(gen, shape):
    """K3 forward and as dgrad (the flipped, swapped pack, no bias) against
    the plain conv; the split-K shapes twice, bit-identical."""
    B, D, H, W, C, O = shape
    x, w, b = _conv_case(gen, B, D, H, W, C, O)
    wp = pack_conv_weight(w)
    before = dict(kernels.launches)
    got = kernels.conv3x3x3_bf16(x, wp, b)
    assert kernels.launches["conv3x3x3_bf16"] == \
        before["conv3x3x3_bf16"] + 1
    _gate(got, conv3x3x3_plain(x, w, b))
    go = _rand((B, D, H, W, O), gen)
    wd = pack_conv_weight(dgrad_weight(w))
    dx = kernels.conv3x3x3_bf16(go, wd, None)
    assert kernels.launches[kernels.K3_DGRAD] == before[kernels.K3_DGRAD] + 1
    _gate(dx, conv3x3x3_bwd_plain(x, w, go)[0])
    if _splits(x.shape, O) > 1 or _splits(go.shape, C) > 1:
        assert torch.equal(got, kernels.conv3x3x3_bf16(x, wp, b))
        assert torch.equal(dx, kernels.conv3x3x3_bf16(go, wd, None))


def test_k3_splits_where_the_tiles_are_few(gen):
    """The release 8^3 and 16^3 convs split their K range; 64^3 does not."""
    assert _splits((1, 8, 8, 8, 1536), 768) > 1
    assert _splits((1, 16, 16, 16, 1536), 768) > 1
    assert _splits((1, 64, 64, 64, 192), 192) == 1


@pytest.mark.parametrize("C,O", [(12, 20), (3, 8), (8, 5), (130, 66)])
def test_card_conv_pads_widths_that_are_not_multiples_of_8(gen, C, O):
    """Through ``Conv3x3x3`` (bf16): forward and the input gradient."""
    m = Conv3x3x3(C, O, dtype=torch.bfloat16, device="cuda")
    m.reset_parameters(gen)
    m.requires_grad_(False)
    x = _rand((2, 5, 6, 7, C), gen).requires_grad_()
    out = m(x)
    g = _rand(out.shape, gen)
    out.backward(g)
    wb = m.weight.to(torch.bfloat16)
    assert out.shape == (2, 5, 6, 7, O)
    _gate(out, conv3x3x3_plain(x.detach(), wb, m.bias))
    _gate(x.grad, conv3x3x3_bwd_plain(x.detach(), wb, g)[0])


@pytest.mark.parametrize("shape", [(2, 5, 7, 9, 12, 20),
                                   (1, 16, 16, 16, 64, 72),
                                   (1, 8, 8, 8, 192, 16)])
def test_f32_conv_matches_plain(gen, shape):
    """conv3x3x3_f32 forward and dgrad against the plain f32 conv (TF32
    off): max-abs <= 1e-4 * max|ref|, the operands zero-padded to multiples
    of 8 as the card's route pads them; and the f32 module on the card, with
    its gradients, counted under conv3x3x3_f32."""
    B, D, H, W, C, O = shape
    x = _rand((B, D, H, W, C), gen, torch.float32)
    w = _rand((O, C, 3, 3, 3), gen, torch.float32) / (27 * C) ** 0.5
    b = _rand((O,), gen, torch.float32)
    before = kernels.launches["conv3x3x3_f32"]
    got = kernels.conv3x3x3_f32(pad_channels(x, 8, -1).contiguous(),
                                pack_conv_weight(w, torch.float32),
                                pad_channels(b, 8, 0))[..., :O]
    ref = conv3x3x3_plain(x, w, b)
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    go = _rand((B, D, H, W, O), gen, torch.float32)
    dx = kernels.conv3x3x3_f32(
        pad_channels(go, 8, -1).contiguous(),
        pack_conv_weight(dgrad_weight(w), torch.float32), None)[..., :C]
    ref_dx = conv3x3x3_bwd_plain(x, w, go)[0]
    assert (dx - ref_dx).abs().max().item() <= \
        1e-4 * ref_dx.abs().max().item()
    assert kernels.launches["conv3x3x3_f32"] == before + 2
    m = Conv3x3x3(C, O, dtype=torch.float32, device="cuda")
    m.reset_parameters(gen)
    xg = x.clone().requires_grad_()
    out = m(xg)
    out.backward(go)
    assert kernels.launches["conv3x3x3_f32"] == before + 4
    ref_dx, ref_dw, ref_db = conv3x3x3_bwd_plain(x, m.weight.detach(), go)
    torch.testing.assert_close(out, conv3x3x3_plain(x, m.weight.detach(),
                                                    m.bias.detach()),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(xg.grad, ref_dx, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(m.weight.grad, ref_dw, atol=1e-3, rtol=1e-4)


def _f32_conv_gate(got, ref):
    """The f32 conv's gate: max-abs <= 1e-4 * max|ref|."""
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def _f32_splits(shape, O):
    B, D, H, W, C = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return kernels.f32_conv_splits(B, D, H, W, C, O, sms)


# the release UNet's six conv shapes with their cubes scaled down 4x (64^3
# -> 16^3, 32^3 -> 8^3, 16^3 and 8^3 -> 4^3), at their widths
F32_SCALED = ((16, 16, 192), (16, 192, 192), (16, 384, 384), (8, 1152, 384),
              (4, 1536, 768), (4, 1536, 768))


@pytest.mark.parametrize("n,C,O", sorted(set(F32_SCALED)))
def test_f32_conv_at_the_unet_shapes(gen, n, C, O):
    """The 3xTF32 conv forward and dgrad at the UNet's widths against the
    plain f32 conv (TF32 off); where K is split, two runs bit-identical."""
    x = _rand((1, n, n, n, C), gen, torch.float32)
    w = _rand((O, C, 3, 3, 3), gen, torch.float32) / (27 * C) ** 0.5
    b = _rand((O,), gen, torch.float32)
    wp = pack_conv_weight(w, torch.float32)
    got = kernels.conv3x3x3_f32(x, wp, b)
    _f32_conv_gate(got, conv3x3x3_plain(x, w, b))
    go = _rand((1, n, n, n, O), gen, torch.float32)
    wd = pack_conv_weight(dgrad_weight(w), torch.float32)
    dx = kernels.conv3x3x3_f32(go, wd, None)
    _f32_conv_gate(dx, conv3x3x3_bwd_plain(x, w, go)[0])
    if _f32_splits(x.shape, O) > 1:
        assert torch.equal(got, kernels.conv3x3x3_f32(x, wp, b))
    if _f32_splits(go.shape, C) > 1:
        assert torch.equal(dx, kernels.conv3x3x3_f32(go, wd, None))


def test_f32_conv_splits_where_the_tiles_are_few(gen):
    """The small-M shapes split K (so the bit-identity above is tested);
    64^3 does not."""
    assert _f32_splits((1, 4, 4, 4, 1536), 768) > 1
    assert _f32_splits((1, 8, 8, 8, 1536), 768) > 1
    assert _f32_splits((1, 64, 64, 64, 192), 192) == 1


def test_f32_kernels_refuse_what_they_do_not_take(gen):
    """The f32 conv takes C, O multiples of 8 and the [2, O, 27*C] pack of
    tf32 parts; the f32 attention f32 q, k, v with d in {64, 96, 128}."""
    x = _rand((1, 4, 4, 4, 12), gen, torch.float32)
    with pytest.raises(ValueError):            # C not a multiple of 8
        kernels.conv3x3x3_f32(x, _rand((2, 16, 27 * 12), gen, torch.float32),
                              None)
    x = _rand((1, 4, 4, 4, 16), gen, torch.float32)
    with pytest.raises(ValueError):            # K3's pack, not hi and lo
        kernels.conv3x3x3_f32(x, _rand((16, 27 * 16), gen, torch.float32),
                              None)
    q = _rand((1, 64, 2, 64), gen)
    with pytest.raises(ValueError):            # bf16, not f32
        kernels.flash_attn_f32(q, q, q, 0.1)
    q = _rand((1, 64, 2, 80), gen, torch.float32)
    with pytest.raises(ValueError):            # head dim 80
        kernels.flash_attn_f32(q, q, q, 0.1)


@pytest.mark.parametrize("C,O", [(20, 36), (16, 1), (3, 8)])
def test_f32_conv_pads_widths_that_are_not_multiples_of_8(gen, C, O):
    """Through ``Conv3x3x3`` in f32 on a 16^3 cube: forward and the input
    gradient, through the padding to multiples of 8."""
    m = Conv3x3x3(C, O, dtype=torch.float32, device="cuda")
    m.reset_parameters(gen)
    with torch.no_grad():
        m.bias.normal_(generator=gen)
    m.requires_grad_(False)
    x = _rand((1, 16, 16, 16, C), gen, torch.float32).requires_grad_()
    before = kernels.launches["conv3x3x3_f32"]
    out = m(x)
    g = _rand(out.shape, gen, torch.float32)
    out.backward(g)
    assert kernels.launches["conv3x3x3_f32"] == before + 2
    assert out.shape == (1, 16, 16, 16, O)
    _f32_conv_gate(out, conv3x3x3_plain(x.detach(), m.weight, m.bias))
    _f32_conv_gate(x.grad, conv3x3x3_bwd_plain(x.detach(), m.weight, g)[0])


@pytest.mark.parametrize("C,O", [(64, 72), (72, 104)])
def test_k7_serves_widths_that_are_not_multiples_of_32(gen, C, O):
    """The int8 conv at 16^3 through the padded K7: equal to the unpadded
    plain int8 conv."""
    x = (torch.randn((1, 16, 16, 16, C), generator=gen, device="cuda") *
         torch.logspace(-1, 1, C, device="cuda")).to(torch.bfloat16)
    w = (_rand((O, C, 3, 3, 3), gen).float() / (27 * C) ** 0.5).to(
        torch.bfloat16)
    b = 0.1 * torch.randn(O, generator=gen, device="cuda")
    before = kernels.launches["conv3x3x3_int8"]
    with torch.no_grad():
        got = conv3x3x3(x, w, b, quant=True)
    assert kernels.launches["conv3x3x3_int8"] == before + 1
    x8, w8, sw = quantize_for_conv(x, w)
    assert got.shape == (1, 16, 16, 16, O)
    assert torch.equal(got, conv3x3x3_int8_plain(x8, w8, sw, b,
                                                 torch.bfloat16))


def _k2_gate(got, ref):
    got, ref = got.double().flatten(), ref.double().flatten()
    cos = float(got @ ref / (got.norm() * ref.norm() + 1e-30))
    assert cos >= 0.9999
    assert (got - ref).abs().max().item() <= \
        2e-2 * min(1.0, ref.abs().max().item())


@pytest.mark.parametrize("nq,nk,h,d", [
    (200, 77, 3, 64), (129, 128, 2, 96), (4096, 4096, 8, 96),
    (512, 512, 8, 96), (300, 1000, 2, 128), (1, 5, 1, 64),
    (1000, 129, 4, 128), (127, 300, 2, 96)])
def test_k2_at_the_edges(gen, nq, nk, h, d):
    """Nq not a multiple of 128, Nk not a multiple of the 128-key tile or
    smaller than it, every head dim; with and without the lse store."""
    q, k, v = _rand((2, nq, h, d), gen), _rand((2, nk, h, d), gen), \
        _rand((2, nk, h, d), gen)
    o, lse = kernels.flash_attn_bf16(q, k, v, d ** -0.5, return_lse=True)
    ref_o, ref_lse = attention_plain(q.float(), k.float(), v.float(),
                                     d ** -0.5, return_lse=True)
    _k2_gate(o, ref_o)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert torch.equal(o, kernels.flash_attn_bf16(q, k, v, d ** -0.5))


@pytest.mark.parametrize("d", [64, 96, 128])
def test_k2_takes_strided_views(gen, d):
    """q, k, v as views into fused projections ([B, N, 3, h, d] and a
    [B, N, 2*h*d] kv), as the models pass them: the same output as from
    contiguous copies."""
    h = 4
    qkv = _rand((2, 300, 3, h, d), gen)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = multi_head_attention(q, k, v)
    ref = multi_head_attention(q.contiguous(), k.contiguous(),
                               v.contiguous())
    assert torch.equal(out, ref)
    _k2_gate(out, attention_plain(q.float(), k.float(), v.float(),
                                  d ** -0.5))
    kv = _rand((2, 77, 2 * h * d), gen)
    k, v = (t.reshape(2, 77, h, d) for t in kv.chunk(2, dim=-1))
    q = _rand((2, 200, h, d), gen)
    assert torch.equal(multi_head_attention(q, k, v),
                       multi_head_attention(q, k.contiguous(),
                                            v.contiguous()))


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def _scale_blocks(x, block, lo, hi):
    """Each block of rows (dim 1) times its own factor, lo to hi, so that
    every quantization block of q and of k gets a different scale."""
    n = x.shape[1]
    f = torch.logspace(math.log10(lo), math.log10(hi), -(-n // block),
                       device=x.device)
    return x * f.repeat_interleave(block)[:n, None, None].to(x.dtype)


@pytest.mark.parametrize("B,n,h,d", [
    (1, 1000, 3, 128),   # N not a multiple of the 128-row tiles
    (2, 128, 2, 64),     # one tile, N = 128
    (1, 77, 2, 128),     # N < 128
    (1, 1, 1, 64),       # a single token
    (1, 3000, 2, 64),    # two 1,536-row blocks, distinct scales, d = 64
    (1, 4700, 2, 128),   # four blocks, the last one ragged
    (2, 1537, 1, 128)])  # one row past the first block
def test_k1_at_the_edges(gen, B, n, h, d):
    """K1 on wgmma against ``int8qk_attention_plain`` on the same int8
    inputs, every block of q and k at its own scale (0.25 to 4): the int8
    gate, cosine >= 0.999; one launch; two runs bit-identical."""
    block, npad = quant_blocks(n)
    assert block % 128 == 0
    q = _scale_blocks(_rand((B, n, h, d), gen), block, 0.25, 4.0)
    k = _scale_blocks(_rand((B, n, h, d), gen), block, 4.0, 0.25)
    v = _rand((B, n, h, d), gen)
    before = kernels.launches["flash_attn_int8qk"]
    out = mha_quantized(q, k, v)
    assert kernels.launches["flash_attn_int8qk"] == before + 1
    q8, sq = block_quantize(fold_heads(q, npad), block)
    k8, sk = block_quantize(fold_heads(k, npad), block)
    ref = int8qk_attention_plain(q8, k8, sq, sk, v, block, d ** -0.5)
    assert out.shape == (B, n, h, d) and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    assert _cos(out, ref) >= 0.999
    assert torch.equal(out, mha_quantized(q, k, v))


def _k5_case(gen, nq, nk, h, d, fused):
    """q, k, v, dO; with ``fused`` q, k, v are views of one [B, N, 3, h, d]
    projection (Nq = Nk), as SelfAttention3D passes them."""
    if fused:
        qkv = _rand((2, nq, 3, h, d), gen)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = (_rand((2, n, h, d), gen) for n in (nq, nk, nk))
    return q, k, v, _rand((2, nq, h, d), gen)


@pytest.mark.parametrize("nq,nk,h,d,fused", [
    (1000, 777, 3, 128, False),  # Nq != Nk, neither a multiple of 64
    (777, 1000, 3, 96, False),
    (300, 300, 4, 96, True),     # strided views of a fused projection
    (129, 65, 2, 64, False),     # one row / key past a tile
    (64, 200, 2, 128, False),
    (1, 5, 1, 64, False),
    (4096, 4096, 8, 96, True),   # the UNet's shapes
    (512, 512, 8, 96, True)])
def test_k5_at_the_edges(gen, nq, nk, h, d, fused):
    """K5 on wgmma against ``attention_bwd_plain`` on the plain f32 output
    and lse (nothing taken from K2): cosine >= 0.9999 and max-abs <= 2e-2 *
    max|ref| on dq, dk and dv; one launch; two runs bit-identical."""
    q, k, v, do = _k5_case(gen, nq, nk, h, d, fused)
    scale = d ** -0.5
    ref_o, ref_lse = attention_plain(q.float(), k.float(), v.float(), scale,
                                     return_lse=True)
    delta = attention_delta(ref_o, do)
    before = kernels.launches["flash_attn_bf16_bwd"]
    got = kernels.flash_attn_bf16_bwd(q, k, v, do, ref_lse, delta, scale)
    assert kernels.launches["flash_attn_bf16_bwd"] == before + 1
    ref = attention_bwd_plain(q.float(), k.float(), v.float(), ref_o,
                              do.float(), ref_lse, scale)
    for a, b, x in zip(got, ref, (q, k, v)):
        assert a.shape == x.shape and a.dtype == torch.bfloat16
        assert torch.isfinite(a).all()
        _gate(a, b)
    again = kernels.flash_attn_bf16_bwd(q, k, v, do, ref_lse, delta, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _f32_gate(got, ref):
    """``flash_attn_f32``'s gate, as ``conv3x3x3_f32``'s: max-abs <= 1e-4 *
    max|ref| against the plain f32 attention."""
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.parametrize("nq,nk,h,d", [
    (4096, 4096, 8, 96), (512, 512, 8, 96),   # the UNet's SelfAttention3D
    (5280, 5280, 4, 64),                      # the GSM pixel branch's
    (300, 77, 3, 64), (1, 5, 1, 64), (1000, 512, 2, 128), (65, 129, 2, 96),
    (200, 1003, 2, 128), (129, 37, 1, 96)])
def test_f32_attention_matches_plain(gen, nq, nk, h, d):
    """``flash_attn_f32`` against ``attention_plain`` in f32 (TF32 off),
    Nq != Nk and every head dim, through ``multi_head_attention``."""
    q, k, v = (_rand((2, n, h, d), gen, torch.float32) for n in (nq, nk, nk))
    before = dict(kernels.launches)
    with torch.no_grad():
        out = multi_head_attention(q, k, v)
    assert kernels.launches["flash_attn_f32"] == \
        before["flash_attn_f32"] + 1
    assert kernels.launches["flash_attn_bf16"] == before["flash_attn_bf16"]
    _f32_gate(out, attention_plain(q, k, v, d ** -0.5))


def test_f32_attention_split_keys_is_reproducible(gen):
    """At the UNet's N = 512 with 8 heads the keys are split into ranges
    (32 query tiles for 132 SMs) and merged in a fixed order: within the
    gate, and two runs bit-identical."""
    q, k, v = (_rand((1, 512, 8, 96), gen, torch.float32) for _ in range(3))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert kernels.f32_attn_splits(1, 8, 512, 512, 96, sms) > 1
    out = kernels.flash_attn_f32(q, k, v, 96 ** -0.5)
    _f32_gate(out, attention_plain(q, k, v, 96 ** -0.5))
    assert torch.equal(out, kernels.flash_attn_f32(q, k, v, 96 ** -0.5))


def test_f32_attention_takes_strided_views(gen):
    """q, k, v as views of a fused [B, N, 3, h, d] f32 projection: the same
    output as from contiguous copies."""
    qkv = _rand((2, 300, 3, 4, 96), gen, torch.float32)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    with torch.no_grad():
        out = multi_head_attention(q, k, v)
        ref = multi_head_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous())
    assert torch.equal(out, ref)
    _f32_gate(out, attention_plain(q, k, v, 96 ** -0.5))


def test_f32_attention_with_a_gradient_raises(gen):
    """An f32 call on the card that needs a gradient launches
    ``flash_attn_f32`` and, in the backward, ``flash_attn_f32_bwd`` once
    each, and its gradients are the plain attention's within the f32 gate;
    other dtypes raise as before."""
    leaves = [_rand((1, 64, 2, 64), gen, torch.float32).requires_grad_()
              for _ in range(3)]
    do = _rand((1, 64, 2, 64), gen, torch.float32)
    before = dict(kernels.launches)
    multi_head_attention(*leaves).backward(do)
    assert kernels.launches["flash_attn_f32"] == \
        before["flash_attn_f32"] + 1
    assert kernels.launches["flash_attn_f32_bwd"] == \
        before["flash_attn_f32_bwd"] + 1
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    attention_plain(*plain, 64 ** -0.5).backward(do)
    for got, want in zip(leaves, plain):
        _f32_gate(got.grad, want.grad)
    x = _rand((1, 64, 2, 64), gen, torch.float16)
    with pytest.raises(ValueError):
        multi_head_attention(x, x, x)


@pytest.mark.parametrize("nq,nk,h,d", [(300, 200, 2, 64), (77, 130, 1, 96),
                                       (1000, 777, 4, 128), (5, 9, 1, 64)])
def test_f32_bwd_ranges_where_items_are_few(gen, nq, nk, h, d):
    """``flash_attn_f32_bwd`` where its 64-row items are fewer than the SMs,
    so each pass splits its streamed axis into ranges added in order
    (``f32_bwd_splits``), Nq != Nk off the tiles: dq, dk and dv within
    1e-4 * max|ref| of ``attention_bwd_plain``, two runs bit-identical."""
    q, do = (_rand((1, nq, h, d), gen, torch.float32) for _ in range(2))
    k, v = (_rand((1, nk, h, d), gen, torch.float32) for _ in range(2))
    scale = d ** -0.5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert max(kernels.f32_bwd_splits(1, h, nq, nk, d, sms, dkv)
               for dkv in (True, False)) > 1 or nq < 16
    o, lse = attention_plain(q, k, v, scale, return_lse=True)
    delta = attention_delta(o, do)
    got = kernels.flash_attn_f32_bwd(q, k, v, do, lse, delta, scale)
    ref = attention_bwd_plain(q, k, v, o, do, lse, scale)
    for a, b in zip(got, ref):
        _f32_gate(a, b)
    again = kernels.flash_attn_f32_bwd(q, k, v, do, lse, delta, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_f32_bwd_takes_strided_views(gen):
    """q, k, v and dout as views of fused projections: the gradients of
    contiguous copies, bit for bit."""
    qkv = _rand((2, 300, 3, 4, 64), gen, torch.float32)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = _rand((2, 300, 2, 4, 64), gen, torch.float32)[:, :, 1]
    o, lse = attention_plain(q, k, v, 0.125, return_lse=True)
    delta = attention_delta(o, do)
    got = kernels.flash_attn_f32_bwd(q, k, v, do, lse, delta, 0.125)
    want = kernels.flash_attn_f32_bwd(q.contiguous(), k.contiguous(),
                                      v.contiguous(), do.contiguous(), lse,
                                      delta, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_f32_unet_with_self_attention_matches_the_cpu(gen):
    """An f32 UNet with SelfAttention3D at ds 4 and 8 (d = 64) on a 16^3
    cube: the card (``conv3x3x3_f32``, ``flash_attn_f32``) against the CPU
    (plain versions), same weights: cosine >= 0.99999 and max-abs <= 1e-3 *
    max|ref|, and every attention block through the f32 kernel."""
    cfg = dict(in_channels=16, out_channels=8, model_channels=32,
               channel_mult=(1, 2, 4, 4), num_res_blocks=2,
               attention_ds=(4, 8), num_heads=2, transformer_depth=1,
               dtype=torch.float32)
    cpu = UNet3D(**cfg).eval().requires_grad_(False)
    cg = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in cpu.parameters():
            p.normal_(0.0, 0.05, generator=cg)
    card = UNet3D(**cfg, device="cuda").eval().requires_grad_(False)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((1, 16, 16, 16, 16), generator=cg)
    t = torch.tensor([500])
    before = kernels.launches["flash_attn_f32"]
    with torch.no_grad():
        ref = cpu(x, t)
        got = card(x.cuda(), t.cuda()).cpu()
    assert kernels.launches["flash_attn_f32"] == before + 10
    assert torch.isfinite(got).all()
    assert _cos(got, ref) >= 0.99999
    assert (got - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()


# K7 at the release UNet's int8 shapes at CFG batch 2 (cube edge, C, O), and
# at two widths the rule admits that K7 takes padded to 32
K7_SHAPES = ((64, 192, 192), (64, 576, 192), (32, 384, 384),
             (32, 1152, 384), (32, 768, 768), (16, 384, 768))
K7_PADDED = ((16, 64, 72), (16, 72, 104))


def _int8_case(g, B, n, C, O, cfg_ratio=1.0):
    """bf16 x with its own range in every channel (and, for a CFG pair, the
    second half scaled), the f32 weight parameter and a bias."""
    x = torch.randn((B, n, n, n, C), generator=g, device="cuda") * \
        torch.logspace(-1, 1, C, device="cuda")
    x[B // 2:] *= cfg_ratio
    w = _rand((O, C, 3, 3, 3), g, torch.float32) / (27 * C) ** 0.5
    b = 0.1 * torch.randn(O, generator=g, device="cuda")
    return x.to(torch.bfloat16), w, b


def _k7_splits(x8, O):
    B, D, H, W, C = x8.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return kernels.k7_splits(B, D, H, W, C, O, sms)


@pytest.mark.parametrize("n,C,O", K7_SHAPES + K7_PADDED)
def test_k7_is_bit_equal_to_plain(gen, n, C, O):
    """K7 (on the padded operands where C or O is not a multiple of 32)
    against conv3x3x3_int8_plain on the same int8 inputs: every output
    equal."""
    x, w, b = _int8_case(gen, 2, n, C, O)
    x8, w8, sw = quantize_for_conv(x, w.to(torch.bfloat16))
    m = K7_MULTIPLE
    got = kernels.conv3x3x3_int8(
        pad_channels(x8, m, -1).contiguous(),
        pack_int8_weight(pad_channels(w8, m, 0, 1)),
        pad_channels(sw, m, 1).contiguous(), pad_channels(b, m, 0))
    ref = conv3x3x3_int8_plain(x8, w8, sw, b, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got[..., :O], ref)


@pytest.mark.parametrize("B,n,C,O", [(2, 16, 64, 96), (1, 8, 384, 768),
                                     (2, 16, 96, 128)])
def test_k7_split_k_is_exact_and_reproducible(gen, B, n, C, O):
    """Where the tiles fall short of the SMs K7 splits each dx group's K
    range; its int32 partials are summed exactly: equal to the plain
    version, and two runs bit-identical."""
    x, w, b = _int8_case(gen, B, n, C, O)
    x8, w8, sw = quantize_for_conv(x, w.to(torch.bfloat16))
    assert _k7_splits(x8, O) > 1 and _k7_splits(x8, O) % 3 == 0
    w8p = pack_int8_weight(w8)
    one = kernels.conv3x3x3_int8(x8, w8p, sw, b)
    two = kernels.conv3x3x3_int8(x8, w8p, sw, b)
    ref = conv3x3x3_int8_plain(x8, w8, sw, b, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(one, two) and torch.equal(one, ref)


@pytest.mark.parametrize("B,n,C,O,ratio", [
    (2, 16, 192, 192, 1.0), (2, 16, 384, 768, 8.0), (2, 8, 72, 104, 0.1),
    (1, 8, 1152, 384, 1.0)])
def test_int8_prologue_is_bit_equal_to_plain(gen, B, n, C, O, ratio):
    """The three prologue kernels against their plain versions and against
    quantize_for_conv + pad_channels + pack_int8_weight, from the f32
    parameter and from its bf16 cast; a CFG pair whose halves have other
    ranges shares one scale per channel; one all-zero channel takes the
    1e-8 floor."""
    x, w, _ = _int8_case(gen, B, n, C, O, ratio)
    x[..., 1] = 0
    before = dict(kernels.launches)
    amax = kernels.int8_conv_amax(x)
    x8 = kernels.int8_conv_quantize_x(x, amax)
    w8p, sw = kernels.int8_conv_quantize_w(w, amax)
    w8p_b, sw_b = kernels.int8_conv_quantize_w(w.to(torch.bfloat16), amax)
    for name, n_calls in (("int8_conv_amax", 1), ("int8_conv_quantize_x", 1),
                          ("int8_conv_quantize_w", 2)):
        assert kernels.launches[name] == before[name] + n_calls
    ref_amax = int8_conv_amax_plain(x)
    assert torch.equal(amax, ref_amax)
    assert torch.equal(x8, int8_conv_quantize_x_plain(x, ref_amax))
    ref_w8p, ref_sw = int8_conv_quantize_w_plain(w, ref_amax)
    assert torch.equal(w8p, ref_w8p) and torch.equal(sw, ref_sw)
    assert torch.equal(w8p_b, ref_w8p) and torch.equal(sw_b, ref_sw)
    rx8, rw8, rsw = quantize_for_conv(x, w.to(torch.bfloat16))
    m = K7_MULTIPLE
    assert torch.equal(x8, pad_channels(rx8, m, -1))
    assert torch.equal(w8p, pack_int8_weight(pad_channels(rw8, m, 0, 1)))
    assert torch.equal(sw, pad_channels(rsw, m, 1))


def test_int8_prologue_wrappers_refuse_what_they_do_not_take(gen):
    x = torch.zeros((1, 4, 4, 4, 12), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):                  # C not a multiple of 8
        kernels.int8_conv_amax(x)
    x = torch.zeros((1, 4, 4, 4, 16), device="cuda")
    with pytest.raises(ValueError):                  # f32 activations
        kernels.int8_conv_amax(x)
    x = x.to(torch.bfloat16)
    amax = kernels.int8_conv_amax(x)
    with pytest.raises(ValueError):                  # amax of another width
        kernels.int8_conv_quantize_x(x, amax[:8].contiguous())
    with pytest.raises(ValueError):                  # a 1x1x1 kernel
        kernels.int8_conv_quantize_w(
            torch.zeros((32, 16, 1, 1, 1), device="cuda"), amax)
    with pytest.raises(ValueError):                  # int8 weights
        kernels.int8_conv_quantize_w(
            torch.zeros((32, 16, 3, 3, 3), dtype=torch.int8,
                        device="cuda"), amax)


# (B, D, H, W, C, O) at the edges of int8_conv_amax's plan and of the
# weight pass: one row (M = 1) at the narrowest C, row counts that are not
# multiples of a block's rows, three slabs of a row at the widest C
INT8_PROLOGUE_EDGES = ((1, 1, 1, 1, 8, 1), (1, 3, 5, 7, 192, 40),
                       (2, 5, 6, 7, 384, 40), (1, 2, 3, 5, 12288, 1),
                       (2, 16, 16, 16, 384, 768))


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,D,H,W,C,O", INT8_PROLOGUE_EDGES)
def test_int8_amax_and_weight_pass_at_the_edges(gen, B, D, H, W, C, O,
                                                w_dtype):
    """int8_conv_amax and int8_conv_quantize_w against their plain versions,
    bit for bit (amax and sw as bits), two runs bit-identical, one launch
    count a call however many CUDA kernels it runs."""
    x = (torch.randn((B, D, H, W, C), generator=gen, device="cuda") *
         torch.logspace(-1, 1, C, device="cuda")).to(torch.bfloat16)
    w = (torch.randn((O, C, 3, 3, 3), generator=gen, device="cuda") /
         (27 * C) ** 0.5).to(w_dtype)
    before = dict(kernels.launches)
    amax = kernels.int8_conv_amax(x)
    w8p, sw = kernels.int8_conv_quantize_w(w, amax)
    assert kernels.launches["int8_conv_amax"] == \
        before["int8_conv_amax"] + 1
    assert kernels.launches["int8_conv_quantize_w"] == \
        before["int8_conv_quantize_w"] + 1
    amax2 = kernels.int8_conv_amax(x)
    w8p2, sw2 = kernels.int8_conv_quantize_w(w, amax2)
    ref_amax = int8_conv_amax_plain(x)
    ref_w8p, ref_sw = int8_conv_quantize_w_plain(w, ref_amax)
    torch.cuda.synchronize()
    assert torch.equal(_bits(amax), _bits(ref_amax))
    assert torch.equal(_bits(amax2), _bits(amax))
    assert torch.equal(w8p, ref_w8p) and torch.equal(w8p2, w8p)
    assert torch.equal(_bits(sw), _bits(ref_sw))
    assert torch.equal(_bits(sw2), _bits(sw))


@pytest.mark.parametrize("C", [6, 13, 20, 300])
def test_int8_weight_pass_at_widths_that_narrow_its_loads(gen, C):
    """The weight pass at C not a multiple of 4 (f32) or 8 (bf16), where
    the rows of w do not start 16 bytes apart and the kernel takes 8-, 4-
    or 2-byte loads: bit-equal to the plain version, the padding zeros."""
    amax = torch.rand(C, generator=gen, device="cuda") * 3
    amax[1] = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        w = (torch.randn((40, C, 3, 3, 3), generator=gen, device="cuda") /
             (27 * C) ** 0.5).to(dtype)
        w8p, sw = kernels.int8_conv_quantize_w(w, amax)
        ref_w8p, ref_sw = int8_conv_quantize_w_plain(w, amax)
        torch.cuda.synchronize()
        assert torch.equal(w8p, ref_w8p)
        assert torch.equal(_bits(sw), _bits(ref_sw))


def test_int8_amax_with_nan_inf_and_negative_zero(gen):
    """int8_conv_amax where x holds NaN, +-inf and -0.0: NaN at the plain
    version's channels (a NaN wins over inf), every other value bit-equal;
    two runs bit-identical."""
    x = _rand((2, 5, 6, 7, 384), gen)
    x[0, 1, 2, 3, 5] = float("nan")
    x[1, 4, 5, 6, 200] = -float("nan")
    x[1, 2, 3, 4, 7] = float("inf")
    x[0, 2, 1, 0, 8] = -float("inf")
    x[..., 9] = -0.0
    x[0, 0, 0, 0, 10] = float("nan")
    x[1, 1, 1, 1, 10] = float("inf")
    got = kernels.int8_conv_amax(x)
    again = kernels.int8_conv_amax(x)
    ref = int8_conv_amax_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.isnan(got[[5, 200, 10]]).all()
    keep = ~torch.isnan(ref)
    assert torch.equal(_bits(got)[keep], _bits(ref)[keep])
    assert torch.equal(_bits(again), _bits(got))


def _sparse_table(g, rows, cap):
    """An int32 [1, rows, 27] neighbour table with tiles of every kind:
    rows 0-127 with every tap absent, 128-255 with only the centre tap
    (each row itself), the rest with neighbours drawn among `cap` rows
    and a third of them absent; rows is not a multiple of 128."""
    nbr = torch.randint(0, cap, (1, rows, 27), generator=g, device="cuda",
                        dtype=torch.int32)
    absent = torch.rand((1, rows, 27), generator=g, device="cuda") < 0.33
    nbr = torch.where(absent, -1, nbr)
    nbr[:, :128] = -1
    nbr[:, 128:256] = -1
    nbr[:, 128:256, 13] = torch.arange(128, 256, device="cuda",
                                       dtype=torch.int32)
    return nbr


@pytest.mark.parametrize("F,Fo", [(256, 256), (256, 128), (128, 128),
                                  (128, 64), (64, 64), (32, 64), (8, 12)])
def test_k4_holds_its_gate_on_every_kind_of_tile(gen, F, Fo):
    """K4 forward and as the input gradient (the dgrad pack) at the
    decoder's and trainer's widths against sparse_conv_plain: max-abs <=
    1e-4 * max|ref|; a tile with every tap absent gives exact zeros, and
    batch element 1, poisoned, is all NaN while element 0 holds."""
    rows = 1000
    nbr = torch.cat([_sparse_table(gen, rows, rows)] * 2)
    plan = ConvPlan(nbr, torch.tensor([0, 3], dtype=torch.int32,
                                      device="cuda"))
    feats = torch.randn((2, rows, F), generator=gen, device="cuda")
    w = torch.randn((27, F, Fo), generator=gen, device="cuda") / \
        (27 * F) ** 0.5
    before = dict(kernels.launches)
    out = kernels.sparse_conv_f32(feats, nbr, pack_sparse_weight(w),
                                  plan.violations)
    ref = sparse_conv_plain(plan, feats, w)
    torch.cuda.synchronize()
    assert torch.isnan(out[1]).all() and torch.isfinite(out[0]).all()
    assert (out[0, :128] == 0).all()
    assert (out[0] - ref[0]).abs().max().item() <= \
        1e-4 * ref[0].abs().max().item()
    gout = torch.randn((2, rows, Fo), generator=gen, device="cuda")
    zero = torch.zeros(2, dtype=torch.int32, device="cuda")
    dx = kernels.sparse_conv_f32(gout, nbr, pack_sparse_weight(w, True),
                                 zero, dgrad=True)
    ref_dx = sparse_conv_plain(ConvPlan(nbr, zero), gout, rev_w(w))
    torch.cuda.synchronize()
    assert kernels.launches["sparse_conv_f32"] == \
        before["sparse_conv_f32"] + 1
    assert kernels.launches["sparse_conv_f32_dgrad"] == \
        before["sparse_conv_f32_dgrad"] + 1
    assert (dx - ref_dx).abs().max().item() <= \
        1e-4 * ref_dx.abs().max().item()


@pytest.mark.parametrize("n_pts,cap,F,Fo", [(60000, 65536, 64, 64),
                                            (20000, 32768, 256, 256),
                                            (40000, 65536, 32, 64)])
def test_k4_on_real_grids(gen, n_pts, cap, F, Fo):
    """K4 and K4-dgrad on a voxel grid at the decode's and the trainer's
    row counts, within the gate."""
    pts = torch.randint(-40, 40, (1, n_pts, 3), generator=gen, device="cuda")
    grid = grid_from_ijk(pts, torch.ones((1, n_pts), dtype=torch.bool,
                                        device="cuda"), 0.2, 0.1, cap)
    plan = conv_plan(grid, dense_bounds=((-64, -64, -64), (128, 128, 128)))
    assert plan.violations.sum().item() == 0
    feats = torch.where(grid.mask[..., None], torch.randn(
        (1, cap, F), generator=gen, device="cuda"), 0.0)
    w = torch.randn((27, F, Fo), generator=gen, device="cuda") / \
        (27 * F) ** 0.5
    out = kernels.sparse_conv_f32(feats, plan.nbr, pack_sparse_weight(w),
                                  plan.violations)
    ref = sparse_conv_plain(plan, feats, w)
    gout = torch.where(grid.mask[..., None], torch.randn(
        (1, cap, Fo), generator=gen, device="cuda"), 0.0)
    dx = kernels.sparse_conv_f32(gout, plan.nbr,
                                 pack_sparse_weight(w, dgrad=True),
                                 plan.violations, dgrad=True)
    ref_dx = sparse_conv_plain(plan, gout, rev_w(w))
    torch.cuda.synchronize()
    for got, want in ((out, ref), (dx, ref_dx)):
        assert (got - want).abs().max().item() <= \
            1e-4 * want.abs().max().item()


def test_int8_quantizers_on_the_card_equal_the_cpu(gen):
    """The plain int8 quantizers on CUDA tensors give the CPU's (and the
    reference's) int8 values and scales bit for bit: their scales divide by
    127 (a Python-scalar divisor would be a product with its rounded
    reciprocal on the card, off in the last bit for some values)."""
    x, w, _ = _int8_case(gen, 2, 16, 192, 192)
    for got, ref in zip(quantize_for_conv(x, w.to(torch.bfloat16)),
                        quantize_for_conv(x.cpu(), w.cpu().to(
                            torch.bfloat16))):
        assert torch.equal(got.cpu(), ref)
    q = _rand((24, 3072, 128), gen) * torch.logspace(
        -2, 2, 3072, device="cuda")[None, :, None].to(torch.bfloat16)
    for fn in (lambda t: block_quantize(t, 1536), channel_quantize):
        for got, ref in zip(fn(q), fn(q.cpu())):
            assert torch.equal(got.cpu(), ref)


def _sheet_grid(gen, B, n_pts, cap):
    """B voxel sheets (a ground plane with bumps, as a driving scene's
    surfaces), the second half the size of the first."""
    ij = torch.randint(-60, 60, (B, n_pts, 2), generator=gen, device="cuda")
    k = (torch.sin(ij[..., :1] * 0.3) * 3).round().int() + torch.randint(
        -1, 2, (B, n_pts, 1), generator=gen, device="cuda")
    mask = torch.ones((B, n_pts), dtype=torch.bool, device="cuda")
    if B > 1:
        mask[-1, n_pts // 2:] = False
    grid = grid_from_ijk(torch.cat([ij, k], -1).int(), mask, 0.2, 0.1, cap)
    plan = conv_plan(grid, dense_bounds=((-64, -64, -64), (128, 128, 128)))
    assert plan.violations.sum().item() == 0
    return grid, plan


# the VAE trainer's (F, Fo) and two widths that are 4 mod 8 (a ragged F
# tile and a narrow N tile)
@pytest.mark.parametrize("B,F,Fo", [(1, 32, 64), (2, 64, 64), (1, 128, 128),
                                    (2, 256, 128), (1, 256, 256),
                                    (2, 36, 68), (1, 260, 12)])
def test_k6_on_real_grids(gen, B, F, Fo):
    """K6 on tf32 wgmma against ``sparse_conv_bwd_plain``'s dW on voxel
    sheets of up to 30,000 rows (several row ranges), with one tap's
    neighbours removed from the table: max-abs <= 5e-4 * max|ref|, that
    tap's dW exactly zero, one launch a call, two runs bit-identical."""
    grid, plan = _sheet_grid(gen, B, 24000, 30000)
    nbr = plan.nbr.clone()
    nbr[..., 5] = -1
    plan = ConvPlan(nbr, plan.violations)
    m = grid.mask[..., None]
    feats = torch.where(m, torch.randn((B, 30000, F), generator=gen,
                                       device="cuda"), 0.0)
    gout = torch.where(m, torch.randn((B, 30000, Fo), generator=gen,
                                      device="cuda"), 0.0)
    rows = B * 30000
    assert -(-rows // kernels.wgrad_rows_per_split(rows, F, Fo)) > 1
    before = kernels.launches["sparse_conv_f32_wgrad"]
    dw = kernels.sparse_conv_f32_wgrad(feats, nbr, gout)
    again = kernels.sparse_conv_f32_wgrad(feats, nbr, gout)
    assert kernels.launches["sparse_conv_f32_wgrad"] == before + 2
    ref = sparse_conv_bwd_plain(plan, feats, torch.zeros(
        (27, F, Fo), device="cuda"), gout)[1]
    torch.cuda.synchronize()
    assert dw.shape == (27, F, Fo) and torch.isfinite(dw).all()
    assert (dw - ref).abs().max().item() <= 5e-4 * ref.abs().max().item()
    assert (dw[5] == 0).all() and (dw[13] != 0).any()
    assert torch.equal(dw, again)


def test_k6_with_one_row_range(gen):
    """Few rows: one range, so the kernel writes dW itself (no partials,
    no reduce pass); a tap of the centre row only."""
    F, Fo = 64, 128
    assert kernels.wgrad_rows_per_split(700, F, Fo) >= 700
    nbr = torch.full((1, 700, 27), -1, dtype=torch.int32, device="cuda")
    nbr[0, :, 13] = torch.arange(700, dtype=torch.int32, device="cuda")
    nbr[0, 3, 0] = 9
    feats = torch.randn((1, 700, F), generator=gen, device="cuda")
    gout = torch.randn((1, 700, Fo), generator=gen, device="cuda")
    dw = kernels.sparse_conv_f32_wgrad(feats, nbr, gout)
    ref = sparse_conv_bwd_plain(ConvPlan(nbr, torch.zeros(
        1, dtype=torch.int32, device="cuda")), feats, torch.zeros(
            (27, F, Fo), device="cuda"), gout)[1]
    torch.cuda.synchronize()
    assert (dw - ref).abs().max().item() <= 5e-4 * ref.abs().max().item()
    assert (dw[0] != 0).any()
    assert (dw[1:13] == 0).all() and (dw[14:] == 0).all()


def test_k6_wrapper_refuses_what_the_kernel_does_not_take(gen):
    nbr = torch.full((1, 64, 27), -1, dtype=torch.int32, device="cuda")
    feats = torch.zeros((1, 64, 8), device="cuda")
    before = dict(kernels.launches)
    with pytest.raises(ValueError):                  # Fo not a multiple of 4
        kernels.sparse_conv_f32_wgrad(feats, nbr, torch.zeros(
            (1, 64, 6), device="cuda"))
    with pytest.raises(ValueError):                  # rows differ
        kernels.sparse_conv_f32_wgrad(feats, nbr, torch.zeros(
            (1, 32, 8), device="cuda"))
    with pytest.raises(ValueError):                  # bf16 features
        kernels.sparse_conv_f32_wgrad(feats.to(torch.bfloat16), nbr, feats)
    with pytest.raises(ValueError):                  # a CPU table
        kernels.sparse_conv_f32_wgrad(feats, nbr.cpu(), feats)
    assert kernels.launches == before


@pytest.mark.parametrize("B,n,h,d", [
    (2, 1000, 3, 128),   # N not a multiple of the 128-key tiles
    (2, 3001, 2, 64),    # two 1,536-row blocks, the second ragged
    (2, 77, 1, 64),      # N < 128: one tile, mostly masked
    (1, 4700, 2, 128)])  # four blocks
def test_k8_at_the_edges(gen, B, n, h, d):
    """K8 on s8 wgmma against ``int8qkv_attention_plain`` on the same int8
    inputs (every block of q and k and every channel of v at its own
    scale): cosine >= 0.999; one launch; two runs bit-identical."""
    block, npad = quant_blocks(n)
    q = _scale_blocks(_rand((B, n, h, d), gen), block, 0.25, 4.0)
    k = _scale_blocks(_rand((B, n, h, d), gen), block, 4.0, 0.25)
    v = _rand((B, n, h, d), gen) * torch.logspace(
        -1, 1, d, device="cuda").to(torch.bfloat16)
    before = dict(kernels.launches)
    out = mha_quantized(q, k, v, quant="qkv")
    assert kernels.launches["flash_attn_int8qkv"] == \
        before["flash_attn_int8qkv"] + 1
    assert kernels.launches["flash_attn_int8qk"] == \
        before["flash_attn_int8qk"]
    q8, sq = block_quantize(fold_heads(q, npad), block)
    k8, sk = block_quantize(fold_heads(k, npad), block)
    v8, sv = channel_quantize(fold_heads(v, npad))
    ref = int8qkv_attention_plain(q8, k8, sq, sk, v8, sv, n, block,
                                  d ** -0.5, torch.float32)
    ref = ref.reshape(B, h, n, d).permute(0, 2, 1, 3)
    assert out.shape == (B, n, h, d) and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    assert _cos(out, ref) >= 0.999
    again = kernels.flash_attn_int8qkv(q8, k8, sq, sk, pack_v8(v8), sv, B,
                                       n, block, d ** -0.5)
    assert torch.equal(out, again)


def test_k8_wrapper_refuses_what_the_kernel_does_not_take(gen):
    q8 = torch.zeros((2, 256, 128), dtype=torch.int8, device="cuda")
    s = torch.ones((2, 2), device="cuda")
    v8t = torch.zeros((2, 128, 256), dtype=torch.int8, device="cuda")
    sv = torch.ones((2, 128), device="cuda")
    before = dict(kernels.launches)
    with pytest.raises(ValueError):                  # a 64-row block
        kernels.flash_attn_int8qkv(q8, q8, torch.ones((2, 4), device="cuda"),
                                   torch.ones((2, 4), device="cuda"), v8t,
                                   sv, 1, 200, 64, 0.1)
    with pytest.raises(ValueError):                  # V not transposed
        kernels.flash_attn_int8qkv(q8, q8, s, s, v8t.transpose(1, 2), sv, 1,
                                   200, 128, 0.1)
    with pytest.raises(ValueError):                  # head dim 96
        kernels.flash_attn_int8qkv(q8[..., :96].contiguous(),
                                   q8[..., :96].contiguous(), s, s,
                                   v8t[:, :96].contiguous(), sv[:, :96], 1,
                                   200, 128, 0.1)
    with pytest.raises(ValueError):                  # n past Npad
        kernels.flash_attn_int8qkv(q8, q8, s, s, v8t, sv, 1, 300, 128, 0.1)
    assert kernels.launches == before
