"""The edges of the wgmma / TMA kernels (K3 with its split K, K2) and of the
widths and dtypes the card's dense conv serves, against their plain PyTorch
versions on the card. Needs an NVIDIA GPU and skips without one; imports no
JAX (the card's machine has none):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_hopper_cuda.py -m cuda -q
"""

import pytest
import torch

from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.ops.attention import (attention_plain,
                                                multi_head_attention)
from infinicube_tpu_torch.ops.dense_conv import (Conv3x3x3, conv3x3x3,
                                                 conv3x3x3_bwd_plain,
                                                 conv3x3x3_int8_plain,
                                                 conv3x3x3_plain,
                                                 dgrad_weight,
                                                 pack_conv_weight,
                                                 quantize_for_conv)

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
    off): max-abs <= 1e-4 * max|ref|; and the f32 module on the card, with
    its gradients, counted under conv3x3x3_f32."""
    B, D, H, W, C, O = shape
    x = _rand((B, D, H, W, C), gen, torch.float32)
    w = _rand((O, C, 3, 3, 3), gen, torch.float32) / (27 * C) ** 0.5
    b = _rand((O,), gen, torch.float32)
    before = kernels.launches["conv3x3x3_f32"]
    got = kernels.conv3x3x3_f32(x, pack_conv_weight(w, torch.float32), b)
    ref = conv3x3x3_plain(x, w, b)
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    go = _rand((B, D, H, W, O), gen, torch.float32)
    dx = kernels.conv3x3x3_f32(
        go, pack_conv_weight(dgrad_weight(w), torch.float32), None)
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
