"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one. The machine with the
card has no JAX, so this file imports none, and the run skips the JAX-side
conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py -m cuda -q
"""

import math

import pytest
import torch

from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.grid.build import grid_from_ijk
from infinicube_tpu_torch.nn.sparse import conv_plan
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
                                                      quant_blocks)
from infinicube_tpu_torch.ops.dense_conv import (Conv3x3x3, conv3x3x3,
                                                 conv3x3x3_bwd_plain,
                                                 conv3x3x3_int8_plain,
                                                 conv3x3x3_plain,
                                                 dgrad_weight,
                                                 int8_conv_applies,
                                                 pack_conv_weight,
                                                 pack_int8_weight,
                                                 quantize_for_conv)
from infinicube_tpu_torch.ops.window_conv import (pack_sparse_weight,
                                                  sparse_conv_bwd_plain,
                                                  sparse_conv_plain,
                                                  window_sparse_conv)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _cos(a, b):
    a, b = a.detach().double().flatten(), b.detach().double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def _rand(shape, g):
    return torch.randn(shape, generator=g, device="cuda",
                       dtype=torch.bfloat16)


def _scale_blocks(x, block, lo, hi):
    """Multiply each block of rows (dim 1) by its own factor, from lo to hi,
    so that every quantization block gets a different scale."""
    n = x.shape[1]
    f = torch.logspace(math.log10(lo), math.log10(hi), -(-n // block),
                       device=x.device)
    return x * f.repeat_interleave(block)[:n, None, None].to(x.dtype)


@pytest.mark.parametrize("n,h,d", [(7800, 12, 128), (1000, 12, 128),
                                   (2000, 2, 64), (300, 4, 64), (65, 2, 128)])
def test_k1_matches_plain(gen, n, h, d):
    """Same int8 inputs on both sides, with a different scale in every
    1536-row block of q and of k; the kernel rounds P to bf16 under a
    running max where the plain version uses the global max: gated at the
    repo's int8 cosine >= 0.999."""
    block, npad = quant_blocks(n)
    q = _scale_blocks(_rand((1, n, h, d), gen), block, 0.25, 4.0)
    k = _scale_blocks(_rand((1, n, h, d), gen), block, 4.0, 0.25)
    v = _rand((1, n, h, d), gen)
    before = kernels.launches["flash_attn_int8qk"]
    out = mha_quantized(q, k, v)
    assert kernels.launches["flash_attn_int8qk"] == before + 1
    q8, sq = block_quantize(fold_heads(q, npad), block)
    k8, sk = block_quantize(fold_heads(k, npad), block)
    ref = int8qk_attention_plain(q8, k8, sq, sk, v, block, d ** -0.5)
    torch.cuda.synchronize()
    assert out.shape == (1, n, h, d) and out.dtype == torch.bfloat16
    assert _cos(out.float(), ref.float()) >= 0.999


@pytest.mark.parametrize("nq,nk,h,d", [(7800, 512, 12, 128),
                                       (1000, 1000, 12, 128),
                                       (333, 77, 4, 64), (1, 5, 1, 64)])
def test_k2_matches_plain(gen, nq, nk, h, d):
    """bf16 kernel vs the plain f32 path on the same bf16 inputs: bf16
    rounding of P and of the output bounds the error."""
    q, k, v = _rand((2, nq, h, d), gen), _rand((2, nk, h, d), gen), \
        _rand((2, nk, h, d), gen)
    out = multi_head_attention(q, k, v)
    ref = attention_plain(q.float(), k.float(), v.float(), d ** -0.5)
    torch.cuda.synchronize()
    assert (out.float() - ref).abs().max().item() <= 2e-2


def test_k2_takes_strided_views(gen):
    """k/v as views into a fused [B, N, 2C] projection, as the DiT's
    cross-attention passes them: no copy, same result."""
    kv = _rand((1, 512, 2 * 12 * 128), gen)
    k, v = (x.reshape(1, 512, 12, 128) for x in kv.chunk(2, dim=-1))
    q = _rand((1, 700, 12, 128), gen)
    out = multi_head_attention(q, k, v)
    ref = multi_head_attention(q, k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = torch.randn((1, 64, 2, 128), device="cuda")
    with pytest.raises(ValueError):            # f32, not bf16
        kernels.flash_attn_bf16(q, q, q, 0.1)
    with pytest.raises(ValueError):            # head dim 80
        x = _rand((1, 64, 2, 80), gen)
        kernels.flash_attn_bf16(x, x, x, 0.1)
    x = _rand((1, 4, 4, 4, 12), gen)           # C not a multiple of 8
    with pytest.raises(ValueError):
        kernels.conv3x3x3_bf16(x, _rand((16, 27 * 12), gen),
                               torch.zeros(16, device="cuda"))
    f = torch.zeros((1, 64, 6), device="cuda")  # F not a multiple of 4
    with pytest.raises(ValueError):
        kernels.sparse_conv_f32(
            f, torch.zeros((1, 64, 27), dtype=torch.int32, device="cuda"),
            torch.zeros((2, 27, 8, 6), device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("n", [4096, 512])
def test_k2_head_dim_96(gen, n):
    """The voxel UNet's SelfAttention3D: 8 heads of 96 at 16^3 and 8^3
    tokens, self-attention. The outputs are small averages of v (about
    sqrt(e / N)), so the gate is relative to them."""
    q, k, v = (_rand((1, n, 8, 96), gen) for _ in range(3))
    out = multi_head_attention(q, k, v)
    ref = attention_plain(q.float(), k.float(), v.float(), 96 ** -0.5)
    torch.cuda.synchronize()
    assert _cos(out.float(), ref) >= 0.9999
    assert (out.float() - ref).abs().max().item() <= \
        2e-2 * ref.abs().max().item()


@pytest.mark.parametrize("shape", [(1, 8, 8, 8, 16, 192),
                                   (2, 6, 5, 7, 64, 72),
                                   (1, 16, 16, 16, 192, 192),
                                   (1, 4, 4, 4, 1536, 768)])
def test_k3_matches_plain(gen, shape):
    """K3 against the plain f32-accumulating conv on the same bf16 inputs:
    both accumulate in f32 and round the output to bf16 once, so the gate is
    bf16 rounding of sums up to 27*C terms."""
    B, D, H, W, C, O = shape
    x = _rand((B, D, H, W, C), gen)
    w = (_rand((O, C, 3, 3, 3), gen).float() / (27 * C) ** 0.5).to(
        torch.bfloat16)
    b = torch.randn(O, generator=gen, device="cuda")
    before = kernels.launches["conv3x3x3_bf16"]
    out = conv3x3x3(x, w, b, pack_conv_weight(w))
    assert kernels.launches["conv3x3x3_bf16"] == before + 1
    ref = conv3x3x3_plain(x, w, b)
    torch.cuda.synchronize()
    assert out.shape == (B, D, H, W, O) and out.dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs().max().item()
    assert _cos(out.float(), ref.float()) >= 0.9999
    assert err <= 2e-2 * ref.float().abs().max().item()


def test_k3_takes_more_than_65535_voxel_tiles(gen):
    """8,396,800 output voxels: 65,600 tiles of 128, past the 65,535 that a
    grid's y or z dimension holds, so the tiles must run along grid.x."""
    B, D, H, W, C, O = 1, 8, 1024, 1025, 8, 16
    x = _rand((B, D, H, W, C), gen)
    w = (_rand((O, C, 3, 3, 3), gen).float() / (27 * C) ** 0.5).to(
        torch.bfloat16)
    b = torch.randn(O, generator=gen, device="cuda")
    out = conv3x3x3(x, w, b, pack_conv_weight(w))
    ref = conv3x3x3_plain(x, w, b)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert _cos(out.float(), ref.float()) >= 0.9999
    assert err <= 2e-2 * ref.float().abs().max().item()


def test_conv3x3x3_on_the_card_needs_packed_weights(gen):
    x = _rand((1, 4, 4, 4, 8), gen)
    w = _rand((8, 8, 3, 3, 3), gen)
    with pytest.raises(ValueError):
        conv3x3x3(x, w, torch.zeros(8, device="cuda"))


def _sparse_case(gen, n_pts, cap, F, Fo, extent=12):
    pts = torch.randint(-extent, extent, (1, n_pts, 3), generator=gen,
                        device="cuda")
    g = grid_from_ijk(pts, torch.ones((1, n_pts), dtype=torch.bool,
                                      device="cuda"), 0.2, 0.1, cap)
    feats = torch.randn((1, cap, F), generator=gen, device="cuda")
    feats = torch.where(g.mask[..., None], feats, 0.0)
    w = torch.randn((27, F, Fo), generator=gen, device="cuda") / \
        (27 * F) ** 0.5
    return g, feats, w


@pytest.mark.parametrize("F,Fo", [(64, 64), (256, 128), (8, 12)])
def test_k4_matches_plain(gen, F, Fo):
    """K4 against the plain gather version on the card, f32 on both
    sides: only the summation order differs."""
    g, feats, w = _sparse_case(gen, 6000, 8192, F, Fo)
    plan = conv_plan(g, dense_bounds=((-16, -16, -16), (32, 32, 32)))
    before = kernels.launches["sparse_conv_f32"]
    out = window_sparse_conv(plan, feats, w)
    assert kernels.launches["sparse_conv_f32"] == before + 1
    ref = sparse_conv_plain(plan, feats, w)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item()


def test_k4_poisons_the_violating_batch_row(gen):
    """Bounds that leave out voxels of batch element 1 only: its rows are
    NaN, element 0's are exact."""
    pts = torch.stack([
        torch.randint(-4, 4, (500, 3), generator=gen, device="cuda"),
        torch.randint(-12, 12, (500, 3), generator=gen, device="cuda")])
    g = grid_from_ijk(pts, torch.ones((2, 500), dtype=torch.bool,
                                      device="cuda"), 0.2, 0.1, 1024)
    plan = conv_plan(g, dense_bounds=((-8, -8, -8), (16, 16, 16)))
    assert plan.violations[0].item() == 0 and plan.violations[1].item() > 0
    feats = torch.randn((2, 1024, 16), generator=gen, device="cuda")
    w = torch.randn((27, 16, 16), generator=gen, device="cuda")
    out = window_sparse_conv(plan, feats, w)
    ref = sparse_conv_plain(plan, feats, w)
    torch.cuda.synchronize()
    assert torch.isnan(out[1]).all() and torch.isfinite(out[0]).all()
    assert (out[0] - ref[0]).abs().max().item() <= \
        1e-4 * ref[0].abs().max().item()


def _close(got, ref, rel=2e-2, cos=0.9999):
    """The kernels' gate: cosine and max-abs relative to the largest
    reference value (bf16 rounding of the operands and of the result)."""
    got, ref = got.float(), ref.float()
    assert _cos(got, ref) >= cos
    assert (got - ref).abs().max().item() <= rel * ref.abs().max().item()


@pytest.mark.parametrize("nq,nk,h,d", [(4096, 4096, 8, 96), (512, 512, 8, 96),
                                       (333, 77, 4, 64), (130, 1000, 3, 128),
                                       (1, 5, 1, 64), (200, 200, 2, 128)])
def test_k2_stores_the_log_sum_exp(gen, nq, nk, h, d):
    q, k, v = _rand((2, nq, h, d), gen), _rand((2, nk, h, d), gen), \
        _rand((2, nk, h, d), gen)
    o, lse = kernels.flash_attn_bf16(q, k, v, d ** -0.5, return_lse=True)
    ref_o, ref_lse = attention_plain(q.float(), k.float(), v.float(),
                                     d ** -0.5, return_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (2, h, nq) and lse.dtype == torch.float32
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert torch.equal(o, kernels.flash_attn_bf16(q, k, v, d ** -0.5))


@pytest.mark.parametrize("nq,nk,h,d", [(4096, 4096, 8, 96), (512, 512, 8, 96),
                                       (333, 77, 4, 64), (130, 1000, 3, 128),
                                       (1, 5, 1, 64), (200, 200, 2, 128)])
def test_k5_matches_plain(gen, nq, nk, h, d):
    """K5 against the formulas in f32 on the same bf16 inputs and the same
    lse: P and dS are rounded to bf16 before their products, the results to
    bf16 at the store. Lengths that are not multiples of 64 check that rows
    >= Nq and keys >= Nk contribute nothing."""
    q, k, v = _rand((2, nq, h, d), gen), _rand((2, nk, h, d), gen), \
        _rand((2, nk, h, d), gen)
    do = _rand((2, nq, h, d), gen)
    scale = d ** -0.5
    o, lse = kernels.flash_attn_bf16(q, k, v, scale, return_lse=True)
    before = kernels.launches["flash_attn_bf16_bwd"]
    got = kernels.flash_attn_bf16_bwd(q, k, v, do, lse,
                                      attention_delta(o, do), scale)
    assert kernels.launches["flash_attn_bf16_bwd"] == before + 1
    ref = attention_bwd_plain(q.float(), k.float(), v.float(), o.float(),
                              do.float(), lse, scale)
    torch.cuda.synchronize()
    for a, b, x in zip(got, ref, (q, k, v)):
        assert a.shape == x.shape and a.dtype == torch.bfloat16
        assert torch.isfinite(a).all()
        _close(a, b)


def test_attention_gradients_through_k5(gen):
    """autograd through ``multi_head_attention`` on strided views of one
    fused qkv projection (as SelfAttention3D passes them) against autograd
    through the plain version in f32."""
    qkv = _rand((1, 700, 3, 8, 96), gen).requires_grad_()
    w = _rand((1, 700, 8, 96), gen)
    k2, k5 = (kernels.launches[n] for n in ("flash_attn_bf16",
                                            "flash_attn_bf16_bwd"))
    out = multi_head_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    (out.float() * w.float()).sum().backward()
    assert kernels.launches["flash_attn_bf16"] == k2 + 1
    assert kernels.launches["flash_attn_bf16_bwd"] == k5 + 1
    ref_in = qkv.detach().float().requires_grad_()
    ref = attention_plain(ref_in[:, :, 0], ref_in[:, :, 1], ref_in[:, :, 2],
                          96 ** -0.5)
    (ref * w.float()).sum().backward()
    torch.cuda.synchronize()
    _close(qkv.grad, ref_in.grad)
    with torch.no_grad():                       # no gradient: K2 alone
        multi_head_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    assert kernels.launches["flash_attn_bf16_bwd"] == k5 + 1


@pytest.mark.parametrize("shape", [(1, 8, 8, 8, 192, 16),
                                   (2, 6, 5, 7, 64, 72),
                                   (1, 16, 16, 16, 192, 192),
                                   (1, 4, 4, 4, 768, 1536)])
def test_k3_dgrad_matches_plain(gen, shape):
    """K3 on the output gradient with the flipped, swapped pack and no bias
    against ``conv3x3x3_bwd_plain``'s dx; shape = (B, D, H, W, C, O) of the
    forward conv."""
    B, D, H, W, C, O = shape
    x = _rand((B, D, H, W, C), gen)
    w = (_rand((O, C, 3, 3, 3), gen).float() / (27 * C) ** 0.5).to(
        torch.bfloat16)
    g = _rand((B, D, H, W, O), gen)
    got = kernels.conv3x3x3_bf16(g, pack_conv_weight(dgrad_weight(w)), None)
    ref, _, _ = conv3x3x3_bwd_plain(x, w, g)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    _close(got, ref)


def test_conv_gradients_through_k3(gen):
    """autograd through the ``Conv3x3x3`` module on the card (K3 forward,
    K3 dgrad, tap products for dW) against ``conv3x3x3_bwd_plain``; the
    output gradient arrives expanded (non-contiguous)."""
    m = Conv3x3x3(64, 72, dtype=torch.bfloat16, device="cuda")
    m.reset_parameters(gen)
    with torch.no_grad():
        m.bias.normal_(generator=gen)
    x = _rand((2, 6, 5, 7, 64), gen).requires_grad_()
    before = dict(kernels.launches)
    out = m(x)
    g = _rand((1, 1, 1, 1, 72), gen).expand(out.shape)
    out.backward(g)
    assert kernels.launches["conv3x3x3_bf16"] == \
        before["conv3x3x3_bf16"] + 1
    assert kernels.launches[kernels.K3_DGRAD] == before[kernels.K3_DGRAD] + 1
    dx, dw, db = conv3x3x3_bwd_plain(x.detach(), m.weight.detach().to(
        torch.bfloat16), g)
    torch.cuda.synchronize()
    _close(x.grad, dx)
    assert m.weight.grad.dtype == torch.float32
    _close(m.weight.grad, dw, rel=1e-2)
    # the bias enters through a bf16 cast, so its gradient is rounded to bf16
    _close(m.bias.grad, db, rel=5e-3)
    # an input without a gradient: no dgrad launch, dW all the same
    m.zero_grad()
    before = dict(kernels.launches)
    m(x.detach()).backward(g)
    assert kernels.launches["conv3x3x3_bf16"] == \
        before["conv3x3x3_bf16"] + 1
    assert kernels.launches[kernels.K3_DGRAD] == before[kernels.K3_DGRAD]
    _close(m.weight.grad, dw, rel=1e-2)


def test_packed_weights_follow_an_optimizer_step(gen):
    """Both packs are rebuilt after an in-place update of the weight."""
    m = Conv3x3x3(16, 16, dtype=torch.bfloat16, device="cuda")
    m.reset_parameters(gen)
    x = _rand((1, 4, 4, 4, 16), gen).requires_grad_()
    m(x).float().sum().backward()
    old = m._packed_weight().clone(), m._packed_weight(dgrad=True).clone()
    torch.optim.SGD(m.parameters(), lr=1.0).step()
    out = m(x)
    ref = conv3x3x3_plain(x.detach(), m.weight.detach().to(torch.bfloat16),
                          m.bias.detach())
    _close(out, ref)
    assert not torch.equal(old[0], m._packed_weight())
    assert not torch.equal(old[1], m._packed_weight(dgrad=True))


def _sparse_bwd_case(gen, B, n_pts, cap, F, Fo):
    """B grids in one batch (the last half the size when B > 1), features,
    weights and an output gradient; extent 12 inside bounds of +-16."""
    pts = torch.randint(-12, 12, (B, n_pts, 3), generator=gen, device="cuda")
    mask = torch.ones((B, n_pts), dtype=torch.bool, device="cuda")
    if B > 1:
        mask[-1, n_pts // 2:] = False
    g = grid_from_ijk(pts, mask, 0.2, 0.1, cap)
    plan = conv_plan(g, dense_bounds=((-16, -16, -16), (32, 32, 32)))
    m = g.mask[..., None]
    feats = torch.where(m, torch.randn((B, cap, F), generator=gen,
                                       device="cuda"), 0.0)
    gout = torch.where(m, torch.randn((B, cap, Fo), generator=gen,
                                      device="cuda"), 0.0)
    w = torch.randn((27, F, Fo), generator=gen, device="cuda") / \
        (27 * F) ** 0.5
    return g, plan, feats, w, gout


@pytest.mark.parametrize("B,cap,F,Fo", [(1, 8192, 64, 64), (2, 5001, 256, 128),
                                        (2, 777, 32, 64), (1, 4099, 8, 12)])
def test_k4_dgrad_and_k6_match_plain(gen, B, cap, F, Fo):
    """The sparse conv's two gradient kernels against
    ``sparse_conv_bwd_plain`` on the card, f32 on both sides (only the
    summation order differs): odd capacities, B = 2, F != Fo; K6 twice,
    bit-identical."""
    g, plan, feats, w, gout = _sparse_bwd_case(gen, B, min(cap, 6000) - 50,
                                               cap, F, Fo)
    before = dict(kernels.launches)
    dx = kernels.sparse_conv_f32(gout, plan.nbr,
                                 pack_sparse_weight(w, dgrad=True),
                                 torch.zeros_like(plan.violations),
                                 dgrad=True)
    dw = kernels.sparse_conv_f32_wgrad(feats, plan.nbr, gout)
    again = kernels.sparse_conv_f32_wgrad(feats, plan.nbr, gout)
    assert kernels.launches["sparse_conv_f32_dgrad"] == \
        before["sparse_conv_f32_dgrad"] + 1
    assert kernels.launches["sparse_conv_f32_wgrad"] == \
        before["sparse_conv_f32_wgrad"] + 2
    assert kernels.launches["sparse_conv_f32"] == before["sparse_conv_f32"]
    ref_dx, ref_dw = sparse_conv_bwd_plain(plan, feats, w, gout)
    torch.cuda.synchronize()
    assert dx.shape == feats.shape and dw.shape == w.shape
    assert (dx - ref_dx).abs().max().item() <= \
        1e-4 * ref_dx.abs().max().item()
    assert (dw - ref_dw).abs().max().item() <= \
        5e-4 * ref_dw.abs().max().item()
    assert torch.equal(dw, again)
    assert (dx[~g.mask] == 0).all()


def test_k6_gives_zero_for_a_tap_no_row_has(gen):
    """Voxels on one z plane: no row has a neighbour at dz = +-1, so 18 of
    the 27 taps get an exactly zero weight gradient; padding rows, whose
    features and gradients are garbage here, contribute nothing."""
    pts = torch.randint(-12, 12, (1, 900, 3), generator=gen, device="cuda")
    pts[..., 2] = 3
    g = grid_from_ijk(pts, torch.ones((1, 900), dtype=torch.bool,
                                      device="cuda"), 0.2, 0.1, 2048)
    plan = conv_plan(g, dense_bounds=((-16, -16, -16), (32, 32, 32)))
    feats = torch.randn((1, 2048, 16), generator=gen, device="cuda")
    gout = torch.randn((1, 2048, 16), generator=gen, device="cuda")
    dw = kernels.sparse_conv_f32_wgrad(feats, plan.nbr, gout)
    ref = sparse_conv_bwd_plain(plan, feats, torch.zeros((27, 16, 16),
                                                         device="cuda"),
                                gout)[1]
    in_plane = torch.arange(27, device="cuda") % 3 == 1
    assert (dw[~in_plane] == 0).all() and (dw[in_plane] != 0).any()
    assert (dw - ref).abs().max().item() <= 5e-4 * ref.abs().max().item()


def test_wgrad_wrapper_refuses_what_the_kernel_does_not_take(gen):
    feats = torch.zeros((1, 64, 8), device="cuda")
    nbr = torch.full((1, 64, 27), -1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):                  # F not a multiple of 4
        kernels.sparse_conv_f32_wgrad(feats[..., :6].contiguous(), nbr, feats)
    with pytest.raises(ValueError):                  # not contiguous
        kernels.sparse_conv_f32_wgrad(feats, nbr, torch.zeros(
            (1, 8, 64), device="cuda").transpose(1, 2))
    with pytest.raises(ValueError):                  # int64 table
        kernels.sparse_conv_f32_wgrad(feats, nbr.long(), feats)
    assert (kernels.sparse_conv_f32_wgrad(feats, nbr, feats) == 0).all()


def test_sparse_conv_trains_through_the_kernels(gen):
    """``SparseConv3d`` trains on the card: what it refused while the
    gradient kernels were missing now matches the plain gradients (B = 2,
    F != Fo), through K4, K4-dgrad and K6 once each, and follows an in-place
    update of the kernel."""
    from infinicube_tpu_torch.nn.sparse import SparseConv3d
    g, plan, feats, _, gout = _sparse_bwd_case(gen, 2, 900, 1024, 8, 16)
    conv = SparseConv3d(8, 16, device="cuda")
    conv.reset_parameters(gen)
    before = dict(kernels.launches)
    x = feats.clone().requires_grad_()
    # a non-contiguous output gradient, as autograd hands them over
    (conv(x, plan).transpose(1, 2) * gout.transpose(1, 2)).sum().backward()
    delta = {k: v - before[k] for k, v in kernels.launches.items()}
    assert {k: v for k, v in delta.items() if v} == {
        "sparse_conv_f32": 1, "sparse_conv_f32_dgrad": 1,
        "sparse_conv_f32_wgrad": 1}
    ref_dx, ref_dw = sparse_conv_bwd_plain(plan, feats, conv.kernel.detach(),
                                           gout)
    assert (x.grad - ref_dx).abs().max().item() <= \
        1e-4 * ref_dx.abs().max().item()
    assert (conv.kernel.grad - ref_dw).abs().max().item() <= \
        5e-4 * ref_dw.abs().max().item()
    torch.testing.assert_close(conv.bias.grad, gout.sum((0, 1)), rtol=1e-4,
                               atol=1e-3)
    first = x.grad.clone()
    with torch.no_grad():
        conv.kernel.mul_(2.0)
    x.grad = None
    (conv(x, plan) * gout).sum().backward()
    torch.testing.assert_close(x.grad, 2.0 * first, rtol=1e-5, atol=1e-6)
    # only the weight needs a gradient: no dgrad launch
    before = dict(kernels.launches)
    (conv(feats, plan) * gout).sum().backward()
    assert kernels.launches["sparse_conv_f32_dgrad"] == \
        before["sparse_conv_f32_dgrad"]
    assert kernels.launches["sparse_conv_f32_wgrad"] == \
        before["sparse_conv_f32_wgrad"] + 1


def test_backward_on_the_card_poisons_nothing(gen):
    """A batch row outside the dense bounds: NaN forward rows, finite
    gradients equal to the plain ones."""
    pts = torch.stack([
        torch.randint(-4, 4, (500, 3), generator=gen, device="cuda"),
        torch.randint(-12, 12, (500, 3), generator=gen, device="cuda")])
    g = grid_from_ijk(pts, torch.ones((2, 500), dtype=torch.bool,
                                      device="cuda"), 0.2, 0.1, 1024)
    plan = conv_plan(g, dense_bounds=((-8, -8, -8), (16, 16, 16)))
    assert plan.violations[1].item() > 0
    x = torch.randn((2, 1024, 16), generator=gen,
                    device="cuda").requires_grad_()
    w = torch.randn((27, 16, 8), generator=gen,
                    device="cuda").requires_grad_()
    gout = torch.randn((2, 1024, 8), generator=gen, device="cuda")
    out = window_sparse_conv(plan, x, w)
    assert torch.isnan(out[1]).all() and torch.isfinite(out[0]).all()
    out.backward(gout)
    ref_dx, ref_dw = sparse_conv_bwd_plain(plan, x.detach(), w.detach(), gout)
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()
    assert (x.grad - ref_dx).abs().max().item() <= \
        1e-4 * ref_dx.abs().max().item()
    assert (w.grad - ref_dw).abs().max().item() <= \
        5e-4 * ref_dw.abs().max().item()


def _int8_conv_case(gen, B, n, C, O):
    """bf16 x with a different range in every input channel (a kernel that
    reads the wrong channel's scale fails) and its quantization."""
    x = (torch.randn((B, n, n, n, C), generator=gen, device="cuda") *
         torch.logspace(-1, 1, C, device="cuda")).to(torch.bfloat16)
    w = (torch.randn((O, C, 3, 3, 3), generator=gen, device="cuda") /
         math.sqrt(27 * C)).to(torch.bfloat16)
    b = 0.1 * torch.randn(O, generator=gen, device="cuda")
    return x, w, b, quantize_for_conv(x, w)


@pytest.mark.parametrize("B,n,C,O", [(2, 8, 64, 64), (1, 12, 96, 160),
                                     (2, 16, 384, 768), (1, 32, 1152, 384),
                                     (1, 5, 32, 32)])
def test_k7_matches_plain(gen, B, n, C, O):
    """The same int8 inputs, exact int32 sums and the reference's order of
    the dequantized adds on both sides: equal outputs."""
    x, w, b, (x8, w8, sw) = _int8_conv_case(gen, B, n, C, O)
    before = kernels.launches["conv3x3x3_int8"]
    got = kernels.conv3x3x3_int8(x8, pack_int8_weight(w8), sw, b)
    assert kernels.launches["conv3x3x3_int8"] == before + 1
    ref = conv3x3x3_int8_plain(x8, w8, sw, b, torch.bfloat16)
    torch.cuda.synchronize()
    assert got.shape == (B, n, n, n, O) and got.dtype == torch.bfloat16
    assert torch.equal(got, ref)
    # and the int8 conv is within the int8 gate of the bf16 one
    assert _cos(got.float(), conv3x3x3_plain(x, w, b).float()) >= 0.999


def test_k7_wrapper_refuses_what_the_kernel_does_not_take(gen):
    x8 = torch.zeros((1, 4, 4, 4, 48), dtype=torch.int8, device="cuda")
    w8 = torch.zeros((64, 27 * 48), dtype=torch.int8, device="cuda")
    sw, b = (torch.ones((3, 64), device="cuda"),
             torch.zeros(64, device="cuda"))
    with pytest.raises(ValueError):                  # C not a multiple of 32
        kernels.conv3x3x3_int8(x8, w8, sw, b)
    x8 = torch.zeros((1, 4, 4, 4, 64), dtype=torch.int8, device="cuda")
    w8 = torch.zeros((64, 27 * 64), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):                  # sw the wrong way round
        kernels.conv3x3x3_int8(x8, w8, sw.t().contiguous(), b)
    with pytest.raises(ValueError):                  # bf16 weights
        kernels.conv3x3x3_int8(x8, w8.to(torch.bfloat16), sw, b)
    assert (kernels.conv3x3x3_int8(x8, w8, sw, b) == 0).all()


def test_int8_conv_module_routes_on_the_card(gen):
    """Conv3x3x3(quant=True): K7 after its three prologue kernels where
    int8_conv_applies holds, K3 at in_conv's width and on an 8^3 cube."""
    for (B, n, C, O), want in (((2, 16, 64, 128), "conv3x3x3_int8"),
                               ((2, 16, 16, 64), "conv3x3x3_bf16"),
                               ((2, 8, 128, 128), "conv3x3x3_bf16")):
        assert int8_conv_applies((B, n, n, n), C, O) == \
            (want == "conv3x3x3_int8")
        m = Conv3x3x3(C, O, dtype=torch.bfloat16, device="cuda", quant=True)
        m.reset_parameters(gen)
        x = torch.randn((B, n, n, n, C), generator=gen, device="cuda")
        before = dict(kernels.launches)
        with torch.no_grad():
            out = m(x)
        delta = {k: v - before[k] for k, v in kernels.launches.items() if
                 v != before[k]}
        prologue = {"int8_conv_amax": 1, "int8_conv_quantize_x": 1,
                    "int8_conv_quantize_w": 1}
        assert delta == ({want: 1} | prologue if want == "conv3x3x3_int8"
                         else {want: 1})
        xb, wb = x.to(torch.bfloat16), m.weight.to(torch.bfloat16)
        ref = conv3x3x3_plain(xb, wb, m.bias)
        assert _cos(out.float(), ref.float()) >= 0.999


@pytest.mark.parametrize("n,h,d", [(7800, 12, 128), (1000, 12, 128),
                                   (2000, 2, 64), (300, 4, 64), (65, 2, 128)])
def test_k8_matches_plain(gen, n, h, d):
    """Same int8 inputs on both sides, a different scale in every 1536-row
    block of q and k and in every channel of v. K8 rounds P to int8 against
    its running max over 128-key tiles, the plain version over 1,536-key
    blocks: gated at the repo's int8 cosine >= 0.999."""
    block, npad = quant_blocks(n)
    q = _scale_blocks(_rand((1, n, h, d), gen), block, 0.25, 4.0)
    k = _scale_blocks(_rand((1, n, h, d), gen), block, 4.0, 0.25)
    v = _rand((1, n, h, d), gen) * torch.logspace(
        -1, 1, d, device="cuda").to(torch.bfloat16)
    before = kernels.launches["flash_attn_int8qkv"]
    got = mha_quantized(q, k, v, quant="qkv")
    assert kernels.launches["flash_attn_int8qkv"] == before + 1
    q8, sq = block_quantize(fold_heads(q, npad), block)
    k8, sk = block_quantize(fold_heads(k, npad), block)
    v8, sv = channel_quantize(fold_heads(v, npad))
    ref = int8qkv_attention_plain(q8, k8, sq, sk, v8, sv, n, block,
                                  d ** -0.5, torch.float32)
    ref = ref.reshape(1, h, n, d).permute(0, 2, 1, 3)
    assert got.shape == (1, n, h, d) and got.dtype == torch.bfloat16
    assert _cos(got.float(), ref) >= 0.999
