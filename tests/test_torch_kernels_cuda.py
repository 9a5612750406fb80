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
from infinicube_tpu_torch.ops.attention import attention_plain, \
    multi_head_attention
from infinicube_tpu_torch.ops.flash_attention import (block_quantize,
                                                      fold_heads,
                                                      int8qk_attention_plain,
                                                      mha_quantized,
                                                      quant_blocks)
from infinicube_tpu_torch.ops.dense_conv import (conv3x3x3, conv3x3x3_plain,
                                                 pack_conv_weight)
from infinicube_tpu_torch.ops.window_conv import (sparse_conv_plain,
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
    a, b = a.double().flatten(), b.double().flatten()
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
            torch.zeros((27, 6, 8), device="cuda"),
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
