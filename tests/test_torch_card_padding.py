"""Head dims and widths that the card's kernels do not take, checked on the
CPU.

K2, K5, ``flash_attn_f32`` and ``flash_attn_f32_bwd`` take head dims 64,
96 and 128, K1 and K8 64
and 128, K4 and K6 widths that are multiples of 4; the reference serves any.
So ``multi_head_attention`` and ``mha_quantized`` zero-pad the head dim on
the card and slice the output, and ``window_sparse_conv`` zero-pads the
widths and slices the output, dx and dW. The kernels run only on the card,
so here the card's branch is taken with CPU tensors and each kernel
replaced by a stand-in that checks what its wrapper checks and computes its
plain version: what is checked is the padding, the slicing, the scale and
the gradients, against the JAX package and the unpadded plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.ops.attention import multi_head_attention as jax_mha
from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.grid.build import grid_from_ijk
from infinicube_tpu_torch.nn.sparse import conv_plan
from infinicube_tpu_torch.ops import attention as att
from infinicube_tpu_torch.ops import flash_attention as fa
from infinicube_tpu_torch.ops import window_conv as wc


class _OnCard(torch.Tensor):
    """A CPU tensor that claims to lie on the card (so are its results)."""
    is_cuda = True


def _plain(t):
    return t.as_subclass(torch.Tensor)


@pytest.fixture
def card(monkeypatch):
    """The attention's card branch for CPU tensors, with plain stand-ins
    for K2, K5, ``flash_attn_f32`` and ``flash_attn_f32_bwd`` that record
    the head dim they get."""
    calls = []

    def check(name, q, k, v):
        assert q.shape[-1] in att.CARD_HEAD_DIMS
        assert k.shape[-1] == v.shape[-1] == q.shape[-1]
        calls.append((name, q.shape[-1]))

    def f32(q, k, v, sm_scale, return_lse=False):
        check("flash_attn_f32", q, k, v)
        return att.attention_plain(q, k, v, sm_scale, return_lse)

    def f32_bwd(q, k, v, do, lse, delta, sm_scale):
        check("flash_attn_f32_bwd", q, k, v)
        o = att.attention_plain(q, k, v, sm_scale)
        return att.attention_bwd_plain(q, k, v, o, do, lse, sm_scale)

    def bf16(q, k, v, sm_scale, return_lse=False):
        check("flash_attn_bf16", q, k, v)
        return att.attention_plain(q, k, v, sm_scale, return_lse)

    def bf16_bwd(q, k, v, do, lse, delta, sm_scale):
        check("flash_attn_bf16_bwd", q, k, v)
        assert do.shape == q.shape
        o = att.attention_plain(q, k, v, sm_scale)
        torch.testing.assert_close(delta, att.attention_delta(o, do))
        return att.attention_bwd_plain(q, k, v, o, do, lse, sm_scale)

    monkeypatch.setattr(att, "_on_card", lambda x: True)
    monkeypatch.setattr(kernels, "flash_attn_f32", f32)
    monkeypatch.setattr(kernels, "flash_attn_f32_bwd", f32_bwd)
    monkeypatch.setattr(kernels, "flash_attn_bf16", bf16)
    monkeypatch.setattr(kernels, "flash_attn_bf16_bwd", bf16_bwd)
    return calls


def _qkv(seed, d, B=2, nq=37, nk=29, h=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, n, h, d)).astype(np.float32)
                 for n in (nq, nk, nk))


@pytest.mark.parametrize("d,dp", [(16, 64), (32, 64), (48, 64), (80, 96),
                                  (112, 128)])
def test_f32_attention_pads_the_head_dim(card, d, dp):
    """f32 forward at a head dim the kernel does not take: the kernel sees
    the next one it takes, the output has the true head dim and is the
    JAX package's attention (scale 1/sqrt(true d))."""
    q, k, v = _qkv(d, d)
    with torch.no_grad():
        out = att.multi_head_attention(*map(torch.from_numpy, (q, k, v)))
    assert card == [("flash_attn_f32", dp)]
    assert out.shape == (2, 37, 2, d)
    ref = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("d", [16, 32, 48])
def test_bf16_attention_pads_forward_and_backward(card, d):
    """bf16 through K2 and K5 at a padded head dim: the output and dq, dk,
    dv equal the plain attention's at the true head dim (to bf16
    rounding), and the padded columns' gradients are dropped."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(d, d))
    do = torch.from_numpy(_qkv(d + 1, d)[0]).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = att.multi_head_attention(*leaves)
    out.backward(do)
    assert [c for c in card] == [("flash_attn_bf16", 64),
                                 ("flash_attn_bf16_bwd", 64)]
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = att.attention_plain(*ref_leaves, d ** -0.5)
    ref.backward(do)
    tol = dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    for got, want in zip(leaves, ref_leaves):
        assert got.grad.shape == got.shape
        torch.testing.assert_close(got.grad.float(), want.grad.float(),
                                   **tol)


def test_card_attention_refuses_head_dims_above_128(card):
    q = torch.zeros((1, 8, 1, 160))
    with torch.no_grad(), pytest.raises(ValueError, match="128"):
        att.multi_head_attention(q, q, q)
    assert card == []
    # f32 with a gradient too, before anything is launched
    with pytest.raises(ValueError, match="128"):
        att.multi_head_attention(*(torch.zeros((1, 8, 1, 160),
                                               requires_grad=True)
                                   for _ in range(3)))
    assert card == []
    # the CPU's plain version serves any head dim
    card_free = att.attention_plain(q, q, q, 160 ** -0.5)
    assert card_free.shape == q.shape


@pytest.mark.parametrize("quant", ["qk", "qkv"])
@pytest.mark.parametrize("d,dp", [(16, 64), (96, 128)])
def test_int8_attention_pads_the_head_dim(monkeypatch, quant, d, dp):
    """K1 and K8 take 64 and 128: a CUDA-claiming call at another head dim
    reaches them padded, and the result equals the unpadded plain int8
    attention (the zero columns change no scale)."""
    seen = []

    def k1(q8, k8, sq, sk, v, block, sm_scale):
        seen.append(q8.shape[-1])
        assert abs(sm_scale - d ** -0.5) < 1e-12
        return fa.int8qk_attention_plain(*map(_plain, (q8, k8, sq, sk, v)),
                                         block, sm_scale)

    def k8(q8, k8_, sq, sk, v8t, sv, B, n, block, sm_scale):
        seen.append(q8.shape[-1])
        BH, npad, dk = q8.shape
        # undo pack_v8's transpose and key permutation
        v8 = _plain(v8t).reshape(BH, dk, npad // 16, 4, 2, 2).permute(
            0, 2, 4, 3, 5, 1).reshape(BH, npad, dk)
        out = fa.int8qkv_attention_plain(
            *map(_plain, (q8, k8_, sq, sk)), v8, _plain(sv), n, block,
            sm_scale, torch.bfloat16)
        return out.reshape(B, BH // B, n, dk).permute(0, 2, 1, 3)

    monkeypatch.setattr(kernels, "flash_attn_int8qk", k1)
    monkeypatch.setattr(kernels, "flash_attn_int8qkv", k8)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(d, d, nq=200, nk=200))
    got = fa.mha_quantized(*(t.as_subclass(_OnCard) for t in (q, k, v)),
                           quant=quant)
    assert seen == [dp]
    ref = fa.mha_quantized(q, k, v, quant=quant)
    assert got.shape == ref.shape == (2, 200, 2, d)
    torch.testing.assert_close(_plain(got).float(), ref.float(), atol=1e-2,
                               rtol=1e-2)
    with pytest.raises(ValueError, match="128"):
        fa.mha_quantized(*(torch.zeros((1, 8, 1, 160)).as_subclass(_OnCard)
                           for _ in range(3)), quant=quant)


def test_pack_v8_inverse_used_above():
    """The stand-in's inverse of ``pack_v8`` is its inverse."""
    v8 = torch.randint(-127, 128, (3, 64, 16), dtype=torch.int8)
    back = fa.pack_v8(v8).reshape(3, 16, 4, 4, 2, 2).permute(
        0, 2, 4, 3, 5, 1).reshape(3, 64, 16)
    assert torch.equal(back, v8)


def _sparse_scene(seed, n=700, cap=1024):
    g = torch.Generator().manual_seed(seed)
    ij = torch.randint(-10, 10, (1, n, 2), generator=g)
    k = torch.randint(-1, 2, (1, n, 1), generator=g)
    grid = grid_from_ijk(torch.cat([ij, k], -1).int(),
                         torch.ones((1, n), dtype=torch.bool), 0.2, 0.1, cap)
    return grid, conv_plan(grid, ((-16, -16, -16), (32, 32, 32))), g


@pytest.mark.parametrize("F,Fo", [(30, 30), (30, 62), (6, 4), (8, 13)])
def test_sparse_conv_pads_widths(monkeypatch, F, Fo):
    """``window_sparse_conv`` at widths that are not multiples of 4, its
    feats on a CUDA-claiming tensor: K4 and K6 stand-ins get padded widths
    (the packs' hi + lo as the weight); the output, dx and dW have the true
    widths and equal the unpadded plain versions."""
    grid, plan, g = _sparse_scene(F * 100 + Fo)
    calls = []

    def k4(feats, nbr, w_pack, poison, dgrad=False):
        K, N = feats.shape[-1], w_pack.shape[2]
        assert K % 4 == 0 and N % 4 == 0 and w_pack.shape[3] == K
        calls.append(("dgrad" if dgrad else "fwd", K, N))
        w = (_plain(w_pack[0]) + _plain(w_pack[1])).transpose(1, 2)
        return wc.sparse_conv_plain(wc.ConvPlan(plan.nbr, _plain(poison)),
                                    _plain(feats), w)

    def k6(feats, nbr, gout):
        F4, Fo4 = feats.shape[-1], gout.shape[-1]
        assert F4 % 4 == 0 and Fo4 % 4 == 0
        calls.append(("wgrad", F4, Fo4))
        return wc.sparse_conv_bwd_plain(plan, _plain(feats), torch.zeros(
            (27, F4, Fo4)), _plain(gout))[1]

    monkeypatch.setattr(kernels, "sparse_conv_f32", k4)
    monkeypatch.setattr(kernels, "sparse_conv_f32_wgrad", k6)
    m = grid.mask[..., None]
    x = torch.where(m, torch.randn((1, 1024, F), generator=g), 0.0)
    w = torch.randn((27, F, Fo), generator=g) / (27 * F) ** 0.5
    cot = torch.where(m, torch.randn((1, 1024, Fo), generator=g), 0.0)
    feats = x.clone().as_subclass(_OnCard).requires_grad_()
    wl = w.clone().requires_grad_()
    out = wc.window_sparse_conv(plan, feats, wl)
    out.backward(cot)
    F4, Fo4 = -(-F // 4) * 4, -(-Fo // 4) * 4
    assert calls == [("fwd", F4, Fo4), ("dgrad", Fo4, F4),
                     ("wgrad", F4, Fo4)]
    ref = wc.sparse_conv_plain(plan, x, w)
    ref_dx, ref_dw = wc.sparse_conv_bwd_plain(plan, x, w, cot)
    assert out.shape == ref.shape and feats.grad.shape == x.shape and \
        wl.grad.shape == w.shape
    # the stand-ins read the packs' hi + lo, w to within 2^-21
    tol = dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(_plain(out), ref, **tol)
    torch.testing.assert_close(_plain(feats.grad), ref_dx, **tol)
    torch.testing.assert_close(wl.grad, ref_dw, **tol)
    # without a gradient: the forward alone, padded and sliced
    calls.clear()
    with torch.no_grad():
        again = wc.window_sparse_conv(plan, x.as_subclass(_OnCard), w)
    assert calls == [("fwd", F4, Fo4)]
    torch.testing.assert_close(_plain(again), ref, **tol)


def test_pad_width_and_the_padded_pack():
    w = torch.randn((27, 6, 5))
    assert wc.pad_width(w, 1, 2).shape == (27, 8, 8)
    assert wc.pad_width(w, -1).shape == (27, 6, 8)
    w8 = torch.randn((27, 8, 12))
    assert wc.pad_width(w8, 1, 2) is w8
    pack = wc.pack_sparse_weight(w)
    assert pack.shape == (2, 27, 8, 8)
    assert (pack[:, :, 5:] == 0).all() and (pack[:, :, :, 6:] == 0).all()
    assert wc.pack_sparse_weight(w, dgrad=True).shape == (2, 27, 8, 8)


@pytest.mark.parametrize("F,Fo", [(30, 30), (30, 62), (6, 4), (12, 13)])
def test_bf16_sparse_conv_pads_widths(monkeypatch, F, Fo):
    """``window_sparse_conv`` on bf16 features at widths that are not
    multiples of 8, its feats on a CUDA-claiming tensor: the bf16 K4 and K6
    stand-ins get widths padded to multiples of 8 (bf16 packs [27, N, K])
    and never an f32 kernel; the output, dx and dW have the true widths
    and dtypes and equal the unpadded plain versions (the zero columns add
    exact zeros to the f32 sums)."""
    grid, plan, g = _sparse_scene(F * 100 + Fo + 1)
    calls = []

    def k4(feats, nbr, w_pack, poison, dgrad=False):
        K, N = feats.shape[-1], w_pack.shape[1]
        assert K % 8 == 0 and N % 8 == 0 and w_pack.shape == (27, N, K)
        assert feats.dtype == w_pack.dtype == torch.bfloat16
        calls.append(("dgrad" if dgrad else "fwd", K, N))
        return wc.sparse_conv_plain(wc.ConvPlan(plan.nbr, _plain(poison)),
                                    _plain(feats),
                                    _plain(w_pack).transpose(1, 2))

    def k6(feats, nbr, gout):
        F8, Fo8 = feats.shape[-1], gout.shape[-1]
        assert F8 % 8 == 0 and Fo8 % 8 == 0
        calls.append(("wgrad", F8, Fo8))
        return wc.sparse_conv_bwd_plain(plan, _plain(feats), torch.zeros(
            (27, F8, Fo8)), _plain(gout))[1]

    def refuse(*a, **kw):
        raise AssertionError("an f32 kernel for bf16 features")

    monkeypatch.setattr(kernels, "sparse_conv_bf16", k4)
    monkeypatch.setattr(kernels, "sparse_conv_bf16_wgrad", k6)
    monkeypatch.setattr(kernels, "sparse_conv_f32", refuse)
    monkeypatch.setattr(kernels, "sparse_conv_f32_wgrad", refuse)
    m = grid.mask[..., None]
    bf = torch.bfloat16
    x = torch.where(m, torch.randn((1, 1024, F), generator=g), 0.0).to(bf)
    w = (torch.randn((27, F, Fo), generator=g) / (27 * F) ** 0.5).to(bf)
    cot = torch.where(m, torch.randn((1, 1024, Fo), generator=g),
                      0.0).to(bf)
    feats = x.clone().as_subclass(_OnCard).requires_grad_()
    wl = w.clone().requires_grad_()
    out = wc.window_sparse_conv(plan, feats, wl)
    out.backward(cot)
    F8, Fo8 = -(-F // 8) * 8, -(-Fo // 8) * 8
    assert calls == [("fwd", F8, Fo8), ("dgrad", Fo8, F8),
                     ("wgrad", F8, Fo8)]
    ref = wc.sparse_conv_plain(plan, x, w)
    ref_dx, ref_dw = wc.sparse_conv_bwd_plain(plan, x, w, cot)
    for got, want in ((_plain(out), ref), (_plain(feats.grad), ref_dx),
                      (wl.grad, ref_dw)):
        assert got.dtype == bf and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=0)
