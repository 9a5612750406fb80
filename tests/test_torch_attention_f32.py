"""f32 attention on the card's route, checked on the CPU.

The reference serves attention in the inputs' dtype (an f32 einsum with an
f32 softmax, or the library Pallas kernel in f32 on the TPU). On the card
``multi_head_attention`` sends f32 tensors to ``flash_attn_f32`` (and, with
a gradient, its backward to ``flash_attn_f32_bwd``), and bf16 ones to K2 /
K5. The kernels run only on the card, so here the card's branch is taken
with CPU tensors and each kernel replaced by its plain version: what is
checked is the dispatch by dtype and gradient, and an f32 UNet whose
SelfAttention3D blocks and convs all take the card's branch, against the
JAX UNet."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.diffusion.unet3d import UNet3D as JaxUNet
from infinicube_tpu.ops.attention import multi_head_attention as jax_mha
from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.models.diffusion.unet3d import (SelfAttention3D,
                                                          UNet3D)
from infinicube_tpu_torch.ops import attention as att
from infinicube_tpu_torch.ops import dense_conv as dc
from infinicube_tpu_torch.weights.from_jax import unet_from_jax
from tests.test_torch_dense_conv_widths import _fake_k3
from tests.test_torch_unet3d import filled_params


@pytest.fixture
def card(monkeypatch):
    """CPU tensors take the card's branch of the attention (and of the dense
    conv), with plain kernels that record what reached them."""
    calls = []

    def f32(q, k, v, sm_scale, return_lse=False):
        assert q.dtype == k.dtype == v.dtype == torch.float32
        calls.append(("flash_attn_f32", q.shape[1], k.shape[1], q.shape[-1]))
        return att.attention_plain(q, k, v, sm_scale, return_lse)

    def f32_bwd(q, k, v, do, lse, delta, sm_scale):
        calls.append(("flash_attn_f32_bwd", q.shape[1], k.shape[1],
                      q.shape[-1]))
        o = att.attention_plain(q, k, v, sm_scale)
        return att.attention_bwd_plain(q, k, v, o, do, lse, sm_scale)

    def bf16(q, k, v, sm_scale, return_lse=False):
        assert q.dtype == torch.bfloat16
        calls.append(("flash_attn_bf16", q.shape[1], k.shape[1], q.shape[-1]))
        return att.attention_plain(q, k, v, sm_scale, return_lse)

    def bf16_bwd(q, k, v, do, lse, delta, sm_scale):
        calls.append(("flash_attn_bf16_bwd", q.shape[1], k.shape[1],
                      q.shape[-1]))
        o = att.attention_plain(q, k, v, sm_scale)
        return att.attention_bwd_plain(q, k, v, o, do, lse, sm_scale)

    monkeypatch.setattr(att, "_on_card", lambda x: True)
    monkeypatch.setattr(kernels, "flash_attn_f32", f32)
    monkeypatch.setattr(kernels, "flash_attn_f32_bwd", f32_bwd)
    monkeypatch.setattr(kernels, "flash_attn_bf16", bf16)
    monkeypatch.setattr(kernels, "flash_attn_bf16_bwd", bf16_bwd)
    monkeypatch.setattr(dc, "_on_card", lambda x: True)
    conv_calls = []
    monkeypatch.setattr(kernels, "conv3x3x3_f32", _fake_k3(conv_calls))
    return calls


def _qkv(seed, B=2, nq=37, nk=21, h=2, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, n, h, d)).astype(np.float32)
                 for n in (nq, nk, nk))


@pytest.mark.parametrize("nq,nk", [(37, 37), (37, 21)])
def test_f32_goes_to_the_f32_kernel(card, nq, nk):
    """f32 without a gradient reaches ``flash_attn_f32`` alone, and the
    result is the reference's f32 attention."""
    q, k, v = _qkv(0, nq=nq, nk=nk)
    with torch.no_grad():
        out = att.multi_head_attention(*map(torch.from_numpy, (q, k, v)))
    assert card == [("flash_attn_f32", nq, nk, 64)]
    assert out.dtype == torch.float32
    ref = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-3, rtol=2e-3)


def test_f32_with_a_gradient_raises_on_the_card(card):
    """An f32 call on the card that needs a gradient launches
    ``flash_attn_f32`` once (with the lse) and, in the backward,
    ``flash_attn_f32_bwd`` once, and its gradients are those of the plain
    attention under autograd; nothing reaches K2 or K5."""
    arrays = _qkv(1)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    do = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 37, 2, 16)).astype(np.float32))
    att.multi_head_attention(q, k, v).backward(do)
    assert card == [("flash_attn_f32", 37, 21, 64),
                    ("flash_attn_f32_bwd", 37, 21, 64)]
    pq, pk, pv = (torch.from_numpy(a).requires_grad_() for a in arrays)
    att.attention_plain(pq, pk, pv, 0.25).backward(do)
    for got, ref in ((q.grad, pq.grad), (k.grad, pk.grad),
                     (v.grad, pv.grad)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def test_bf16_keeps_k2_and_k5(card):
    """bf16 goes to K2 without a gradient and through K2 and K5 with one."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(2))
    with torch.no_grad():
        att.multi_head_attention(q, k, v)
    assert card == [("flash_attn_bf16", 37, 21, 64)]
    q.requires_grad_()
    att.multi_head_attention(q, k, v).float().sum().backward()
    assert [c[0] for c in card] == ["flash_attn_bf16", "flash_attn_bf16",
                                    "flash_attn_bf16_bwd"]
    assert q.grad is not None and q.grad.shape == q.shape


def test_f32_unet_with_attention_through_the_card_route_matches_jax(card):
    """A tiny f32 UNet with SelfAttention3D at ds 2 whose attention and
    convs all take the card's branch, against the JAX UNet on the same
    weights: every SelfAttention3D call reaches ``flash_attn_f32`` once,
    nothing reaches K2."""
    small = dict(out_channels=8, model_channels=16, channel_mult=(1, 2),
                 num_res_blocks=1, attention_ds=(2,), num_heads=2,
                 transformer_depth=1)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 8, 8, 8, 16)).astype(np.float32)
    t = np.array([250], np.int32)
    jnet = JaxUNet(**small, dtype=jnp.float32)
    params = filled_params(jnet, jnp.asarray(x), jnp.asarray(t), seed=7)
    ref = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(t)))
    net = UNet3D(in_channels=16, **small, dtype=torch.float32)
    net.load_state_dict(unet_from_jax(params))
    with torch.no_grad():
        out = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    n_attn = sum(isinstance(m, SelfAttention3D) for m in net.modules())
    assert n_attn == 3
    # 4^3 tokens at ds 2, 32 channels in 2 heads
    assert card == [("flash_attn_f32", 64, 64, 64)] * n_attn
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=2e-3)


def test_release_unet_has_ten_self_attention_blocks():
    """The release config's SelfAttention3D count, which fixes the f32
    attention launches of one UNet call on the card: 2 + 2 on the way down
    (ds 4 and 8), 3 + 3 on the way up."""
    net = UNet3D(in_channels=16, out_channels=8, model_channels=8,
                 channel_mult=(1, 2, 4, 4), num_res_blocks=2,
                 attention_ds=(4, 8), num_heads=8, transformer_depth=1,
                 dtype=torch.float32, device="meta")
    assert sum(isinstance(m, SelfAttention3D) for m in net.modules()) == 10


def test_the_f32_wrapper_takes_card_tensors_only():
    q = torch.zeros((1, 8, 2, 64))
    before = kernels.launches["flash_attn_f32"]
    with pytest.raises(ValueError):
        kernels.flash_attn_f32(q, q, q, 0.125)
    assert kernels.launches["flash_attn_f32"] == before
