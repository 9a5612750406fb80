"""The f32 attention's gradient on the card's route, checked on the CPU.

On the card an f32 ``multi_head_attention`` that needs a gradient goes
through ``_FlashAttentionF32``: ``flash_attn_f32`` with the rows'
log-sum-exp forward, ``flash_attn_f32_bwd`` backward. The kernels run only
on the card, so here the card's branch is taken with CPU tensors and each
kernel replaced by its plain version (``attention_plain`` with the lse,
``attention_bwd_plain``): what is checked is the route (the forward's lse,
the delta, the head-dim padding and its dropped gradients) against
``jax.grad`` of the reference's einsum attention, at 1e-5 of the largest
reference value (both sides f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.ops.attention import _einsum_attention
from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.ops import attention as att
from tests.test_torch_gsm import one_torch_thread  # noqa: F401


@pytest.fixture
def card(monkeypatch):
    """CPU tensors take the card's branch, with plain kernels that record
    what reached them."""
    calls = []

    def f32(q, k, v, sm_scale, return_lse=False):
        calls.append(("flash_attn_f32", q.shape[-1], return_lse))
        return att.attention_plain(q, k, v, sm_scale, return_lse)

    def f32_bwd(q, k, v, do, lse, delta, sm_scale):
        calls.append(("flash_attn_f32_bwd", q.shape[-1]))
        assert do.dtype == lse.dtype == delta.dtype == torch.float32
        o = att.attention_plain(q, k, v, sm_scale)
        torch.testing.assert_close(delta, att.attention_delta(o, do),
                                   rtol=0, atol=0)
        return att.attention_bwd_plain(q, k, v, o, do, lse, sm_scale)

    monkeypatch.setattr(att, "_on_card", lambda x: True)
    monkeypatch.setattr(kernels, "flash_attn_f32", f32)
    monkeypatch.setattr(kernels, "flash_attn_f32_bwd", f32_bwd)
    return calls


def _inputs(seed, B, nq, nk, h, d):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, nq, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, nk, h, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _jax_grads(q, k, v, do):
    scale = 1.0 / np.sqrt(q.shape[-1])

    def f(q_, k_, v_):
        return jnp.sum(_einsum_attention(q_, k_, v_, scale) * do)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("shape", [(2, 37, 21, 2, 64), (1, 70, 70, 2, 96),
                                   (1, 33, 40, 1, 128)])
def test_gradients_through_the_card_route_match_jax(card, shape):
    """dQ, dK, dV of one f32 call that needs a gradient: one forward with
    the lse, one backward, each within 1e-5 of the largest JAX value."""
    q, k, v, do = _inputs(0, *shape)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = att.multi_head_attention(tq, tk, tv)
    out.backward(torch.from_numpy(do))
    d = shape[-1]
    assert card == [("flash_attn_f32", d, True), ("flash_attn_f32_bwd", d)]
    for got, ref in zip((tq.grad, tk.grad, tv.grad), _jax_grads(q, k, v, do)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_padded_head_dim_gradients_match_jax(card):
    """d = 40 is padded to 64 for the kernels: the zero columns' gradients
    are dropped and the rest are the reference's, at the scale of the true
    head dim."""
    q, k, v, do = _inputs(1, 2, 45, 30, 2, 40)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    att.multi_head_attention(tq, tk, tv).backward(torch.from_numpy(do))
    assert card == [("flash_attn_f32", 64, True), ("flash_attn_f32_bwd", 64)]
    for got, ref in zip((tq.grad, tk.grad, tv.grad), _jax_grads(q, k, v, do)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_forward_lse_matches_jax():
    """The log-sum-exp the f32 forward keeps, the plain version's, against
    the reference's scaled logits."""
    q, k, v, _ = _inputs(2, 2, 37, 21, 2, 64)
    scale = 1.0 / 8.0
    o, lse = att.attention_plain(*map(torch.from_numpy, (q, k, v)), scale,
                                 return_lse=True)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
    ref = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    assert lse.shape == (2, 2, 37) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(
        o.numpy(), np.asarray(_einsum_attention(q, k, v, scale)), rtol=0,
        atol=1e-5)


def test_the_f32_backward_wrapper_takes_card_tensors_only():
    q = torch.zeros((1, 8, 2, 64))
    lse = torch.zeros((1, 2, 8))
    before = kernels.launches["flash_attn_f32_bwd"]
    with pytest.raises(ValueError):
        kernels.flash_attn_f32_bwd(q, q, q, q, lse, lse, 0.125)
    assert kernels.launches["flash_attn_f32_bwd"] == before
