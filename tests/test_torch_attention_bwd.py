"""Port parity: ``attention_bwd_plain`` (the formulas K5 follows) and the
log-sum-exp of ``attention_plain`` against ``jax.grad`` through the JAX
``multi_head_attention`` (einsum path on the CPU) and against torch autograd
through ``attention_plain``, f32 on all sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.ops.attention import multi_head_attention as jax_mha
from infinicube_tpu_torch.ops.attention import (attention_bwd_plain,
                                                attention_delta,
                                                attention_plain,
                                                multi_head_attention)

# Nq != Nk, lengths that are not multiples of 64, d = 96 and 128
SHAPES = [(1, 70, 70, 2, 96), (2, 33, 130, 3, 128), (1, 100, 9, 1, 96)]


def _case(shape, seed=0):
    B, nq, nk, h, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, nq, h, d)).astype(np.float32)
    k = rng.standard_normal((B, nk, h, d)).astype(np.float32)
    v = rng.standard_normal((B, nk, h, d)).astype(np.float32)
    do = rng.standard_normal((B, nq, h, d)).astype(np.float32)
    return q, k, v, do


def _assert_close(got, ref):
    """Within 2e-3 of the largest reference value (f32 on both sides,
    differing in summation order and in exp(S - lse) against softmax)."""
    lim = 2e-3 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=lim, rtol=2e-3)


def _plain_grads(q, k, v, do):
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    o, lse = attention_plain(tq, tk, tv, scale, return_lse=True)
    return o, lse, attention_bwd_plain(tq, tk, tv, o, tdo, lse, scale)


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_matches_jax_grad(shape):
    q, k, v, do = _case(shape)
    ref = jax.grad(lambda a, b, c: jnp.sum(jax_mha(a, b, c) * do),
                   argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _, _, got = _plain_grads(q, k, v, do)
    for g, r in zip(got, ref):
        _assert_close(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_matches_autograd(shape):
    q, k, v, do = _case(shape, seed=1)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = multi_head_attention(*leaves)        # CPU: plain version, autograd
    out.backward(torch.from_numpy(do))
    _, _, got = _plain_grads(q, k, v, do)
    for g, leaf in zip(got, leaves):
        _assert_close(g.numpy(), leaf.grad.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_lse_and_delta(shape):
    q, k, v, do = _case(shape, seed=2)
    o, lse, _ = _plain_grads(q, k, v, do)
    B, nq, nk, h, d = shape
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    ref = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + \
        logits.max(-1)
    assert lse.shape == (B, h, nq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(jax_mha(
        *map(jnp.asarray, (q, k, v)))), atol=2e-5, rtol=2e-5)
    delta = attention_delta(o, torch.from_numpy(do))
    assert delta.shape == (B, h, nq) and delta.is_contiguous()
    np.testing.assert_allclose(
        delta.numpy(), (o.numpy() * do).sum(-1).transpose(0, 2, 1),
        atol=1e-5, rtol=1e-5)


def test_bwd_plain_in_query_chunks(monkeypatch):
    """Chunking the query rows changes nothing."""
    from infinicube_tpu_torch.ops import attention as att
    q, k, v, do = _case((1, 50, 40, 2, 96), seed=3)
    o, lse, whole = _plain_grads(q, k, v, do)
    monkeypatch.setattr(att, "_PLAIN_CHUNK_ELEMS", 7 * 2 * 40)
    o2, lse2, parts = _plain_grads(q, k, v, do)
    np.testing.assert_allclose(lse2.numpy(), lse.numpy(), atol=1e-6)
    for a, b in zip(parts, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
