"""Port parity: ``infinicube_tpu_torch.ops.attention.multi_head_attention``
(plain version, CPU) against the JAX ``multi_head_attention`` (its einsum path
on the CPU). Kernel K2 is held against the plain version on the card in
tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.ops.attention import multi_head_attention as jax_mha
from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.ops.attention import attention_plain, \
    multi_head_attention

# f32 on both sides; the two differ only in summation order: 2e-3 is the
# repo's f32 parity tolerance (tests/test_wan_torch_parity.py)
TOL = dict(atol=2e-3, rtol=2e-3)


def _qkv(rng, B, nq, nk, h, d):
    q = rng.normal(size=(B, nq, h, d)).astype(np.float32)
    k = rng.normal(size=(B, nk, h, d)).astype(np.float32)
    v = rng.normal(size=(B, nk, h, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,nq,nk,h,d", [
    (2, 64, 64, 2, 16),      # self-attention
    (1, 50, 13, 3, 32),      # cross-attention, Nq != Nk
    (2, 37, 37, 2, 64),      # ragged N
])
def test_plain_attention_matches_jax(B, nq, nk, h, d):
    q, k, v = _qkv(np.random.default_rng(0), B, nq, nk, h, d)
    ref = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = multi_head_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert kernels.launches["flash_attn_bf16"] == 0


def test_plain_attention_chunks_rows(monkeypatch):
    """The row-chunked plain version equals one unchunked pass."""
    import infinicube_tpu_torch.ops.attention as att
    q, k, v = map(torch.from_numpy,
                  _qkv(np.random.default_rng(1), 1, 40, 24, 2, 16))
    full = attention_plain(q, k, v, 0.25)
    monkeypatch.setattr(att, "_PLAIN_CHUNK_ELEMS", 2 * 24 * 7)
    chunked = attention_plain(q, k, v, 0.25)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), atol=1e-6)



def test_plain_attention_takes_bf16_logits_in_f32():
    """On bf16 q, k, v the plain version takes the logits in f32, as K2
    and the TPU library's flash kernel do (f32 products of the bf16
    operands; the reference's einsum route rounds them to bf16 first), and
    the softmax in f32. Logits of some tens, where a bf16 ulp is 0.125:
    the lse within 1e-4 of an f64 oracle on the same bf16 values, and the
    output within one bf16 ulp of its largest value. Logits rounded to
    bf16 move the lse by up to 0.06 and the output by two of those ulps."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(2.5 * a).to(torch.bfloat16)
               for a in _qkv(rng, 1, 64, 64, 2, 16))
    scale = 16 ** -0.5
    out, lse = attention_plain(q, k, v, scale, return_lse=True)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    assert logits.abs().max() > 16
    want_lse = torch.logsumexp(logits, dim=-1)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1),
                        v.double())
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert (lse.double() - want_lse).abs().max() <= 1e-4
    top = want.abs().max()
    ulp = 2.0 ** (torch.floor(torch.log2(top)) - 7)
    assert (out.double() - want).abs().max() <= ulp
