"""Port parity: ``infinicube_tpu_torch.ops.flash_attention`` against the JAX
int8-QK flash attention (Pallas interpret mode on the CPU, as
tests/test_quant.py runs it). Kernel K1 is held against its plain version on
the card in tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.ops.flash_attention import _block_quantize
from infinicube_tpu.ops.flash_attention import mha_quantized as jax_mhaq
from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.ops.attention import multi_head_attention
from infinicube_tpu_torch.ops.flash_attention import (block_quantize,
                                                      fold_heads,
                                                      int8qk_attention_plain,
                                                      mha_quantized,
                                                      quant_blocks)


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_block_quantize_equals_reference(dtype):
    """Same int8 values and scales, bit for bit (round half to even on both
    sides), in f32 and from bf16 inputs."""
    x = np.random.default_rng(0).normal(size=(3, 512, 64)).astype(np.float32)
    x[1, :128] *= 1e-3     # a block with a tiny range
    x[2, 128:256] = 0.0    # an all-zero block (the 1e-8 floor)
    xj = jnp.asarray(x, dtype)
    q_ref, s_ref = _block_quantize(xj, 128)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    if dtype is jnp.bfloat16:
        xt = xt.to(torch.bfloat16)
    q, s = block_quantize(xt, 128)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


@pytest.mark.parametrize("n,bq,npad", [(300, 512, 512), (7800, 1536, 9216),
                                       (37440, 1536, 38400), (100, 128, 128)])
def test_block_choice_matches_reference(n, bq, npad):
    assert quant_blocks(n) == (bq, npad)


@pytest.mark.parametrize("B,N,h,d", [(1, 300, 2, 64), (2, 130, 2, 128)])
def test_mha_quantized_matches_jax(B, N, h, d):
    """int8 paths on both sides: the same int8 inputs, so the two agree to
    f32 rounding; the repo's int8 gate is cosine >= 0.999."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(B, N, h, d)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jax_mhaq(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              quant="qk"))
    out = mha_quantized(*map(torch.from_numpy, (q, k, v)), quant="qk")
    assert out.shape == (B, N, h, d)
    assert _cos(out.numpy(), ref) >= 0.999
    assert kernels.launches["flash_attn_int8qk"] == 0


def _scale_blocks(x, block, factors):
    """Multiply each block of rows (axis 1) of x by its own factor, so that
    every block gets a different quantization scale."""
    f = np.repeat(factors, block)[:x.shape[1]]
    return (x * f[None, :, None, None]).astype(np.float32)


@pytest.mark.parametrize("B,N,h,d", [(1, 300, 2, 64), (2, 520, 2, 128)])
def test_per_block_scales_match_jax(B, N, h, d):
    """Several quantization blocks (128 rows on both sides), each with its
    own scale for q and for k: the plain int8 path must pair every query
    and key row with its own block's scale. Same int8 inputs on both sides,
    so the repo's int8 gate cosine >= 0.999 holds; a block read with
    another block's scale (the factors differ up to 4x) fails it."""
    rng = np.random.default_rng(1)
    block = 128
    nb = -(-N // block)
    q, k, v = (rng.normal(size=(B, N, h, d)).astype(np.float32)
               for _ in range(3))
    q = _scale_blocks(q, block, np.geomspace(0.5, 2.0, nb))
    k = _scale_blocks(k, block, np.geomspace(2.0, 0.5, nb))
    ref = np.asarray(jax_mhaq(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              quant="qk", block_q=block, block_k=block))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    q8, sq = block_quantize(fold_heads(qt, nb * block), block)
    k8, sk = block_quantize(fold_heads(kt, nb * block), block)
    assert len(set(sq[0].tolist())) == nb and len(set(sk[0].tolist())) == nb
    out = int8qk_attention_plain(q8, k8, sq, sk, vt, block, d ** -0.5)
    assert out.shape == (B, N, h, d)
    assert _cos(out.numpy(), ref) >= 0.999


def test_plain_int8_path_chunks_rows(monkeypatch):
    """The row-chunked plain version equals one unchunked pass, with the
    last chunk ending at the real N (not in the padding)."""
    import infinicube_tpu_torch.ops.attention as att
    q, k, v = (torch.from_numpy(np.random.default_rng(i).normal(
        size=(1, 300, 2, 32)).astype(np.float32)) for i in range(3))
    full = mha_quantized(q, k, v)
    monkeypatch.setattr(att, "_PLAIN_CHUNK_ELEMS", 2 * 300 * 7)
    np.testing.assert_allclose(mha_quantized(q, k, v).numpy(), full.numpy(),
                               atol=1e-6)


def test_mha_quantized_routes():
    """"none" is the bf16 attention, "qkv" the int8-PV plain version (it no
    longer raises), anything else an error."""
    q, k, v = (torch.from_numpy(np.random.default_rng(i).normal(
        size=(1, 40, 2, 16)).astype(np.float32)) for i in range(3))
    np.testing.assert_array_equal(mha_quantized(q, k, v, quant="none"),
                                  multi_head_attention(q, k, v))
    out = mha_quantized(q, k, v, quant="qkv")
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert not torch.equal(out, mha_quantized(q, k, v, quant="qk"))
    with pytest.raises(ValueError):
        mha_quantized(q, k, v, quant="fp8")

