"""Port parity: the int8-PV attention (``quant="qkv"``) of
``infinicube_tpu_torch.ops.flash_attention`` against the JAX kernel in
Pallas interpret mode, and a tiny DiT that selects it. Kernel K8 is held
against the plain version on the card in tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.wan.dit import WanDiTConfig as JaxCfg
from infinicube_tpu.ops.flash_attention import _channel_quantize
from infinicube_tpu.ops.flash_attention import mha_quantized as jax_mhaq
from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.models.wan.dit import WanDiTConfig
from infinicube_tpu_torch.ops.flash_attention import (block_quantize,
                                                      channel_quantize,
                                                      fold_heads,
                                                      int8qkv_attention_plain,
                                                      mha_quantized,
                                                      quant_blocks)
from tests.test_torch_wan_dit import TINY, _cos, _inputs, _run_both


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_channel_quantize_equals_reference(dtype):
    """Same int8 values and per-(BH, channel) scales, bit for bit, with a
    channel of tiny range and an all-zero channel (the 1e-8 floor)."""
    x = np.random.default_rng(0).normal(size=(3, 300, 64)).astype(np.float32)
    x[1, :, 5] *= 1e-3
    x[2, :, 7] = 0.0
    xj = jnp.asarray(x, dtype)
    q_ref, s_ref = _channel_quantize(xj)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    if dtype is jnp.bfloat16:
        xt = xt.to(torch.bfloat16)
    q, s = channel_quantize(xt)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def _qkv(B, N, h, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, N, h, d)).astype(np.float32)
               for _ in range(3))
    v *= rng.uniform(0.1, 4.0, d).astype(np.float32)   # a range per channel
    return q, k, v


@pytest.mark.parametrize("B,N,h,d", [(1, 300, 2, 64), (1, 1700, 2, 64),
                                     (2, 130, 2, 128)])
def test_int8qkv_matches_jax(B, N, h, d):
    """N = 1,700 pads to 3,072 in two 1,536-key blocks, so the running max
    crosses a block. Same int8 inputs and the same blocking on both sides:
    the outputs differ only where a last-bit difference of P moves its int8
    rounding (cosine >= 0.99999, max-abs <= 1e-3 of max |out|)."""
    q, k, v = _qkv(B, N, h, d, seed=N)
    ref = np.asarray(jax_mhaq(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              quant="qkv"))
    out = mha_quantized(*map(torch.from_numpy, (q, k, v)), quant="qkv")
    assert out.shape == (B, N, h, d) and out.dtype == torch.float32
    assert _cos(out.numpy(), ref) >= 0.99999
    assert np.abs(out.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()
    assert kernels.launches["flash_attn_int8qkv"] == 0


def test_plain_int8qkv_is_the_blocked_running_max():
    """The plain version spelled out once more in f64 over the same int8
    inputs: one 1,536-key block at a time, P rounded against the running
    max of the blocks so far."""
    q, k, v = _qkv(1, 1600, 1, 64, seed=3)
    block, npad = quant_blocks(1600)
    q8, sq = block_quantize(fold_heads(torch.from_numpy(q), npad), block)
    k8, sk = block_quantize(fold_heads(torch.from_numpy(k), npad), block)
    v8, sv = channel_quantize(fold_heads(torch.from_numpy(v), npad))
    out = int8qkv_attention_plain(q8, k8, sq, sk, v8, sv, 1600, block,
                                  0.125, torch.float32)[0].double()
    qd, kd, vd = q8[0].double(), k8[0].double(), v8[0].double()
    s = (qd @ kd.T) * 0.125 * np.log2(np.e)
    s = s * sq[0].double().repeat_interleave(block)[:, None] * \
        sk[0].double().repeat_interleave(block)[None, :]
    s[:, 1600:] = -np.inf
    m = torch.full((npad, 1), -np.inf, dtype=torch.float64)
    num = torch.zeros((npad, 64), dtype=torch.float64)
    den = torch.zeros((npad, 1), dtype=torch.float64)
    for j in range(npad // block):
        sj = s[:, j * block:(j + 1) * block]
        m_new = torch.maximum(m, sj.amax(1, keepdim=True))
        p = torch.exp2(sj - m_new)
        a = torch.exp2(m - m_new)
        den = den * a + p.sum(1, keepdim=True)
        num = num * a + torch.floor(p * 127 + 0.5) @ \
            vd[j * block:(j + 1) * block] * (sv[0].double() / 127)
        m = m_new
    ref = (num / den)[:1600]
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_tiny_dit_with_int8_pv_matches_jax():
    """WanDiTConfig(attn_quant="qkv"): self-attention through the int8-PV
    path, cross-attention through the bf16 one, on both sides."""
    inputs = _inputs()
    out, ref = _run_both(
        JaxCfg(**TINY, dtype=jnp.float32, attn_quant="qkv"),
        WanDiTConfig(**TINY, dtype=torch.float32, attn_quant="qkv"), inputs)
    assert out.shape == ref.shape
    assert _cos(out, ref) >= 0.9999
    assert kernels.launches["flash_attn_int8qkv"] == 0
