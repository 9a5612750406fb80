"""The arithmetic of the card's f32 attention backward on the CPU.

``flash_attn_f32_bwd`` (csrc/flash_attention_f32_bwd.cu) takes every product
on tf32 ``wgmma`` by the 3xTF32 split. A prologue writes the tf32 hi and lo
of q, k, v and dout as they lie and of q, dout and k token-major, the
tokens of each 8 in the order 0, 2, 4, 6, 1, 3, 5, 7
(``kernels.f32_bwd_prologue_plain``), so that a row of P or dS taken from
the accumulators is an A fragment. Then a dK/dV pass over 64-key items and
a dQ pass over 64-query items, each streaming tiles of BT rows (32 at
d = 64, 16 at 96 and in the dQ pass at 128, 8 in the dK/dV pass at 128):
per tile X = A1 B1^T and Y = A2 B2^T (S^T and dP^T, or S and dP), P and dS,
and the products over the tile's rows into sums of their own that are
added into f32 sums with a rounded add; two warpgroups take the tiles in
turn, and their sums are added, the first's first; where items are few the
streamed axis is split into ranges whose partial sums a combine pass adds
in range order, then scales.

Here that arithmetic is emulated in plain PyTorch as the tensor cores run
it (every k8 step adds its eight exact tf32 products to the running sum and
truncates to f32), reading the token-major operands through the
prologue's plain form with P and dS in the positions the permuted layout
gives them, and held against an f64 reference and against ``jax.grad`` of
the reference's einsum attention (``infinicube_tpu/ops/attention.py:19``)
at ``chip_smoke.py``'s gate for the kernel, max-abs <= 1e-4 * max|ref| of
each gradient. Small shapes, one torch thread: about 5 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.ops.attention import _einsum_attention
from infinicube_tpu_torch import kernels
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.test_torch_tf32x3_f32_kernels import rz

GATE = 1e-4
LOG2E = 1.4426950408889634


def stream_tile(d, dkv):
    return 32 if d == 64 else 16 if d == 96 or not dkv else 8


def products(a_parts, b_parts):
    """sum_k a[:, :, k] b[:, k, :] over k8 steps as the tensor cores take
    it: for each step, each of the three products in order (lo_A hi_B,
    hi_A lo_B, hi_A hi_B) added to the running f32 sum and truncated; the
    first overwrites (a sum of its own). a_parts: (hi, lo) [BH, M, K];
    b_parts: (hi, lo) [BH, K, N]."""
    (ah, al), (bh, bl) = a_parts, b_parts
    acc = None
    for k0 in range(0, ah.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for a, b in ((al, bh), (ah, bl), (ah, bh)):
            prod = a[..., ks].double() @ b[..., ks, :].double()
            acc = rz(prod if acc is None else acc.double() + prod)
    return acc


def split(x):
    """f32 x as its tf32 (hi, lo)."""
    hi = (x.contiguous().view(torch.int32) & -8192).view(torch.float32)
    lo = ((x - hi).contiguous().view(torch.int32) & -8192).view(
        torch.float32)
    return hi, lo


def one_pass(dkv, items, stream, tmajor, lse2, delta, n_str, d,
             scale_log2, splits, parity):
    """One pass of the kernel over every (batch*head): the item rows' sums
    of dV and dK (dkv) or dQ, unscaled, as the kernel adds them up.
    items: (A1, A2) as (hi, lo) [BH, n_item, d]; stream: (B1, B2) as (hi,
    lo) [BH, n_str, d]; tmajor: the token-major packs the products read
    ((dO^T, Q^T) or (K^T,)), each [2, BH, d, n_str rounded up to 8];
    lse2 (base 2), delta [BH, nq]."""
    bt = stream_tile(d, dkv)
    n_tiles = -(-n_str // bt)
    per = -(-n_tiles // splits)
    # a thread's accumulators hold the tile's columns 2c and 2c + 1 of each
    # 8; the tf32 A fragment takes them as positions c and c + 4
    order = torch.tensor([2 * (p % 4) + p // 4 for p in range(8)])
    outs = []
    for _ in tmajor:
        outs.append(torch.zeros((splits,) + items[0][0].shape))
    for s in range(splits):
        wg_sums = [[torch.zeros(items[0][0].shape) for _ in tmajor]
                   for _ in range(2)]
        for t in range(s * per, min(n_tiles, (s + 1) * per)):
            wg = (t - s * per + parity) % 2
            rows = slice(t * bt, t * bt + bt)
            pad = max(0, t * bt + bt - n_str)

            def tile(x):  # rows of a streamed pack, zeros past n_str
                return torch.nn.functional.pad(x[:, rows], (0, 0, 0, pad))
            x = products(items[0], [tile(p).transpose(1, 2)
                                    for p in stream[0]])
            y = products(items[1], [tile(p).transpose(1, 2)
                                    for p in stream[1]])
            cols = torch.arange(t * bt, t * bt + bt)
            if dkv:  # columns are queries: lse and D of each
                ok = cols < n_str
                l2 = torch.where(ok, lse2[:, cols.clamp(max=n_str - 1)],
                                 torch.inf)[:, None, :]
                dd = torch.where(ok, delta[:, cols.clamp(max=n_str - 1)],
                                 0.0)[:, None, :]
                p = torch.exp2(x.double() * scale_log2 - l2).float()
            else:  # rows are queries; keys past n_str masked
                l2, dd = lse2[:, :, None], delta[:, :, None]
                p = torch.exp2(x.double() * scale_log2 - l2).float()
                p = torch.where(cols[None, None] < n_str, p, 0.0)
            ds = p * (y - dd)
            # the A operand in the token-major layout's positions
            pos = (torch.arange(bt) // 8 * 8 +
                   order[torch.arange(bt) % 8])
            zs = (p, ds) if dkv else (ds,)
            for o, (z, tm) in enumerate(zip(zs, tmajor)):
                zp = split(z[..., pos])
                b = [tm[i][:, :, t * bt:t * bt + bt] for i in range(2)]
                b = [torch.nn.functional.pad(x_, (0, bt - x_.shape[-1]))
                     .transpose(1, 2) for x_ in b]
                fresh = products(zp, b)
                wg_sums[wg][o] = wg_sums[wg][o] + fresh
        for o in range(len(tmajor)):
            outs[o][s] = wg_sums[0][o] + wg_sums[1][o]
    return outs


def combine(part, scale):
    acc = torch.zeros(part.shape[1:])
    for s in range(part.shape[0]):
        acc = acc + part[s]
    return acc * scale


def bwd_emulation(q, k, v, do, lse, delta, scale, splits=(1, 1), parity=0):
    """dq, dk, dv [B, N, h, d] as ``flash_attn_f32_bwd`` computes them."""
    scale_log2 = float(np.float32(scale * LOG2E))
    B, nq, h, d = q.shape
    nk = k.shape[1]
    dm = {n: kernels.f32_bwd_prologue_plain(x)
          for n, x in (("q", q), ("k", k), ("v", v), ("do", do))}
    lse2 = (lse.reshape(B * h, nq).double() * np.float32(LOG2E)).float() \
        .double()
    dlt = delta.reshape(B * h, nq)
    dv, dk = one_pass(True, (dm["k"][0], dm["v"][0]),
                      (dm["q"][0], dm["do"][0]), (dm["do"][1], dm["q"][1]),
                      lse2, dlt, nq, d, scale_log2, splits[0], parity)
    dq, = one_pass(False, (dm["q"][0], dm["do"][0]),
                   (dm["k"][0], dm["v"][0]), (dm["k"][1],), lse2, dlt, nk, d,
                   scale_log2, splits[1], parity)
    dq, dk, dv = combine(dq, scale), combine(dk, scale), combine(dv, 1.0)

    def back(x, n):
        return x.reshape(B, h, n, d).permute(0, 2, 1, 3)
    return back(dq, nq), back(dk, nk), back(dv, nk)


def reference(q, k, v, do, scale):
    """f64 gradients, the forward's f32 lse and D."""
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", q64, k64) * scale
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v64)
    delta = (o * do64).sum(-1).transpose(1, 2)
    dp = torch.einsum("bqhd,bkhd->bhqk", do64, v64)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k64) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q64) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do64)
    return (dq, dk, dv), lse.float(), delta.float()


def _inputs(seed, B, nq, nk, h, d):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, nq, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, nk, h, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _err(got, ref):
    return ((got.double() - ref.double()).abs().max() /
            ref.double().abs().max()).item()


def test_prologue_layout_matches_numpy():
    """The prologue's plain form: hi the tf32 truncation, lo that of the
    rest; token-major with the tokens of each 8 in the order 0, 2, 4, 6, 1,
    3, 5, 7 and zeros past N."""
    x = np.random.default_rng(1).standard_normal((2, 13, 3, 64)) \
        .astype(np.float32)
    dm, tm = kernels.f32_bwd_prologue_plain(torch.from_numpy(x))
    rows = x.transpose(0, 2, 1, 3).reshape(6, 13, 64)
    hi = (rows.view(np.int32) & -8192).view(np.float32)
    lo = ((rows - hi).view(np.int32) & -8192).view(np.float32)
    np.testing.assert_array_equal(dm.numpy(), np.stack([hi, lo]))
    want = np.zeros((2, 6, 64, 16), np.float32)
    for p in range(16):
        tok = p // 8 * 8 + (0, 2, 4, 6, 1, 3, 5, 7)[p % 8]
        if tok < 13:
            want[0, :, :, p] = hi[:, tok]
            want[1, :, :, p] = lo[:, tok]
    np.testing.assert_array_equal(tm.numpy(), want)


@pytest.mark.parametrize("shape,splits,parity", [
    ((1, 70, 45, 2, 64), (1, 1), 0),     # Nq != Nk off the tiles
    ((1, 70, 45, 2, 64), (2, 2), 1),     # ranges, the other tile parity
    ((1, 40, 33, 1, 96), (3, 1), 0),
    ((1, 37, 21, 1, 128), (2, 2), 0)])
def test_emulated_backward_holds_the_gate(shape, splits, parity):
    """The emulated kernel (3xTF32 products, sums flushed per tile, the
    warpgroups' sums and the ranges added in order) against f64 and
    against ``jax.grad`` of ``_einsum_attention``: each gradient within
    1e-4 * max|ref|."""
    q, k, v, do = _inputs(0, *shape)
    d = shape[-1]
    scale = d ** -0.5
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    ref64, lse, delta = reference(tq, tk, tv, tdo, scale)
    got = bwd_emulation(tq, tk, tv, tdo, lse, delta, scale, splits, parity)
    for g, r in zip(got, ref64):
        assert g.shape == r.shape
        assert _err(g, r) <= GATE

    def f(q_, k_, v_):
        return jnp.sum(_einsum_attention(q_, k_, v_, scale) * do)
    jgrads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    for g, r in zip(got, jgrads):
        assert _err(g, torch.from_numpy(np.array(r))) <= GATE
