"""Port parity for the sparse conv on bf16 features: the plain versions of
``infinicube_tpu_torch`` (the oracle of ``sparse_conv_bf16`` and
``sparse_conv_bf16_wgrad`` on the card) against the JAX package's
``window_sparse_conv`` through its Pallas kernels in interpret mode, forward
and ``jax.grad``, at the sizes of tests/test_torch_sparse_conv.py and
tests/test_torch_sparse_conv_bwd.py; and the rounding contract itself: the
TPU kernels add every tap's product into f32 sums and round once
(``_conv_kernel``'s ``acc``, ``_dw_kernel``, ``_wc_bwd``'s casts), which the
plain versions must too.

The gate is one bf16 ulp per element (of the larger of the two values),
with a floor of 2^-16 of the largest reference value: the two sides sum in
f32 in different orders, and where an element's terms cancel the order
alone moves it by more than its own ulp. Measured: 99.9 % or more of the
elements are bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.ops.window_conv import build_window_plan
from infinicube_tpu.ops.window_conv import \
    window_sparse_conv as jax_window_conv
from infinicube_tpu_torch.nn.sparse import conv_plan
from infinicube_tpu_torch.ops.window_conv import (ConvPlan, pad_width,
                                                  sparse_conv_bwd_plain,
                                                  sparse_conv_plain,
                                                  width_multiple,
                                                  window_sparse_conv)
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.test_torch_sparse_conv import BOUNDS
from tests.test_torch_sparse_conv import _scene as fwd_scene
from tests.test_torch_sparse_conv_bwd import _scene as bwd_scene

BF16 = torch.bfloat16


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 (8 significant bits) at |x|."""
    a = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def hold_ulp(got, ref, mask=None):
    """got within one bf16 ulp of ref element by element (floor: 2^-16 of
    max|ref|); returns the share of elements that are bit-equal."""
    got = torch.as_tensor(np.asarray(got, np.float32)).float()
    ref = torch.as_tensor(np.asarray(ref, np.float32)).float()
    if mask is not None:
        got, ref = got[mask], ref[mask]
    d = (got - ref).abs()
    tol = bf16_ulp(torch.maximum(got.abs(), ref.abs())) + \
        2.0 ** -16 * ref.abs().max()
    assert (d <= tol).all(), f"{int((d > tol).sum())} elements beyond " \
        f"one ulp, worst {float((d - tol).max()):.3e} over"
    return float((got == ref).float().mean())


def _bf16(a):
    """numpy f32 -> (bf16 numpy for JAX, bf16 torch): the same values."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(BF16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def test_bf16_forward_matches_the_pallas_window_conv():
    jg, tg, feats = fwd_scene()
    w = (np.random.default_rng(1).standard_normal((27, 16, 24)) *
         0.1).astype(np.float32)
    plan = build_window_plan(jg, block_rows=128, window_rows=256,
                             dense_bounds=BOUNDS)
    # no misses: the JAX fallback would add them in bf16, a second rounding
    assert int(np.asarray(plan.num_missed).sum()) == 0
    jf, tf = _bf16(feats)
    jw, tw = _bf16(w)
    ref = jax_window_conv(plan, jf, jw)
    assert ref.dtype == jnp.bfloat16
    got = window_sparse_conv(conv_plan(tg, dense_bounds=BOUNDS), tf, tw)
    assert got.dtype == BF16
    m = torch.from_numpy(np.array(jg.mask))
    share = hold_ulp(got.float(), np.asarray(ref.astype(jnp.float32)), m)
    assert share >= 0.99
    assert (got[~m] == 0).all()


@pytest.fixture(scope="module")
def bf16_grads():
    """jax.grad (dx and dW, bf16) through the Pallas kernels in interpret
    mode, on a plan without misses, beside the port's autograd on the same
    bf16 values."""
    import jax
    jg, tg, feats, w, cot = bwd_scene()
    plan = build_window_plan(jg, block_rows=128, window_rows=256,
                             dense_bounds=BOUNDS)
    assert int(np.asarray(plan.num_missed).sum()) == 0
    (jf, tf), (jw, tw), (jc, tc) = (_bf16(a) for a in (feats, w, cot))

    def loss(f, w_):
        return jnp.sum((jax_window_conv(plan, f, w_) * jc).astype(
            jnp.float32))

    dx, dw = jax.grad(loss, argnums=(0, 1))(jf, jw)
    assert dx.dtype == dw.dtype == jnp.bfloat16
    f = tf.clone().requires_grad_()
    wt = tw.clone().requires_grad_()
    window_sparse_conv(conv_plan(tg, dense_bounds=BOUNDS), f, wt).backward(tc)
    return (tg, np.asarray(dx.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)), f.grad, wt.grad)


def test_bf16_input_gradient_matches_jax_grad(bf16_grads):
    tg, ref_dx, _, dx, _ = bf16_grads
    assert dx.dtype == BF16
    m = tg.mask
    assert hold_ulp(dx.float(), ref_dx, m) >= 0.99
    assert (dx[~m] == 0).all()


def test_bf16_weight_gradient_matches_jax_grad(bf16_grads):
    """dW is an f32 sum over every row of both batch elements, rounded to
    the weight's bf16 once."""
    _, _, ref_dw, _, dw = bf16_grads
    assert dw.dtype == BF16
    assert hold_ulp(dw.float(), ref_dw) >= 0.99


def _cancelling_plan():
    """One output row whose 27 taps read rows 0..26 (F = Fo = 1, weights
    1): the first tap brings 256, the last -256 and the 25 between 0.25
    each. Summed in f32 and rounded once that is 6.25; rounded to bf16
    after every tap, 256 + 0.25 stays 256 (its ulp is 2) and the sum ends
    at 0."""
    nbr = torch.full((1, 27, 27), -1, dtype=torch.int32)
    nbr[0, 0] = torch.arange(27, dtype=torch.int32)
    x = torch.full((1, 27, 1), 0.25)
    x[0, 0], x[0, 26] = 256.0, -256.0
    return ConvPlan(nbr, torch.zeros(1, dtype=torch.int32)), x.to(BF16)


def test_plain_bf16_rounds_once_after_f32_sums():
    """The TPU kernels' contract (window_conv.py:173, :342): the forward and
    dx rounded to bf16 once after f32 sums, dW an f32 sum rounded once.
    Rounding per tap gives 0 here, 6.25 apart (many ulps)."""
    plan, x = _cancelling_plan()
    w = torch.ones((27, 1, 1), dtype=BF16)
    out = sparse_conv_plain(plan, x, w)
    assert out.dtype == BF16 and out[0, 0, 0].item() == 6.25
    # dx of the same stencil: rev_w(w) = w here, the output gradient x
    dx, dw = sparse_conv_bwd_plain(plan, x, w, x)
    assert dx.dtype == BF16 and dx[0, 0, 0].item() == 6.25
    # dW[t] = x[t] * x[0]: one product per tap, rounded once
    ref_dw = (x[0, :, 0].double() * x[0, 0, 0].double()).to(BF16)
    assert dw.dtype == BF16 and torch.equal(dw[:, 0, 0], ref_dw)
    # through the autograd function too
    xr = x.clone().requires_grad_()
    wr = w.clone().requires_grad_()
    window_sparse_conv(plan, xr, wr).backward(x)
    assert xr.grad[0, 0, 0].item() == 6.25 and torch.equal(wr.grad, dw)


def test_f32_is_unchanged_by_the_contract():
    """In f32 the single rounding is the f32 sum itself: the plain version
    is the f32 gather-GEMM of the parent, tap by tap."""
    plan, x = _cancelling_plan()
    x, w = x.float(), torch.ones((27, 1, 1))
    out = sparse_conv_plain(plan, x, w)
    acc = torch.zeros_like(out)
    for t in range(27):
        idx = plan.nbr[:, :, t].long()
        tap = torch.where((idx >= 0)[..., None],
                          x[0][idx.clamp_min(0)], torch.zeros(()))
        acc = acc + tap @ w[t]
    assert out.dtype == torch.float32 and torch.equal(out, acc)


@pytest.mark.parametrize("dtype,mult", [(torch.float32, 4), (BF16, 8)])
def test_width_multiple_by_dtype(dtype, mult):
    """16-byte row pieces: 4 f32 or 8 bf16 features; a bf16 width that is
    not a multiple of 8 is zero-padded exactly."""
    assert width_multiple(dtype) == mult
    t = torch.randn((2, 5, 30)).to(dtype)
    p = pad_width(t, -1)
    assert p.shape[-1] == -(-30 // mult) * mult and p.dtype == dtype
    assert torch.equal(p[..., :30], t) and (p[..., 30:] == 0).all()
