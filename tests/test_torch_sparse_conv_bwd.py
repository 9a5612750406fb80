"""Port parity: the gradients of the sparse conv of ``infinicube_tpu_torch``
(``sparse_conv_bwd_plain`` and the autograd Function behind
``window_sparse_conv``, on the CPU) against ``jax.grad`` of the JAX
``window_sparse_conv`` through its Pallas kernels in interpret mode, on a
window plan that has misses; ``rev_w``; the poison policy of the backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.grid.build import grid_from_ijk as jax_grid_from_ijk
from infinicube_tpu.ops.window_conv import _rev_w, build_window_plan
from infinicube_tpu.ops.window_conv import \
    window_sparse_conv as jax_window_conv
from infinicube_tpu_torch.grid.build import grid_from_ijk
from infinicube_tpu_torch.nn.sparse import SparseConv3d, conv_plan
from infinicube_tpu_torch.ops.window_conv import (rev_w, sparse_conv_bwd_plain,
                                                  window_sparse_conv)
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

CAP = 1024
BOUNDS = ((-16, -16, -16), (32, 32, 32))
F_IN, F_OUT = 16, 24
# f32 on both sides, differing only in summation order; a weight gradient
# sums over some thousand rows, so it is held relative to its largest value
TOL = dict(atol=2e-3, rtol=2e-3)


def _scene(seed=0, n=(900, 600), extent=8):
    """Two sheet-like voxel sets of different sizes (B = 2), negative ijk
    included, with features, weights and an output gradient."""
    rng = np.random.default_rng(seed)
    ijk = np.zeros((2, max(n), 3), np.int32)
    mask = np.zeros((2, max(n)), bool)
    for b, nb in enumerate(n):
        ij = rng.integers(-extent, extent, (nb, 2))
        k = (np.sin(ij[:, :1] * 0.5 + b) * 2).round() + \
            rng.integers(-1, 2, (nb, 1))
        ijk[b, :nb] = np.concatenate([ij, k], -1)
        mask[b, :nb] = True
    jg = jax_grid_from_ijk(jnp.asarray(ijk), jnp.asarray(mask), 0.2, 0.1,
                           capacity=CAP)
    tg = grid_from_ijk(torch.from_numpy(ijk), torch.from_numpy(mask), 0.2,
                       0.1, CAP)
    m = np.asarray(jg.mask)[..., None]
    feats = np.where(m, rng.standard_normal((2, CAP, F_IN)), 0.0)
    cot = np.where(m, rng.standard_normal((2, CAP, F_OUT)), 0.0)
    w = rng.standard_normal((27, F_IN, F_OUT)) * 0.1
    return jg, tg, *(a.astype(np.float32) for a in (feats, w, cot))


@pytest.fixture(scope="module")
def reference():
    """jax.grad through the Pallas kernels (interpret mode on the CPU) on a
    plan whose small windows leave misses to the exact fallback."""
    jg, tg, feats, w, cot = _scene()
    plan = build_window_plan(jg, block_rows=128, window_rows=128,
                             miss_capacity=1 << 16, dense_bounds=BOUNDS)
    assert int(np.asarray(plan.num_missed).sum()) > 0
    assert not np.asarray(plan.overflowed).any()

    def loss(f, w_):
        return jnp.sum(jax_window_conv(plan, f, w_) * jnp.asarray(cot))

    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats),
                                            jnp.asarray(w))
    return jg, tg, feats, w, cot, np.asarray(dx), np.asarray(dw)


def _check(tg, dx, dw, ref_dx, ref_dw):
    m = tg.mask.numpy()
    np.testing.assert_allclose(dx[m], ref_dx[m], **TOL)
    np.testing.assert_array_equal(dx[~m], 0.0)
    np.testing.assert_allclose(dw, ref_dw, rtol=2e-3,
                               atol=2e-3 * np.abs(ref_dw).max())


def test_plain_backward_matches_jax_grad(reference):
    jg, tg, feats, w, cot, ref_dx, ref_dw = reference
    dx, dw = sparse_conv_bwd_plain(
        conv_plan(tg, dense_bounds=BOUNDS), torch.from_numpy(feats),
        torch.from_numpy(w), torch.from_numpy(cot))
    assert dx.shape == feats.shape and dw.shape == w.shape
    _check(tg, dx.numpy(), dw.numpy(), ref_dx, ref_dw)


@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)])
def test_autograd_function_matches_jax_grad(reference, needs):
    """Each gradient only when asked for; a non-contiguous output gradient
    (the transposed product below) goes through."""
    jg, tg, feats, w, cot, ref_dx, ref_dw = reference
    f = torch.from_numpy(feats).requires_grad_(needs[0])
    wt = torch.from_numpy(w).requires_grad_(needs[1])
    out = window_sparse_conv(conv_plan(tg, dense_bounds=BOUNDS), f, wt)
    g = torch.from_numpy(cot.transpose(0, 2, 1).copy()).transpose(1, 2)
    assert not g.is_contiguous()
    out.backward(g)
    assert (f.grad is not None, wt.grad is not None) == needs
    dx = f.grad.numpy() if needs[0] else ref_dx
    dw = wt.grad.numpy() if needs[1] else ref_dw
    _check(tg, dx, dw, ref_dx, ref_dw)


def test_no_gradient_asked_takes_the_plain_forward(reference):
    jg, tg, feats, w, _, _, _ = reference
    plan = conv_plan(tg, dense_bounds=BOUNDS)
    out = window_sparse_conv(plan, torch.from_numpy(feats),
                             torch.from_numpy(w))
    assert out.grad_fn is None
    with torch.no_grad():
        f = torch.from_numpy(feats).requires_grad_()
        assert window_sparse_conv(plan, f, torch.from_numpy(w)).grad_fn is None


def test_rev_w_matches_jax():
    w = np.random.default_rng(3).standard_normal((27, 4, 6)).astype(
        np.float32)
    got = rev_w(torch.from_numpy(w))
    assert got.shape == (27, 6, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_rev_w(
        jnp.asarray(w))))
    np.testing.assert_array_equal(got[5].numpy(), w[21].T)


def test_sparse_conv_module_gradients_follow_the_weight():
    """SparseConv3d trains: its kernel and bias get gradients, and after an
    in-place update of the kernel the input gradient uses the new values
    (the reversed weights are rebuilt per call)."""
    _, tg, feats, w, cot = _scene(seed=1)
    plan = conv_plan(tg, dense_bounds=BOUNDS)
    conv = SparseConv3d(F_IN, F_OUT)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    f = torch.from_numpy(feats).requires_grad_()
    conv(f, plan).backward(torch.from_numpy(cot))
    assert conv.kernel.grad.abs().max() > 0 and conv.bias.grad.abs().max() > 0
    first = f.grad.clone()
    with torch.no_grad():
        conv.kernel.mul_(2.0)
    f.grad = None
    conv(f, plan).backward(torch.from_numpy(cot))
    torch.testing.assert_close(f.grad, 2.0 * first, rtol=1e-5, atol=1e-6)


def test_backward_poisons_nothing():
    """A batch element outside the dense bounds has NaN in every forward
    row, and its input gradient stays finite, as the JAX ``_wc_bwd`` on an
    overflowed plan: the backward replays the stencil without the poison."""
    import dataclasses
    rng = np.random.default_rng(2)
    ijk = np.stack([rng.integers(-4, 4, (300, 3)),
                    rng.integers(-30, 30, (300, 3))]).astype(np.int32)
    mask = np.ones((2, 300), bool)
    tg = grid_from_ijk(torch.from_numpy(ijk), torch.from_numpy(mask), 0.2,
                       0.1, 512)
    plan = conv_plan(tg, dense_bounds=BOUNDS)
    assert plan.violations[0] == 0 and plan.violations[1] > 0
    gen = torch.Generator().manual_seed(0)
    f = torch.randn((2, 512, 8), generator=gen).requires_grad_()
    w = torch.randn((27, 8, 4), generator=gen).requires_grad_()
    g = torch.randn((2, 512, 4), generator=gen)
    out = window_sparse_conv(plan, f, w)
    assert torch.isfinite(out[0]).all() and torch.isnan(out[1]).all()
    out.backward(g)
    assert torch.isfinite(f.grad).all() and torch.isfinite(w.grad).all()
    dx, dw = sparse_conv_bwd_plain(plan, f.detach(), w.detach(), g)
    assert torch.equal(dx, f.grad) and torch.equal(dw, w.grad)
    # the JAX backward of a plan forced to overflow: NaN forward, finite dx
    jg = jax_grid_from_ijk(jnp.asarray(ijk[:1]), jnp.asarray(mask[:1]), 0.2,
                           0.1, capacity=512)
    jplan = build_window_plan(jg, dense_bounds=BOUNDS)
    forced = dataclasses.replace(jplan, num_missed=jnp.full_like(
        jplan.num_missed, jplan.miss_out.shape[1] + 1))
    jf, jw, jc = (jnp.asarray(a.detach().numpy()) for a in (f[:1], w, g[:1]))
    jout, vjp = jax.vjp(lambda a, b: jax_window_conv(forced, a, b), jf, jw)
    assert np.isnan(np.asarray(jout)).all()
    jdx, _ = vjp(jc)
    m = tg.mask[0].numpy()
    np.testing.assert_allclose(f.grad[0].numpy()[m], np.asarray(jdx)[0][m],
                               **TOL)
