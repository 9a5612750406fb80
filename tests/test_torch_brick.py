"""Port parity: ``infinicube_tpu_torch.nn.brick`` (the brick plan, the
round trip through the bricks, ``halo_pad`` and both conv forms) against
the JAX brick functions on the same grid and features, and the brick
backend of ``SparseConv3d`` and ``SparseResBlock`` (brick-resident)
against the JAX modules and the port's gather conv; the overflow raise and
a finite gradient. f32 on both sides, differing only in summation order:
ROADMAP's atol/rtol 2e-3 (the plans are integer, held exactly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.grid.build import grid_from_ijk as j_grid_from_ijk
from infinicube_tpu.nn import brick as jbrick
from infinicube_tpu.nn import sparse as jsparse
from infinicube_tpu_torch.grid.build import grid_from_ijk
from infinicube_tpu_torch.nn import brick
from infinicube_tpu_torch.nn import sparse
from infinicube_tpu_torch.weights.from_jax import sparse_vae_from_jax
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-3, rtol=2e-3)
CAP, FIN, FOUT = 256, 6, 10


def grids(seed=0):
    """Two batch rows of a clustered scene (locally dense, as bricks
    want), one much emptier."""
    rng = np.random.default_rng(seed)
    ijk = rng.integers(-4, 4, (2, 300, 3)).astype(np.int32)
    mask = np.ones((2, 300), bool)
    mask[1, 40:] = False
    jg = j_grid_from_ijk(jnp.asarray(ijk), jnp.asarray(mask), 0.2, 0.1,
                         capacity=CAP)
    tg = grid_from_ijk(torch.from_numpy(ijk), torch.from_numpy(mask), 0.2,
                       0.1, capacity=CAP)
    feats = rng.normal(size=(2, CAP, FIN)).astype(np.float32)
    feats[~np.asarray(jg.mask)] = 0.0
    return jg, tg, feats


def test_plan_round_trip_and_convs():
    jg, tg, feats = grids()
    jplan = jbrick.build_brick_plan(jg)
    plan = brick.build_brick_plan(tg)
    for name in ("brick_mask", "dense_src", "voxel_dst", "nbr_brick",
                 "num_dropped"):
        np.testing.assert_array_equal(getattr(plan, name).numpy(),
                                      np.asarray(getattr(jplan, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(plan.brick_keys.numpy(),
                                  np.asarray(jplan.brick_keys).astype(
                                      np.int64))
    assert int(plan.num_dropped.sum()) == 0
    f = torch.from_numpy(feats)
    bricks = brick.to_bricks(plan, f)
    assert torch.equal(brick.from_bricks(plan, bricks), f)
    padded = brick.halo_pad(plan, bricks)
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jax.jit(lambda p, f: jbrick.halo_pad(
            p, jbrick.to_bricks(p, f)))(jplan, jnp.asarray(feats))))
    w = np.random.default_rng(1).normal(size=(27, FIN, FOUT)).astype(
        np.float32) * 0.2
    ref = np.asarray(jax.jit(jbrick.brick_sparse_conv)(
        jplan, jnp.asarray(feats), jnp.asarray(w)))
    gather = sparse.window_sparse_conv(sparse.conv_plan(tg), f,
                                       torch.from_numpy(w))
    m = tg.mask.numpy()
    for conv in (brick.brick_conv_taps, brick.brick_conv_xla):
        got = brick.from_bricks(plan, conv(padded, torch.from_numpy(w)))
        np.testing.assert_allclose(got.numpy(), ref, **TOL,
                                   err_msg=conv.__name__)
        np.testing.assert_allclose(got.numpy()[m], gather.numpy()[m],
                                   **TOL, err_msg=conv.__name__)


class _Block(jsparse.nn.Module):
    @jsparse.nn.compact
    def __call__(self, feats, plan, mask):
        return jsparse.SparseResBlock(FOUT, name="blk")(feats, plan, mask)


def test_conv_and_res_block_on_the_brick_plan():
    """The brick-resident res block against JAX's, and against the port's
    own block on the gather plan; its gradient is finite and equal to the
    gather plan's."""
    jg, tg, feats = grids(2)
    jplan = jbrick.build_brick_plan(jg)
    mod = _Block()
    params = jax.jit(mod.init)(jax.random.PRNGKey(0), jnp.asarray(feats),
                               jplan, jg.mask)
    params = jax.tree.map(lambda a: a + 0.03, params)   # biases not zero
    ref = np.asarray(jax.jit(mod.apply)(params, jnp.asarray(feats), jplan,
                                        jg.mask))
    blk = sparse.SparseResBlock(FIN, FOUT)
    sd = sparse_vae_from_jax(params)
    blk.load_state_dict({k[len("blk."):]: v for k, v in sd.items()})
    plan = sparse.conv_plan(tg, backend="brick")
    assert isinstance(plan, brick.BrickPlan)
    x = torch.from_numpy(feats).requires_grad_()
    got = blk(x, plan, tg.mask)
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)
    m = tg.mask
    x2 = torch.from_numpy(feats).requires_grad_()
    via_gather = blk(x2, sparse.conv_plan(tg), m)
    np.testing.assert_allclose(got.detach().numpy(),
                               via_gather.detach().numpy(), **TOL)
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    (gx,) = torch.autograd.grad((got * cot).sum(), [x])
    (gx2,) = torch.autograd.grad((via_gather * cot).sum(), [x2])
    assert torch.isfinite(gx).all() and gx[m].abs().max() > 0
    torch.testing.assert_close(gx, gx2, **TOL)
    # the conv alone, not brick-resident, against JAX's module
    conv = blk.conv1
    jconv = jsparse.SparseConv3d(FOUT)
    jp = {"params": {"kernel": jnp.asarray(conv.kernel.detach().numpy()),
                     "bias": jnp.asarray(conv.bias.detach().numpy())}}
    ref = np.asarray(jax.jit(jconv.apply)(jp, jnp.asarray(feats), jplan))
    got = conv(torch.from_numpy(feats), plan).detach().numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_overflow_raises(monkeypatch):
    jg, tg, _ = grids(4)
    plan = brick.build_brick_plan(tg, brick_capacity=4)
    jplan = jbrick.build_brick_plan(jg, brick_capacity=4)
    np.testing.assert_array_equal(plan.num_dropped.numpy(),
                                  np.asarray(jplan.num_dropped))
    assert int(plan.num_dropped[0]) > 0
    orig = brick.build_brick_plan
    monkeypatch.setattr(sparse, "build_brick_plan",
                        lambda g: orig(g, brick_capacity=4))
    with pytest.raises(ValueError, match="brick plan dropped"):
        sparse.conv_plan(tg, backend="brick")
    with pytest.raises(ValueError, match="unknown conv backend"):
        sparse.conv_plan(tg, backend="bricks")
