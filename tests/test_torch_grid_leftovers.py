"""Port parity for the grid functions the sparse VAE did not need:
``Grid.world_to_grid`` / ``points_in_active_voxel``, the constructors
``grid_from_nearest_voxels_to_points`` (with a capacity overflow, which
drops the highest keys), ``dense_ijk``, ``grid_from_dense`` (whole and
occupancy-masked) and ``merge_grids``, and the data ops
``fill_from_grid``, ``splat_trilinear``, ``sample_trilinear`` and
``avg_pool`` against the JAX package on the same numpy-seeded inputs:
integer results exactly, values at ROADMAP's f32 atol/rtol 2e-3, and the
gradients JAX defines (splat and sample in their features and points,
avg_pool in its data), finite where JAX's are. Far points exercise the
saturating float -> int32 cast."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.grid import build as jb
from infinicube_tpu.grid import ops as jops
from infinicube_tpu_torch.grid import build as tb
from infinicube_tpu_torch.grid import ops as tops
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-3, rtol=2e-3)
VS, ORG, CAP = (0.5, 0.5, 0.25), (0.25, 0.25, 0.125), 512


def same_grid(tg, jg):
    np.testing.assert_array_equal(tg.keys.numpy(),
                                  np.asarray(jg.keys).astype(np.int64))
    np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
    np.testing.assert_array_equal(tg.ijk.numpy(), np.asarray(jg.ijk))
    if jg.num_dropped is not None:
        np.testing.assert_array_equal(tg.num_dropped.numpy(),
                                      np.asarray(jg.num_dropped))


def points(seed, n=120, far=True):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, (2, n, 3)).astype(np.float32)
    if far:
        pts[0, :3] = [[1e12, 0, 0], [-3e11, 2, 1], [0, 0, np.inf]]
    mask = rng.random((2, n)) < 0.8
    return pts, mask


def grids(seed=0):
    pts, mask = points(seed)
    return (jb.grid_from_points(jnp.asarray(pts), jnp.asarray(mask), VS, ORG,
                                capacity=CAP),
            tb.grid_from_points(torch.from_numpy(pts), torch.from_numpy(mask),
                                VS, ORG, capacity=CAP))


@pytest.mark.parametrize("cap", [2048, 300])
def test_nearest_voxels_dense_and_merge(cap):
    pts, mask = points(1)
    args = (VS, ORG)
    same_grid(tb.grid_from_nearest_voxels_to_points(
        torch.from_numpy(pts), torch.from_numpy(mask), *args, capacity=cap),
        jb.grid_from_nearest_voxels_to_points(
            jnp.asarray(pts), jnp.asarray(mask), *args, capacity=cap))
    np.testing.assert_array_equal(tb.dense_ijk((3, 4, 5), (-1, 2, -3)).numpy(),
                                  np.asarray(jb.dense_ijk((3, 4, 5),
                                                          (-1, 2, -3))))
    occ = np.random.default_rng(2).random((2, 3, 4, 5)) < 0.4
    for o in (None, occ):
        same_grid(tb.grid_from_dense(
            2, (3, 4, 5), (-1, 2, -3), VS, ORG,
            None if o is None else torch.from_numpy(o),
            capacity=min(cap, 60)),
            jb.grid_from_dense(2, (3, 4, 5), (-1, 2, -3), VS, ORG,
                               None if o is None else jnp.asarray(o),
                               capacity=min(cap, 60)))
    (ja, ta), (jbb, tbb) = grids(3), grids(4)
    same_grid(tb.merge_grids(ta, tbb, capacity=cap // 2),
              jb.merge_grids(ja, jbb, capacity=cap // 2))


def test_world_to_grid_and_points_in_active_voxel():
    jg, tg = grids(0)
    pts, mask = points(5)
    np.testing.assert_allclose(tg.world_to_grid(torch.from_numpy(pts)).numpy(),
                               np.asarray(jg.world_to_grid(jnp.asarray(pts))),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        tg.world_to_ijk(torch.from_numpy(pts)).numpy(),
        np.asarray(jg.world_to_ijk(jnp.asarray(pts))))
    got = tg.points_in_active_voxel(torch.from_numpy(pts),
                                    torch.from_numpy(mask)).numpy()
    ref = np.asarray(jg.points_in_active_voxel(jnp.asarray(pts),
                                               jnp.asarray(mask)))
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < got.size


def test_fill_from_grid():
    jg, tg = grids(0)
    jf = jb.coarsened_grid(jg, (2, 2, 1), capacity=CAP)
    tf = tb.coarsened_grid(tg, (2, 2, 1), capacity=CAP)
    data = np.random.default_rng(6).normal(size=(2, CAP, 5)).astype(
        np.float32)
    for (jd, js, td, ts) in ((jg, jf, tg, tf), (jf, jg, tf, tg)):
        ref = np.asarray(jops.fill_from_grid(jd, js, jnp.asarray(data)))
        got = tops.fill_from_grid(td, ts, torch.from_numpy(data)).numpy()
        np.testing.assert_array_equal(got, ref)
        assert np.abs(ref).sum() > 0


def _both(jfn, tfn, jargs, targs, wrt):
    """Values and the gradients of sum(out * cot) in the arguments ``wrt``
    of the JAX and the port function."""
    ref = jax.jit(jfn)(*jargs)
    cot = np.random.default_rng(9).normal(size=ref.shape).astype(np.float32)
    jgrad = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * cot),
                             argnums=wrt))(*jargs)
    targs = list(targs)
    for i in wrt:
        targs[i] = targs[i].clone().requires_grad_()
    out = tfn(*targs)
    tgrad = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [targs[i] for i in wrt])
    return (out.detach().numpy(), np.asarray(ref),
            [g.numpy() for g in tgrad], [np.asarray(g) for g in jgrad])


@pytest.mark.parametrize("op", ["splat", "sample"])
def test_trilinear(op):
    jg, tg = grids(0)
    pts, mask = points(7, far=False)
    rng = np.random.default_rng(8)
    if op == "splat":
        feats = rng.normal(size=(2, pts.shape[1], 4)).astype(np.float32)
        got, ref, tgr, jgr = _both(
            lambda p, f: jops.splat_trilinear(jg, p, f, jnp.asarray(mask)),
            lambda p, f: tops.splat_trilinear(tg, p, f,
                                              torch.from_numpy(mask)),
            (jnp.asarray(pts), jnp.asarray(feats)),
            (torch.from_numpy(pts), torch.from_numpy(feats)), (0, 1))
    else:
        data = rng.normal(size=(2, CAP, 4)).astype(np.float32)
        got, ref, tgr, jgr = _both(
            lambda p, d: jops.sample_trilinear(jg, d, p, jnp.asarray(mask)),
            lambda p, d: tops.sample_trilinear(tg, d, p,
                                               torch.from_numpy(mask)),
            (jnp.asarray(pts), jnp.asarray(data)),
            (torch.from_numpy(pts), torch.from_numpy(data)), (0, 1))
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, **TOL)
    for t, j in zip(tgr, jgr):
        assert np.isfinite(j).all() and np.isfinite(t).all()
        np.testing.assert_allclose(t, j, **TOL)


def test_avg_pool():
    jg, tg = grids(0)
    data = np.random.default_rng(10).normal(size=(2, CAP, 6)).astype(
        np.float32)
    jc = jb.coarsened_grid(jg, (2, 2, 2), capacity=CAP)
    tc = tb.coarsened_grid(tg, (2, 2, 2), capacity=CAP)
    got, ref, tgr, jgr = _both(
        lambda d: jops.avg_pool(jg, d, (2, 2, 2))[1],
        lambda d: tops.avg_pool(tg, d, (2, 2, 2))[1],
        (jnp.asarray(data),), (torch.from_numpy(data),), (0,))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(tgr[0], jgr[0], **TOL)
    assert np.isfinite(tgr[0]).all()
    # into a given coarse grid
    _, into = tops.avg_pool(tg, torch.from_numpy(data), 2, coarse=tc)
    np.testing.assert_allclose(
        into.numpy(), np.asarray(jops.avg_pool(jg, jnp.asarray(data), 2,
                                               coarse=jc)[1]), **TOL)
