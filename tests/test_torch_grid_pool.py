"""Port parity: what the VAE trainer adds to ``infinicube_tpu_torch.grid``
(``Grid.world_to_ijk``, ``grid_from_points``, ``coarsened_grid``,
``max_pool`` with its NaN-safe gradient, ``scatter_to_grid``,
``majority_label``) against the JAX package on the same numpy inputs.
Integer results are equal; f32 values agree to 1e-6 (the same operations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.grid import build as jbuild
from infinicube_tpu.grid import ops as jops
from infinicube_tpu_torch.grid import build as tbuild
from infinicube_tpu_torch.grid import ops as tops

VS, ORG = (0.2, 0.2, 0.2), (0.1, 0.1, 0.1)


def _points(seed=0, B=2, N=500, lo=-3.0, hi=3.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, (B, N, 3)).astype(np.float32)
    mask = rng.uniform(size=(B, N)) > 0.1
    return pts, mask


def _grids(pts, mask, capacity=1024):
    jg = jbuild.grid_from_points(jnp.asarray(pts), jnp.asarray(mask), VS, ORG,
                                 capacity=capacity)
    tg = tbuild.grid_from_points(torch.from_numpy(pts),
                                 torch.from_numpy(mask), VS, ORG, capacity)
    return jg, tg


def _same_grid(tg, jg):
    np.testing.assert_array_equal(tg.keys.numpy(),
                                  np.asarray(jg.keys).astype(np.int64))
    np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
    m = tg.mask.numpy()
    np.testing.assert_array_equal(tg.ijk.numpy()[m], np.asarray(jg.ijk)[m])
    np.testing.assert_array_equal(tg.num_dropped.numpy(),
                                  np.asarray(jg.num_dropped))
    np.testing.assert_allclose(tg.voxel_size.numpy(),
                               np.asarray(jg.voxel_size), rtol=1e-6)
    np.testing.assert_allclose(tg.origin.numpy(), np.asarray(jg.origin),
                               rtol=1e-6)


def test_world_to_ijk_rounds_half_to_even():
    jg, tg = _grids(*_points())
    # with origin 0 and voxel size 1 the halves are exact in f32
    p = np.array([[[0.5, 1.5, 2.5], [-0.5, -1.5, -2.5], [0.49, 0.51, -0.51]]],
                 np.float32)
    import dataclasses
    one = dataclasses.replace(tg, voxel_size=torch.ones(3),
                              origin=torch.zeros(3))
    assert one.world_to_ijk(torch.from_numpy(p)).tolist() == [
        [[0, 2, 2], [0, -2, -2], [0, 1, -1]]]
    pts, _ = _points(seed=5)
    np.testing.assert_array_equal(
        tg.world_to_ijk(torch.from_numpy(pts)).numpy(),
        np.asarray(jg.world_to_ijk(jnp.asarray(pts))))


@pytest.mark.parametrize("capacity", [1024, 300])
def test_grid_from_points_matches_jax(capacity):
    jg, tg = _grids(*_points(seed=1), capacity=capacity)
    _same_grid(tg, jg)
    assert (int(tg.num_dropped.sum()) > 0) == (capacity == 300)


@pytest.mark.parametrize("factor,capacity", [((2, 2, 1), 512),
                                             ((2, 2, 2), None), (4, 64)])
def test_coarsened_grid_matches_jax(factor, capacity):
    jg, tg = _grids(*_points(seed=2))
    assert int(tg.ijk.min()) < 0               # floor division matters
    f3 = tuple(np.broadcast_to(np.asarray(factor), (3,)).tolist())
    _same_grid(tbuild.coarsened_grid(tg, factor, capacity=capacity),
               jbuild.coarsened_grid(jg, f3, capacity=capacity))


def _pool_case(seed=3):
    """A hash-tree level pair whose coarse grid also holds parents that no
    child reaches, and data with exact ties inside parents."""
    pts, mask = _points(seed=seed)
    jg, tg = _grids(pts, mask)
    extra = np.array([[[40.0, 40.0, 40.0]], [[-40.0, 40.0, 0.0]]], np.float32)
    cpts = np.concatenate([pts, extra], 1)
    cmask = np.concatenate([mask, np.ones((2, 1), bool)], 1)
    jc = jbuild.coarsened_grid(
        jbuild.grid_from_points(jnp.asarray(cpts), jnp.asarray(cmask), VS,
                                ORG, capacity=1024), (2, 2, 2), capacity=512)
    tc = tbuild.coarsened_grid(
        tbuild.grid_from_points(torch.from_numpy(cpts),
                                torch.from_numpy(cmask), VS, ORG, 1024),
        (2, 2, 2), capacity=512)
    rng = np.random.default_rng(seed)
    data = rng.integers(-2, 3, (2, 1024, 5)).astype(np.float32) * 0.5
    return jg, tg, jc, tc, data


def test_max_pool_values_and_gradient_match_jax():
    jg, tg, jc, tc, data = _pool_case()
    _same_grid(tc, jc)
    cot = np.random.default_rng(9).standard_normal((2, 512, 5)).astype(
        np.float32)

    def jloss(x):
        _, pooled = jops.max_pool(jg, x, (2, 2, 2), coarse=jc)
        return jnp.sum(pooled * cot), pooled

    (_, ref), ref_grad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    coarse, pooled = tops.max_pool(tg, x, (2, 2, 2), coarse=tc)
    assert coarse is tc
    (pooled * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(ref),
                               atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad),
                               atol=1e-6)
    # the case holds what it is meant to: ties that split a gradient, and
    # parents without children, whose rows are 0
    g = x.grad.numpy()
    assert np.isfinite(g).all()
    nz = np.abs(g[np.abs(g) > 0])
    assert len(np.unique(np.round(nz / np.abs(cot).max(), 6))) > 10
    children = torch.zeros((2, 513)).scatter_add_(
        1, torch.where(tg.mask, tc.ijk_to_index(
            torch.div(tg.ijk, 2, rounding_mode="floor"), tg.mask).long(),
            torch.full((2, 1024), 512)), torch.ones((2, 1024)))[:, :512]
    empty = tc.mask & (children == 0)
    assert empty.any() and (pooled.detach()[empty] == 0).all()
    # derived coarse grid (no ``coarse=``)
    c2, p2 = tops.max_pool(tg, torch.from_numpy(data), (2, 2, 1),
                           capacity=700)
    j2, jp2 = jops.max_pool(jg, jnp.asarray(data), (2, 2, 1), capacity=700)
    _same_grid(c2, j2)
    np.testing.assert_allclose(p2.numpy(), np.asarray(jp2), atol=1e-6)


def test_masked_max_grads_finite_and_correct():
    """Counterpart of the JAX package's regression test: the gradient goes
    to the maximal child, is split on ties, and is zero on masked children
    and finite everywhere."""
    ijk = torch.tensor([[[0, 0, 0], [1, 0, 0], [0, 1, 0], [4, 4, 0]]],
                       dtype=torch.int32)
    g = tbuild.grid_from_ijk(ijk, torch.ones((1, 4), dtype=torch.bool), 1.0,
                             0.0, 8)
    x = (torch.arange(g.capacity * 3, dtype=torch.float32).reshape(
        1, g.capacity, 3) * 0.1).requires_grad_()
    _, pooled = tops.max_pool(g, x, (2, 2, 2))
    pooled.square().sum().backward()
    grad = x.grad[0]
    m = g.mask[0]
    assert torch.isfinite(grad).all() and torch.isfinite(pooled).all()
    assert (grad[~m] == 0).all()
    # slots 0..2 share the parent (0, 0, 0); the largest of them is slot 2
    # in key order, and it takes the whole gradient 2 * max
    first = grad[:3]
    assert int((first.abs().sum(-1) > 0).sum()) == 1
    torch.testing.assert_close(first.sum(0), 2 * pooled[0, 0].detach())
    torch.testing.assert_close(grad[3], 2 * x.detach()[0, 3])
    x2 = torch.ones_like(x).requires_grad_()
    _, pooled2 = tops.max_pool(g, x2, (2, 2, 2))
    pooled2.square().sum().backward()
    torch.testing.assert_close(x2.grad[0, :3], torch.full((3, 3), 2.0 / 3.0))
    torch.testing.assert_close(x2.grad[0, 3], torch.full((3,), 2.0))
    assert (x2.grad[0, 4:] == 0).all()


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_scatter_to_grid_matches_jax(reduce):
    pts, mask = _points(seed=4, N=3000, lo=-1.0, hi=1.0)
    jg, tg = _grids(pts, mask, capacity=2048)
    # a grid built from other points, so that some points fall in no voxel
    other, omask = _points(seed=6, N=400, lo=-1.0, hi=1.0)
    jg2, tg2 = _grids(other, omask, capacity=512)
    vals = np.random.default_rng(4).standard_normal((2, 3000, 3)).astype(
        np.float32)
    for jgrid, tgrid in ((jg, tg), (jg2, tg2)):
        ref = jops.scatter_to_grid(jgrid, jnp.asarray(pts), jnp.asarray(vals),
                                   jnp.asarray(mask), reduce)
        got = tops.scatter_to_grid(tgrid, torch.from_numpy(pts),
                                   torch.from_numpy(vals),
                                   torch.from_numpy(mask), reduce)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    with pytest.raises(ValueError):
        tops.scatter_to_grid(tg, torch.from_numpy(pts),
                             torch.from_numpy(vals), torch.from_numpy(mask),
                             "median")


def test_majority_label_ties_take_the_first_class():
    # 1-2 points a voxel: most voxels hold a tie between two classes
    pts, mask = _points(seed=7, N=1500, lo=-2.0, hi=2.0)
    jg, tg = _grids(pts, mask, capacity=2048)
    labels = np.random.default_rng(7).integers(0, 23, (2, 1500)).astype(
        np.int32)
    ref = np.asarray(jops.majority_label(jg, jnp.asarray(pts),
                                         jnp.asarray(labels),
                                         jnp.asarray(mask), 23))
    got = tops.majority_label(tg, torch.from_numpy(pts),
                              torch.from_numpy(labels),
                              torch.from_numpy(mask), 23)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    votes = tops.scatter_to_grid(
        tg, torch.from_numpy(pts),
        torch.nn.functional.one_hot(torch.from_numpy(labels).long(),
                                    23).float(), torch.from_numpy(mask))
    tied = (votes == votes.amax(-1, keepdim=True)).sum(-1) > 1
    assert int((tied & tg.mask).sum()) > 100
    # two points of one voxel, classes 7 and 3: the lower class wins
    p = torch.tensor([[[0.1, 0.1, 0.1], [0.12, 0.1, 0.1]]])
    g1 = tbuild.grid_from_points(p, torch.ones((1, 2), dtype=torch.bool), VS,
                                 ORG, 4)
    assert tops.majority_label(g1, p, torch.tensor([[7, 3]]),
                               torch.ones((1, 2), dtype=torch.bool),
                               23)[0, 0] == 3
