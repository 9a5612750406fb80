"""Port parity: the sparse conv of ``infinicube_tpu_torch`` (plain gather
version of ``window_sparse_conv`` over the dense-bounds neighbour table),
``GroupNormSparse`` and ``SparseResBlock`` against the JAX package: the
Pallas window conv in interpret mode, and the flax layers on the same
parameters (``weights/from_jax.py``)."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.grid.build import grid_from_ijk as jax_grid_from_ijk
from infinicube_tpu.nn.sparse import GroupNormSparse as JaxGN
from infinicube_tpu.nn.sparse import SparseResBlock as JaxBlock
from infinicube_tpu.nn.sparse import conv_plan as jax_conv_plan
from infinicube_tpu.ops.window_conv import build_window_plan
from infinicube_tpu.ops.window_conv import \
    window_sparse_conv as jax_window_conv
from infinicube_tpu_torch.grid.build import grid_from_ijk
from infinicube_tpu_torch.nn.sparse import (GroupNormSparse, SparseResBlock,
                                            conv_plan)
from infinicube_tpu_torch.ops.window_conv import window_sparse_conv
from infinicube_tpu_torch.weights.from_jax import _convert

CAP = 1024
BOUNDS = ((-16, -16, -16), (32, 32, 32))
# f32 on both sides, differing only in summation order
TOL = dict(atol=2e-3, rtol=2e-3)


def _scene(seed=0, n=1500, extent=8):
    """A sheet-like voxel set (a ground plane with bumps), negative ijk
    included, in batch 1."""
    rng = np.random.default_rng(seed)
    ij = rng.integers(-extent, extent, (n, 2))
    k = (np.sin(ij[:, :1] * 0.5) * 2).round() + rng.integers(-1, 2, (n, 1))
    ijk = np.concatenate([ij, k], -1).astype(np.int32)[None]
    mask = np.ones((1, n), bool)
    jg = jax_grid_from_ijk(jnp.asarray(ijk), jnp.asarray(mask), 0.2, 0.1,
                           capacity=CAP)
    tg = grid_from_ijk(torch.from_numpy(ijk), torch.from_numpy(mask), 0.2,
                       0.1, CAP)
    feats = rng.standard_normal((1, CAP, 16)).astype(np.float32)
    feats = np.where(np.asarray(jg.mask)[..., None], feats, 0.0)
    return jg, tg, feats


def test_matches_the_pallas_window_conv():
    jg, tg, feats = _scene()
    w = (np.random.default_rng(1).standard_normal((27, 16, 24)) *
         0.1).astype(np.float32)
    plan = build_window_plan(jg, block_rows=128, window_rows=256,
                             dense_bounds=BOUNDS)
    ref = np.asarray(jax_window_conv(plan, jnp.asarray(feats),
                                     jnp.asarray(w)))
    got = window_sparse_conv(conv_plan(tg, dense_bounds=BOUNDS),
                             torch.from_numpy(feats),
                             torch.from_numpy(w)).numpy()
    m = np.asarray(jg.mask[0])
    np.testing.assert_allclose(got[0][m], ref[0][m], **TOL)
    np.testing.assert_array_equal(got[0][~m], 0.0)


def test_dense_bounds_violation_poisons_its_batch_row():
    rng = np.random.default_rng(2)
    ijk = np.stack([rng.integers(-4, 4, (300, 3)),
                    rng.integers(-30, 30, (300, 3))]).astype(np.int32)
    mask = np.ones((2, 300), bool)
    tg = grid_from_ijk(torch.from_numpy(ijk), torch.from_numpy(mask), 0.2,
                       0.1, 512)
    plan = conv_plan(tg, dense_bounds=BOUNDS)
    assert plan.violations.tolist()[0] == 0 and plan.violations[1] > 0
    feats = torch.randn((2, 512, 8), generator=torch.Generator()
                        .manual_seed(0))
    out = window_sparse_conv(plan, feats, torch.ones((27, 8, 4)))
    assert torch.isfinite(out[0]).all() and torch.isnan(out[1]).all()
    # the JAX window plan flags the same element as overflowed
    jg = jax_grid_from_ijk(jnp.asarray(ijk), jnp.asarray(mask), 0.2, 0.1,
                           capacity=512)
    jplan = build_window_plan(jg, dense_bounds=BOUNDS)
    np.testing.assert_array_equal(np.asarray(jplan.overflowed),
                                  plan.overflowed.numpy())


def _jax_params(module, *args, seed=0):
    p = module.init(jax.random.PRNGKey(seed), *args)
    p = jax.tree.map(np.asarray, flax.linen.meta.unbox(p))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        p)


def test_group_norm_sparse_matches():
    jg, tg, feats = _scene(seed=3)
    jm = JaxGN()
    params = _jax_params(jm, jnp.asarray(feats), jg.mask)
    ref = np.asarray(jm.apply(params, jnp.asarray(feats), jg.mask))
    m = GroupNormSparse(16)
    m.load_state_dict(_convert(params["params"]))
    with torch.no_grad():
        got = m(torch.from_numpy(feats), tg.mask).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(got[~tg.mask.numpy()], 0.0)


@pytest.mark.parametrize("fout", [16, 24])
def test_sparse_res_block_matches(fout):
    jg, tg, feats = _scene(seed=4)
    jm = JaxBlock(fout)
    jplan = jax_conv_plan(jg, "gather")
    params = _jax_params(jm, jnp.asarray(feats), jplan, jg.mask)
    ref = np.asarray(jm.apply(jax.tree.map(jnp.asarray, params),
                              jnp.asarray(feats), jplan, jg.mask))
    m = SparseResBlock(16, fout)
    m.load_state_dict(_convert(params["params"]))      # strict
    with torch.no_grad():
        got = m(torch.from_numpy(feats), conv_plan(tg, dense_bounds=BOUNDS),
                tg.mask).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(got[~tg.mask.numpy()], 0.0)
