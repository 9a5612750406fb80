"""Port parity: ``infinicube_tpu_torch.grid`` (keys, grid construction with
overflow, neighbour tables, dense <-> sparse, index maps, nearest
upsampling) against ``infinicube_tpu.grid`` on the same coordinates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.grid import build as jbuild
from infinicube_tpu.grid import keys as jkeys
from infinicube_tpu.grid import ops as jops
from infinicube_tpu_torch.grid import build, keys, ops


def _ijk(seed, n, lo=-20, hi=20):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (2, n, 3)).astype(np.int32)


def _grids(seed=0, n=700, cap=1024, lo=-20, hi=20):
    ijk = _ijk(seed, n, lo, hi)
    mask = np.random.default_rng(seed + 1).random((2, n)) < 0.9
    jg = jbuild.grid_from_ijk(jnp.asarray(ijk), jnp.asarray(mask), 0.2, 0.1,
                              capacity=cap)
    tg = build.grid_from_ijk(torch.from_numpy(ijk), torch.from_numpy(mask),
                             0.2, 0.1, cap)
    return jg, tg


def _same_grid(jg, tg):
    np.testing.assert_array_equal(np.asarray(jg.keys).astype(np.int64),
                                  tg.keys.numpy())
    np.testing.assert_array_equal(np.asarray(jg.mask), tg.mask.numpy())
    np.testing.assert_array_equal(np.asarray(jg.ijk), tg.ijk.numpy())
    np.testing.assert_allclose(np.asarray(jg.voxel_size),
                               tg.voxel_size.numpy())
    np.testing.assert_allclose(np.asarray(jg.origin), tg.origin.numpy())


def test_keys_match_and_invalid_sorts_last():
    ijk = _ijk(0, 500, -1100, 1100)           # some outside the domain
    valid = np.random.default_rng(3).random((2, 500)) < 0.8
    jk = np.asarray(jkeys.pack(jnp.asarray(ijk), jnp.asarray(valid)))
    tk = keys.pack(torch.from_numpy(ijk), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(jk.astype(np.int64), tk)
    assert (tk == keys.INVALID_KEY).any() and tk.max() == keys.INVALID_KEY
    np.testing.assert_array_equal(np.argsort(jk, kind="stable"),
                                  np.argsort(tk, kind="stable"))
    ok = tk != keys.INVALID_KEY
    np.testing.assert_array_equal(keys.unpack(torch.from_numpy(tk)).numpy()
                                  [ok], ijk[ok])


@pytest.mark.parametrize("cap", [1024, 300])
def test_grid_from_keys_overflow_drops_the_same_keys(cap):
    jg, tg = _grids(cap=cap)
    _same_grid(jg, tg)
    np.testing.assert_array_equal(np.asarray(jg.num_dropped),
                                  tg.num_dropped.numpy())
    if cap == 300:
        assert (tg.num_dropped > 0).all()


def test_subdivided_grid_matches():
    jg, tg = _grids(n=200, cap=256)
    sub = np.random.default_rng(5).random((2, 256)) < 0.5
    js = jbuild.subdivided_grid(jg, (2, 2, 1), jnp.asarray(sub),
                                capacity=600)
    ts = build.subdivided_grid(tg, (2, 2, 1), torch.from_numpy(sub), 600)
    _same_grid(js, ts)
    np.testing.assert_array_equal(np.asarray(js.num_dropped),
                                  ts.num_dropped.numpy())


@pytest.mark.parametrize("dense", [False, True])
def test_neighbor_indexes_match(dense):
    jg, tg = _grids()
    bounds = ((-24, -24, -24), (48, 48, 48)) if dense else None
    ref = np.asarray(jops.neighbor_indexes(jg, 3, dense_bounds=bounds))
    got = ops.neighbor_indexes(tg, 3, dense_bounds=bounds).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got >= 0).any() and (got < 0).any()
    np.testing.assert_array_equal(ops.neighbor_offsets(3),
                                  jops.neighbor_offsets(3))


def test_dense_bounds_violations_match():
    jg, tg = _grids()
    bounds = ((-10, -24, -5), (30, 48, 20))
    np.testing.assert_array_equal(
        np.asarray(jops.dense_bounds_violations(jg, *bounds)),
        ops.dense_bounds_violations(tg, *bounds).numpy())


def test_read_from_dense_and_to_dense_match():
    jg, tg = _grids()
    dense = np.random.default_rng(7).standard_normal(
        (2, 16, 12, 20, 5)).astype(np.float32)
    ijk_min = (-8, -6, -10)
    ref = np.asarray(jops.read_from_dense(jg, jnp.asarray(dense), ijk_min))
    got = ops.read_from_dense(tg, torch.from_numpy(dense), ijk_min).numpy()
    np.testing.assert_array_equal(got, ref)
    data = np.random.default_rng(8).standard_normal((2, 1024, 3)).astype(
        np.float32)
    ref = np.asarray(jops.to_dense(jg, jnp.asarray(data), ijk_min,
                                   (16, 12, 20)))
    got = ops.to_dense(tg, torch.from_numpy(data), ijk_min,
                       (16, 12, 20)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_index_map_matches():
    jg, tg = _grids()
    jh, th = _grids(seed=4, n=500, cap=600)
    np.testing.assert_array_equal(np.asarray(jops.index_map(jh, jg)),
                                  ops.index_map(th, tg).numpy())


def test_upsample_nearest_matches():
    jg, tg = _grids(n=150, cap=200)
    data = np.random.default_rng(9).standard_normal((2, 200, 4)).astype(
        np.float32)
    jf, jd = jops.upsample_nearest(jg, jnp.asarray(data), (2, 2, 2),
                                   capacity=1600)
    tf, td = ops.upsample_nearest(tg, torch.from_numpy(data), (2, 2, 2),
                                  capacity=1600)
    _same_grid(jf, tf)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
