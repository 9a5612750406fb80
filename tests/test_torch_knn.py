"""The port's nearest-neighbour queries, segment reductions and road
surface against the JAX package's: brute force and voxel hash on tensors,
the native KD-tree against the JAX package's and against scipy, the label
and color transfers. Distances within 1e-5 relative, indices equal, on
inputs without ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.grid import build as jbuild
from infinicube_tpu.ops import knn as jknn
from infinicube_tpu.ops import knn_host as jhost
from infinicube_tpu.ops import segment as jseg
from infinicube_tpu.data_process import road_surface as jroad
from infinicube_tpu_torch.grid import build as tbuild
from infinicube_tpu_torch.ops import knn as tknn
from infinicube_tpu_torch.ops import knn_host as thost
from infinicube_tpu_torch.ops import segment as tseg
from infinicube_tpu_torch.data_process import road_surface as troad


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(seed, n, scale=20.0):
    return np.random.default_rng(seed).uniform(-scale, scale, (n, 3)).astype(
        np.float32)


def _no_ties(d, gap=1e-6):
    """Rows whose k + 1 nearest distances are all apart."""
    s = np.sort(d, 1)
    return (np.diff(s, axis=1) > gap * np.maximum(s[:, 1:], 1e-6)).all(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_bruteforce_matches_jax():
    q, r = _cloud(0, 700), _cloud(1, 3000)
    mask = np.random.default_rng(2).uniform(size=3000) > 0.1
    for k, chunk, m in ((1, 4096, None), (4, 128, mask)):
        dj, ij = jknn.knn_bruteforce(jnp.asarray(q), jnp.asarray(r),
                                     None if m is None else jnp.asarray(m),
                                     k=k, chunk=chunk)
        dt, it = tknn.knn_bruteforce(_t(q), _t(r), None if m is None
                                     else _t(m), k=k, chunk=chunk)
        dj, ij = np.asarray(dj), np.asarray(ij)
        assert dt.dtype == torch.float32 and it.dtype == torch.int32
        np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5, atol=0)
        np.testing.assert_array_equal(it.numpy(), ij)
        if m is not None:
            assert m[it.numpy()].all()


def test_bruteforce_distances_exact_near_the_points():
    """Queries 1-5 cm from references 60 m out: the expansion cancels, and
    the port sums the norms in the reference's order, so the small
    distances agree to the bit."""
    r = _cloud(3, 2000, 60.0)
    q = r[:300] + np.random.default_rng(4).normal(
        0, 0.02, (300, 3)).astype(np.float32)
    dj, ij = jknn.knn_bruteforce(jnp.asarray(q), jnp.asarray(r), k=2)
    dt, it = tknn.knn_bruteforce(_t(q), _t(r), k=2)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_grid_hash_matches_jax():
    r = np.random.default_rng(5).uniform(0, 20, (1500, 3)).astype(np.float32)
    q = np.random.default_rng(6).uniform(0, 20, (400, 3)).astype(np.float32)
    mask = np.random.default_rng(7).uniform(size=1500) > 0.2
    dj, ij = jknn.knn_grid_hash(jnp.asarray(q), jnp.asarray(r), 1.0,
                                jnp.asarray(mask), k=3)
    dt, it = tknn.knn_grid_hash(_t(q), _t(r), 1.0, _t(mask), k=3)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (it.numpy() == -1).any() and (it.numpy()[:, 0] >= 0).mean() > 0.9


def test_host_tree_matches_jax_and_scipy():
    r, q = _cloud(8, 5000), _cloud(9, 800)
    d, i = thost.knn_query(q, r, 4)
    dj, ij = jhost.knn_query(q, r, 4)
    ds, is_ = thost.knn_query(q, r, 4, backend="scipy")
    np.testing.assert_array_equal(d, dj)
    np.testing.assert_array_equal(i, ij)
    ok = _no_ties(ds)
    assert ok.mean() > 0.99
    np.testing.assert_allclose(d, ds, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i[ok], is_[ok])
    # fewer than 64 references: brute force
    np.testing.assert_array_equal(thost.knn_query(q, r[:50], 2)[1],
                                  jhost.knn_query(q, r[:50], 2)[1])
    with pytest.raises(ValueError, match="backend"):
        thost.knn_query(q, r, 1, backend="nope")


def test_label_and_color_transfer_match_jax():
    r, q = _cloud(10, 2000), _cloud(11, 500)
    rng = np.random.default_rng(12)
    sem = rng.integers(0, 23, 2000).astype(np.int32)
    cols = rng.uniform(size=(2000, 3)).astype(np.float32)
    for k in (1, 5):
        got = tknn.semantic_from_points(_t(q), _t(r), _t(sem), k=k)
        want = jknn.semantic_from_points(jnp.asarray(q), jnp.asarray(r),
                                         jnp.asarray(sem), k=k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tknn.color_from_points(_t(q), _t(r), _t(cols))
    want = jknn.color_from_points(jnp.asarray(q), jnp.asarray(r),
                                  jnp.asarray(cols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_latent_semantic_from_grid_matches_jax():
    pts = _cloud(13, 3000, 6.0)[None]
    sem = np.random.default_rng(14).integers(0, 23, 512).astype(np.int32)
    grids = []
    for build, arr in ((jbuild, jnp.asarray), (tbuild, _t)):
        mask = arr(np.ones((1, 3000), bool))
        fine = build.grid_from_points(arr(pts), mask, 0.5, 0.25,
                                      capacity=512)
        coarse = build.grid_from_points(arr(pts), mask, 2.0, 1.0,
                                        capacity=64)
        grids.append((fine, coarse))
    (jf, jc), (tf, tc) = grids
    want = jknn.latent_semantic_from_grid(jf, jnp.asarray(sem), jc)
    got = tknn.latent_semantic_from_grid(tf, _t(sem), tc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segment_reductions_match_jax_exactly():
    rng = np.random.default_rng(15)
    vals = rng.normal(size=(400, 5)).astype(np.float32)
    idx = rng.integers(-3, 30, 400).astype(np.int32)
    idx[idx == 7] = 8                      # segment 7 gets no row
    for name in ("segment_sum", "segment_mean", "segment_max"):
        got = getattr(tseg, name)(_t(vals), _t(idx), 30)
        want = getattr(jseg, name)(jnp.asarray(vals), jnp.asarray(idx), 30)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tseg.segment_max(_t(vals), _t(idx), 30, fill=-5.0)
    assert (got[7] == -5.0).all()
    ints = rng.integers(-9, 9, (400, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        tseg.segment_max(_t(ints), _t(idx), 30).numpy(),
        np.asarray(jseg.segment_max(jnp.asarray(ints), jnp.asarray(idx), 30)))


def test_road_surface_matches_jax():
    edges = [np.stack([np.linspace(-5, 30, 12), np.full(12, e),
                       np.random.default_rng(16 + i).normal(0, 0.05, 12)], -1)
             for i, e in enumerate((-6.0, 6.0))]
    got = troad.estimate_road_surface(edges)
    want = jroad.estimate_road_surface(edges)
    assert got.dtype == np.float32 and len(got) > 500
    np.testing.assert_array_equal(got, want)
