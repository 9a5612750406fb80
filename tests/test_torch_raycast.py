"""Port parity: ``infinicube_tpu_torch.ops.raycast`` against
``infinicube_tpu.ops.raycast``: the L1 distance transform exactly, the DDA
first hit on the reference's own test scenes and on a random 48^3 block
with 64 x 48 rays (with and without the empty-space skip): ``hit`` and
``ijk`` equal on >= 99.9 % of rays, ``t_entry`` within 1e-4; and the grid
helpers the DDA route needs (``occupancy_dense``, ``Grid.bbox_ijk``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.grid import grid_from_ijk as jax_grid_from_ijk
from infinicube_tpu.grid.ops import occupancy_dense as jax_occupancy_dense
from infinicube_tpu.ops import raycast as jr
from infinicube_tpu_torch.grid.build import grid_from_ijk
from infinicube_tpu_torch.grid.ops import occupancy_dense
from infinicube_tpu_torch.ops import raycast as tr
from tests.test_torch_gsm import one_torch_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _agree(got, ref, min_share=0.999):
    """hit and ijk equal on min_share of the rays, t_entry and t_exit
    within 1e-4 where both hit the same cell."""
    hit, rhit = got.hit.numpy(), np.asarray(ref.hit)
    same = (hit == rhit) & (got.ijk.numpy() == np.asarray(ref.ijk)).all(-1)
    assert same.mean() >= min_share
    both = same & hit
    for a, b in ((got.t_entry, ref.t_entry), (got.t_exit, ref.t_exit)):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both],
                                   atol=1e-4, rtol=0)
    assert (got.t_entry.numpy()[~hit] == 0).all()


@pytest.mark.parametrize("shape,p", [((20, 17, 9), 0.02), ((8, 8, 8), 0.0)])
def test_distance_transform_is_exact(shape, p):
    occ = np.random.default_rng(sum(shape)).random(shape) < p
    ref = np.asarray(jr.manhattan_distance_transform(jnp.asarray(occ)))
    got = tr.manhattan_distance_transform(torch.from_numpy(occ))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


def _scene_cases():
    """The scenes of tests/test_raycast.py: (occ, ray_o, ray_d, vs, origin,
    ijk_min)."""
    occ1 = np.zeros((8, 8, 8), bool)
    occ1[4, 4, 4] = True
    occ2 = np.zeros((8, 8, 8), bool)
    occ2[2, 3, 5] = True
    occ3 = np.zeros((16, 16, 16), bool)
    occ3[5, 5, 5] = occ3[9, 9, 9] = True
    d3 = np.ones(3, np.float32) / np.sqrt(3)
    occ4 = np.zeros((6, 6, 6), bool)
    occ4[3, 2, 1] = True
    vs4, org4 = np.array([0.5, 1.0, 2.0]), np.array([10.0, -5.0, 3.0])
    c4 = org4 + np.array([1, 0, -1]) * vs4 + np.array([0.0, 0.0, 10.0])
    occ5 = np.zeros((16, 16, 4), bool)
    occ5[:, :, 0] = True
    rng = np.random.default_rng(0)
    ro5 = np.stack([rng.uniform(2, 14, 32), rng.uniform(2, 14, 32),
                    np.full(32, 3.0)], -1)
    d5 = np.stack([rng.uniform(-0.2, 0.2, 32), rng.uniform(-0.2, 0.2, 32),
                   -np.ones(32)], -1)
    d5 /= np.linalg.norm(d5, axis=-1, keepdims=True)
    f = np.float32
    return [
        (occ1, [[-3.0, 4.0, 4.0]], [[1.0, 0.0, 0.0]], 1.0, 0.0, (0, 0, 0)),
        (occ2, [[10.0, 3.0, 5.0], [10.0, 0.0, 0.0]],
         [[-1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]], 1.0, 0.0, (0, 0, 0)),
        (occ3, [[0.0, 0.0, 0.0]], d3[None], 1.0, 0.0, (0, 0, 0)),
        (occ4, c4[None], [[0.0, 0.0, -1.0]], vs4.astype(f), org4.astype(f),
         (-2, -2, -2)),
        (np.ones((4, 4, 4), bool), [[1.2, 1.2, 1.2]], [[0.0, 0.0, 1.0]],
         1.0, 0.0, (0, 0, 0)),
        (occ5, ro5, d5, 1.0, 0.0, (0, 0, 0)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_dda_on_the_reference_scenes(case):
    occ, ro, rd, vs, org, imn = _scene_cases()[case]
    ro, rd = (np.asarray(a, np.float32) for a in (ro, rd))
    ref = jr.dda_first_hit(jnp.asarray(occ), jnp.asarray(ro), jnp.asarray(rd),
                           vs, org, imn)
    got = tr.dda_first_hit(torch.from_numpy(occ), _t(ro), _t(rd), vs, org,
                           imn)
    _agree(got, ref, min_share=1.0)


@pytest.mark.parametrize("skip", [False, True])
def test_dda_on_a_random_block(skip):
    """A random 48^3 block (5 % filled, with a floor), 64 x 48 rays from
    outside and inside it, unnormalized and normalized directions."""
    rng = np.random.default_rng(11)
    occ = rng.random((48, 48, 48)) < 0.05
    occ[:, :, :2] = True
    n = 64 * 48
    ro = np.concatenate([rng.uniform(-20, 60, (n // 2, 3)),
                         rng.uniform(2, 40, (n - n // 2, 3))]).astype(
                             np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd[n // 4:] /= np.linalg.norm(rd[n // 4:], axis=-1, keepdims=True)
    vs, org, imn = 0.8, np.array([0.1, -0.3, 0.2], np.float32), (-5, 3, -2)
    sd = jr.manhattan_distance_transform(jnp.asarray(occ)) if skip else None
    ref = jr.dda_first_hit(jnp.asarray(occ), jnp.asarray(ro), jnp.asarray(rd),
                           vs, org, imn, skip_dist=sd)
    got = tr.dda_first_hit(
        torch.from_numpy(occ), _t(ro), _t(rd), vs, org, imn,
        skip_dist=tr.manhattan_distance_transform(torch.from_numpy(occ))
        if skip else None)
    assert 0.2 < got.hit.float().mean().item() < 1.0
    _agree(got, ref)


def test_dda_with_per_ray_voxel_sizes_equals_separate_marches():
    """Per-ray voxel sizes and origins (all objects' rays in one march) give
    each object's own march."""
    rng = np.random.default_rng(2)
    occ = torch.from_numpy(rng.random((12, 8, 8)) < 0.2)
    ro = torch.from_numpy(rng.uniform(-4, 4, (2, 300, 3)).astype(np.float32))
    rd = torch.from_numpy(rng.standard_normal((2, 300, 3)).astype(np.float32))
    vs = torch.tensor([[0.3, 0.25, 0.2], [0.5, 0.4, 0.1]])
    one = [tr.dda_first_hit(occ, ro[m], rd[m], vs[m], vs[m] / 2, (-6, -4, -4))
           for m in range(2)]
    vs_r = vs[:, None].expand(2, 300, 3).reshape(-1, 3)
    both = tr.dda_first_hit(occ, ro.reshape(-1, 3), rd.reshape(-1, 3), vs_r,
                            vs_r / 2, (-6, -4, -4))
    for f in tr.RayHit._fields:
        assert torch.equal(getattr(both, f),
                           torch.cat([getattr(o, f) for o in one]))


def test_raycast_grid_and_grid_helpers():
    ijk = np.array([[[2, 2, 2], [5, 2, 2], [-1, 7, 3]]], np.int32)
    mask = np.array([[True, True, False]])
    jg = jax_grid_from_ijk(jnp.asarray(ijk), jnp.asarray(mask), 1.0, 0.0,
                           capacity=8)
    tg = grid_from_ijk(torch.from_numpy(ijk), torch.from_numpy(mask), 1.0,
                       0.0, 8)
    for got, ref in zip(tg.bbox_ijk(), jg.bbox_ijk()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        occupancy_dense(tg, (0, 0, 0), (8, 8, 8)).numpy(),
        np.asarray(jax_occupancy_dense(jg, (0, 0, 0), (8, 8, 8))))
    sem = torch.zeros((8, 1))
    sem[:2, 0] = tg.ijk[0, :2, 0].float()
    ro = torch.tensor([[-5.0, 2.0, 2.0], [10.0, 2.0, 2.0], [1.0, 6.0, 2.0]])
    rd = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    hit, attrs = tr.raycast_grid(tg, 0, ro, rd, (0, 0, 0), (8, 8, 8),
                                 {"sem": sem})
    assert hit.hit.tolist() == [True, True, False]
    assert hit.ijk[:2, 0].tolist() == [2, 5]
    assert attrs["sem"][:, 0].tolist() == [2.0, 5.0, 0.0]
    dense = tr.dense_attribute_lookup(tg, sem[None], (0, 0, 0), (8, 8, 8))
    assert dense.shape == (1, 8, 8, 8, 1) and dense[0, 5, 2, 2, 0] == 5.0


def test_far_and_nan_casts_saturate_as_xla():
    """The float -> int32 casts of the port clamp first: XLA saturates
    (NaN -> 0), torch's cast does not."""
    from infinicube_tpu_torch.utils.casts import saturating_int32
    x = np.array([5e9, -5e9, np.nan, np.inf, -np.inf, 3.7, -3.7, 0.5],
                 np.float32)
    ref = np.asarray(jnp.asarray(x).astype(jnp.int32)).astype(np.int64)
    got = saturating_int32(torch.from_numpy(x)).numpy().astype(np.int64)
    # equal but at the top end (5e9, inf), there within float32's spacing
    top = np.array([0, 3])
    rest = np.setdiff1d(np.arange(len(x)), top)
    np.testing.assert_array_equal(got[rest], ref[rest])
    assert (np.abs(got[top] - ref[top]) <= 128).all()
    # torch's own cast does not saturate
    assert torch.from_numpy(x[:1]).to(torch.int32).item() != ref[0]
