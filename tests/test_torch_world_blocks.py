"""Port parity for the rest of stage-1 serving: blocks mode of
``VoxelWorldGenerator`` (tiles, skipped tiles, the latent table and the
SDEdit it feeds), trajectory extrapolation, the connected-component filter,
``voxel_generation_single_chunk`` and the port's copy of the interpolation
helpers, each against the JAX package on the same weights and with the JAX
generator's random numbers injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.inference import voxel_generation_single_chunk as jsc
from infinicube_tpu.inference import voxel_world_generation as jgen
from infinicube_tpu.utils import interpolate as jinterp
from infinicube_tpu.utils import world_grid as jwg
from infinicube_tpu_torch.inference import voxel_generation_single_chunk as sc
from infinicube_tpu_torch.inference.voxel_world_generation import (
    VoxelWorldGenerator, WorldGenConfig)
from infinicube_tpu_torch.models.diffusion.model import DiffusionConfig
from infinicube_tpu_torch.utils import interpolate
from infinicube_tpu_torch.utils.world_grid import (WorldGrid,
                                                   connected_component_filter)
from tests.test_torch_voxel_diffusion import SMALL, jax_noise, models
from tests.test_torch_world_generation import scene
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

STEPS = 2
CFG = dict(ddim_steps=STEPS, max_map_points=256, max_boxes=4,
           guidance_scale=2.0)
LATENT = (1, 8, 8, 8, 8)


def jax_decode(latents):
    """Both sides decode by thresholding the first latent channel (the
    single-chunk CLI's decode): identical latents signs give identical
    voxels."""
    lat = np.asarray(latents)[0]
    occ = lat[..., 0] > 0
    ii, jj, kk = np.meshgrid(*[np.arange(n) for n in lat.shape[:3]],
                             indexing="ij")
    ijk = (np.stack([ii, jj, kk], -1)[occ] + np.asarray(SMALL["cube_ijk_min"])
           ) * 4
    return ijk.astype(np.int64), np.ones(len(ijk), np.int32)


def _draws(seed, n):
    """The JAX generator's per-block random numbers: one split per
    generated block, x_T and the SDEdit noise from each."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        x_T, sd = jax_noise(sub, LATENT, STEPS)
        out.append(dict(noise=torch.from_numpy(x_T),
                        sdedit_noise=[torch.from_numpy(n) for n in sd]))
    return out


def _record(gen, name, into):
    real = getattr(gen, name)

    def wrapped(*a):
        out = real(*a)
        into.append(out)
        return out
    setattr(gen, name, wrapped)


def test_generate_blocks_matches_jax():
    """A 2 x 2 tiling (4.8 m steps of 6.4 m blocks) with one tile skipped:
    the same centres, SDEdit masks, latent-table keys and world voxels."""
    jd, params, td = models(seed=7)
    _, maps, boxes = scene()
    skip = lambda c: bool(c[0] > 5 and c[1] < 5)   # noqa: E731
    jg = jgen.VoxelWorldGenerator(jd, params, jax_decode,
                                  jgen.WorldGenConfig(**CFG))
    tg = VoxelWorldGenerator(td, sc.occupancy_decode_fn(td.cfg),
                             WorldGenConfig(**CFG))
    np.testing.assert_array_equal(tg._block_centers((0, 0), (8, 8)),
                                  jg._block_centers((0, 0), (8, 8)))
    assert len(tg._block_centers((0, 0), (8, 8))) == 4
    jsd, tsd = [], []
    _record(jg, "_sdedit_from_table", jsd)
    _record(tg, "_sdedit_from_table", tsd)
    ref = jg.generate_blocks((0, 0), (8, 8), maps, boxes, seed=2,
                             skip_empty_fn=skip)
    world = tg.generate_blocks((0, 0), (8, 8), maps, boxes, seed=2,
                               skip_empty_fn=skip, block_noise=_draws(2, 3))
    assert len(tg.last_chunks) == 3
    assert [s is None for s in tsd] == [s is None for s in jsd] == \
        [True, False, False]
    for j, t in zip(jsd[1:], tsd[1:]):
        np.testing.assert_array_equal(t.overlap_mask.numpy(),
                                      np.asarray(j.overlap_mask))
        np.testing.assert_allclose(t.warped_latents.numpy(),
                                   np.asarray(j.warped_latents), atol=2e-3)
        assert 0 < t.overlap_mask.float().mean() < 1
    np.testing.assert_array_equal(tg._table_keys, jg._table_keys)
    np.testing.assert_allclose(tg._table_vals, jg._table_vals, atol=2e-3,
                               rtol=2e-3)
    assert set(tg._latent_table) == set(jg._latent_table)
    assert world.num_voxels > 0
    np.testing.assert_array_equal(world.keys, ref.keys)
    np.testing.assert_array_equal(world.semantics, ref.semantics)


def test_latent_table_first_writer_wins():
    """An update inserts only cells the table lacks, and within one update
    the first of two cells that round onto one world cell wins."""
    jd, params, td = models()
    jg = jgen.VoxelWorldGenerator(jd, params, jax_decode)
    tg = VoxelWorldGenerator(td, jax_decode)
    rng = np.random.default_rng(0)
    c2w = np.eye(4)
    rot = np.eye(4)
    rot[:2, :2] = [[np.cos(0.7), -np.sin(0.7)], [np.sin(0.7), np.cos(0.7)]]
    rot[:3, 3] = [1.3, -0.4, 0.0]
    for pose in (c2w, rot):
        lat = rng.standard_normal(LATENT).astype(np.float32)
        jg._update_table(lat, pose)
        tg._update_table(torch.from_numpy(lat), pose)
        np.testing.assert_array_equal(tg._table_keys, jg._table_keys)
        np.testing.assert_array_equal(tg._table_vals, jg._table_vals)
    assert len(tg._table_keys) < 2 * 512


def test_pack_keys_refuses_the_outside_of_its_domain():
    ok = np.array([[-(1 << 20), 0, (1 << 20) - 1]])
    np.testing.assert_array_equal(VoxelWorldGenerator._pack_keys(ok),
                                  jgen.VoxelWorldGenerator._pack_keys(ok))
    for bad in ([[1 << 20, 0, 0]], [[0, -(1 << 20) - 1, 0]]):
        with pytest.raises(ValueError, match="domain"):
            VoxelWorldGenerator._pack_keys(np.array(bad))


@pytest.mark.parametrize("extra", [0, 3])
def test_key_poses_extrapolate_like_jax(extra):
    jd, params, td = models()
    ego, _, _ = scene()
    ref = jgen.VoxelWorldGenerator(
        jd, params, jax_decode,
        jgen.WorldGenConfig(extrapolation_steps=extra)
    ).key_poses_along_trajectory(ego)
    got = VoxelWorldGenerator(
        td, jax_decode, WorldGenConfig(extrapolation_steps=extra)
    ).key_poses_along_trajectory(ego)
    np.testing.assert_array_equal(got, ref)
    assert len(got) == 3 + extra


def _clusters(seed=0):
    """Voxel clusters of 1 to 30 voxels, some touching only by an edge."""
    rng = np.random.default_rng(seed)
    parts = []
    for i, n in enumerate([1, 2, 5, 12, 30, 3]):
        start = np.array([20 * i, 0, 0])
        walk = np.cumsum(rng.integers(0, 2, (n, 3)) *
                         np.eye(3, dtype=int)[rng.integers(0, 3, n)], 0)
        parts.append(start + walk)
    parts.append(np.array([[200, 0, 0], [201, 1, 0]]))      # edge, not face
    return np.unique(np.concatenate(parts), axis=0)


@pytest.mark.parametrize("min_size,largest", [(2, False), (5, False),
                                              (10, False), (1, True)])
def test_connected_component_filter_matches(min_size, largest):
    ijk = _clusters()
    np.testing.assert_array_equal(
        connected_component_filter(ijk, min_size, largest),
        jwg.connected_component_filter(ijk, min_size, largest))
    assert connected_component_filter(np.zeros((0, 3), int)).shape == (0,)


def test_cc_min_size_filters_before_the_merge():
    jd, params, td = models()
    ijk = _clusters(1)
    sem = np.arange(len(ijk), dtype=np.int32) % 7
    pose = np.eye(4)
    pose[:3, 3] = [3.0, -1.0, 0.4]
    worlds = []
    for cls, gen_cfg, d, extra in (
            (jgen.VoxelWorldGenerator, jgen.WorldGenConfig, jd, (params,)),
            (VoxelWorldGenerator, WorldGenConfig, td, ())):
        g = cls(d, *extra, lambda lat: (ijk, sem), gen_cfg(cc_min_size=5))
        w = (jwg.WorldGrid if cls is jgen.VoxelWorldGenerator
             else WorldGrid)(g.vs)
        g._decode_and_merge(np.zeros(LATENT, np.float32), pose, w)
        worlds.append(w)
    np.testing.assert_array_equal(worlds[1].keys, worlds[0].keys)
    np.testing.assert_array_equal(worlds[1].semantics, worlds[0].semantics)
    assert 0 < worlds[1].num_voxels < len(ijk)


def test_sample_single_chunk_matches_jax():
    jd, params, td = models(seed=8)
    _, maps, boxes = scene()
    ref = jsc.sample_single_chunk(jd, params, jax_decode, maps, boxes,
                                  ddim_steps=STEPS, guidance=2.0, seed=5)
    x_T, _ = jax_noise(jax.random.PRNGKey(5), LATENT, STEPS)
    got = sc.sample_single_chunk(td, sc.occupancy_decode_fn(td.cfg), maps,
                                 boxes, ddim_steps=STEPS, guidance=2.0,
                                 noise=dict(noise=torch.from_numpy(x_T)))
    np.testing.assert_allclose(got[2].numpy(), ref[2], atol=2e-3, rtol=2e-3)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert len(got[0]) > 0


def test_single_chunk_cli_writes_the_grid(tmp_path):
    cfg = DiffusionConfig(**SMALL, dtype=torch.float32)
    sc.main(["--output", str(tmp_path), "--ddim_steps", "2", "--guidance",
             "2.0"], device="cpu", cfg=cfg)
    out = np.load(tmp_path / "chunk.npz")
    assert out["ijk"].shape[1] == 3 and len(out["ijk"]) == \
        len(out["semantics"]) > 0
    assert (out["ijk"] % 4 == 0).all() and (out["semantics"] == 1).all()


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        out[i, :3, :3] = jinterp.quat_to_rot(rng.normal(size=4))
        out[i, :3, 3] = rng.normal(size=3) * 5
    return out


@pytest.mark.parametrize("name,args", [
    ("rot_to_quat", lambda p: (p[:, :3, :3],)),
    ("quat_to_rot", lambda p: (jinterp.rot_to_quat(p[:, :3, :3]),)),
    ("slerp", lambda p: (jinterp.rot_to_quat(p[0, :3, :3]),
                         jinterp.rot_to_quat(p[1, :3, :3]),
                         np.linspace(0, 1, 7))),
    ("interpolate_two_poses", lambda p: (p[0], p[1], 9)),
    ("inter_poses", lambda p: (p, 17, 1.5)),
    ("polyline_to_points", lambda p: (p[:, :3, 3], 0.7)),
    ("average_quaternions", lambda p: (jinterp.rot_to_quat(p[:, :3, :3]),)),
    ("extrapolate_trajectory", lambda p: (p, 4, 2.5)),
])
def test_interpolate_copy_matches(name, args):
    poses = _poses(5, seed=len(name))
    a = args(poses)
    np.testing.assert_allclose(getattr(interpolate, name)(*a),
                               getattr(jinterp, name)(*a), rtol=0,
                               atol=1e-12)
