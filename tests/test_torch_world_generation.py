"""Port parity for the slice as a whole: ``VoxelWorldGenerator.
generate_trajectory`` of ``infinicube_tpu_torch`` (conditions, DDIM with
SDEdit from the previous chunk, sparse-VAE decode, world merge) against the
JAX generator, with small configs, 3 chunks, 2 DDIM steps, the same weights
and the JAX generator's random numbers injected."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from infinicube_tpu.inference import voxel_world_generation as jgen
from infinicube_tpu.models.diffusion import model as jmodel
from infinicube_tpu.models.vae import sunet as jsunet
from infinicube_tpu_torch.inference.voxel_world_generation import (
    VoxelWorldGenerator, WorldGenConfig, vae_decode_fn)
from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                   SparseVAEConfig)
from infinicube_tpu_torch.weights.from_jax import sparse_vae_from_jax
from tests.test_torch_sparse_vae import SMALL as VAE_SMALL
from tests.test_torch_sparse_vae import jax_params as vae_jax_params
from tests.test_torch_voxel_diffusion import jax_noise, models
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

STEPS = 2


def scene():
    ego = np.tile(np.eye(4), (30, 1, 1))
    ego[:, 0, 3] = np.linspace(0, 10, 30)        # 3 key poses, 4.8 m apart
    ego[:, 1, 3] = np.linspace(0, 0.6, 30)
    xs = np.linspace(-2, 12, 120)
    maps = {"road_edge": np.stack([xs, np.full(120, -1.5), np.zeros(120)],
                                  -1),
            "road_line": np.stack([xs, np.full(120, 1.5), np.zeros(120)],
                                  -1)}
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, :3, 3] = [[2.0, 1.0, 0.2], [6.5, -1.0, 0.0], [9.0, 0.5, 0.4]]
    poses[1, :2, :2] = [[0.6, -0.8], [0.8, 0.6]]
    boxes = {"poses": poses, "lwhs": np.array([[2.0, 1.0, 1.0]] * 3)}
    return ego, maps, boxes


def test_generate_trajectory_matches_jax():
    jd, dparams, td = models(seed=4)
    vae_kw = dict(VAE_SMALL, capacities=(4096, 2048, 1024))
    jvae, vparams = vae_jax_params(jsunet.SparseVAEConfig(**vae_kw), seed=5)
    tvae = SparseStructureVAE(SparseVAEConfig(**vae_kw), device="cpu")
    tvae.load_state_dict(sparse_vae_from_jax(vparams))     # strict
    cfg = dict(ddim_steps=STEPS, max_map_points=256, max_boxes=4)
    ego, maps, boxes = scene()

    jg = jgen.VoxelWorldGenerator(
        jd, dparams, jgen.vae_decode_fn(jvae, jax.tree.map(jnp.asarray,
                                                          vparams)),
        jgen.WorldGenConfig(**cfg))
    ref_latents = []
    sample = jg._sample_chunk
    jg._sample_chunk = lambda *a: ref_latents.append(sample(*a)) or \
        ref_latents[-1]
    ref = jg.generate_trajectory(ego, map_points=maps, boxes=boxes, seed=3)

    # the random numbers the JAX generator drew for each chunk
    shape = (1, 8, 8, 8, 8)
    rng, noise = jax.random.PRNGKey(3), []
    for _ in range(3):
        rng, sub = jax.random.split(rng)
        x_T, sd = jax_noise(sub, shape, STEPS)
        noise.append(dict(noise=torch.from_numpy(x_T),
                          sdedit_noise=[torch.from_numpy(n) for n in sd]))
    tg = VoxelWorldGenerator(td, vae_decode_fn(tvae), WorldGenConfig(**cfg))
    world = tg.generate_trajectory(ego, map_points=maps, boxes=boxes, seed=3,
                                   chunk_noise=noise)

    assert len(tg.last_chunks) == len(ref_latents) == 3
    for c, r in zip(tg.last_chunks, ref_latents):
        np.testing.assert_allclose(c["latents"].numpy(), r, atol=2e-3,
                                   rtol=2e-3)
    assert [c["overlap"] is None for c in tg.last_chunks] == \
        [True, False, False]
    assert all(c["overlap"] > 0 for c in tg.last_chunks[1:])
    assert world.num_voxels > 0
    np.testing.assert_array_equal(world.keys, ref.keys)
    np.testing.assert_array_equal(world.semantics, ref.semantics)
