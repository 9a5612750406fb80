"""Port parity: ``infinicube_tpu_torch.models.diffusion`` (condition
encoders, DDIM sampling, SDEdit warp and re-noising) against the JAX
``VoxelDiffusion`` on the same weights, inputs and random numbers: the
port's ``sample`` takes the JAX sampler's x_T and per-step SDEdit noise."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.diffusion import model as jmodel
from infinicube_tpu.models.diffusion import sdedit as jsdedit
from infinicube_tpu_torch.models.diffusion.model import (CondCubes,
                                                         DiffusionConfig,
                                                         VoxelDiffusion)
from infinicube_tpu_torch.models.diffusion.sdedit import warp_prev_latents
from infinicube_tpu_torch.weights.from_jax import unet_from_jax
from tests.test_torch_sparse_vae import random_params
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

SMALL = dict(cube_dims=(8, 8, 8), cube_ijk_min=(-4, -4, -4),
             model_channels=32, channel_mult=(1, 2), attention_ds=(2,),
             num_heads=4, transformer_depth=2)
# f32 on both sides, differing only in summation order
TOL = dict(atol=2e-3, rtol=2e-3)


def models(seed=0):
    """The JAX model with random parameters (zero-init layers included)
    and the port on the same parameters."""
    jd = jmodel.VoxelDiffusion(jmodel.DiffusionConfig(**SMALL,
                                                      dtype=jnp.float32))
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(seed))
    params = random_params(flax.linen.meta.unbox(shapes), seed)
    td = VoxelDiffusion(DiffusionConfig(**SMALL, dtype=torch.float32),
                        device="cpu")
    td.load_params(unet_from_jax(params))                 # strict
    return jd, jax.tree.map(jnp.asarray, params), td


def conditions(seed=0, n_boxes=3):
    rng = np.random.default_rng(seed)
    mp = rng.uniform(-4, 4, (1, 3, 200, 3)).astype(np.float32)
    mm = rng.random((1, 3, 200)) < 0.8
    poses = np.tile(np.eye(4, dtype=np.float32), (1, 4, 1, 1))
    for i in range(4):
        yaw = rng.uniform(-np.pi, np.pi)
        poses[0, i, :2, :2] = [[np.cos(yaw), -np.sin(yaw)],
                               [np.sin(yaw), np.cos(yaw)]]
        poses[0, i, :3, 3] = rng.uniform(-2.5, 2.5, 3)
    lwh = rng.uniform(1.0, 3.0, (1, 4, 3)).astype(np.float32)
    bm = np.arange(4)[None] < n_boxes
    return mp, mm, poses, lwh, bm


def encode_both(jd, td, seed=0):
    args = conditions(seed)
    jc = jd.encode_conditions(*map(jnp.asarray, args))
    tc = td.encode_conditions(*map(torch.from_numpy, args))
    return jc, tc


def test_encode_conditions_match():
    jd, _, td = models()
    jc, tc = encode_both(jd, td)
    np.testing.assert_array_equal(tc.map_cube.numpy(),
                                  np.asarray(jc.map_cube))
    np.testing.assert_allclose(tc.box_cube.numpy(), np.asarray(jc.box_cube),
                               atol=1e-5)
    assert tc.map_cube.sum() > 0 and (tc.box_cube != 0).any()


def jax_noise(rng, shape, steps):
    """x_T and the per-step SDEdit noise that the JAX sampler draws from
    ``rng`` (model.py sample / sdedit.make_sdedit_callback)."""
    r_init, r_loop = jax.random.split(rng)
    key = jax.random.fold_in(r_loop, 7)
    return (np.array(jax.random.normal(r_init, shape)),
            [np.array(jax.random.normal(jax.random.fold_in(key, i), shape))
             for i in range(steps)])


def test_ddim_sample_matches_with_injected_noise():
    jd, params, td = models()
    jc, tc = encode_both(jd, td)
    rng = jax.random.PRNGKey(5)
    ref = np.asarray(jd.sample(params, rng, jc, num_steps=3,
                               scale_factor=0.7))
    x_T, _ = jax_noise(rng, ref.shape, 3)
    got = td.sample(tc, num_steps=3, scale_factor=0.7,
                    noise=torch.from_numpy(x_T)).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, **TOL)


def test_guided_sample_matches():
    """guidance != 1: condition and null run as one doubled batch."""
    jd, params, td = models(seed=2)
    jc, tc = encode_both(jd, td, seed=2)
    rng = jax.random.PRNGKey(1)
    ref = np.asarray(jd.sample(params, rng, jc, num_steps=2,
                               guidance_scale=3.0))
    x_T, _ = jax_noise(rng, ref.shape, 2)
    got = td.sample(tc, num_steps=2, guidance_scale=3.0,
                    noise=torch.from_numpy(x_T)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.fixture(scope="module")
def warped():
    rng = np.random.default_rng(3)
    prev = rng.standard_normal((1, 8, 8, 8, 8)).astype(np.float32)
    valid = rng.random((1, 8, 8, 8)) < 0.9
    rel = np.eye(4, dtype=np.float32)
    rel[0, 3] = 2.4                          # 3 latent cells along x
    geo = ((-4, -4, -4), (0.8, 0.8, 0.4), (0.4, 0.4, 0.2))
    js = jsdedit.warp_prev_latents(jnp.asarray(prev), jnp.asarray(valid),
                                   jnp.asarray(rel), *geo)
    ts = warp_prev_latents(torch.from_numpy(prev), torch.from_numpy(valid),
                           torch.from_numpy(rel), *geo)
    return js, ts


def test_warp_prev_latents_matches(warped):
    js, ts = warped
    np.testing.assert_array_equal(ts.overlap_mask.numpy(),
                                  np.asarray(js.overlap_mask))
    np.testing.assert_array_equal(ts.warped_latents.numpy(),
                                  np.asarray(js.warped_latents))
    assert 0 < ts.overlap_mask.float().mean() < 1


def test_sdedit_sample_matches_with_injected_noise(warped):
    js, ts = warped
    jd, params, td = models(seed=1)
    jc, tc = encode_both(jd, td, seed=1)
    rng = jax.random.PRNGKey(9)
    ref = np.asarray(jd.sample(params, rng, jc, num_steps=3,
                               scale_factor=1.3, sdedit=js, use_sdedit=True))
    x_T, noises = jax_noise(rng, ref.shape, 3)
    got = td.sample(tc, num_steps=3, scale_factor=1.3, sdedit=ts,
                    noise=torch.from_numpy(x_T),
                    sdedit_noise=[torch.from_numpy(n) for n in noises])
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the overlap really steered the sample
    plain = td.sample(tc, num_steps=3, scale_factor=1.3,
                      noise=torch.from_numpy(x_T)).numpy()
    assert np.abs(plain - got.numpy()).max() > 1e-2


def test_null_condition_is_zeros():
    c = CondCubes.null(2, DiffusionConfig(**SMALL))
    assert c.map_cube.shape == (2, 8, 8, 8, 3) and not c.map_cube.any()
    assert c.box_cube.shape == (2, 8, 8, 8, 2) and not c.box_cube.any()
