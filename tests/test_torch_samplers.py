"""Port parity: the DDPM and DPM-Solver++ samplers, the Karras timesteps and
the scaled-linear schedule of ``infinicube_tpu_torch.models.diffusion.
schedulers`` against the JAX functions (on a toy model_fn, with JAX's DDPM
draws injected), and ``VoxelDiffusion.sample(sampler=...)`` against the JAX
model on the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.diffusion import schedulers as jsched
from infinicube_tpu_torch.models.diffusion.schedulers import (
    NoiseSchedule, ddpm_sample, dpmpp_sample, karras_timesteps,
    sampling_timesteps)
from tests.test_torch_voxel_diffusion import encode_both, models
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-3, rtol=2e-3)
SHAPE = (2, 3, 4, 5, 4)


def _toy_fns():
    """The same model_fn on both sides: a smooth function of x and t."""
    def jfn(x, t):
        return 0.5 * jnp.tanh(x) + 1e-3 * t[:, None, None, None, None]

    def tfn(x, t):
        return 0.5 * torch.tanh(x) + 1e-3 * t[:, None, None, None, None]
    return jfn, tfn


def _x_T(seed=0):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(
        np.float32)


def ddpm_draws(rng, shape, steps):
    """The per-step noise JAX's ddpm_sample draws from ``rng``."""
    out = []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape))))
    return out


def test_scaled_linear_matches():
    ref = jsched.NoiseSchedule.scaled_linear(1000)
    got = NoiseSchedule.scaled_linear(1000)
    np.testing.assert_allclose(got.betas.numpy(), np.asarray(ref.betas),
                               rtol=1e-6)
    np.testing.assert_allclose(got.alphas_cumprod.numpy(),
                               np.asarray(ref.alphas_cumprod), rtol=1e-5)


@pytest.mark.parametrize("steps", [10, 25, 100])
def test_karras_timesteps_equal(steps):
    for kind in ("linear", "scaled_linear"):
        ref = jsched.karras_timesteps(getattr(jsched.NoiseSchedule, kind)(),
                                      steps)
        got = karras_timesteps(getattr(NoiseSchedule, kind)(), steps)
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype and np.all(np.diff(got) < 0)


@pytest.mark.parametrize("steps", [4, 1000])
def test_ddpm_matches_with_injected_noise(steps):
    jfn, tfn = _toy_fns()
    rng = jax.random.PRNGKey(3)
    x_T = _x_T()
    ref = np.asarray(jsched.ddpm_sample(jsched.NoiseSchedule.linear(), jfn,
                                        jnp.asarray(x_T), rng, steps))
    got = ddpm_sample(NoiseSchedule.linear(), tfn, torch.from_numpy(x_T),
                      steps, step_noise=ddpm_draws(rng, SHAPE, steps))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_ddpm_draws_from_the_generator():
    jfn, tfn = _toy_fns()
    x_T = torch.from_numpy(_x_T())
    a, b = (ddpm_sample(NoiseSchedule.linear(), tfn, x_T, 5,
                        generator=torch.Generator().manual_seed(s))
            for s in (1, 1))
    c = ddpm_sample(NoiseSchedule.linear(), tfn, x_T, 5,
                    generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("karras", [False, True])
@pytest.mark.parametrize("pred", ["v_prediction", "epsilon"])
def test_dpmpp_matches(karras, pred):
    jfn, tfn = _toy_fns()
    x_T = _x_T(1)
    calls = []

    def counted(x, t):
        calls.append(int(t[0]))
        return tfn(x, t)
    ref = np.asarray(jsched.dpmpp_sample(
        jsched.NoiseSchedule.linear(), jfn, jnp.asarray(x_T), 12,
        prediction_type=pred, use_karras_sigmas=karras))
    got = dpmpp_sample(NoiseSchedule.linear(), counted, torch.from_numpy(x_T),
                       12, prediction_type=pred, use_karras_sigmas=karras)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    want = karras_timesteps(NoiseSchedule.linear(), 12) if karras else \
        sampling_timesteps(1000, 12)
    assert calls == want.tolist()


def test_step_callback_runs_before_each_model_call():
    _, tfn = _toy_fns()
    seen = []
    for sample in (ddpm_sample, dpmpp_sample):
        seen.clear()
        sample(NoiseSchedule.linear(), tfn, torch.from_numpy(_x_T()), 3,
               step_callback=lambda x, t, i: seen.append((t, i)) or x)
        assert seen == [(666, 0), (333, 1), (0, 2)]


@pytest.mark.parametrize("sampler", ["ddpm", "dpmpp"])
def test_voxel_diffusion_samples_match(sampler):
    """The small model of tests/test_torch_voxel_diffusion.py, guided, with
    JAX's x_T and (DDPM) per-step draws injected."""
    jd, params, td = models(seed=3)
    jc, tc = encode_both(jd, td, seed=3)
    rng = jax.random.PRNGKey(4)
    ref = np.asarray(jd.sample(params, rng, jc, num_steps=3,
                               guidance_scale=2.0, sampler=sampler,
                               scale_factor=0.8))
    r_init, r_loop = jax.random.split(rng)
    x_T = torch.from_numpy(np.array(jax.random.normal(r_init, ref.shape)))
    step_noise = ddpm_draws(r_loop, ref.shape, 3) if sampler == "ddpm" \
        else None
    got = td.sample(tc, num_steps=3, guidance_scale=2.0, sampler=sampler,
                    scale_factor=0.8, noise=x_T, step_noise=step_noise)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_unknown_sampler_raises():
    _, _, td = models()
    with pytest.raises(ValueError, match="sampler"):
        td.sample(None, sampler="euler")
