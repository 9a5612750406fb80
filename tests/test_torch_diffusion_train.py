"""Port parity: ``VoxelDiffusion.train_loss`` and every parameter's gradient
against the JAX package on the same weights, batch and draws (the JAX
function's timesteps, noise and drop masks are injected into the port),
``remat``, ``classifier_free_drop`` and ``EmaState``. f32 on both sides."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.diffusion import ema as jema
from infinicube_tpu.models.diffusion import model as jmodel
from infinicube_tpu_torch.models.diffusion.ema import EmaState
from infinicube_tpu_torch.models.diffusion.encoders import \
    classifier_free_drop
from infinicube_tpu_torch.models.diffusion.model import (CondCubes,
                                                         DiffusionConfig,
                                                         VoxelDiffusion)
from infinicube_tpu_torch.weights.from_jax import unet_from_jax
from tests.test_torch_sparse_vae import random_params
from tests.test_torch_voxel_diffusion import SMALL, conditions
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

PROB = 0.5      # so that a batch of 2 mixes dropped and kept conditions


def _models(seed=0, remat=False, **kw):
    """The JAX model on random parameters (the zero-init layers filled) and
    a trainable port model on the same parameters (flax renames the blocks
    under ``remat``, so that option goes to the port only)."""
    jd = jmodel.VoxelDiffusion(jmodel.DiffusionConfig(
        **SMALL, dtype=jnp.float32, classifier_free_prob=PROB, **kw))
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(seed))
    params = random_params(flax.linen.meta.unbox(shapes), seed)
    td = VoxelDiffusion(DiffusionConfig(
        **SMALL, dtype=torch.float32, classifier_free_prob=PROB, remat=remat,
        **kw), device="cpu", trainable=True)
    td.load_params(unet_from_jax(params))
    return jd, jax.tree.map(jnp.asarray, params), td


def _batch(jd, td, seed=0, B=2):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((B, 8, 8, 8, 8)).astype(np.float32)
    args = [np.concatenate([a, a[:, ::-1] if a.ndim > 2 else a])[:B]
            for a in conditions(seed)]
    jc = jd.encode_conditions(*map(jnp.asarray, args))
    tc = td.encode_conditions(*map(torch.from_numpy, args))
    return lat, jc, tc


def _jax_draws(rng, shape, cfg):
    """What ``train_loss`` draws from ``rng`` (model.py:305-323)."""
    r_t, r_n, r_m, r_b = jax.random.split(rng, 4)
    B = shape[0]
    t = jax.random.randint(r_t, (B,), 0, cfg.num_train_timesteps)
    noise = jax.random.normal(r_n, shape)
    drops = tuple(np.asarray(jax.random.uniform(r, (B,)) <
                             cfg.classifier_free_prob) for r in (r_m, r_b))
    return np.asarray(t), np.asarray(noise), drops


def _port_loss_and_grads(td, lat, tc, draws, scale_factor):
    t, noise, drops = draws
    for p in td.unet.parameters():
        p.grad = None
    loss, metrics = td.train_loss(
        torch.from_numpy(lat), tc, scale_factor=scale_factor,
        t=torch.from_numpy(t.copy()).long(),
        noise=torch.from_numpy(noise.copy()),
        drop=tuple(torch.from_numpy(d.copy()) for d in drops))
    loss.backward()
    assert metrics["mse"] is loss
    return loss.item(), {k: p.grad.clone()
                         for k, p in td.named_parameters().items()}


@pytest.mark.parametrize("prediction_type,rng_seed",
                         [("v_prediction", 4), ("epsilon", 11)])
def test_train_loss_and_gradients_match_jax(prediction_type, rng_seed):
    jd, params, td = _models(prediction_type=prediction_type)
    lat, jc, tc = _batch(jd, td)
    rng = jax.random.PRNGKey(rng_seed)
    (ref_loss, _), ref_grads = jax.value_and_grad(
        jd.train_loss, has_aux=True)(params, rng, jnp.asarray(lat), jc, 0.8)
    draws = _jax_draws(rng, lat.shape, jd.cfg)
    assert any(d.any() and not d.all() for d in draws[2]) or rng_seed != 4
    loss, grads = _port_loss_and_grads(td, lat, tc, draws, 0.8)
    # the loss to 1e-4 relative; each gradient within 2e-3 of its largest
    # reference value (f32 on both sides, other summation orders)
    assert abs(loss - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    # A conv bias that feeds a GroupNorm of one channel per group has a
    # gradient of exactly zero; both sides give rounding noise there, which
    # is held to the same limit with a floor of 1e-3 of the largest gradient.
    ref = unet_from_jax(jax.tree.map(np.asarray, ref_grads))
    assert set(ref) == set(grads)
    floor = 1e-3 * max(r.abs().max().item() for r in ref.values())
    n_real = 0
    for name, r in ref.items():
        r = r.numpy()
        n_real += np.abs(r).max() > floor
        np.testing.assert_allclose(
            grads[name].numpy(), r, rtol=2e-3,
            atol=2e-3 * max(np.abs(r).max(), floor), err_msg=name)
    assert n_real >= 0.9 * len(ref)


def test_remat_gives_identical_gradients():
    jd, params, td = _models(seed=1)
    _, _, tr = _models(seed=1, remat=True)
    assert tr.unet.remat and not td.unet.remat
    lat, jc, tc = _batch(jd, td, seed=1)
    draws = _jax_draws(jax.random.PRNGKey(2), lat.shape, jd.cfg)
    loss, grads = _port_loss_and_grads(td, lat, tc, draws, 1.0)
    loss_r, grads_r = _port_loss_and_grads(tr, lat, tc, draws, 1.0)
    assert loss == loss_r
    for name, g in grads.items():
        assert torch.equal(g, grads_r[name]), name


def test_train_loss_draws_from_the_generator():
    """Without injected draws the loss is a function of the generator's
    seed, and EMA parameters can stand in for the model's."""
    jd, _, td = _models(seed=2)
    lat, _, tc = _batch(jd, td, seed=2)
    lat = torch.from_numpy(lat)

    def run(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return td.train_loss(lat, tc, generator=g, **kw)[0].item()

    assert run(0) == run(0) and run(0) != run(1)
    zeros = {k: torch.zeros_like(v) for k, v in td.named_parameters().items()}
    assert run(0, params=zeros) != run(0)
    assert run(0, params=td.named_parameters()) == run(0)


def test_serving_model_stays_frozen():
    td = VoxelDiffusion(DiffusionConfig(**SMALL, dtype=torch.float32),
                        device="cpu")
    assert not any(p.requires_grad for p in td.unet.parameters())
    x = torch.zeros((1, 8, 8, 8, 8))
    out = td.denoise(x, torch.tensor([3]), CondCubes.null(1, td.cfg))
    assert not out.requires_grad


def test_classifier_free_drop():
    g = torch.Generator().manual_seed(0)
    cond = torch.ones((4000, 2, 1, 1, 3))
    out = classifier_free_drop(cond, 0.1, g)
    dropped = (out == 0).all(dim=(1, 2, 3, 4))
    kept = (out == 1).all(dim=(1, 2, 3, 4))
    assert (dropped | kept).all()
    assert abs(dropped.float().mean().item() - 0.1) < 0.02
    mask = torch.tensor([True, False, True])
    got = classifier_free_drop(torch.full((3, 2), 7.0), 0.1, drop=mask)
    assert got.tolist() == [[0, 0], [7, 7], [0, 0]]
    # the JAX function on the same mask source: uniform < prob
    u = jax.random.uniform(jax.random.PRNGKey(3), (6,))
    from infinicube_tpu.models.diffusion.encoders import \
        classifier_free_drop as jdrop
    ref = np.asarray(jdrop(jnp.ones((6, 2)), jax.random.PRNGKey(3), 0.4))
    got = classifier_free_drop(torch.ones((6, 2)), 0.4,
                               drop=torch.from_numpy(np.array(u < 0.4)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal(5).astype(np.float32),
          "b": rng.standard_normal((2, 3)).astype(np.float32)}
    jstate = jema.EmaState.create(jax.tree.map(jnp.asarray, p0))
    tstate = EmaState.create({k: torch.from_numpy(v) for k, v in p0.items()})
    for i in range(12):
        p = {k: (v + rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in p0.items()}
        jstate = jstate.update(jax.tree.map(jnp.asarray, p), 0.9)
        tstate.update({k: torch.from_numpy(v) for k, v in p.items()}, 0.9)
        assert tstate.step == int(jstate.step) == i + 1
        for k in p0:
            np.testing.assert_allclose(tstate.params[k].numpy(),
                                       np.asarray(jstate.params[k]),
                                       rtol=1e-5, atol=1e-6)
    before = {k: v.clone() for k, v in tstate.params.items()}
    tstate.update({k: torch.from_numpy(v) for k, v in p0.items()}, 0.9,
                  apply=False)
    assert tstate.step == 13
    assert all(torch.equal(before[k], tstate.params[k]) for k in before)
    assert EmaState.decay_at(1, 0.9999) == pytest.approx(2 / 11)
