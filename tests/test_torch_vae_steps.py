"""Port parity for the sparse-VAE trainer's gradients and steps: every
parameter's gradient of ``vae_loss`` and five train steps (one on a NaN
batch) of ``infinicube_tpu_torch`` against the JAX package, on the batches,
weights and reparametrize noise of ``tests/test_torch_vae_train.py`` (f32 on
both sides, ``f_maps`` 8; the JAX sparse convs through their gather
reference)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

from infinicube_tpu.training import state as jstate
from infinicube_tpu_torch.models.vae.loss import VAELossConfig, vae_loss
from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                   SparseVAEConfig)
from infinicube_tpu_torch.training.state import (TrainConfig, TrainState,
                                                 make_train_step)
from infinicube_tpu_torch.weights.from_jax import (sparse_vae_from_jax,
                                                   vae_train_state_from_jax)
from tests.test_torch_vae_train import (LATENT, SMALL, ZERO_GRAD, _jax_batch,
                                        _jax_forward, _models, _noise,
                                        _port_batch, _scene)
from tests.test_torch_gsm import one_torch_thread  # noqa: F401


def _port_grads(port, batch, noise):
    grids, sem = batch
    for p in port.parameters():
        p.grad = None
    out = port(grids, sem, noise=torch.from_numpy(noise))
    loss, _ = vae_loss(VAELossConfig(), out, grids[0], sem)
    loss.backward()
    return loss.item(), {k: p.grad.clone()
                         for k, p in port.named_parameters()}


def test_every_gradient_matches_jax():
    jvae, params, port = _models(seed=2)
    pts, labels = _scene(6)
    rng = jax.random.PRNGKey(11)
    jbatch = _jax_batch(jvae.cfg, pts, labels)
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_forward(jvae, p, jbatch, rng)[0], has_aux=True))(
            params)
    loss, grads = _port_grads(port, _port_batch(port.cfg, pts, labels),
                              _noise(rng, LATENT))
    assert abs(loss - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    # each gradient within 2e-3 of its largest reference value, with a floor
    # of 1e-3 of the largest gradient for the tensors whose gradient is
    # exactly zero (ZERO_GRAD), as the diffusion trainer's test gates them
    ref = sparse_vae_from_jax(jax.tree.map(np.asarray, ref_grads))
    assert set(ref) == set(grads)
    floor = 1e-3 * max(r.abs().max().item() for r in ref.values())
    noise_only = set()
    for name, r in ref.items():
        r = r.numpy()
        if np.abs(r).max() <= floor:
            noise_only.add(name)
        np.testing.assert_allclose(
            grads[name].numpy(), r, rtol=2e-3,
            atol=2e-3 * max(np.abs(r).max(), floor), err_msg=name)
    assert all(n.endswith(ZERO_GRAD) for n in noise_only), noise_only
    assert len(ref) - len(noise_only) >= 0.85 * len(ref)


def _adam_state(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam


def test_five_train_steps_match_jax():
    """Five AdamW steps, the third on a batch whose grid origin is NaN:
    losses, counters, parameters, Adam moments and the EMA shadow. Adam
    moves every element by about the learning rate per step whatever its
    gradient's size, so parameters are held to 2 % of the largest distance
    five steps can cover; the second moment, which sums squares, to 1e-2 of
    its largest value. The ZERO_GRAD tensors are left out: their update is
    the sign of rounding noise."""
    kw = dict(learning_rate=1e-3, weight_decay=0.01, grad_clip_value=0.5,
              ema_decay=0.9, use_ema=True)
    steps, lr = 5, kw["learning_rate"]
    jvae, params, port = _models(seed=3)
    jcfg = jstate.TrainConfig(**kw)
    js = jstate.TrainState.create(jcfg, params)
    jstep = jax.jit(jstate.make_train_step(
        jcfg, lambda p, rng, batch: _jax_forward(jvae, p, batch, rng)[0]))

    def loss_fn(p, generator, batch):
        grids, sem, noise = batch
        out = functional_call(port, p, (grids, sem), {"noise": noise})
        return vae_loss(VAELossConfig(), out, grids[0], sem)

    tcfg = TrainConfig(**kw)
    ts = TrainState.create(tcfg, dict(port.named_parameters()))
    tstep = make_train_step(tcfg, loss_fn)
    for i in range(steps):
        pts, labels = _scene(20 + i)
        jgrids, jsem = _jax_batch(jvae.cfg, pts, labels)
        tgrids, tsem = _port_batch(port.cfg, pts, labels)
        if i == 2:
            jgrids[0] = dataclasses.replace(
                jgrids[0], origin=jgrids[0].origin * jnp.nan)
            tgrids[0] = dataclasses.replace(
                tgrids[0], origin=tgrids[0].origin * float("nan"))
        rng = jax.random.PRNGKey(i)
        js, jm = jstep(js, rng, (jgrids, jsem))
        ts, tm = tstep(ts, None, (tgrids, tsem,
                                  torch.from_numpy(_noise(rng, LATENT))))
        assert float(tm["grad_finite"]) == float(jm["grad_finite"]) == \
            float(i != 2)
        if i != 2:
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=1e-3)
            np.testing.assert_allclose(float(tm["struct1_iou"]),
                                       float(jm["struct1_iou"]), atol=1e-3)
    assert ts.step == int(js.step) == steps
    assert ts.num_nan_skips == int(js.num_nan_skips) == 1
    assert ts.ema.step == int(js.ema.step) == steps
    adam = _adam_state(js.opt_state)
    assert ts.opt_count == int(adam.count) == steps - 1
    ref = vae_train_state_from_jax(
        *(jax.tree.map(np.asarray, t) for t in (js.params, adam.mu, adam.nu)),
        count=int(adam.count), step=int(js.step),
        num_nan_skips=int(js.num_nan_skips),
        ema_params=jax.tree.map(np.asarray, js.ema.params),
        ema_step=int(js.ema.step))
    mu, nu = ts.moments()
    assert set(ref["params"]) == set(ts.params) == set(mu)
    start = sparse_vae_from_jax(jax.tree.map(np.asarray, params))
    compared = 0
    for name, p in ts.params.items():
        if name.endswith(ZERO_GRAD):
            continue
        compared += 1
        moved = (ref["params"][name] - start[name]).abs().max().item()
        assert moved > 0.5 * lr, name
        for got, want in ((p.detach(), ref["params"][name]),
                          (ts.ema.params[name], ref["ema"]["params"][name])):
            assert (got - want).abs().max().item() <= \
                0.02 * lr * (steps - 1), name
        m_ref, v_ref = ref["mu"][name], ref["nu"][name]
        np.testing.assert_allclose(
            mu[name].numpy(), m_ref.numpy(), rtol=2e-3,
            atol=2e-3 * m_ref.abs().max().item(), err_msg=name)
        np.testing.assert_allclose(
            nu[name].numpy(), v_ref.numpy(), rtol=1e-2,
            atol=1e-2 * v_ref.abs().max().item(), err_msg=name)
    assert compared >= 0.85 * len(ts.params)
    # the state loads into a fresh port state
    fresh = SparseStructureVAE(SparseVAEConfig(**SMALL), device="cpu")
    fs = TrainState.create(tcfg, dict(fresh.named_parameters()))
    fs.load_state_dict(ref)
    assert fs.step == steps and fs.opt_count == steps - 1
    name = "enc1_0.conv2.kernel"
    np.testing.assert_array_equal(
        fs.moments()[1][name].numpy(),
        np.asarray(adam.nu["params"]["enc1_0"]["conv2"]["kernel"]))
    with pytest.raises(ValueError):
        vae_train_state_from_jax({}, {}, {}, count=5, step=5,
                                 num_nan_skips=1)
