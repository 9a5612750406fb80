"""Port parity of the video stage's training objective:
``WanVideoGenerator.train_loss`` and every DiT parameter's gradient against
``jax.value_and_grad`` of the JAX package's ``train_loss`` on
``tests/test_wan.py``'s tiny config (f32 on both sides), the draws taken
from the JAX key and injected into the port; text dropout at probabilities
0 and 1; the flow-matching helpers; the VAE's reparameterized encode with
injected noise; and an int8 DiT refusing a gradient."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.wan.dit import WanDiTConfig as JaxDiTCfg
from infinicube_tpu.models.wan.flow_match import \
    FlowMatchSchedule as JaxSchedule
from infinicube_tpu.models.wan.pipeline import WanPipelineConfig as JaxCfg
from infinicube_tpu.models.wan.pipeline import WanVideoGenerator as JaxGen
from infinicube_tpu.models.wan.t5 import T5Config as JaxT5Cfg
from infinicube_tpu.models.wan.vae3d import VideoVAE as JaxVAE
from infinicube_tpu.models.wan.vae3d import VideoVAEConfig as JaxVAECfg
from infinicube_tpu_torch.models.wan.dit import WanDiT, WanDiTConfig
from infinicube_tpu_torch.models.wan.flow_match import FlowMatchSchedule
from infinicube_tpu_torch.models.wan.pipeline import (WanPipelineConfig,
                                                      WanVideoGenerator)
from infinicube_tpu_torch.models.wan.t5 import T5Config
from infinicube_tpu_torch.models.wan.vae3d import VideoVAE, VideoVAEConfig
from infinicube_tpu_torch.weights.from_jax import dit_from_jax, vae_from_jax
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.test_torch_sparse_vae import random_params

# tests/test_wan.py's tiny towers (:11-20, the train test at :191), f32
DIT = dict(dim=64, ffn_dim=128, num_layers=2, num_heads=4, in_channels=4,
           out_channels=4, text_dim=32, freq_dim=32, buffer_channels=8)
VAE = dict(latent_channels=4, base_channels=8, channel_mult=(1, 1, 2, 2),
           num_res_blocks=1)
PIPE = dict(num_frames=5, height=16, width=16)
TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.fixture(scope="module")
def gens():
    """The JAX generator with random DiT parameters (every layer filled,
    the zero-init head and buffer embedder too, so every gradient shows)
    and the port's generator on the same DiT weights."""
    jgen = JaxGen(JaxCfg(dit=JaxDiTCfg(**DIT, dtype=jnp.float32),
                         vae=JaxVAECfg(**VAE, dtype=jnp.float32),
                         t5=JaxT5Cfg.tiny(d_model=32, dtype=jnp.float32),
                         **PIPE))
    shapes = jax.eval_shape(jgen.dit.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, 8, 8, 4)), jnp.zeros((1,)),
                            jnp.zeros((1, 6, 32)), jnp.zeros((1, 3, 8, 8, 8)))
    params = {"dit": random_params(flax.linen.meta.unbox(shapes), 3)}
    tgen = WanVideoGenerator(WanPipelineConfig(
        dit=WanDiTConfig(**DIT, dtype=torch.float32),
        vae=VideoVAEConfig(**VAE, dtype=torch.float32),
        t5=T5Config.tiny(d_model=32, dtype=torch.float32), **PIPE),
        device="cpu")
    tgen.dit.load_state_dict(dit_from_jax(params["dit"]))
    return jgen, params, tgen


def _batch(seed=0):
    """tests/test_wan.py:191's shapes: latents, buffers and text, batch 2."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 3, 8, 8, 4)).astype(np.float32),
            rng.standard_normal((2, 6, 32)).astype(np.float32),
            rng.standard_normal((2, 3, 8, 8, 8)).astype(np.float32))


def _jax_draws(rng, shape, prob):
    """What the JAX ``train_loss`` draws from ``rng`` (pipeline.py:299-305):
    u, the noise and the text-drop mask."""
    r_s, r_n, r_d = jax.random.split(rng, 3)
    B = shape[0]
    return (np.asarray(jax.random.uniform(r_s, (B,))),
            np.asarray(jax.random.normal(r_n, shape)),
            np.asarray(jax.random.uniform(r_d, (B,)) < prob))


@pytest.mark.parametrize("prob,seed", [(0.1, 4), (0.0, 5), (1.0, 6),
                                       (0.5, 8)])
def test_train_loss_and_gradients_match_jax(gens, prob, seed):
    jgen, params, tgen = gens
    lat, txt, buf = _batch(seed)
    rng = jax.random.PRNGKey(seed)

    def loss_fn(p):
        return jgen.train_loss(p, rng, jnp.asarray(lat), jnp.asarray(txt),
                               jnp.asarray(buf), text_drop_prob=prob)

    (ref_loss, ref_aux), ref_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    u, noise, drop = _jax_draws(rng, lat.shape, prob)
    if prob in (0.0, 1.0):
        assert drop.all() == (prob == 1.0) and drop.any() == (prob == 1.0)
    if prob == 0.5:
        assert drop.any() and not drop.all()    # one row of each

    tgen.dit.requires_grad_(True)
    try:
        for p in tgen.dit.parameters():
            p.grad = None
        loss, aux = tgen.train_loss(
            torch.from_numpy(lat), torch.from_numpy(txt),
            torch.from_numpy(buf), text_drop_prob=prob,
            u=torch.from_numpy(u.copy()),
            noise=torch.from_numpy(noise.copy()),
            drop=torch.from_numpy(drop.copy()))
        loss.backward()
    finally:
        tgen.dit.requires_grad_(False)
    assert aux["fm_mse"] is loss
    assert abs(loss.item() - float(ref_loss)) <= 2e-3 * abs(float(ref_loss))
    ref = dit_from_jax(jax.tree.map(np.asarray, ref_grads["dit"]))
    grads = {k: p.grad for k, p in tgen.dit.named_parameters()}
    assert set(ref) == set(grads)
    # each gradient within 2e-3 of its largest reference value; one that is
    # exactly zero (cross-attention's q where every text is dropped: equal
    # keys make the softmax flat) is rounding noise on both sides, held to
    # the same limit with a floor of 1e-3 of the largest gradient
    top = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    for k, g in ref.items():
        got = grads[k].numpy()
        lim = 2e-3 * max(float(np.abs(g.numpy()).max()), 1e-3 * top)
        assert np.abs(got - g.numpy()).max() <= lim, k
    if prob == 1.0:     # the text never reaches the DiT
        assert float(np.abs(ref["text_proj_in.weight"].numpy()).max()) == 0
        assert float(grads["text_proj_in.weight"].abs().max()) == 0


def test_train_loss_draws_from_generator(gens):
    """Without injected draws the loss draws u, the noise and the drop mask
    from the generator in that order: the same seed gives the same loss."""
    _, _, tgen = gens
    lat, txt, buf = (torch.from_numpy(a) for a in _batch(1))
    losses = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        with torch.no_grad():
            losses.append(tgen.train_loss(lat, txt, buf, generator=g)[0])
    g = torch.Generator().manual_seed(7)
    u = torch.rand((2,), generator=g)
    noise = torch.randn(lat.shape, generator=g)
    drop = torch.rand((2,), generator=g) < 0.1
    with torch.no_grad():
        injected = tgen.train_loss(lat, txt, buf, u=u, noise=noise,
                                   drop=drop)[0]
    assert losses[0].item() == losses[1].item() == injected.item()


def test_flow_match_helpers_match_jax():
    js, ts = JaxSchedule(shift=3.0), FlowMatchSchedule(shift=3.0)
    np.testing.assert_allclose(ts.timesteps(7).numpy(),
                               np.asarray(js.timesteps(7)), rtol=1e-6)
    rng = np.random.default_rng(2)
    x0, n = (rng.standard_normal((3, 2, 4, 5)).astype(np.float32)
             for _ in range(2))
    sig = np.asarray([0.0, 0.3, 1.0], np.float32)
    np.testing.assert_allclose(
        ts.add_noise(torch.from_numpy(x0), torch.from_numpy(n),
                     torch.from_numpy(sig)).numpy(),
        np.asarray(js.add_noise(jnp.asarray(x0), jnp.asarray(n),
                                jnp.asarray(sig))), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        ts.velocity_target(torch.from_numpy(x0), torch.from_numpy(n)).numpy(),
        np.asarray(js.velocity_target(jnp.asarray(x0), jnp.asarray(n))))


def test_reparameterized_encode_matches_jax():
    """``encode`` with injected noise (the JAX side's draw from its key):
    logvar clipped, mu + exp(logvar / 2) * noise, then normalized."""
    stats = dict(latent_mean=(0.1, -0.2, 0.3, 0.0),
                 latent_std=(1.5, 0.5, 2.0, 1.0))
    cfg = dict(latent_channels=4, base_channels=8, channel_mult=(1, 2),
               num_res_blocks=1)
    vae = JaxVAE(JaxVAECfg(**cfg, **stats, dtype=jnp.float32))
    vid = np.random.default_rng(3).uniform(-1, 1, (1, 5, 16, 16, 3)).astype(
        np.float32)
    shapes = jax.eval_shape(vae.init, jax.random.PRNGKey(0),
                            jnp.asarray(vid))
    params = random_params(flax.linen.meta.unbox(shapes), 4)
    rng = jax.random.PRNGKey(11)
    ref = np.asarray(vae.apply(params, jnp.asarray(vid), rng,
                               method=JaxVAE.encode))
    mean = np.asarray(vae.apply(params, jnp.asarray(vid),
                                method=JaxVAE.encode))
    noise = np.asarray(jax.random.normal(rng, ref.shape))
    port = VideoVAE(VideoVAEConfig(**cfg, **stats, dtype=torch.float32),
                    device="cpu")
    port.load_state_dict(vae_from_jax(params))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(vid),
                          noise=torch.from_numpy(noise))
        got_mean = port.encode(torch.from_numpy(vid))
        g = torch.Generator().manual_seed(0)
        sampled = port.encode(torch.from_numpy(vid), generator=g)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(got_mean.numpy(), mean, **TOL)
    assert np.abs(ref - mean).max() > 1e-2          # the sample moved mu
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        again = port.encode(torch.from_numpy(vid),
                            noise=torch.randn(ref.shape, generator=g))
    assert torch.equal(sampled, again)


@pytest.mark.parametrize("flags", [dict(attn_quant="qk"),
                                   dict(quant_linear=True)])
def test_int8_dit_refuses_a_gradient(flags):
    cfg = WanDiTConfig(**DIT, dtype=torch.float32, **flags)
    dit = WanDiT(cfg, device="cpu")
    args = (torch.zeros((1, 1, 4, 4, 4)), torch.zeros(1),
            torch.zeros((1, 3, 32)), None)
    with pytest.raises(ValueError, match="serves only"):
        dit(*args)
    with torch.no_grad():
        assert dit(*args).shape == (1, 1, 4, 4, 4)
    dit.requires_grad_(False)
    assert dit(*args).shape == (1, 1, 4, 4, 4)
