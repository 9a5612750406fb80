"""Port parity: ``infinicube_tpu_torch.models.wan.vae3d`` against the JAX
``VideoVAE`` on the same weights: full-clip encode and decode, and the tiled
serving paths with at least two tiles per axis."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.wan.vae3d import VideoVAE as JaxVAE
from infinicube_tpu.models.wan.vae3d import VideoVAEConfig as JaxCfg
from infinicube_tpu.models.wan.vae3d import decode_tiled_host as jax_dec_tiled
from infinicube_tpu.models.wan.vae3d import encode_tiled_host as jax_enc_tiled
from infinicube_tpu_torch.models.wan.vae3d import (VideoVAE, VideoVAEConfig,
                                                   decode_tiled_host,
                                                   encode_tiled_host)
from infinicube_tpu_torch.weights.from_jax import vae_from_jax
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

TINY = dict(latent_channels=4, base_channels=8, channel_mult=(1, 2),
            num_res_blocks=1)
# f32 on both sides, differing only in summation order
TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.fixture(scope="module")
def pair():
    """(JAX module, JAX params, port module) on one set of random weights;
    the latent stats are set so the normalization runs too."""
    stats = dict(latent_mean=(0.1, -0.2, 0.3, 0.0),
                 latent_std=(1.5, 0.5, 2.0, 1.0))
    jcfg = JaxCfg(**TINY, **stats, dtype=jnp.float32)
    vae = JaxVAE(jcfg)
    params = vae.init(jax.random.PRNGKey(0), jnp.zeros((1, 5, 16, 16, 3)))
    params = jax.tree.map(np.asarray, flax.linen.meta.unbox(params))
    port = VideoVAE(VideoVAEConfig(**TINY, **stats, dtype=torch.float32),
                    device="cpu")
    port.load_state_dict(vae_from_jax(params))
    return vae, params, port


def _video(h, w, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (1, 5, h, w, 3)).astype(np.float32)


def test_encode_decode_match_jax(pair):
    vae, params, port = pair
    vid = _video(16, 24)
    z_ref = np.asarray(vae.apply(params, jnp.asarray(vid),
                                 method=JaxVAE.encode))
    dec_ref = np.asarray(vae.apply(params, jnp.asarray(z_ref),
                                   method=JaxVAE.decode))
    with torch.no_grad():
        z = port.encode(torch.from_numpy(vid))
        dec = port.decode(torch.from_numpy(z_ref))
    assert z.shape == z_ref.shape == (1, 5, 8, 12, 4)
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    assert dec.shape == dec_ref.shape == (1, 5, 16, 24, 3)
    np.testing.assert_allclose(dec.numpy(), dec_ref, **TOL)


def test_tiled_encode_decode_match_jax(pair):
    vae, params, port = pair
    vid = _video(32, 48, seed=1)
    # 16-px tiles with 4-px overlap: 3 x 4 tiles; 8-latent tiles: 3 x 5
    z_ref = np.asarray(jax_enc_tiled(vae, params, jnp.asarray(vid),
                                     tile=(16, 16), overlap=4))
    z = encode_tiled_host(port, torch.from_numpy(vid), tile=(16, 16),
                          overlap=4)
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    dec_ref = jax_dec_tiled(vae, params, jnp.asarray(z_ref), tile=(8, 8),
                            overlap=2)
    dec = decode_tiled_host(port, torch.from_numpy(z_ref), tile=(8, 8),
                            overlap=2)
    assert dec.shape == dec_ref.shape == (1, 5, 32, 48, 3)
    np.testing.assert_allclose(dec, dec_ref, **TOL)
    u8_ref = jax_dec_tiled(vae, params, jnp.asarray(z_ref), tile=(8, 8),
                           overlap=2, to_uint8=True)
    u8 = decode_tiled_host(port, torch.from_numpy(z_ref), tile=(8, 8),
                           overlap=2, to_uint8=True)
    assert u8.dtype == np.uint8
    assert np.abs(u8.astype(int) - u8_ref.astype(int)).max() <= 1


def test_temporal_resampling_matches_jax():
    """A config with 3D down/upsampling (frame pairing and first-frame
    passthrough), encode + decode."""
    cfg = dict(latent_channels=4, base_channels=8, channel_mult=(1, 2, 2),
               num_res_blocks=1, temporal_down=(False, True))
    vae = JaxVAE(JaxCfg(**cfg, dtype=jnp.float32))
    vid = _video(16, 16, seed=2)
    params = vae.init(jax.random.PRNGKey(1), jnp.asarray(vid))
    params = jax.tree.map(np.asarray, flax.linen.meta.unbox(params))
    out_ref = np.asarray(vae.apply(params, jnp.asarray(vid)))
    port = VideoVAE(VideoVAEConfig(**cfg, dtype=torch.float32), device="cpu")
    port.load_state_dict(vae_from_jax(params))
    with torch.no_grad():
        out = port(torch.from_numpy(vid))
    assert out.shape == out_ref.shape == (1, 5, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), out_ref, **TOL)


def test_one_frame_encodes_and_decodes_as_jax():
    """A clip of one frame (an image): the temporal downsamplings have no
    whole window, so they pass the first frame alone, as the JAX VAE's VALID
    convolutions do."""
    tiny = dict(latent_channels=4, base_channels=4, channel_mult=(1, 1, 1, 1),
                num_res_blocks=1)
    vae = JaxVAE(JaxCfg(**tiny, dtype=jnp.float32))
    params = vae.init(jax.random.PRNGKey(1), jnp.zeros((1, 5, 16, 16, 3)))
    params = jax.tree.map(np.asarray, flax.linen.meta.unbox(params))
    port = VideoVAE(VideoVAEConfig(**tiny, dtype=torch.float32),
                    device="cpu")
    port.load_state_dict(vae_from_jax(params))
    vid = np.random.default_rng(2).uniform(
        -1, 1, (1, 1, 16, 24, 3)).astype(np.float32)
    z_ref = np.asarray(vae.apply(params, jnp.asarray(vid),
                                 method=JaxVAE.encode))
    dec_ref = np.asarray(vae.apply(params, jnp.asarray(z_ref),
                                   method=JaxVAE.decode))
    with torch.no_grad():
        z = port.encode(torch.from_numpy(vid))
        dec = port.decode(torch.from_numpy(z_ref))
    assert z.shape == z_ref.shape == (1, 1, 2, 3, 4)
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    assert dec.shape == dec_ref.shape == (1, 1, 16, 24, 3)
    np.testing.assert_allclose(dec.numpy(), dec_ref, **TOL)
