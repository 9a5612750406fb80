"""Port parity of the Wan VAE's streaming decode (the Wan2.1 feature
cache): ``decode_streaming_host`` against the JAX package's and against the
port's own whole-clip decode at chunks of 1, 2 and 3 latent frames with a
ragged tail, on ``tests/test_wan.py``'s tiny VAE and on a VAE whose
ResidualBlock convs take the routed conv (``conv_impl="auto"``); and
``decode_step``'s cache against the reference's, key by key."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.wan.vae3d import VideoVAE as JaxVAE
from infinicube_tpu.models.wan.vae3d import VideoVAEConfig as JaxCfg
from infinicube_tpu.models.wan.vae3d import \
    decode_streaming_host as jax_streaming
from infinicube_tpu_torch.models.wan.vae3d import (VideoVAE, VideoVAEConfig,
                                                   decode_streaming_host)
from infinicube_tpu_torch.weights.from_jax import vae_from_jax
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.test_torch_sparse_vae import random_params

# tests/test_wan.py's tiny_vae(), and a VAE whose res-block convs route
TINY = dict(latent_channels=4, base_channels=8, channel_mult=(1, 1, 2, 2),
            num_res_blocks=1)
ROUTED = dict(latent_channels=4, base_channels=64, channel_mult=(1, 2),
              num_res_blocks=1, temporal_down=(True,))
# tests/test_wan.py's tolerances for the streamed against the whole-clip
# decode and for the routed against the XLA conv
TOL = dict(atol=2e-5, rtol=2e-5)


def _pair(cfg, impl="xla", seed=0):
    vae = JaxVAE(JaxCfg(**cfg, dtype=jnp.float32, conv_impl=impl))
    scale = 2 ** (len(cfg["channel_mult"]) - 1)
    shapes = jax.eval_shape(vae.init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 5, 2 * scale, 2 * scale, 3)))
    params = random_params(flax.linen.meta.unbox(shapes), seed)
    port = VideoVAE(VideoVAEConfig(**cfg, dtype=torch.float32,
                                   conv_impl=impl), device="cpu")
    port.load_state_dict(vae_from_jax(params))
    return vae, params, port


@pytest.fixture(scope="module", params=[
    ("tiny", TINY, "xla", (1, 7, 4, 4, 4)),
    ("routed", ROUTED, "auto", (1, 5, 4, 6, 4))], ids=lambda p: p[0])
def case(request):
    _, cfg, impl, zshape = request.param
    vae, params, port = _pair(cfg, impl)
    z = np.random.default_rng(1).standard_normal(zshape).astype(np.float32)
    whole = np.asarray(jax.jit(lambda p, x: vae.apply(
        p, x, method=JaxVAE.decode))(params, jnp.asarray(z)))
    # the frames are clipped to [-1, 1]: most must lie inside
    assert (np.abs(whole) < 1).mean() > 0.5
    return vae, params, port, z, whole


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_streaming_decode_matches_jax_and_whole_clip(case, chunk):
    vae, params, port, z, whole = case
    ref = jax_streaming(vae, params, jnp.asarray(z), chunk=chunk)
    got = decode_streaming_host(port, torch.from_numpy(z), chunk=chunk)
    with torch.no_grad():
        mine = port.decode(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == whole.shape == mine.shape
    np.testing.assert_allclose(got, mine, **TOL, err_msg=f"{chunk}")
    np.testing.assert_allclose(got, ref, **TOL, err_msg=f"{chunk}")
    np.testing.assert_allclose(got, whole, **TOL, err_msg=f"{chunk}")


def _shapes(cache):
    """{key path: shape} of a nested cache."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": s for kk, s in _shapes(v).items()})
        else:
            out[k] = tuple(v.shape)
    return out


def test_decode_step_cache_matches_reference(case):
    """Two chunks: the frames of each and the cache after each, key by key
    and value by value (the contexts [B, 2, H, W, C], the reference's
    layout)."""
    vae, params, port, z, _ = case
    step = jax.jit(lambda p, zc, c: vae.apply(p, zc, c,
                                              method=JaxVAE.decode_step))
    cache_ref, cache = None, None
    for t0, t1 in ((0, 1), (1, 3)):
        out_ref, cache_ref = step(params, jnp.asarray(z[:, t0:t1]),
                                  cache_ref)
        with torch.no_grad():
            out, cache = port.decode_step(torch.from_numpy(z[:, t0:t1]),
                                          cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(out_ref),
                                   **TOL)
        ref_shapes = _shapes(jax.tree.map(np.asarray, cache_ref))
        assert _shapes(cache) == ref_shapes
        flat = jax.tree_util.tree_flatten_with_path(cache_ref)[0]
        for path, leaf in flat:
            v = cache
            for p in path:
                v = v[p.key]
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), np.asarray(leaf),
                                       **TOL)
