"""Port parity of the Wan VAE's ``conv_impl`` route: the routed causal conv
(``vae3d.RoutedCausalConv3d``, the plain version of K3 / ``conv3x3x3_f32``
here) against the JAX package's ``causal_conv3d`` on its Pallas route, the
routed VAE against the JAX VAE on both of its routes, one parameter tree on
both port routes, and the routed set of convs against the reference's rule.

On the CPU the reference's ``conv_impl="auto"`` takes the routed arithmetic
without interpret mode (``Conv3x3x3`` falls back to ``_xla_conv``): the
weight and bias rounded to the VAE's dtype, f32 sums and bias, one rounding.
Its Pallas kernel runs in interpret mode only at ``tests/test_wan.py``'s
shape (1, 3, 8, 16, 64) f32."""

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.wan import vae3d as jvae3d
from infinicube_tpu.models.wan.vae3d import VideoVAE as JaxVAE
from infinicube_tpu.models.wan.vae3d import VideoVAEConfig as JaxCfg
from infinicube_tpu_torch.models.wan import vae3d
from infinicube_tpu_torch.models.wan.vae3d import (RoutedCausalConv3d,
                                                   VideoVAE, VideoVAEConfig)
from infinicube_tpu_torch.ops import dense_conv
from infinicube_tpu_torch.weights.from_jax import vae_from_jax
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.test_torch_sparse_conv_bf16 import hold_ulp

# every ResidualBlock conv routes: base 64, widths 64 and 128
ROUTED = dict(latent_channels=4, base_channels=64, channel_mult=(1, 2),
              num_res_blocks=1)
# f32 on both sides, differing only in summation order
TOL = dict(atol=2e-3, rtol=2e-3)


class _Conv(fnn.Module):
    """The reference's causal conv under a parent, as tests/test_wan.py
    builds it."""
    impl: str
    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x, tctx=None):
        return jvae3d.causal_conv3d(x, 64, "c", impl=self.impl, tctx=tctx,
                                    dtype=self.dtype)


def _port_conv(params, dtype):
    """The port's routed conv on the flax conv's parameters."""
    conv = RoutedCausalConv3d(64, 64, dtype=dtype, device="cpu")
    conv.load_state_dict(vae_from_jax(params["params"]["c"]))
    return conv


def _cf(a):
    """NDHWC numpy -> channels-first torch."""
    return torch.from_numpy(np.array(a)).permute(0, 4, 1, 2, 3)


def _conv_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 3, 8, 16, 64)).astype(np.float32)
    tctx = rng.standard_normal((1, 2, 8, 16, 64)).astype(np.float32)
    return x, tctx


def test_routed_conv_matches_pallas_route():
    """Zero history and the streaming ``tctx`` case, f32, against the
    reference's Pallas route (interpret mode, tests/test_wan.py's shape)."""
    x, tctx = _conv_inputs()
    params = _Conv("xla").init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, flax.linen.meta.unbox(params))
    conv = _port_conv(params, torch.float32)
    for ctx in (None, tctx):
        jargs = (jnp.asarray(x),) + (() if ctx is None else
                                     (jnp.asarray(ctx),))
        ref = np.asarray(_Conv("pallas").apply(params, *jargs))
        with torch.no_grad():
            got = conv(_cf(x), None if ctx is None else torch.from_numpy(ctx))
        got = got.permute(0, 2, 3, 4, 1).numpy()
        assert got.shape == ref.shape == (1, 3, 8, 16, 64)
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("history", [False, True])
def test_routed_conv_bf16_matches_auto_route(history):
    """bf16: the reference's "auto" route on the CPU (``_xla_conv``: f32
    sums, f32 bias, one rounding) within one bf16 ulp per element."""
    x, tctx = _conv_inputs(1)
    params = _Conv("auto", jnp.bfloat16).init(jax.random.PRNGKey(1),
                                              jnp.asarray(x))
    params = jax.tree.map(np.asarray, flax.linen.meta.unbox(params))
    params["params"]["c"]["bias"] = np.random.default_rng(2).standard_normal(
        64).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    cb = jnp.asarray(tctx, jnp.bfloat16) if history else None
    ref = _Conv("auto", jnp.bfloat16).apply(
        params, xb, *(() if cb is None else (cb,)))
    assert ref.dtype == jnp.bfloat16
    conv = _port_conv(params, torch.bfloat16)
    with torch.no_grad():
        got = conv(_cf(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
                   None if cb is None else torch.from_numpy(
                       np.asarray(cb.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    hold_ulp(got.permute(0, 2, 3, 4, 1).float(),
             np.asarray(ref.astype(jnp.float32)))


@pytest.fixture(scope="module")
def routed_pair():
    """The JAX VAE's parameters (f32, latent stats set) and the port's VAE
    on each route, all from one JAX init."""
    stats = dict(latent_mean=(0.1, -0.2, 0.3, 0.0),
                 latent_std=(1.5, 0.5, 2.0, 1.0))
    params = JaxVAE(JaxCfg(**ROUTED, **stats, dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5, 16, 16, 3)))
    params = jax.tree.map(np.asarray, flax.linen.meta.unbox(params))
    ports = {}
    for impl in ("xla", "auto"):
        port = VideoVAE(VideoVAEConfig(**ROUTED, **stats, dtype=torch.float32,
                                       conv_impl=impl), device="cpu")
        port.load_state_dict(vae_from_jax(params))
        ports[impl] = port
    return stats, params, ports


def _video(seed=0, h=16, w=24):
    return np.random.default_rng(seed).uniform(
        -1, 1, (1, 5, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("jax_impl", ["auto", "xla"])
def test_routed_vae_matches_jax(routed_pair, jax_impl):
    """The port's routed f32 VAE against the JAX VAE on its "auto" and
    "xla" routes: encode and decode."""
    stats, params, ports = routed_pair
    vae = JaxVAE(JaxCfg(**ROUTED, **stats, dtype=jnp.float32,
                        conv_impl=jax_impl))
    vid = _video()
    z_ref = np.asarray(vae.apply(params, jnp.asarray(vid),
                                 method=JaxVAE.encode))
    dec_ref = np.asarray(vae.apply(params, jnp.asarray(z_ref),
                                   method=JaxVAE.decode))
    with torch.no_grad():
        z = ports["auto"].encode(torch.from_numpy(vid))
        dec = ports["auto"].decode(torch.from_numpy(z_ref.copy()))
    assert z.shape == z_ref.shape == (1, 5, 8, 12, 4)
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    assert dec.shape == dec_ref.shape == (1, 5, 16, 24, 3)
    np.testing.assert_allclose(dec.numpy(), dec_ref, **TOL)


def test_one_tree_drives_both_port_routes(routed_pair):
    """One JAX parameter tree loads into the port's VAE on both routes
    (the same keys and shapes), and the two give equal outputs."""
    _, params, ports = routed_pair
    sd = {k: v.shape for k, v in ports["xla"].state_dict().items()}
    assert sd == {k: v.shape for k, v in ports["auto"].state_dict().items()}
    assert set(sd) == set(vae_from_jax(params))
    vid = torch.from_numpy(_video(1))
    with torch.no_grad():
        out = {impl: p(vid) for impl, p in ports.items()}
    assert out["auto"].shape == (1, 5, 16, 24, 3)
    np.testing.assert_allclose(out["auto"].numpy(), out["xla"].numpy(),
                               atol=2e-5, rtol=2e-5)


def _reference_routed(cfg: JaxCfg, video, z, monkeypatch):
    """The flax paths of the convs the reference routes, recorded at each
    call of its ``Conv3x3x3`` under ``conv_impl="auto"`` (traced only: the
    calls are recorded at trace time)."""
    seen = []

    class Recording(jvae3d.Conv3x3x3):
        def __call__(self, x):
            seen.append("/".join(self.scope.path))
            return super().__call__(x)

    monkeypatch.setattr(jvae3d, "Conv3x3x3", Recording)
    vae = JaxVAE(cfg)
    params = jax.eval_shape(vae.init, jax.random.PRNGKey(0), video)
    out = []
    for x, method in ((video, JaxVAE.encode), (z, JaxVAE.decode)):
        seen.clear()
        jax.eval_shape(lambda p: vae.apply(p, x, method=method), params)
        out.append(list(seen))
    monkeypatch.undo()
    return out


def _port_path(name):
    """'encoder.downsamples.0.residual_2' -> the flax path."""
    parts = name.split(".")
    out = []
    for p in parts:
        if p.isdigit():
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    return "/".join(out)


@pytest.mark.parametrize("cfg", [
    dict(ROUTED),
    # widths 32 and 64: the 32-wide convs, and the 32 -> 64 one, stay on
    # F.conv3d
    dict(latent_channels=4, base_channels=32, channel_mult=(1, 2),
         num_res_blocks=1),
])
def test_routed_set_matches_reference(cfg, monkeypatch):
    """The port routes exactly the convs the reference's rule routes:
    the reference's set recorded at its ``Conv3x3x3`` calls, the port's
    by its modules and counted through the plain route's calls (one a
    routed conv)."""
    jcfg = JaxCfg(**cfg, dtype=jnp.float32, conv_impl="auto")
    vid = jnp.zeros((1, 5, 16, 16, 3))
    s = jcfg.spatial_scale
    z = jnp.zeros((1, 1 + 4 // jcfg.temporal_scale, 16 // s, 16 // s, 4))
    enc, dec = _reference_routed(jcfg, vid, z, monkeypatch)
    port = VideoVAE(VideoVAEConfig(**cfg, dtype=torch.float32,
                                   conv_impl="auto"), device="cpu")
    routed = [_port_path(n) for n, m in port.named_modules()
              if isinstance(m, RoutedCausalConv3d)]
    assert sorted(routed) == sorted(enc + dec)
    for n, m in port.named_modules():
        if isinstance(m, vae3d.CausalConv3d):
            cout, cin = m.weight.shape[:2]
            assert not vae3d.routes("auto", m.weight.shape[2:], cin, cout), n
    calls = []
    plain = dense_conv.conv3x3x3_plain
    monkeypatch.setattr(dense_conv, "conv3x3x3_plain",
                        lambda *a: calls.append(1) or plain(*a))
    port.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        port.encode(torch.from_numpy(np.asarray(vid)))
        assert len(calls) == len(enc)
        port.decode(torch.from_numpy(np.asarray(z)))
    assert len(calls) == len(enc) + len(dec)


def test_unknown_conv_impl_raises():
    with pytest.raises(ValueError, match="conv_impl"):
        VideoVAEConfig(conv_impl="cudnn")
