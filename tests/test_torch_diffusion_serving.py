"""Port parity: the int8 serving twin of the voxel UNet
(``DiffusionConfig.serve_quant``) against the JAX ``unet_serve``, with JAX
parameters carried across by ``weights/from_jax.unet_from_jax``. On the CPU
the JAX model's twin would take XLA's conv (no int8), so the test gives it a
local clone with the Pallas convs in interpret mode, as tests/test_quant.py
runs them."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.diffusion import model as jmodel
from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.models.diffusion.model import (CondCubes,
                                                         DiffusionConfig,
                                                         VoxelDiffusion)
from infinicube_tpu_torch.ops import dense_conv
from infinicube_tpu_torch.weights.from_jax import unet_from_jax
from tests.test_torch_sparse_vae import random_params
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

# two levels, 64 channels: the level-0 convs (4 x 8 x 32 cube) are int8,
# in_conv (C = 16) and the level-1 convs (2 x 4 x 16) stay full precision
SMALL = dict(cube_dims=(4, 8, 32), cube_ijk_min=(-2, -4, -16),
             model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
             attention_ds=(2,), num_heads=4, transformer_depth=1,
             serve_quant=True)


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def both():
    jd = jmodel.VoxelDiffusion(jmodel.DiffusionConfig(**SMALL,
                                                      dtype=jnp.float32))
    jd.unet_serve = jd.unet.clone(conv_quant=True, conv_impl="pallas")
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0))
    params = random_params(flax.linen.meta.unbox(shapes), 6)
    td = VoxelDiffusion(DiffusionConfig(**SMALL, dtype=torch.float32),
                        device="cpu")
    td.load_params(unet_from_jax(params))                 # strict
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, *SMALL["cube_dims"], 8)).astype(np.float32)
    mc = (rng.random((2, *SMALL["cube_dims"], 3)) < 0.1).astype(np.float32)
    bc = rng.standard_normal((2, *SMALL["cube_dims"], 2)).astype(np.float32)
    t = np.array([420, 420], np.int32)
    jc = jmodel.CondCubes(jnp.asarray(mc), jnp.asarray(bc))
    tc = CondCubes(torch.from_numpy(mc), torch.from_numpy(bc))
    return jd, jax.tree.map(jnp.asarray, params), td, (x, t, jc, tc)


def test_serving_twin_carries_jax_weights(both):
    """Weights carried across by unet_from_jax drive the twin: int8 output
    within the cosine gate of JAX's twin (the int8 inputs are equal, the f32
    dequantized sums differ in their last bits), and the full-precision
    UNet within the f32 tolerance."""
    jd, params, td, (x, t, jc, tc) = both
    calls = []
    real = dense_conv.quantize_for_conv

    def counted(x_, w_):
        calls.append((tuple(x_.shape), w_.shape[0]))
        return real(x_, w_)
    dense_conv.quantize_for_conv = counted
    try:
        with torch.no_grad():
            out = td.denoise(torch.from_numpy(x), torch.from_numpy(t), tc,
                             serve=True).numpy()
    finally:
        dense_conv.quantize_for_conv = real
    ref = np.asarray(jd.denoise(params, jnp.asarray(x), jnp.asarray(t), jc,
                                serve=True))
    assert np.abs(ref).max() > 0.1
    assert _cos(out, ref) >= 0.9999
    # the level-0 convs and up1 are int8: 2 + 2 x 2 ResBlock convs + up1
    assert len(calls) == 7 and all(s[1:4] == (4, 8, 32) for s, _ in calls)
    with torch.no_grad():
        full = td.denoise(torch.from_numpy(x), torch.from_numpy(t),
                          tc).numpy()
    np.testing.assert_allclose(
        full, np.asarray(jd.denoise(params, jnp.asarray(x), jnp.asarray(t),
                                    jc)), atol=2e-3, rtol=2e-3)
    assert 0.999 <= _cos(out, full) < 1.0
    assert all(v == 0 for v in kernels.launches.values())


def test_serving_twin_shares_the_parameters(both):
    _, _, td, _ = both
    twin, unet = td.unet_serve, td.unet
    assert twin is not unet and twin.conv_quant and not unet.conv_quant
    pt, pu = dict(twin.named_parameters()), dict(unet.named_parameters())
    assert pt.keys() == pu.keys()
    assert all(pt[k] is pu[k] for k in pt)
    assert all(m.quant for m in twin.modules()
               if isinstance(m, dense_conv.Conv3x3x3))
    assert not any(m.quant for m in unet.modules()
                   if isinstance(m, dense_conv.Conv3x3x3))
    plain = VoxelDiffusion(dataclasses.replace(td.cfg, serve_quant=False),
                           device="cpu")
    assert plain.unet_serve is plain.unet


def test_train_loss_keeps_full_precision(both, monkeypatch):
    """train_loss runs the UNet itself, never the int8 twin."""
    _, _, td, (x, _, _, tc) = both

    def refuse(*a):
        raise AssertionError("int8 conv in train_loss")
    monkeypatch.setattr(dense_conv, "quantize_for_conv", refuse)
    loss, _ = td.train_loss(torch.from_numpy(x), tc,
                            generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
