"""Port parity: ``infinicube_tpu_torch.models.diffusion.unet3d`` against the
JAX ``UNet3D`` on the same weights (carried across by
``weights/from_jax.unet_from_jax``, loaded strictly) and inputs."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.diffusion.unet3d import UNet3D as JaxUNet
from infinicube_tpu_torch.models.diffusion.unet3d import UNet3D
from infinicube_tpu_torch.weights.from_jax import unet_from_jax

# a small UNet with both kinds of attention: SelfAttention3D at ds 2 and a
# scanned 2-block middle transformer
SMALL = dict(out_channels=8, model_channels=32, channel_mult=(1, 2),
             num_res_blocks=2, attention_ds=(2,), num_heads=4,
             transformer_depth=2)
# f32 on both sides, differing only in summation order
TOL = dict(atol=2e-3, rtol=2e-3)


def filled_params(module, *inputs, seed=0, scale=0.05):
    """JAX init with every leaf perturbed by small random values, so the
    zero-initialised layers (conv2, proj, proj_out, out_conv) carry weight
    and every path shows in the output."""
    p = module.init(jax.random.PRNGKey(seed), *inputs)
    p = jax.tree.map(np.asarray, flax.linen.meta.unbox(p))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + scale * rng.standard_normal(a.shape)).astype(a.dtype),
        p)


@pytest.mark.parametrize("cube", [(8, 8, 8), (6, 8, 4)])
def test_unet_f32_matches_jax(cube):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, *cube, 16)).astype(np.float32)
    t = np.array([430], np.int32)
    jnet = JaxUNet(**SMALL, dtype=jnp.float32)
    params = filled_params(jnet, jnp.asarray(x), jnp.asarray(t))
    ref = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(t)))
    net = UNet3D(in_channels=16, **SMALL, dtype=torch.float32)
    net.load_state_dict(unet_from_jax(params))          # strict
    with torch.no_grad():
        out = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert out.shape == ref.shape == (1, *cube, 8)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, **TOL)
