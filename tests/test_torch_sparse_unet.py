"""Port parity: ``infinicube_tpu_torch.models.diffusion.unet_sparse.
SparseUNet`` against the JAX ``SparseUNet`` at the sizes of
``tests/test_alt_encoders.py``'s test (two levels of a 256-slot grid pair,
8 channels, attention at level 1 with 2 heads), without and with a
cross-attention context, on the same parameters
(``weights/from_jax.sparse_unet_from_jax``, strict) and inputs; and its
gradients with the context. f32 on both sides, differing only in summation
order: ROADMAP's atol/rtol 2e-3."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.grid import coarsened_grid as j_coarsened_grid
from infinicube_tpu.grid import grid_from_points as j_grid_from_points
from infinicube_tpu.models.diffusion import unet_sparse as jus
from infinicube_tpu_torch.grid.build import coarsened_grid, grid_from_points
from infinicube_tpu_torch.models.diffusion.unet_sparse import (
    SparseUNet, SparseUNetConfig)
from infinicube_tpu_torch.weights.from_jax import sparse_unet_from_jax
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.test_torch_sparse_vae import random_params

TOL = dict(atol=2e-3, rtol=2e-3)
KW = dict(out_channels=4, model_channels=8, channel_mult=(1, 2),
          num_res_blocks=1, attend_levels=(1,), num_heads=2)


def scene():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, (2, 150, 3)).astype(np.float32)
    mask = np.ones((2, 150), bool)
    mask[1, 60:] = False                 # unequal fills
    x = rng.normal(size=(2, 256, 4)).astype(np.float32)
    t = np.array([10, 500])
    ctx = rng.normal(size=(2, 7, 16)).astype(np.float32)
    return pts, mask, x, t, ctx


def grids_both(pts, mask):
    jg0 = j_grid_from_points(jnp.asarray(pts), jnp.asarray(mask), 0.5, 0.25,
                             capacity=256)
    tg0 = grid_from_points(torch.from_numpy(pts), torch.from_numpy(mask),
                           0.5, 0.25, capacity=256)
    return ([jg0, j_coarsened_grid(jg0, (2, 2, 2), capacity=128)],
            [tg0, coarsened_grid(tg0, (2, 2, 2), capacity=128)])


@pytest.mark.parametrize("with_context", [False, True])
def test_sparse_unet_matches_jax(with_context):
    pts, mask, x, t, ctx = scene()
    jgrids, tgrids = grids_both(pts, mask)
    model = jus.SparseUNet(jus.SparseUNetConfig(**KW))
    jc = jnp.asarray(ctx) if with_context else None
    args = (jgrids, jnp.asarray(x), jnp.asarray(t), jc)
    shapes = jax.eval_shape(lambda r: model.init(r, *args),
                            jax.random.PRNGKey(0))
    params = random_params(flax.linen.meta.unbox(shapes), 1)
    # with the context, the output and the gradients of a random
    # cotangent with respect to x and every parameter in one trace
    cot = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def loss(p, xx):
        out = model.apply(p, jgrids, xx, jnp.asarray(t), jc)
        return jnp.sum(out * cot), out

    if with_context:
        (_, ref), jg = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
                jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    else:
        ref = jax.jit(model.apply)(params, *args)
    ref = np.asarray(ref)
    port = SparseUNet(SparseUNetConfig(**KW), in_channels=4,
                      context_dim=16 if with_context else None,
                      device="cpu")
    port.load_state_dict(sparse_unet_from_jax(params))        # strict
    tc = torch.from_numpy(ctx) if with_context else None
    xt = torch.from_numpy(x).requires_grad_()
    got = port(tgrids, xt, torch.from_numpy(t), tc)
    m = tgrids[0].mask.numpy()
    assert np.abs(ref[m]).max() > 0.1
    assert (got.detach().numpy()[~m] == 0).all()
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)
    if not with_context:
        return
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg[1]), **TOL)
    # each within 2e-3 of its largest value, with a floor of 1e-3 of the
    # largest gradient for tensors whose gradient is zero but for rounding
    # (a bias that a one-channel-per-group GroupNorm removes)
    ref_p = sparse_unet_from_jax(jax.tree.map(np.asarray, jg[0]))
    floor = 1e-3 * max(np.abs(r.numpy()).max() for r in ref_p.values())
    for name, p in port.named_parameters():
        r = ref_p[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=2e-3,
                                   atol=2e-3 * max(np.abs(r).max(), floor),
                                   err_msg=name)
