"""Port parity: the plain ``conv3x3x3`` and the ``Conv3x3x3`` module of
``infinicube_tpu_torch.ops.dense_conv`` against the JAX op (the Pallas
kernel in interpret mode where its plan fits, XLA's conv where it does not),
f32 on both sides, plus the packed weight layout that K3 reads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.ops.dense_conv import (_xla_conv, conv3x3x3 as
                                           jax_conv3x3x3, conv_plan_feasible)
from infinicube_tpu_torch.ops.dense_conv import (Conv3x3x3, conv3x3x3,
                                                 pack_conv_weight)

# f32 on both sides, differing only in summation order
TOL = dict(atol=2e-3, rtol=2e-3)


def _case(shape, seed=0):
    B, D, H, W, C, O = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, C, O)) * 0.05).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    return x, w, b


def _port(x, w, b):
    wt = torch.from_numpy(w).permute(4, 3, 0, 1, 2)      # DHWIO -> OIDHW
    return conv3x3x3(torch.from_numpy(x), wt, torch.from_numpy(b)).numpy()


def test_plain_matches_the_pallas_kernel():
    x, w, b = _case((1, 4, 8, 16, 64, 64))
    plan = conv_plan_feasible(x.shape[:4], 64, 64, jnp.float32)
    assert plan is not None
    ref = np.asarray(jax_conv3x3x3(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), plan, True))
    np.testing.assert_allclose(_port(x, w, b), ref, **TOL)


def test_plain_matches_xla_at_in_conv_width():
    """C = 16, the UNet's in_conv, which the JAX package sends to XLA."""
    x, w, b = _case((2, 5, 6, 7, 16, 24), seed=1)
    ref = np.asarray(_xla_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b)))
    np.testing.assert_allclose(_port(x, w, b), ref, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_module_promotes_like_flax(dtype):
    """Input, kernel and bias are cast to the module's dtype first."""
    x, w, b = _case((1, 3, 4, 5, 8, 16), seed=2)
    m = Conv3x3x3(8, 16, dtype=dtype)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w).permute(4, 3, 0, 1, 2))
        m.bias.copy_(torch.from_numpy(b))
        out = m(torch.from_numpy(x))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = _xla_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                    jnp.asarray(b, jdt).astype(jnp.float32))
    assert out.dtype == dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2 if dtype == torch.bfloat16 else 2e-3,
                               rtol=2e-2 if dtype == torch.bfloat16 else 2e-3)


def test_packed_weight_is_the_implicit_gemm_operand():
    """out = im2col(x)[M, 27*C] @ packed.T in (tap, channel) order, tap =
    dz*9 + dy*3 + dx: the layout K3 multiplies."""
    x, w, b = _case((1, 3, 4, 5, 8, 16), seed=3)
    wt = torch.from_numpy(w).permute(4, 3, 0, 1, 2)
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, 0, 1, 1, 1, 1, 1, 1))
    cols = [xp[:, dz:dz + 3, dy:dy + 4, dx:dx + 5] for dz in range(3)
            for dy in range(3) for dx in range(3)]
    a = torch.cat(cols, dim=-1).reshape(-1, 27 * 8)
    packed = pack_conv_weight(wt)
    assert packed.shape == (16, 27 * 8) and packed.dtype == torch.bfloat16
    got = (a @ packed.float().T).reshape(1, 3, 4, 5, 16) + \
        torch.from_numpy(b)
    ref = conv3x3x3(torch.from_numpy(x), wt.to(torch.bfloat16).float(),
                    torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
