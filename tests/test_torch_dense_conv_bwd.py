"""Port parity: ``conv3x3x3_bwd_plain`` and autograd through the
``Conv3x3x3`` module (CPU) against ``jax.grad`` of the JAX op (the Pallas
kernel in interpret mode, forward and input gradient, and XLA's conv), the
input-gradient weight pack against the JAX ``wf``, and the packs' cache
against in-place updates of the weight. f32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.ops.dense_conv import (_xla_conv, conv3x3x3 as
                                           jax_conv3x3x3, conv_plan_feasible)
from infinicube_tpu_torch.ops.dense_conv import (Conv3x3x3,
                                                 conv3x3x3_bwd_plain,
                                                 conv3x3x3_plain,
                                                 dgrad_weight,
                                                 pack_conv_weight)


def _case(shape, seed=0):
    B, D, H, W, C, O = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, C, O)) * 0.05).astype(np.float32)
    b = rng.standard_normal(O).astype(np.float32)
    g = rng.standard_normal((B, D, H, W, O)).astype(np.float32)
    return x, w, b, g


def _oidhw(w):
    return torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous()


def _dhwio(w: torch.Tensor):
    return w.permute(2, 3, 4, 1, 0).numpy()


def _assert_close(got, ref):
    """Each gradient within 2e-3 of its largest reference value."""
    lim = 2e-3 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=lim, rtol=2e-3)


def _jax_grads(fn, x, w, b, g):
    return jax.grad(lambda *a: jnp.sum(fn(*a) * g), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, w, b)))


def _check_against(ref, x, w, b, g):
    rdx, rdw, rdb = (np.asarray(r) for r in ref)
    dx, dw, db = conv3x3x3_bwd_plain(torch.from_numpy(x), _oidhw(w),
                                     torch.from_numpy(g))
    _assert_close(dx.numpy(), rdx)
    _assert_close(_dhwio(dw), rdw)
    _assert_close(db.numpy(), rdb)
    # autograd through the module on the CPU
    m = Conv3x3x3(x.shape[-1], g.shape[-1])
    with torch.no_grad():
        m.weight.copy_(_oidhw(w))
        m.bias.copy_(torch.from_numpy(b))
    tx = torch.from_numpy(x).requires_grad_()
    m(tx).backward(torch.from_numpy(g))
    _assert_close(tx.grad.numpy(), rdx)
    _assert_close(_dhwio(m.weight.grad), rdw)
    _assert_close(m.bias.grad.numpy(), rdb)


def test_bwd_matches_the_pallas_kernel():
    """jax.grad through the Pallas kernel in interpret mode: its dx runs
    the same kernel on the flipped, swapped weights."""
    x, w, b, g = _case((1, 4, 8, 16, 64, 64))
    plan = conv_plan_feasible(x.shape[:4], 64, 64, jnp.float32)
    assert plan is not None
    ref = _jax_grads(lambda a, k, c: jax_conv3x3x3(a, k, c, plan, True),
                     x, w, b, g)
    _check_against(ref, x, w, b, g)


@pytest.mark.parametrize("shape", [(2, 5, 6, 7, 16, 24),
                                   (1, 3, 4, 5, 24, 8)])
def test_bwd_matches_xla(shape):
    x, w, b, g = _case(shape, seed=1)
    _check_against(_jax_grads(_xla_conv, x, w, b, g), x, w, b, g)


def test_dgrad_pack_is_the_jax_wf_relaid():
    """The pack K3 reads for the input gradient is the JAX ``wf =
    w[::-1, ::-1, ::-1]`` with in/out swapped ([3, 3, 3, O, C]), re-laid out
    as [C, 27*O] in (tap, channel) order."""
    _, w, _, _ = _case((1, 2, 2, 2, 8, 16), seed=2)
    wf = w[::-1, ::-1, ::-1].transpose(0, 1, 2, 4, 3)       # [3,3,3,O,C]
    ref = wf.reshape(27 * 16, 8).T                          # [C, 27*O]
    got = pack_conv_weight(dgrad_weight(_oidhw(w)))
    assert got.shape == (8, 27 * 16) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        torch.from_numpy(ref.copy()).to(torch.bfloat16).float().numpy())


def test_dx_is_the_conv_of_g_with_the_dgrad_weights():
    x, w, b, g = _case((1, 3, 4, 5, 8, 16), seed=3)
    wt = _oidhw(w)
    dx, _, _ = conv3x3x3_bwd_plain(torch.from_numpy(x), wt,
                                   torch.from_numpy(g))
    ref = conv3x3x3_plain(torch.from_numpy(g), dgrad_weight(wt),
                          torch.zeros(8))
    np.testing.assert_array_equal(dx.numpy(), ref.numpy())


def test_packed_weights_follow_in_place_updates():
    """Both packs are cached against the weight's version: an optimizer
    step or ``load_state_dict`` (in-place writes) rebuilds them, a second
    read does not."""
    m = Conv3x3x3(8, 16)
    m.reset_parameters(torch.Generator().manual_seed(0))
    fwd, dgr = m._packed_weight(), m._packed_weight(dgrad=True)
    assert m._packed_weight() is fwd and m._packed_weight(dgrad=True) is dgr
    x = torch.randn((1, 3, 3, 3, 8), generator=torch.Generator().manual_seed(1))
    m(x).sum().backward()
    torch.optim.AdamW(m.parameters(), lr=0.1).step()
    for dgrad, old in ((False, fwd), (True, dgr)):
        new = m._packed_weight(dgrad=dgrad)
        src = dgrad_weight(m.weight.detach()) if dgrad else m.weight.detach()
        assert not torch.equal(new, old)
        assert torch.equal(new, pack_conv_weight(src))
    stepped = m._packed_weight()
    m.load_state_dict({"weight": torch.zeros_like(m.weight),
                       "bias": torch.zeros_like(m.bias)})
    assert not m._packed_weight().any() and stepped.any()
    assert not m._packed_weight(dgrad=True).any()
