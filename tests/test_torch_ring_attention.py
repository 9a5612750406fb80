"""Port parity: ``infinicube_tpu_torch.ops.ring_attention`` over 2 and 4
gloo ranks against the JAX ``ring_attention`` on a 2- and 4-device CPU mesh
(values at atol 2e-5 in f32 as ``tests/test_ring_attention.py``, gradients
against ``jax.grad`` at atol 5e-4; bf16 inputs at a bf16 gate), the
virtual-rank composition against the collective run (bit for bit: the same
pieces in the same order on the same values), one rank against the
single-device attention, and the card's branch through stand-ins of the
kernels' wrappers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from infinicube_tpu.ops.ring_attention import ring_attention as jax_ring
from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.ops import attention, ring_attention as ring
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.torch_dist import ring_rank, run_ranks, seeded

B, N, H, D = 2, 64, 4, 16
F32_ATOL, GRAD_ATOL = 2e-5, 5e-4
# bf16: inputs, outputs and gradients rounded to 8 bits of mantissa, and
# the two rings round at other places (the port merges in f32, the JAX
# ring rescales its output in bf16): within 4 ulp of bf16 at the values'
# scale (~1)
BF16_ATOL = 3e-2


@pytest.fixture(scope="module")
def case():
    return tuple(seeded(0, *[(B, N, H, D)] * 4))


def _jax_ring(world, q, k, v, cot, dtype):
    mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(1, world),
                ("data", "seq"))
    sh = NamedSharding(mesh, P(None, "seq"))
    args = [jax.device_put(jnp.asarray(a, dtype), sh) for a in (q, k, v)]

    def loss(q, k, v):
        out = jax_ring(q, k, v, mesh)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*args)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _join(parts):
    """Rank slices (out, dq, dk, dv) -> the whole tensors as numpy f32."""
    return [torch.cat([p[i] for p in parts], dim=1).float().numpy()
            for i in range(4)]


@pytest.mark.parametrize("world", [2, 4])
def test_ring_matches_jax_and_the_virtual_ring(world, case, tmp_path):
    res = run_ranks(ring_rank, world, tmp_path,
                    [(case, "float32"), (case, "bfloat16")])
    q, k, v, cot = case
    got32 = _join([r[0] for r in res])
    ref32 = _jax_ring(world, q, k, v, cot, jnp.float32)
    np.testing.assert_allclose(got32[0], ref32[0], atol=F32_ATOL)
    for g, r in zip(got32[1:], ref32[1:]):
        np.testing.assert_allclose(g, r, atol=GRAD_ATOL)
    got16 = _join([r[1] for r in res])
    ref16 = _jax_ring(world, q, k, v, cot, jnp.bfloat16)
    for g, r in zip(got16, ref16):
        np.testing.assert_allclose(g, r, atol=BF16_ATOL)
    # the same pieces composed on one device, in the collective run's order
    for dtype, parts in ((torch.float32, res), (torch.bfloat16, res)):
        i = 0 if dtype == torch.float32 else 1
        t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
        out, grads = ring.ring_attention_virtual(
            *t, world, do=torch.from_numpy(cot).to(dtype))
        for got, want in zip((out, *grads), _join([p[i] for p in parts])):
            assert np.array_equal(got.float().numpy(), want), dtype


def test_one_rank_is_the_single_device_attention(case):
    """No group: one block, no collective; the output is the plain
    attention's bit for bit and the gradients agree with autograd's."""
    q, k, v, cot = (torch.from_numpy(a) for a in case)
    t1 = [x.clone().requires_grad_() for x in (q, k, v)]
    t2 = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ring.ring_attention(*t1)
    ref = attention.multi_head_attention(*t2)
    assert torch.equal(out, ref)
    (out * cot).sum().backward()
    (ref * cot).sum().backward()
    for a, b in zip(t1, t2):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5)


class _OnCard(torch.Tensor):
    """A CPU tensor that claims to lie on the card (so are its results)."""
    is_cuda = True


def _plain(t):
    return t.as_subclass(torch.Tensor)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_branch_goes_through_the_flash_kernels(monkeypatch, dtype,
                                                    case):
    """On a CUDA tensor each block is one forward kernel launch with its
    lse (K2 in bf16, ``flash_attn_f32`` in f32) at the head dim padded to
    64, and each block's gradient one K5 / ``flash_attn_f32_bwd`` launch
    with the rows' global lse; never a plain version. Checked without a
    card: stand-ins that record their calls take the wrappers' place, and
    the result equals the CPU ring's."""
    calls = []
    plain_fwd = attention.attention_plain

    def fake_fwd(q, k, v, scale, return_lse=False):
        calls.append(("fwd", q.shape[-1], return_lse, q.dtype))
        return plain_fwd(_plain(q), _plain(k), _plain(v), scale, return_lse)

    def fake_bwd(q, k, v, do, lse, delta, scale):
        # K5's formulas on the lse and delta it is given
        calls.append(("bwd", q.shape[-1], tuple(lse.shape), q.dtype))
        qf, kf, vf, dof = (_plain(t).float() for t in (q, k, v, do))
        p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale -
                      _plain(lse)[..., None])
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
        ds = p * (dp - _plain(delta)[..., None])
        return (torch.einsum("bhqk,bkhd->bqhd", ds, kf).mul(scale).to(q.dtype),
                torch.einsum("bhqk,bqhd->bkhd", ds, qf).mul(scale).to(k.dtype),
                torch.einsum("bhqk,bqhd->bkhd", p, dof).to(v.dtype))

    def refuse(*a, **kw):
        raise AssertionError("a plain attention ran on a CUDA tensor")

    f32 = dtype == torch.float32
    monkeypatch.setattr(kernels, "flash_attn_f32" if f32 else
                        "flash_attn_bf16", fake_fwd)
    monkeypatch.setattr(kernels, "flash_attn_f32_bwd" if f32 else
                        "flash_attn_bf16_bwd", fake_bwd)
    monkeypatch.setattr(ring, "attention_plain", refuse)
    monkeypatch.setattr(ring, "attention_bwd_plain", refuse)
    q, k, v, cot = (torch.from_numpy(a[:, :32]).to(dtype) for a in case)
    out, grads = ring.ring_attention_virtual(
        *(x.as_subclass(_OnCard) for x in (q, k, v)), 2,
        do=cot.as_subclass(_OnCard))
    assert calls[:4] == [("fwd", 64, True, dtype)] * 4
    assert calls[4:] == [("bwd", 64, (B, H, 16), dtype)] * 4
    monkeypatch.undo()
    ref, ref_grads = ring.ring_attention_virtual(q, k, v, 2, do=cot)
    tol = dict(atol=1e-5, rtol=1e-5) if f32 else dict(atol=1e-2, rtol=0)
    for a, b in zip((out, *grads), (ref, *ref_grads)):
        assert a.shape == b.shape and a.dtype == dtype
        torch.testing.assert_close(_plain(a).float(), b.float(), **tol)
