"""Port parity: ``infinicube_tpu_torch.nn.sparse.sparse_attention`` against
the JAX ``sparse_attention`` on the same Dense weights and features, and
its card route (each sample's active rows compacted through
``ops/attention.multi_head_attention``) against its plain version, run
here on the CPU with the plain attention in the kernels' place: values and
gradients, with a sample that has no active row. f32 throughout: ROADMAP's
atol/rtol 2e-3 against JAX; the two port routes differ only in summation
order, at 1e-5 in f32; in bf16 the einsum rounds its logits to bf16 and
the card's attention does not (ROADMAP "Known differences"), so there each
route is held to the f32 computation and the compacted one may stand at
most twice as far from it as the einsum, in norm (the bound style of
``tests/test_torch_gsm_bf16.py``)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.nn.sparse import sparse_attention as j_sparse_attention
from infinicube_tpu_torch.nn import sparse
from infinicube_tpu_torch.nn.layers import Dense
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-3, rtol=2e-3)
ROUTES = dict(atol=1e-5, rtol=1e-5)
B, C, F, HEADS = 3, 40, 16, 4


class _Attn(fnn.Module):
    @fnn.compact
    def __call__(self, feats, mask):
        return j_sparse_attention(feats, mask, HEADS,
                                  fnn.Dense(3 * F, name="qkv"),
                                  fnn.Dense(F, name="proj"))


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, C, F)).astype(np.float32)
    mask = rng.random((B, C)) < 0.6
    mask[1] = False                              # no active row
    feats[~mask] = 0.0
    return feats, mask


def port_layers(params):
    qkv, proj = Dense(F, 3 * F, compute_dtype=None), \
        Dense(F, F, compute_dtype=None)
    for m, name in ((qkv, "qkv"), (proj, "proj")):
        p = params["params"][name]
        m.load_state_dict({"weight": torch.from_numpy(
            np.asarray(p["kernel"]).T.copy()),
            "bias": torch.from_numpy(np.asarray(p["bias"]))})
    return qkv, proj


def test_plain_matches_jax():
    feats, mask = inputs()
    mod = _Attn()
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                      jnp.asarray(mask))
    params = jax.tree.map(lambda a: a + 0.05, params)    # proj not zero
    ref = np.asarray(mod.apply(params, jnp.asarray(feats),
                               jnp.asarray(mask)))
    qkv, proj = port_layers(params)
    got = sparse.sparse_attention(torch.from_numpy(feats),
                                  torch.from_numpy(mask), HEADS, qkv, proj)
    assert np.abs(ref).max() > 0.1 and (ref[1] == 0).all()
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_route_compaction_matches_plain(dtype, monkeypatch):
    """The compacted route gives the einsum's output and gradients; it
    launches nothing for the sample without an active row and never calls
    the einsum."""
    feats, mask = inputs(1)
    g = torch.Generator().manual_seed(0)
    qkv, proj = Dense(F, 3 * F, compute_dtype=dtype), \
        Dense(F, F, compute_dtype=dtype)
    for m in (qkv, proj):
        torch.nn.init.normal_(m.weight, 0.0, 0.3, generator=g)
        torch.nn.init.normal_(m.bias, 0.0, 0.1, generator=g)
    tmask = torch.from_numpy(mask)
    cot = torch.randn((B, C, F), generator=g)

    def run(dt=dtype):
        for m in (qkv, proj):
            m.compute_dtype = dt
        x = torch.from_numpy(feats).to(dt).requires_grad_()
        out = sparse.sparse_attention(x, tmask, HEADS, qkv, proj)
        grads = torch.autograd.grad((out.float() * cot).sum(),
                                    [x, qkv.weight, proj.weight])
        return [out.float()] + [t.float() for t in grads]

    ref = run()
    ref32 = run(torch.float32)
    calls = []
    mha = sparse.multi_head_attention

    def counted(q, k, v):
        calls.append(q.shape[1])
        return mha(q, k, v)

    def refuse(*a, **kw):
        raise AssertionError("the einsum ran on the card's route")

    monkeypatch.setattr(sparse, "_on_card", lambda x: True)
    monkeypatch.setattr(sparse, "multi_head_attention", counted)
    monkeypatch.setattr(sparse, "_attention_plain", refuse)
    got = run()
    assert calls == [int(mask[0].sum()), int(mask[2].sum())]
    assert (got[0][1] == 0).all()
    for a, b, c in zip(got, ref, ref32):
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, **ROUTES)
        else:
            assert (a - c).norm() <= 2 * (b - c).norm() + 1e-6 * c.norm()
