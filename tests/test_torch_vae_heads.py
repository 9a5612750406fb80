"""Port parity for the sparse VAE's leftovers: attention levels (level 1,
encoder and decoder), the normal and color heads and the featurizer's
extra per-voxel inputs, against the JAX package on the same points,
weights (``weights/from_jax.sparse_vae_from_jax``, strict) and
reparametrize noise: the teacher-forced forward's outputs, ``vae_loss`` and
every gradient (the JAX loss does not read the heads, so their gradients
are zero on both sides); the inference decode's heads; the switches
``dense_lookup`` and ``conv_backend``. f32 on both sides, differing only in
summation order: ROADMAP's atol/rtol 2e-3 (gradients within 2e-3 of each
tensor's largest value, as ``tests/test_torch_vae_steps.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.vae import sunet as jsunet
from infinicube_tpu_torch.models.vae.loss import VAELossConfig, vae_loss
from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                   SparseVAEConfig,
                                                   VoxelFeaturizer)
from infinicube_tpu_torch.weights.from_jax import sparse_vae_from_jax
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.test_torch_sparse_vae import random_params
from tests.test_torch_vae_train import (SMALL, ZERO_GRAD, _jax_batch,
                                        _jax_forward, _noise, _port_batch,
                                        _scene)

TOL = dict(atol=2e-3, rtol=2e-3)
# two levels (one pooling) keep the JAX trace short; the attention level
# is the coarsest, between the encoder's last blocks and the neck
HEADS = dict(SMALL, pooling_factors=((2, 2, 2),), neck_dims=(16, 16, 16),
             neck_ijk_min=(-8, -8, -8), capacities=(1024, 512),
             attention_levels=(1,), attn_heads=2,
             use_normal_head=True, use_color_head=True)


def jax_shapes(port):
    """The flax tree's leaf shapes read off the port's own modules (the
    inverse of ``sparse_vae_from_jax``'s renames and transposes), so the
    JAX model needs no init trace; the strict load back and the JAX apply
    on the tree check every name and shape."""
    tree: dict = {}
    for key, p in port.state_dict().items():
        *path, leaf = key.split(".")
        shape = tuple(p.shape)
        if leaf == "weight":
            mod = port.get_submodule(".".join(path))
            if isinstance(mod, torch.nn.Embedding):
                leaf = "embedding"
            elif len(shape) == 1:
                leaf = "scale"
            else:
                leaf = "kernel"
                shape = shape[::-1] if len(shape) == 2 else \
                    shape[2:] + shape[1::-1]
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jax.ShapeDtypeStruct(shape, jnp.float32)
    return {"params": tree}


LATENT = (2, 16, 16, 16, 8)
jax_batch = jax.jit(_jax_batch, static_argnums=0)


@pytest.fixture(scope="module")
def pair():
    jvae = jsunet.SparseStructureVAE(jsunet.SparseVAEConfig(**HEADS))
    port = SparseStructureVAE(SparseVAEConfig(**HEADS), device="cpu")
    params = random_params(jax_shapes(port), 4)
    port.load_state_dict(sparse_vae_from_jax(params))          # strict
    names = set(dict(port.named_parameters()))
    assert {"attn1_enc_qkv.weight", "attn1_dec_proj.bias",
            "normal_head.weight", "color_head.bias"} <= names
    return jvae, jax.tree.map(jnp.asarray, params), port


def test_forward_loss_and_every_gradient(pair):
    jvae, params, port = pair
    pts, labels = _scene(6)
    rng = jax.random.PRNGKey(5)
    jbatch = jax_batch(jvae.cfg, pts, labels)

    def jloss(p):
        (loss, _), out = _jax_forward(jvae, p, jbatch, rng)
        return loss, out

    (ref_loss, ref_out), ref_grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    grids, sem = _port_batch(port.cfg, pts, labels)
    for p in port.parameters():
        p.grad = None
    out = port(grids, sem, noise=torch.from_numpy(_noise(rng, LATENT)))
    loss, _ = vae_loss(VAELossConfig(), out, grids[0], sem)
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    m = grids[0].mask.numpy()
    for key in ("semantic_logits", "normals", "colors", "features"):
        np.testing.assert_allclose(out[key].detach().numpy()[m],
                                   np.asarray(ref_out[key])[m], **TOL,
                                   err_msg=key)
    assert (out["colors"][grids[0].mask] > 0).all()
    ref = sparse_vae_from_jax(jax.tree.map(np.asarray, ref_grads))
    # a parameter the loss does not reach has no gradient in PyTorch
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in port.named_parameters()}
    assert set(ref) == set(grads)
    floor = 1e-3 * max(r.abs().max().item() for r in ref.values())
    for name, r in ref.items():
        r = r.numpy()
        np.testing.assert_allclose(
            grads[name].numpy(), r, rtol=2e-3,
            atol=2e-3 * max(np.abs(r).max(), floor), err_msg=name)
        if name.startswith(("normal_head", "color_head")):
            assert np.abs(r).max() == 0                # outputs only
        elif name.startswith("attn1") and not name.endswith(ZERO_GRAD):
            assert np.abs(r).max() > floor, name


def test_inference_decode_heads(pair):
    """The inference branch runs the same level attention and heads after
    its loop as the teacher-forced one (held against JAX above): the heads
    on its final features, on the predicted grid's rows."""
    _, _, port = pair
    z = np.random.default_rng(7).standard_normal(LATENT).astype(np.float32)
    out = port.decode(torch.from_numpy(z))
    m = out["grid"].mask
    assert m.sum() > 0
    h = out["features"]
    torch.testing.assert_close(out["normals"], port.normal_head(h))
    torch.testing.assert_close(out["colors"],
                               torch.sigmoid(port.color_head(h)))
    assert torch.isfinite(out["normals"][m]).all()


def test_featurizer_extra_feats():
    """The JAX VAE never passes extra inputs: a direct call's tree (its
    Dense wider by the extra width) loads into a featurizer built with
    ``extra_dim``."""
    import flax
    jcfg = jsunet.SparseVAEConfig(**HEADS)
    grids, sem = jax_batch(jcfg, *_scene(6))
    extra = np.random.default_rng(2).normal(
        size=grids[0].mask.shape + (4,)).astype(np.float32)
    feat = jsunet.VoxelFeaturizer(jcfg)
    shapes = jax.eval_shape(feat.init, jax.random.PRNGKey(0), grids[0], sem,
                            jnp.asarray(extra))
    params = random_params(flax.linen.meta.unbox(shapes), 3)
    ref = np.asarray(feat.apply(params, grids[0], sem, jnp.asarray(extra)))
    tcfg = SparseVAEConfig(**HEADS)
    port = VoxelFeaturizer(tcfg, extra_dim=4)
    port.load_state_dict(sparse_vae_from_jax(params))
    tgrids, tsem = _port_batch(tcfg, *_scene(6))
    got = port(tgrids[0], tsem, torch.from_numpy(extra)).detach().numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    with pytest.raises(ValueError):
        port(tgrids[0], tsem)


def test_switches():
    """``dense_lookup`` off: no bounds and the same plans' neighbours;
    ``conv_backend`` takes the reference's values and refuses others."""
    off = SparseVAEConfig(**dict(SMALL, dense_lookup=False))
    assert off.level_dense_bounds(1) is None
    on = SparseVAEConfig(**SMALL)
    grids, _ = _port_batch(on, *_scene(2))
    a = SparseStructureVAE(on, device="cpu").level_plans(grids)
    b = SparseStructureVAE(off, device="cpu").level_plans(grids)
    assert all(torch.equal(p.nbr, q.nbr) for p, q in zip(a, b))
    for backend in ("auto", "window", "gather"):
        vae = SparseStructureVAE(dataclasses.replace(on,
                                                     conv_backend=backend),
                                 device="cpu")
        assert all(torch.equal(p.nbr, q.nbr)
                   for p, q in zip(vae.level_plans(grids), a))
    with pytest.raises(ValueError, match="unknown conv backend"):
        SparseStructureVAE(dataclasses.replace(on, conv_backend="taps"),
                           device="cpu").level_plans(grids)
