"""Port parity: the inference decode of
``infinicube_tpu_torch.models.vae.sunet.SparseStructureVAE`` against the
JAX module on the same parameters (``weights/from_jax.sparse_vae_from_jax``,
loaded strictly) and latents: the same grid at every level, overflow
included, and the same semantic logits."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.vae import sunet as jsunet
from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                   SparseVAEConfig)
from infinicube_tpu_torch.weights.from_jax import sparse_vae_from_jax
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

SMALL = dict(f_maps=8, c_dim=8, sem_embed_dim=4, neck_dims=(8, 8, 8),
             neck_ijk_min=(-4, -4, -4), dense_lookup_ijk_min=(-18, -18, -10),
             dense_lookup_dims=(36, 36, 20))
# f32 on both sides, differing only in summation order
TOL = dict(atol=2e-3, rtol=2e-3)
# struct-head weights are scaled on both sides so that no occupancy
# decision rests on a logit margin near 0
STRUCT_SCALE = 20.0


def random_params(shapes, seed):
    """Random values for an abstract flax tree: kernels at 1/sqrt(fan_in),
    norm scales near 1, small biases (no init run needed)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape)
        if name == "kernel":
            n = n / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            n = 1.0 + 0.1 * n
        elif name == "bias":
            n = 0.1 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_params(jcfg, seed=1):
    vae = jsunet.SparseStructureVAE(jcfg)
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(-3, 3, (1, 200, 3)), jnp.float32)
    grids = jsunet.build_hash_tree(jcfg, pts, jnp.ones((1, 200), bool))
    shapes = jax.eval_shape(vae.init, jax.random.PRNGKey(seed), grids,
                            jnp.zeros((1, jcfg.capacities[0]), jnp.int32),
                            jax.random.PRNGKey(2))
    p = random_params(flax.linen.meta.unbox(shapes), seed)
    for name, leaf in p["params"].items():
        if name.startswith("struct"):
            p["params"][name] = {k: v * STRUCT_SCALE for k, v in leaf.items()}
    return vae, p


def jax_decode_with_grids(vae, params, z, monkeypatch):
    """The JAX decode, recording every grid that grid_from_keys builds
    (the neck grid, then each pruned level)."""
    built = []
    orig = jsunet.grid_from_keys

    def record(*a, **kw):
        g = orig(*a, **kw)
        built.append(g)
        return g

    monkeypatch.setattr(jsunet, "grid_from_keys", record)
    dec = vae.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(z), None,
                    method=jsunet.SparseStructureVAE.decode)
    return dec, built


@pytest.mark.parametrize("caps", [(4096, 2048, 1024), (600, 300, 150)])
def test_decode_matches_jax(caps, monkeypatch):
    kw = dict(SMALL, capacities=caps)
    vae, params = jax_params(jsunet.SparseVAEConfig(**kw))
    z = np.random.default_rng(3).standard_normal(
        (1, 8, 8, 8, 8)).astype(np.float32)
    ref, ref_grids = jax_decode_with_grids(vae, params, z, monkeypatch)
    port = SparseStructureVAE(SparseVAEConfig(**kw), device="cpu")
    port.load_state_dict(sparse_vae_from_jax(params))     # strict
    out = port.decode(torch.from_numpy(z))
    assert len(out["grids"]) == len(ref_grids) == 3
    for jg, tg in zip(ref_grids, out["grids"]):
        np.testing.assert_array_equal(tg.keys.numpy(),
                                      np.asarray(jg.keys).astype(np.int64))
        np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
        np.testing.assert_array_equal(tg.num_dropped.numpy(),
                                      np.asarray(jg.num_dropped))
        np.testing.assert_allclose(tg.voxel_size.numpy(),
                                   np.asarray(jg.voxel_size))
    if caps[-1] == 150:
        assert any(int(g.num_dropped.sum()) > 0 for g in out["grids"])
    m = out["grid"].mask.numpy()
    assert m.sum() > 0
    np.testing.assert_allclose(out["semantic_logits"].numpy()[m],
                               np.asarray(ref["semantic_logits"])[m], **TOL)
