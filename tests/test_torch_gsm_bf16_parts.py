"""Port parity for the GSM's branches in ``gsm_bf16_config`` on their own:
the voxel branch, the pixel branch (the gradient of its gaussians, its
bf16 attention's backward included) and the sky modulator in bf16, each
against the JAX module of the same dtype on the same inputs and
parameters (numpy, seeded; carried across by ``gsm_from_jax``). The
tolerance is tests/test_torch_gsm_bf16.py's and for the same reasons: each
output within twice the distance of the port's f32 module from the JAX
bf16 one (the movement bf16 itself makes), each gradient within four times
it in norm."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from infinicube_tpu.camera import projection as jproj
from infinicube_tpu.grid.build import coarsened_grid as j_coarsened_grid
from infinicube_tpu.models.gsm import pixel_branch as jpb
from infinicube_tpu.models.gsm import sky as jsky
from infinicube_tpu.models.gsm import voxel_branch as jvb
from infinicube_tpu_torch.grid.build import coarsened_grid
from infinicube_tpu_torch.models.gsm import pixel_branch as tpb
from infinicube_tpu_torch.models.gsm import sky as tsky
from infinicube_tpu_torch.models.gsm import voxel_branch as tvb
from infinicube_tpu_torch.weights.from_jax import gsm_from_jax
from tests.test_gsm import HW
from tests.test_torch_gsm import (one_torch_thread,  # noqa: F401
                                  port_batch, prior_batch)
from tests.test_torch_gsm_bf16 import (BF16, FIELDS, V, _sky, hold_bf16,
                                       hold_grads, random_tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _load(module, tree):
    module.load_state_dict(gsm_from_jax(tree))
    return module

def test_voxel_branch_matches_jax():
    """The bf16 voxel branch (sparse ResBlocks in bf16, its input
    projection and heads in f32 by promotion) on the scene's two-level
    pyramid with random lifted and image features."""
    b = prior_batch()
    rng = np.random.default_rng(6)
    jg = [b["grid"]]
    jg.append(j_coarsened_grid(jg[0], (2, 2, 2), capacity=jg[0].capacity))
    tg = [port_batch(b)["grid"]]
    tg.append(coarsened_grid(tg[0], (2, 2, 2), capacity=tg[0].capacity))
    mask = np.array(jg[0].mask)
    feats = np.where(mask[..., None],
                     rng.normal(size=mask.shape + (16,)), 0.0)
    visible = mask & (rng.uniform(size=mask.shape) < 0.5)
    img = rng.normal(size=(V,) + HW + (16,))
    args = [feats.astype(np.float32), visible, img.astype(np.float32),
            np.array(b["Ks"]), np.array(b["cam_to_worlds"])]
    kw = dict(f_maps=16, levels=2, gaussians_per_voxel=2)
    ports = {name: tvb.VoxelBranch(tvb.VoxelBranchConfig(**kw, dtype=dt), 16)
             for name, dt in (("bf16", BF16), ("f32", torch.float32))}
    tree = random_tree(ports["f32"], seed=5)
    jm = jvb.VoxelBranch(jvb.VoxelBranchConfig(**kw, dtype=jnp.bfloat16))
    want = jax.jit(jm.apply)(tree, jg, *args)
    outs = {}
    for name, m in ports.items():
        with torch.inference_mode():
            outs[name] = _load(m, tree)(tg, *(_t(a) for a in args))
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(outs["bf16"]["valid"].numpy(), valid)
    for k in FIELDS:
        assert outs["bf16"][k].dtype == torch.float32
        hold_bf16(outs["bf16"][k], want[k], outs["f32"][k], k, valid)


def test_pixel_branch_and_its_attention_gradient_match_jax():
    """The bf16 pixel branch with attention in its second stage as well as
    at the bottleneck: the gaussians, and the gradient of a random linear
    function of their means and colours against jax.grad (the attention's
    bf16 backward included)."""
    b = prior_batch()
    rng = np.random.default_rng(7)
    mask = rng.uniform(size=(V,) + HW) < 0.7
    args = [np.array(b["images"]), np.array(b["depth_prior"]),
            np.array(b["Ks"]), np.array(b["cam_to_worlds"]), mask]
    kw = dict(width=8, dims=(1, 2), gs_per_pixel=1,
              self_attn_per_stage=(0, 1))
    ports = {name: tpb.PixelBranch(tpb.PixelBranchConfig(**kw, dtype=dt))
             for name, dt in (("bf16", BF16), ("f32", torch.float32))}
    tree = random_tree(ports["f32"], seed=8)
    jm = jpb.PixelBranch(jpb.PixelBranchConfig(**kw, dtype=jnp.bfloat16))
    n = V * HW[0] * HW[1]
    wm, wc = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(2))

    def fn(params):
        o = jm.apply(params, *args)
        return jnp.sum(o["means"] * wm) + jnp.sum(o["colors"] * wc), o

    (_, want), jgrad = jax.jit(jax.value_and_grad(fn, has_aux=True))(tree)
    jgrad = gsm_from_jax(jax.tree.map(np.asarray, jgrad))
    outs, grads = {}, {}
    for name, m in ports.items():
        o = _load(m, tree)(*(_t(a) for a in args))
        (torch.sum(o["means"] * _t(wm)) +
         torch.sum(o["colors"] * _t(wc))).backward()
        outs[name] = o
        grads[name] = {k: q.grad for k, q in m.named_parameters()}
    for k in FIELDS:
        assert outs["bf16"][k].dtype == torch.float32
        hold_bf16(outs["bf16"][k], want[k], outs["f32"][k], k)
    carried = hold_grads(grads["bf16"], jgrad, grads["f32"])
    assert {"unet.d1a0.qkv.weight", "unet.mid_attn.out.weight"} <= carried


def test_sky_modulator_matches_jax():
    """The bf16 sky: its token (patch embedding, attention with its
    logits, mask at bf16's minimum and softmax in bf16, the Denses in bf16,
    the LayerNorms in f32) and its samples (bf16 Denses, f32 LayerNorms,
    the colour back in f32)."""
    b = prior_batch()
    dirs = np.stack([np.asarray(jproj.posed_rays_from_intrinsics(
        K, T, HW)[1]) for K, T in zip(b["Ks"], b["cam_to_worlds"])])
    sky = _sky()
    sky[1, 8:16, :24] = True
    sample = np.random.default_rng(9).normal(size=(4, 6, 3)).astype(
        np.float32)
    args = (np.array(b["images"]), sky, dirs, sample)
    kw = dict(embed_dim=32, num_layers=2, num_heads=2, patch=8)
    ports = {name: tsky.SkyboxMlpModulator(tsky.SkyConfig(**kw, dtype=dt))
             for name, dt in (("bf16", BF16), ("f32", torch.float32))}
    tree = random_tree(ports["f32"], seed=10)
    jm = jsky.SkyboxMlpModulator(jsky.SkyConfig(**kw, dtype=jnp.bfloat16))
    rgb_j, tok_j = jax.jit(jm.apply)(tree, *args)
    outs = {}
    for name, m in ports.items():
        with torch.inference_mode():
            outs[name] = _load(m, tree)(*(_t(a) for a in args))
    assert outs["bf16"][0].dtype == outs["bf16"][1].dtype == torch.float32
    hold_bf16(outs["bf16"][1], tok_j, outs["f32"][1], "token")
    hold_bf16(outs["bf16"][0], rgb_j, outs["f32"][0], "rgb")
