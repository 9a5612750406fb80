"""Port parity: ``infinicube_tpu_torch.models.diffusion.alt_encoders`` and
the alternative conditioning of ``VoxelDiffusion`` (``CondEncoders``, the
extra cube, the adm class one-hot, the cross-attention context) against the
JAX package on the same parameters (``weights/from_jax``, loaded strictly),
inputs and random numbers. Everything is f32 on both sides and differs only
in summation order: ROADMAP's atol/rtol 2e-3."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.diffusion import alt_encoders as jalt
from infinicube_tpu.models.diffusion import model as jmodel
from infinicube_tpu_torch.models.diffusion import alt_encoders as alt
from infinicube_tpu_torch.models.diffusion.model import (CondCubes,
                                                         CondEncoders,
                                                         DiffusionConfig,
                                                         VoxelDiffusion)
from infinicube_tpu_torch.weights.from_jax import (_convert,
                                                   diffusion_from_jax)
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.test_torch_sparse_vae import random_params

TOL = dict(atol=2e-3, rtol=2e-3)
V, H, W = 2, 32, 32


def views(seed=0, batch=None):
    """Images, intrinsics and poses of 2 views looking along +x into a
    cube around the origin (axis-permutation rotations, so the world
    points are exact on both sides)."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    images = rng.uniform(size=lead + (V, H, W, 3)).astype(np.float32)
    K = np.array([[16.0, 0, 16.1], [0, 16.0, 15.9], [0, 0, 1]], np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    T[:, :3, 0] = [0, -1, 0]
    T[:, :3, 1] = [0, 0, -1]
    T[:, :3, 2] = [1, 0, 0]
    T[:, :3, 3] = [[-6.0, 0.0, 0.3], [-5.0, 0.7, 0.1]]
    Ks = np.broadcast_to(K, lead + (V, 3, 3)).copy()
    Ts = np.broadcast_to(T, lead + (V, 4, 4)).copy()
    return images, Ks, Ts


def init_jax(module, *args, seed=0):
    """Random parameters in ``module``'s tree (static arguments such as
    the cube geometry are closed over, not traced)."""
    shapes = jax.eval_shape(lambda r: module.init(r, *args),
                            jax.random.PRNGKey(seed))
    return random_params(flax.linen.meta.unbox(shapes), seed)


def port_of(module, params):
    module.load_state_dict(_convert(params["params"]))     # strict
    return module


def test_class_semantic_and_pointnet():
    rng = np.random.default_rng(1)
    ids = np.array([3, 0, 9])
    jp = init_jax(jalt.ClassEmbedder(10, 6), jnp.asarray(ids))
    ref = jalt.ClassEmbedder(10, 6).apply(jp, jnp.asarray(ids))
    got = port_of(alt.ClassEmbedder(10, 6), jp)(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))

    sem = rng.integers(-3, 30, (2, 4, 4, 4)).astype(np.int32)   # clipped
    jp = init_jax(jalt.SemanticEncoder(23, 5), jnp.asarray(sem))
    ref = jalt.SemanticEncoder(23, 5).apply(jp, jnp.asarray(sem))
    got = port_of(alt.SemanticEncoder(23, 5), jp)(torch.from_numpy(sem))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))

    pts = rng.normal(size=(3, 40, 3)).astype(np.float32)
    mask = rng.random((3, 40)) < 0.6
    mask[2] = False                      # no point: the -inf -> 0 guard
    enc = jalt.PointNetEncoder(width=16, out_dim=8)
    jp = init_jax(enc, jnp.asarray(pts), jnp.asarray(mask))
    ref = np.asarray(enc.apply(jp, jnp.asarray(pts), jnp.asarray(mask)))
    got = port_of(alt.PointNetEncoder(16, 8), jp)(
        torch.from_numpy(pts), torch.from_numpy(mask)).detach().numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, **TOL)


def test_lift3d_lss_struct_and_depth_loss():
    images, Ks, Ts = views()
    ii, jj, kk = np.meshgrid(np.arange(8), np.arange(8), np.arange(4),
                             indexing="ij")
    centers = np.stack([ii - 3.5, jj - 3.5, kk - 1.5], -1).astype(np.float32)
    ja = tuple(map(jnp.asarray, (images, Ks, Ts)))
    ta = tuple(map(torch.from_numpy, (images, Ks, Ts)))

    enc = jalt.Lift3DEncoder(feat_dim=6)
    jp = init_jax(enc, *ja, jnp.asarray(centers))
    ref = np.asarray(jax.jit(enc.apply)(jp, *ja, jnp.asarray(centers)))
    got = port_of(alt.Lift3DEncoder(6), jp)(
        *ta, torch.from_numpy(centers)).detach().numpy()
    assert (np.abs(ref).sum(-1) > 0).mean() > 0.3     # most cells seen
    np.testing.assert_allclose(got, ref, **TOL)

    lcfg = jalt.LssConfig(feat_dim=6, depth_bins=8, d_min=1.0, d_max=12.0)
    geo = ((8, 8, 4), (-4, -4, -2), (1.0, 1.0, 1.0), (0.5, 0.5, 0.5))
    enc = jalt.LssEncoder(lcfg)
    jp = init_jax(enc, *ja, *geo)
    ref, rdlog = jax.jit(enc.apply, static_argnums=(4, 5, 6, 7))(
        jp, *ja, *geo)
    lss = port_of(alt.LssEncoder(alt.LssConfig(6, 8, 1.0, 12.0)), jp)
    got, dlog = lss(*ta, *geo)
    assert (np.abs(np.asarray(ref)).sum(-1) > 0).mean() > 0.1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(dlog.detach().numpy(), np.asarray(rdlog),
                               **TOL)
    gt = np.random.default_rng(2).uniform(-2, 14, (V, H, W)).astype(
        np.float32)                      # some pixels without depth
    ref_l = jax.jit(jalt.depth_distribution_loss, static_argnums=2)(
        rdlog, jnp.asarray(gt), lcfg)
    got_l = alt.depth_distribution_loss(dlog, torch.from_numpy(gt),
                                        alt.LssConfig(6, 8, 1.0, 12.0))
    np.testing.assert_allclose(float(got_l), float(ref_l), **TOL)

    occ = (np.random.default_rng(3).random((1, 4, 4, 4, 1)) < 0.3).astype(
        np.float32)
    enc = jalt.StructEncoder(feat_dim=4)
    jp = init_jax(enc, jnp.asarray(occ))
    ref = np.asarray(jax.jit(enc.apply)(jp, jnp.asarray(occ)))
    got = port_of(alt.StructEncoder(4), jp)(torch.from_numpy(occ))
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)


ALT = dict(latent_channels=2, cube_dims=(8, 8, 8), cube_ijk_min=(-4, -4, -4),
           latent_voxel_size=(1.0, 1.0, 1.0), latent_origin=(0.5, 0.5, 0.5),
           model_channels=16, channel_mult=(1, 2), attention_ds=(2,),
           num_res_blocks=1, num_heads=2, transformer_depth=2,
           num_map_types=2, use_semantic_cond=True, semantic_embed_dim=4,
           use_single_scan_cond=True, single_scan_dim=3, image_cond_dim=4,
           num_classes=5, context_dim=12, classifier_free_prob=0.5)


def init_jax_model(jd, seed):
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(seed))
    return random_params(flax.linen.meta.unbox(shapes), seed)


def raw_conditions(seed=0, B=2):
    rng = np.random.default_rng(seed)
    images, Ks, Ts = views(seed, batch=B)
    return dict(
        semantics=rng.integers(0, 23, (B, 8, 8, 8)).astype(np.int32),
        scan_points=rng.normal(size=(B, 50, 3)).astype(np.float32),
        scan_mask=rng.random((B, 50)) < 0.7,
        images=images, Ks=Ks, cam_to_worlds=Ts)


@pytest.fixture(scope="module")
def lss():
    """The LSS-conditioned JAX model with random parameters, the port on
    them (loaded strictly) and one batch's conditions on both sides,
    built once for the module: each JAX function is traced once."""
    jd = jmodel.VoxelDiffusion(jmodel.DiffusionConfig(
        **ALT, use_image_cond="lss", dtype=jnp.float32))
    params = jax.tree.map(jnp.asarray, init_jax_model(jd, 0))
    td = VoxelDiffusion(DiffusionConfig(**ALT, use_image_cond="lss",
                                        dtype=torch.float32), device="cpu")
    td.load_params(diffusion_from_jax(params))            # strict
    raw = raw_conditions()
    jx = jax.jit(jd.encode_extra)(params, **{k: jnp.asarray(v) for k, v in
                                             raw.items()})
    tx = td.encode_extra(**{k: torch.from_numpy(v) for k, v in raw.items()})
    rng = np.random.default_rng(10)
    mc = rng.random((2, 8, 8, 8, 2)).astype(np.float32)
    bc = rng.random((2, 8, 8, 8, 2)).astype(np.float32)
    oh = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 2)]
    ctx = rng.normal(size=(2, 7, 12)).astype(np.float32)
    jc = jmodel.CondCubes(*map(jnp.asarray, (mc, bc)), extra_cube=jx,
                          class_oh=jnp.asarray(oh), context=jnp.asarray(ctx))
    tc = CondCubes(*map(torch.from_numpy, (mc, bc)), extra_cube=tx,
                   class_oh=torch.from_numpy(oh),
                   context=torch.from_numpy(ctx))
    return jd, params, td, jc, tc


def lift3d_extra():
    """The ``"lift3d"`` config's condition encoders alone (the UNet is the
    LSS config's): the JAX extra cube and the port's."""
    kw = dict(ALT, use_image_cond="lift3d")
    jenc = jmodel.CondEncoders(jmodel.DiffusionConfig(**kw,
                                                      dtype=jnp.float32))
    raw = raw_conditions()
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    shapes = jax.eval_shape(lambda r: jenc.init(r, **jraw),
                            jax.random.PRNGKey(1))
    params = jax.tree.map(jnp.asarray, random_params(
        flax.linen.meta.unbox(shapes), 1))
    ref = jax.jit(jenc.apply)(params, **jraw)
    port = port_of(CondEncoders(DiffusionConfig(**kw, dtype=torch.float32),
                                device="cpu"), params)
    got = port(**{k: torch.from_numpy(v) for k, v in raw.items()})
    return got, ref


@pytest.mark.parametrize("image_cond", ["lss", "lift3d"])
def test_encode_extra_and_denoise(image_cond, lss):
    """The extra cube of every condition; with LSS also the UNet on it
    with the class one-hot and the context (the unrolled middle
    transformer)."""
    jd, params, td, jc, tc = lss
    if image_cond == "lift3d":
        got, ref = lift3d_extra()
    else:
        got, ref = tc.extra_cube, jc.extra_cube
    assert got.shape == (2, 8, 8, 8, 11)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    if image_cond == "lift3d":
        return
    x = np.random.default_rng(4).normal(size=(2, 8, 8, 8, 2)).astype(
        np.float32)
    t = np.array([3, 700])
    ref = np.asarray(jax.jit(jd.denoise)(params, jnp.asarray(x),
                                         jnp.asarray(t), jc))
    with torch.no_grad():
        got = td.denoise(torch.from_numpy(x), torch.from_numpy(t),
                         tc).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, **TOL)


def test_train_loss_and_guided_sample(lss):
    jd, params, td, jc, tc = lss
    lat = np.random.default_rng(5).normal(size=(2, 8, 8, 8, 2)).astype(
        np.float32)
    rng = jax.random.PRNGKey(7)
    ref, _ = jax.jit(jd.train_loss)(params, rng, jnp.asarray(lat), jc)
    # the JAX loss's draws (model.py train_loss)
    r_t, r_n, r_m, r_b = jax.random.split(rng, 4)
    t = jax.random.randint(r_t, (2,), 0, 1000)
    noise = jax.random.normal(r_n, lat.shape)
    keys = [r_m, r_b, *jax.random.split(jax.random.fold_in(r_m, 1), 3)]
    drop = [torch.from_numpy(np.array(jax.random.uniform(k, (2,)) < 0.5))
            for k in keys]
    assert any(d.any() for d in drop) and not all(d.all() for d in drop)
    got, _ = td.train_loss(torch.from_numpy(lat), tc,
                           t=torch.from_numpy(np.asarray(t)),
                           noise=torch.from_numpy(np.asarray(noise)),
                           drop=tuple(drop))
    np.testing.assert_allclose(float(got), float(ref), **TOL)

    srng = jax.random.PRNGKey(3)
    ref = np.asarray(jd.sample(params, srng, jc, num_steps=2,
                               guidance_scale=2.0))
    x_T = np.asarray(jax.random.normal(jax.random.split(srng)[0], ref.shape))
    got = td.sample(tc, num_steps=2, guidance_scale=2.0,
                    noise=torch.from_numpy(x_T)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("layout", ["scanned", "unrolled"])
def test_middle_transformer_layouts_load(layout, lss):
    """Scan-stacked ``blocks`` (no context) and unrolled ``block{i}`` (a
    context) both load strictly, each block's weights from its own slice
    or entry; the unrolled UNet computes the JAX one in
    ``test_encode_extra_and_denoise[lss]``, the scanned one in
    ``tests/test_torch_diffusion*.py``."""
    if layout == "unrolled":
        _, params, td, _, _ = lss
        mt = params["params"]["unet"]["middle_transformer"]
        assert {"block0", "block1"} <= set(mt) and "blocks" not in mt
        assert {"cross_q", "cross_k", "cross_v", "cross_o"} <= \
            set(mt["block0"])
        blocks = td.unet.middle_transformer.blocks
        assert blocks[1].cross
        kernels = [mt[f"block{i}"]["self_q"]["kernel"] for i in range(2)]
    else:
        kw = dict(ALT, use_semantic_cond=False, use_single_scan_cond=False,
                  num_classes=0, context_dim=None)
        jd = jmodel.VoxelDiffusion(jmodel.DiffusionConfig(
            **kw, dtype=jnp.float32))
        params = init_jax_model(jd, 2)
        mt = params["params"]["middle_transformer"]
        assert "blocks" in mt and "block0" not in mt
        td = VoxelDiffusion(DiffusionConfig(**kw, dtype=torch.float32),
                            device="cpu")
        td.load_params(diffusion_from_jax(params))        # strict
        blocks = td.unet.middle_transformer.blocks
        assert not blocks[1].cross
        (body,) = mt["blocks"].values()
        kernels = list(body["self_q"]["kernel"])
    for blk, k in zip(blocks, kernels, strict=True):
        np.testing.assert_array_equal(blk.self_q.weight.detach().numpy(),
                                      np.asarray(k).T)
