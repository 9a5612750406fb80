"""Port parity for the GSM's parts: the image encoders (conv, patch ViT,
Plucker, ConvNeXt) and the unified encoder's masks, the sky models (the
top-k over tied sky ratios included), the lifter (splat and DDA routes,
finite gradients with behind-camera points) and ``utils/sky_math``, each
against the JAX module on the same inputs (numpy, seeded) and the same
weights (a random JAX init carried over by ``gsm_from_jax``). f32 at
atol/rtol 2e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.grid import grid_from_points as j_grid_from_points
from infinicube_tpu.models.gsm import convnext as jcn
from infinicube_tpu.models.gsm import encoders as jenc
from infinicube_tpu.models.gsm import lifter as jlift
from infinicube_tpu.models.gsm import sky as jsky
from infinicube_tpu.utils import sky_math as jsm
from infinicube_tpu_torch.grid.build import grid_from_points
from infinicube_tpu_torch.models.gsm import convnext as tcn
from infinicube_tpu_torch.models.gsm import encoders as tenc
from infinicube_tpu_torch.models.gsm import lifter as tlift
from infinicube_tpu_torch.models.gsm import sky as tsky
from infinicube_tpu_torch.utils import sky_math as tsm
from infinicube_tpu_torch.weights.from_jax import gsm_from_jax
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-3, rtol=2e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _port(module, params):
    module.load_state_dict(gsm_from_jax(_np(params)))
    return module.eval()


def _cameras(hw, n=2):
    """FLU world, cameras 1.5 m up looking +x (OpenCV camera frame), the
    second shifted off the voxel lattice."""
    h, w = hw
    T = np.eye(4, dtype=np.float32)
    T[:3, 0] = [0, -1, 0]
    T[:3, 1] = [0, 0, -1]
    T[:3, 2] = [1, 0, 0]
    T[:3, 3] = [0.013, 0.021, 1.507]
    poses = [T]
    for i in range(1, n):
        T2 = T.copy()
        T2[:3, 3] = [0.9 + 0.37 * i, 0.47 - 0.21 * i, 1.53]
        poses.append(T2)
    K = np.array([[40.3, 0, w / 2 + 0.17], [0, 40.1, h / 2 - 0.09],
                  [0, 0, 1]], np.float32)
    return np.stack([K] * n), np.stack(poses)


def _images(shape, seed=0):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


# ---------------------------------------------------------------- encoders

def _encoder_case(jmod, tmod, *args):
    p = jax.jit(jmod.init)(jax.random.PRNGKey(0), *args)
    want = jax.jit(jmod.apply)(p, *args)
    with torch.inference_mode():
        got = _port(tmod, p)(*(None if a is None else _t(a) for a in args))
    return got, want


def test_conv_encoder_matches():
    x = _images((2, 16, 24, 3))
    got, want = _encoder_case(jenc.ConvEncoder(16), tenc.ConvEncoder(16), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_patch_vit_encoder_matches():
    x = _images((1, 16, 24, 3), 1)
    got, want = _encoder_case(
        jenc.PatchViTEncoder(16, patch=4, depth=1, num_heads=2),
        tenc.PatchViTEncoder(16, patch=4, depth=1, num_heads=2,
                             num_patches=24), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plucker_encoder_matches():
    x = _images((2, 16, 24, 3), 2)
    Ks, poses = _cameras((16, 24))
    got, want = _encoder_case(jenc.PluckerConvPatchEncoder(8, 4),
                              tenc.PluckerConvPatchEncoder(8, 4), x, Ks,
                              poses)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_convnext_feature_encoder_matches():
    cfg_j = jcn.ConvNextConfig.tiny_test()
    cfg_t = tcn.ConvNextConfig.tiny_test()
    x = _images((1, 64, 96, 3), 3)
    got, want = _encoder_case(jcn.ConvNextFeatureEncoder(8, cfg_j),
                              tcn.ConvNextFeatureEncoder(8, cfg_t), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unified_encoder_features_and_masks():
    x = _images((1, 2, 16, 24, 3), 4)
    rng = np.random.default_rng(5)
    masks = (rng.uniform(size=(1, 2, 16, 24, 4)) > 0.3).astype(np.float32)
    Ks, poses = _cameras((16, 24))
    cj = jenc.UnifiedEncoderConfig(encoders=("conv", "plucker"),
                                   conv_width=8, plucker_width=8,
                                   plucker_patch=4)
    ct = tenc.UnifiedEncoderConfig(encoders=("conv", "plucker"),
                                   conv_width=8, plucker_width=8,
                                   plucker_patch=4)
    args = (x, masks, Ks[None], poses[None])
    got, want = _encoder_case(jenc.UnifiedEncoder(cj),
                              tenc.UnifiedEncoder(ct), *args)
    np.testing.assert_allclose(got["features"].numpy(),
                               np.asarray(want["features"]), **TOL)
    for k in ("sky_mask", "effective_mask", "midground"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("kind", ["dav2", "dino"])
def test_frozen_tower_kinds_raise(kind):
    """A frozen tower kind beside a kind the reference lacks raises (the
    frozen kinds themselves build: test_frozen_tower_kinds_build)."""
    with pytest.raises(ValueError, match="unknown encoder kinds"):
        tenc.UnifiedEncoder(tenc.UnifiedEncoderConfig(
            encoders=(kind, f"{kind}_v3")))


@pytest.mark.parametrize("kind", ["dav2", "dino"])
def test_frozen_tower_kinds_build(kind):
    """The frozen tower kinds build (their parity is in
    tests/test_torch_dav2.py)."""
    from infinicube_tpu_torch.models.gsm.dav2 import DAv2Config
    enc = tenc.UnifiedEncoder(tenc.UnifiedEncoderConfig(
        encoders=(kind,), dav2_config=DAv2Config.tiny(),
        dino_config=DAv2Config.tiny()))
    assert hasattr(enc, kind)


# -------------------------------------------------------------------- sky

def test_top_k_keeps_lower_indices_among_ties():
    x = np.array([1.0, 0.0, 1.0, 1.0, 0.5, 1.0, 0.75, 1.0], np.float32)
    for k in (3, 5, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tsky.top_k_stable(_t(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_sky_modulator_matches_with_tied_patches():
    """3 views of 32x48 with patch 8: 72 patches, 40 of them all sky
    (ratio 1.0), and 16 kept: which 16 is decided by the tie order."""
    cj = jsky.SkyConfig(embed_dim=32, num_layers=2, num_heads=2, patch=8,
                        max_sky_tokens=16)
    ct = tsky.SkyConfig(embed_dim=32, num_layers=2, num_heads=2, patch=8,
                        max_sky_tokens=16)
    V, h, w = 3, 32, 48
    images = _images((V, h, w, 3), 6)
    sky = np.zeros((V, h, w), bool)
    sky[:, :16] = True                      # 2 patch rows x 6 x 3 views
    sky[1, 16:24, :40] = True               # one more row, partly
    sky[2, 16:20] = True                    # half-sky patches
    Ks, poses = _cameras((h, w), V)
    from infinicube_tpu.camera import projection as jproj
    dirs = np.stack([np.asarray(jproj.posed_rays_from_intrinsics(
        jnp.asarray(K), jnp.asarray(p), (h, w))[1])
        for K, p in zip(Ks, poses)])
    sample = np.random.default_rng(7).normal(size=(5, 7, 3)).astype(
        np.float32)
    jm = jsky.SkyboxMlpModulator(cj)
    args = (images, sky, dirs, sample)
    p = jax.jit(jm.init)(jax.random.PRNGKey(1), *args)
    rgb_j, tok_j = jax.jit(jm.apply)(p, *args)
    tm = _port(tsky.SkyboxMlpModulator(ct), p)
    with torch.inference_mode():
        rgb_t, tok_t = tm(*(_t(a) for a in args))
    np.testing.assert_allclose(tok_t.numpy(), np.asarray(tok_j), **TOL)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), **TOL)
    # the token depends on which tied patches are kept
    with torch.inference_mode():
        perm = tm.encode(_t(images[::-1]), _t(sky[::-1]), _t(dirs[::-1]))
    assert (perm - tok_t).abs().max() > 1e-4


def test_sky_panorama_and_null_match():
    cj, ct = jsky.SkyConfig(pano_hw=(8, 16)), tsky.SkyConfig(pano_hw=(8, 16))
    dirs = np.random.default_rng(8).normal(size=(6, 5, 3)).astype(np.float32)
    jm = jsky.SkyboxPanorama(cj)
    p = jm.init(jax.random.PRNGKey(0), dirs)
    p = jax.tree.map(lambda a: jnp.asarray(
        np.random.default_rng(9).uniform(size=a.shape), a.dtype), p)
    want = jm.apply(p, dirs)
    with torch.inference_mode():
        got = _port(tsky.SkyboxPanorama(ct), p)(_t(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    null = tsky.SkyboxNull((0.1, 0.2, 0.3))(_t(dirs))
    np.testing.assert_allclose(null.numpy(), np.asarray(
        jsky.SkyboxNull((0.1, 0.2, 0.3)).apply({}, dirs)))


# ------------------------------------------------------------------ lifter

@pytest.fixture(scope="module")
def scene():
    """A ground sheet and a wall, 0.4 m voxels, two cameras off the
    lattice, random features."""
    rng = np.random.default_rng(10)
    n = 3000
    ground = np.stack([rng.uniform(3, 16, n // 2), rng.uniform(-5, 5, n // 2),
                       np.zeros(n // 2)], -1)
    wall = np.stack([np.full(n - n // 2, 14.0),
                     rng.uniform(-5, 5, n - n // 2),
                     rng.uniform(0, 4, n - n // 2)], -1)
    pts = np.concatenate([ground, wall]).astype(np.float32)
    jgrid = j_grid_from_points(jnp.asarray(pts)[None],
                               jnp.ones((1, n), bool), 0.4, 0.2,
                               capacity=4096)
    tgrid = grid_from_points(_t(pts)[None], torch.ones((1, n), dtype=bool),
                             0.4, 0.2, capacity=4096)
    np.testing.assert_array_equal(tgrid.keys.numpy(), np.asarray(jgrid.keys))
    hw = (32, 48)
    Ks, poses = _cameras(hw)
    feats = _images((2,) + hw + (8,), 11)
    return jgrid, tgrid, Ks, poses, feats


BOUNDS = ((-16, -32, -8), (64, 64, 32))


@pytest.mark.parametrize("impl", ["splat", "dda"])
def test_lift_and_visibility_match(scene, impl):
    jgrid, tgrid, Ks, poses, feats = scene
    # jitted: op by op, the JAX lifter takes many times longer on the CPU
    want, vis_j, dj = (np.asarray(a) for a in jax.jit(
        lambda g, f, K, p: (
            jlift.lift_features(g, f, K, p, *BOUNDS, impl=impl),
            jlift.visible_voxel_mask(g, K, p, *BOUNDS, ray_hw=(32, 48),
                                     impl=impl),
            jlift.voxel_depth_prior(g, K, p, *BOUNDS, (32, 48), impl=impl)))(
        jgrid, jnp.asarray(feats), jnp.asarray(Ks), jnp.asarray(poses)))
    got = tlift.lift_features(tgrid, _t(feats), _t(Ks), _t(poses), *BOUNDS,
                              impl=impl)
    hit = np.abs(want).sum(-1) > 0
    assert hit.sum() > 100
    close = np.isclose(got.numpy(), want, **TOL).all(-1)
    assert close.mean() >= 0.999, close.mean()
    vis_t = tlift.visible_voxel_mask(tgrid, _t(Ks), _t(poses), *BOUNDS,
                                     ray_hw=(32, 48), impl=impl).numpy()
    assert vis_j.sum() > 50
    assert (vis_j == vis_t).mean() >= 0.999
    dt = tlift.voxel_depth_prior(tgrid, _t(Ks), _t(poses), *BOUNDS,
                                 (32, 48), impl=impl).numpy()
    assert np.isclose(dt, dj, **TOL).mean() >= 0.999


def test_sample_image_features_matches_with_finite_gradients(scene):
    """Points in front of, beside and behind the cameras: the running max
    over views matches, and the gradient to the image features is finite
    (the uv sanitizing precedes any arithmetic)."""
    _, _, Ks, poses, feats = scene
    rng = np.random.default_rng(12)
    pts = np.stack([rng.uniform(-8, 16, 500), rng.uniform(-6, 6, 500),
                    rng.uniform(-1, 4, 500)], -1).astype(np.float32)
    want = jlift.sample_image_features(jnp.asarray(pts), jnp.asarray(feats),
                                       jnp.asarray(Ks), jnp.asarray(poses))
    f = _t(feats).requires_grad_()
    got = tlift.sample_image_features(_t(pts), f, _t(Ks), _t(poses))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    seen = (np.abs(np.asarray(want)).sum(-1) > 0)
    assert 50 < seen.sum() < 450
    got.square().sum().backward()
    assert torch.isfinite(f.grad).all() and f.grad.abs().sum() > 0
    jg = jax.grad(lambda x: jnp.sum(jlift.sample_image_features(
        jnp.asarray(pts), x, jnp.asarray(Ks), jnp.asarray(poses)) ** 2))(
        jnp.asarray(feats))
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jg), **TOL)


# --------------------------------------------------------------- sky math

def test_sky_math_matches():
    rng = np.random.default_rng(13)
    d = rng.normal(size=(50, 3))
    for fn in ("direction_to_latlong_uv", "direction_to_skylatlong_uv"):
        np.testing.assert_allclose(getattr(tsm, fn)(d),
                                   getattr(jsm, fn)(d), atol=1e-12)
        tt = getattr(tsm, fn)(_t(d.astype(np.float32)))
        assert isinstance(tt, torch.Tensor)
    uv = rng.uniform(size=(40, 2))
    np.testing.assert_allclose(tsm.latlong_uv_to_direction(uv),
                               jsm.latlong_uv_to_direction(uv), atol=1e-12)
    pano = rng.uniform(size=(8, 16, 3))
    for mapping in ("latlong", "skylatlong"):
        np.testing.assert_allclose(
            tsm.sample_panorama(pano, d, mapping),
            jsm.sample_panorama(pano, d, mapping), atol=1e-12)
    faces = rng.uniform(size=(6, 5, 5, 3))
    np.testing.assert_allclose(tsm.sample_cubemap(faces, d),
                               jsm.sample_cubemap(faces, d), atol=1e-12)
    for face in range(6):
        np.testing.assert_allclose(
            tsm.cubemap_face_uv_to_direction(face, uv),
            jsm.cubemap_face_uv_to_direction(face, uv), atol=1e-12)
    fn = lambda x: np.abs(x)  # noqa: E731
    for mapping in ("latlong", "skylatlong"):
        np.testing.assert_allclose(
            tsm.render_panorama(fn, (6, 12), mapping),
            jsm.render_panorama(fn, (6, 12), mapping))


def test_skybox_files_render_as_the_reference(tmp_path):
    """read_skybox + render_sky_api for a panorama, a cubemap and a sky
    modulator saved beside a gaussian file."""
    rng = np.random.default_rng(14)
    pose = np.eye(4)
    pose[:3, :3] = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
    cases = {}
    pano = tmp_path / "a.ply"
    np.savez(tmp_path / "a_pano.npz",
             panorama=rng.uniform(size=(8, 32, 3)).astype(np.float32))
    cases["rgb_panorama"] = pano
    cube = tmp_path / "b.ply"
    np.savez(tmp_path / "b_cubemap.npz",
             faces=rng.uniform(size=(6, 4, 4, 3)).astype(np.float32))
    cases["rgb_cubemap"] = cube
    mod = tmp_path / "c.ply"
    jm = jsky.SkyboxMlpModulator(jsky.SkyConfig())
    dirs = np.zeros((2, 3), np.float32)
    tok = rng.normal(size=(192,)).astype(np.float32)
    p = jax.jit(lambda: jm.init(jax.random.PRNGKey(2), tok, dirs,
                                method=jsky.SkyboxMlpModulator.sample))()
    np.save(tmp_path / "c_sky_token.npy", tok)
    np.savez(tmp_path / "c_modulator.npz",
             params=np.array(_np(p["params"]), dtype=object))
    cases["sky_modulator"] = mod
    for kind, path in cases.items():
        sj, st = jsm.read_skybox(path), tsm.read_skybox(path)
        assert sj["type"] == st["type"] == kind
        np.testing.assert_allclose(
            tsm.render_sky_api(st, pose, 12, 20, 60.0, 90.0),
            jsm.render_sky_api(sj, pose, 12, 20, 60.0, 90.0), **TOL)
