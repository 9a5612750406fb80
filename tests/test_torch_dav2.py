"""Port parity: the frozen GSM towers (``infinicube_tpu_torch.models.gsm``
``dav2`` and ``convnext``) and the resize helper against the JAX package.

- ``encoders.resize`` against ``jax.image.resize`` at the shapes the towers
  resize at: the antialiased bilinear downsample of 480x832 frames to the
  252x336 target, the antialiased bicubic (Keys, a = -0.5) of the 37x37
  position table to 18x24, and the tiny test shapes.
- The tiny ``DAv2Config``'s features, the DINOv2 backbone's taps and the
  tiny ConvNeXt tower, JAX forward against the port's on the same inputs
  with the JAX parameters carried over by ``weights.from_jax``, at atol /
  rtol 2e-3 (the f32 gate of tests/test_wan_torch_parity.py).
- The "dav2" and "dino" encoder kinds build and run, the tower without
  gradient.
- A tiny GSM with ``encoders=("conv", "dav2")``: its encoder's features
  against JAX, its refiner's gradients against ``jax.grad`` within the same
  gate, and no gradient on the tower. The whole GSM's forward with that
  encoder is held in tests/test_torch_e2e.py, whose chain runs it.
Parameters are drawn with numpy from a seed over the JAX modules' shapes.
The HuggingFace converters are held in tests/test_torch_segformer.py,
which imports ``transformers`` once for all the towers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.gsm import convnext as jconv
from infinicube_tpu.models.gsm import dav2 as jdav2
from infinicube_tpu.models.gsm.encoders import UnifiedEncoder as JEncoder
from infinicube_tpu.models.gsm.encoders import \
    UnifiedEncoderConfig as JEncCfg
from infinicube_tpu_torch.models.gsm import convnext as tconv
from infinicube_tpu_torch.models.gsm import dav2 as tdav2
from infinicube_tpu_torch.models.gsm import model as tm
from infinicube_tpu_torch.models.gsm.encoders import (UnifiedEncoder,
                                                      UnifiedEncoderConfig,
                                                      resize, resize_weights)
from infinicube_tpu_torch.weights.from_jax import gsm_from_jax, gsm_to_jax
from tests.test_gsm import make_batch, tiny_cfg
from tests.test_torch_gsm import port_batch, port_tiny_cfg

TOL = dict(atol=2e-3, rtol=2e-3)
TINY_HW = (28, 42)        # the tiny tower's target: a 2 x 3 patch grid


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch thread for the module: the suite runs files in parallel
    workers, and a thread per core in each of them oversubscribes the
    machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draw_params(shapes, seed=0):
    """Numpy parameters over a flax parameter tree of shapes: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), everything else
    N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def init_numpy(module, *args, seed=0):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    return draw_params(shapes, seed)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,hw,method", [
    ((2, 480, 832, 3), (252, 336), "bilinear"),    # frames -> DAv2 target
    ((1, 37, 37, 384), (18, 24), "bicubic"),       # vits position table
    ((2, 40, 56, 3), TINY_HW, "bilinear"),         # tiny frames -> target
    ((1, 5, 5, 32), (2, 3), "bicubic"),            # tiny position table
], ids=["frames-480x832", "pos-37x37", "frames-tiny", "pos-tiny"])
def test_resize_matches_jax(shape, hw, method):
    """Frames are images in [0, 1], as the encoders take them; the position
    tables N(0, 1). The port is also held within 1e-6 of the f64 result of
    the same weights (jax's own CPU contraction is 1.5e-5 off it at the
    480x832 frames when they are N(0, 1))."""
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=shape) if shape[-1] == 3
         else rng.normal(size=shape)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x),
                                       (shape[0],) + hw + shape[-1:],
                                       method))
    got = resize(nchw(x), hw, method).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-5
    exact = np.einsum("bhwc,hH,wW->bHWc", x.astype(np.float64),
                      resize_weights(shape[1], hw[0], method),
                      resize_weights(shape[2], hw[1], method),
                      optimize=True)
    assert np.abs(got - exact).max() <= 1e-6


# ---------------------------------------------------------------------------
# towers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dav2_run():
    jcfg = jdav2.DAv2Config.tiny()
    x = np.random.default_rng(1).normal(size=(2,) + TINY_HW + (3,)).astype(
        np.float32)
    jm = jdav2.DepthAnythingFeatures(jcfg)
    params = init_numpy(jm, jnp.asarray(x))
    want = [np.asarray(o) for o in jax.jit(jm.apply)(params, jnp.asarray(x))]
    model = tdav2.DepthAnythingFeatures(tdav2.DAv2Config.tiny())
    model.load_state_dict(gsm_from_jax(params))
    with torch.inference_mode():
        got = [o.permute(0, 2, 3, 1).numpy()
               for o in model(torch.from_numpy(x))]
    return want, got


def test_dav2_features_match_jax(dav2_run):
    """All four fusion maps, on a 2 x 3 patch grid (the 5 x 5 position
    table resized by the bicubic)."""
    want, got = dav2_run
    assert [w.shape for w in want] == [g.shape for g in got]
    assert got[-1].shape == (2, 16, 24, 16)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, **TOL)


def test_dinov2_backbone_taps_match_jax():
    cfg = dict(hidden_size=32, num_layers=2, num_heads=2, out_indices=(1, 2),
               pos_tokens=(70 // 14) ** 2)
    x = np.random.default_rng(2).normal(size=(1,) + TINY_HW + (3,)).astype(
        np.float32)
    jm = jdav2.Dinov2Backbone(jdav2.DAv2Config(**cfg))
    params = init_numpy(jm, jnp.asarray(x), seed=3)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    model = tdav2.Dinov2Backbone(tdav2.DAv2Config(**cfg))
    model.load_state_dict(gsm_from_jax(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_convnext_tower_matches_jax():
    x = np.random.default_rng(4).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    jm = jconv.ConvNextTower(jconv.ConvNextConfig.tiny_test())
    params = init_numpy(jm, jnp.asarray(x), seed=5)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    model = tconv.ConvNextTower(tconv.ConvNextConfig.tiny_test())
    model.load_state_dict(gsm_from_jax(params))
    with torch.inference_mode():
        got = model(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# the "dav2" and "dino" encoder kinds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dav2", "dino"])
def test_unified_encoder_frozen_kinds_build_and_run(kind):
    cfg = UnifiedEncoderConfig(
        encoders=("conv", kind), conv_width=8, dav2_width=8, dino_width=8,
        dav2_target_hw=TINY_HW, dino_target_hw=TINY_HW,
        dav2_config=tdav2.DAv2Config.tiny(),
        dino_config=tdav2.DAv2Config.tiny())
    enc = UnifiedEncoder(cfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if name.endswith("weight") and p.ndim > 1:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
    images = torch.rand(1, 2, 32, 48, 3, generator=gen)
    out = enc(images, torch.ones(1, 2, 32, 48, 4))
    assert out["features"].shape == (1, 2, 32, 48, 16)
    assert torch.isfinite(out["features"]).all()
    tower = enc.dav2.features if kind == "dav2" else enc.dino.backbone
    assert out["features"].requires_grad
    out["features"].sum().backward()
    assert all(p.grad is None for p in tower.parameters())
    assert getattr(enc, kind).up0.weight.grad is not None


def dav2_gsm_cfgs():
    """The tiny GSM with ``encoders=("conv", "dav2")``: (JAX config, port
    config)."""
    enc = dict(encoders=("conv", "dav2"), conv_width=16, dav2_width=8,
               dav2_target_hw=TINY_HW)
    jcfg = tiny_cfg(encoder=JEncCfg(**enc,
                                    dav2_config=jdav2.DAv2Config.tiny()))
    tcfg = port_tiny_cfg(encoder=UnifiedEncoderConfig(
        **enc, dav2_config=tdav2.DAv2Config.tiny()))
    return jcfg, tcfg


def dav2_gsm_params(tcfg, seed=7):
    """Numpy parameters over the flax tree of the port's GSM
    (``gsm_to_jax``), drawn as ``draw_params`` draws them."""
    return draw_params(gsm_to_jax(tm.GSM(tcfg)), seed=seed)


def test_gsm_dav2_encoder_matches_jax_and_trains_only_its_refiner():
    """The encoder of a tiny GSM built with ``encoders=("conv", "dav2")``
    (the whole GSM's forward with it is held in tests/test_torch_e2e.py,
    whose chain runs it): its parameter tree against flax's, its features
    against the JAX GSM's encoder, and the gradients of a fixed random
    projection of them on the refiner (``encoder/dav2/up0``-``up2``)
    against ``jax.grad`` at 2e-3 of each tensor's largest value, with
    None on the tower (JAX's ``stop_gradient``). One JAX trace gives both
    the features and the gradients."""
    jcfg, tcfg = dav2_gsm_cfgs()
    b = make_batch()
    model = tm.GSM(tcfg)
    je = JEncoder(jcfg.encoder)
    images, masks = b["images"][None], b["masks"][None]
    enc_shapes = jax.eval_shape(lambda: je.init(jax.random.PRNGKey(0),
                                                images, masks))
    tree = gsm_to_jax(model)
    assert jax.tree.structure(tree["params"]["encoder"]) == \
        jax.tree.structure(enc_shapes["params"])
    for a, e in zip(jax.tree.leaves(tree["params"]["encoder"]),
                    jax.tree.leaves(enc_shapes["params"])):
        assert a.shape == e.shape
    params = draw_params(tree, seed=7)
    jp = {"params": params["params"]["encoder"]}
    wf = np.random.default_rng(8).normal(
        size=images.shape[:-1] + (24,)).astype(np.float32)

    def loss(p):
        f = je.apply(p, images, masks)["features"]
        return jnp.sum(f * wf), f

    jgrad, want = jax.jit(jax.grad(loss, has_aux=True))(jp)
    jgrad = jgrad["params"]["dav2"]
    model.load_state_dict(gsm_from_jax(params))
    tb = port_batch(b)
    feats = model.encoder(tb["images"][None], tb["masks"][None])["features"]
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(want),
                               **TOL)
    (feats * torch.from_numpy(wf)).sum().backward()
    enc = model.encoder.dav2
    assert all(p.grad is None for p in enc.features.parameters())
    for name in ("up0", "up1", "up2"):
        for leaf, jleaf in (("weight", "kernel"), ("bias", "bias")):
            got = getattr(getattr(enc, name), leaf).grad.numpy()
            w = np.asarray(jgrad[name][jleaf])
            w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w
            scale = np.abs(w).max()
            assert scale > 0, (name, leaf)
            np.testing.assert_allclose(got, w, atol=2e-3 * scale, rtol=0,
                                       err_msg=f"{name}.{leaf}")
