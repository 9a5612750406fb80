"""Port parity: the SegFormer sky segmenter
(``infinicube_tpu_torch.models.gsm.segformer``), stage 3's
``--segformer-ckpt`` path, and the HuggingFace converters of every frozen
tower, against the JAX package.

- ``encoders.resize`` against ``jax.image.resize`` at SegFormer's shapes:
  the decoder's upsample of each stage's map to stage 0's 120x208 (a
  480x832 frame) and the logits' upsample to 480x832.
- The tiny SegFormer's logits, JAX forward against the port's with the JAX
  parameters carried over by ``weights.from_jax.gsm_from_jax``, at
  atol / rtol 2e-3; the sky masks equal except at pixels where the top two
  upsampled logits lie within 1e-4, which are counted.
- The sky segmenter, ``segment_sky`` on an HF-layout ``.pth`` and the CLI's
  ``--segformer-ckpt`` wiring; ``load_torch_state_dict``'s refusals.
- ``convert_*_hf`` of one random ``transformers`` model of each tower
  (SegFormer, DAv2, DINOv2, ConvNeXt) equals ``from_jax`` of the JAX
  converter's tree, exactly."""

import importlib.util
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.gsm import convnext as jconv
from infinicube_tpu.models.gsm import dav2 as jdav2
from infinicube_tpu.models.gsm import segformer as jseg
from infinicube_tpu_torch.inference import scene_gaussian_generation as sgg
from infinicube_tpu_torch.models.gsm import convnext as tconv
from infinicube_tpu_torch.models.gsm import dav2 as tdav2
from infinicube_tpu_torch.models.gsm import segformer as tseg
from infinicube_tpu_torch.models.gsm.encoders import resize
from infinicube_tpu_torch.weights import convert as tconvert
from infinicube_tpu_torch.weights.from_jax import gsm_from_jax
from tests.test_torch_dav2 import draw_params, nchw

TOL = dict(atol=2e-3, rtol=2e-3)
HW = (64, 96)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch thread for the module: the suite runs files in parallel
    workers, and a thread per core in each of them oversubscribes the
    machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def transformers():
    """``transformers`` with the four model classes these tests build,
    imported with its TensorFlow and scikit-learn support off where this
    process has not imported them yet: these tests build torch models only,
    importing TensorFlow alone takes about 10 s, and scikit-learn (which
    only HF's assisted generation uses) about 3 s."""
    if importlib.util.find_spec("transformers") is None:
        pytest.skip("transformers is not installed")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")
        import transformers
        import transformers.utils.import_utils as iu
        mp.setattr(iu, "_sklearn_available", False)
        for name in ("SegformerForSemanticSegmentation",
                     "DepthAnythingForDepthEstimation", "Dinov2Model",
                     "ConvNextModel"):
            getattr(transformers, name)
    return transformers


def _numpy_segformer_params(seed=0):
    """Numpy parameters over the tiny JAX SegFormer's shapes, BatchNorm's
    variance kept positive."""
    shapes = jax.eval_shape(lambda: jseg.Segformer(
        jseg.SegformerConfig.tiny()).init(jax.random.PRNGKey(0),
                                          jnp.zeros((1,) + HW + (3,))))
    params = draw_params(shapes, seed)
    p = params["params"]
    p["bn_var"] = 1.0 + np.abs(p["bn_var"])
    return params


@pytest.fixture(scope="module")
def seg_run():
    """The sky class's bias is raised so that it wins on about a third of
    the pixels (random weights would make it win nowhere)."""
    params = _numpy_segformer_params()
    x = np.random.default_rng(1).normal(size=(2,) + HW + (3,)).astype(
        np.float32)
    model = tseg.Segformer(tseg.SegformerConfig.tiny())
    model.load_state_dict(gsm_from_jax(params))
    with torch.inference_mode():
        logits = model(torch.from_numpy(x)).numpy()
    sky = tseg.CITYSCAPES_SKY_ID
    gap = np.delete(logits, sky, -1).max(-1) - logits[..., sky]
    params["params"]["classifier"]["bias"][sky] += np.quantile(gap, 0.33)
    jm = jseg.Segformer(jseg.SegformerConfig.tiny())

    @jax.jit
    def fwd(p, x):
        logits = jm.apply(p, x)
        up = jax.image.resize(logits, logits.shape[:1] + HW
                              + logits.shape[-1:], "bilinear")
        return logits, up, jseg.sky_mask_from_logits(logits, HW)

    want = [np.asarray(a) for a in fwd(params, jnp.asarray(x))]
    model.load_state_dict(gsm_from_jax(params))
    with torch.inference_mode():
        logits = model(torch.from_numpy(x))
        mask = tseg.sky_mask_from_logits(logits, HW)
    return dict(params=params, x=x, want=want, logits=logits.numpy(),
                mask=mask.numpy())


@pytest.mark.parametrize("shape", [(1, 15, 26, 256), (1, 60, 104, 256),
                                   (1, 120, 208, 19)],
                         ids=["stage3-to-stage0", "stage1-to-stage0",
                              "logits-to-frame"])
def test_resize_matches_jax_at_segformer_shapes(shape):
    hw = (480, 832) if shape[-1] == 19 else (120, 208)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x),
                                       (shape[0],) + hw + shape[-1:],
                                       "bilinear"))
    got = resize(nchw(x), hw, "bilinear").permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-5


def test_segformer_logits_match_jax(seg_run):
    want = seg_run["want"][0]
    assert seg_run["logits"].shape == want.shape == (2, 16, 24, 19)
    np.testing.assert_allclose(seg_run["logits"], want, **TOL)


def test_sky_masks_equal_except_at_near_ties(seg_run):
    _, up, want = seg_run["want"]
    got = seg_run["mask"]
    assert got.dtype == np.uint8 and got.shape == want.shape == (2,) + HW
    top2 = np.sort(up, -1)[..., -2:]
    ties = (top2[..., 1] - top2[..., 0]) <= 1e-4
    differ = got != want
    assert not (differ & ~ties).any()
    assert differ.sum() <= ties.sum() <= 0.01 * ties.size
    assert 0.2 < want.mean() < 0.5


def test_sky_segmenter_matches_the_jax_one(seg_run):
    from infinicube_tpu.data_process.generate_additional_attributes import \
        make_segformer_sky_segmenter as jmake
    img = (np.random.default_rng(2).uniform(size=HW + (3,)) * 255).astype(
        np.uint8)
    want = jmake(seg_run["params"], jseg.SegformerConfig.tiny())(img)
    seg = tseg.make_segformer_sky_segmenter(
        gsm_from_jax(seg_run["params"]), tseg.SegformerConfig.tiny(),
        device="cpu")
    got = seg(img)
    assert got.shape == HW and got.dtype == np.uint8
    assert (got != want).mean() <= 0.01
    np.testing.assert_array_equal(seg.batch(np.stack([img, img])),
                                  np.stack([got, got]))


def _hf_segformer(transformers):
    torch.manual_seed(0)
    hcfg = transformers.SegformerConfig(
        num_channels=3, num_encoder_blocks=4, depths=[1, 1, 1, 1],
        sr_ratios=[8, 4, 2, 1], hidden_sizes=[8, 16, 24, 32],
        patch_sizes=[7, 3, 3, 3], strides=[4, 2, 2, 2],
        num_attention_heads=[1, 2, 3, 4], mlp_ratios=[4, 4, 4, 4],
        decoder_hidden_size=16, num_labels=19, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, classifier_dropout_prob=0.0,
        drop_path_rate=0.0)
    return transformers.SegformerForSemanticSegmentation(hcfg).eval()


def test_segformer_ckpt_gives_sky_masks(transformers, tmp_path,
                                        monkeypatch):
    """An HF-layout ``.pth`` of a random tiny SegFormer: ``segment_sky``
    masks the frames, and the CLI's ``--segformer-ckpt`` puts them into the
    scene's data as ``sky_seg`` (the reconstruction itself is stubbed)."""
    hf = _hf_segformer(transformers)
    ckpt = tmp_path / "segformer.pth"
    torch.save(hf.state_dict(), ckpt)
    video = np.random.default_rng(3).uniform(size=(3,) + HW + (3,)).astype(
        np.float32)
    masks = sgg.segment_sky(video, str(ckpt), "tiny", device="cpu",
                            chunk=2)
    assert masks.shape == (3,) + HW and masks.dtype == np.uint8
    with torch.no_grad():
        ref = hf(torch.from_numpy(((video - np.array(tseg.IMAGENET_MEAN))
                                   / np.array(tseg.IMAGENET_STD)).astype(
            np.float32)).permute(0, 3, 1, 2)).logits
    ref = tseg.sky_mask_from_logits(ref.permute(0, 2, 3, 1), HW).numpy()
    assert (masks != ref).mean() <= 0.01

    seen = {}

    def stub(data, **kw):
        seen.update(data)
        raise KeyboardInterrupt

    monkeypatch.setattr(sgg, "load_buffer_folder",
                        lambda *a, **k: {"video": video})
    monkeypatch.setattr(sgg, "reconstruct_scene", stub)
    with pytest.raises(KeyboardInterrupt):
        sgg.main(["--buffer_folder", str(tmp_path), "--output",
                  str(tmp_path), "--segformer-ckpt", str(ckpt),
                  "--segformer-variant", "tiny", "--device", "cpu"])
    np.testing.assert_array_equal(seen["sky_seg"], masks)


def test_load_torch_state_dict_refuses_msgpack_and_missing_safetensors(
        tmp_path, monkeypatch):
    sd = {"w": torch.arange(3.0)}
    torch.save({"state_dict": sd}, tmp_path / "a.pth")
    got = tconvert.load_torch_state_dict(tmp_path / "a.pth")
    assert torch.equal(got["w"], sd["w"])
    with pytest.raises(ValueError, match="from_jax"):
        tconvert.load_torch_state_dict(tmp_path / "a.msgpack")
    # a missing safetensors package no longer matters: the port reads the
    # format itself, and a missing file raises as any missing file does
    monkeypatch.setitem(sys.modules, "safetensors", None)
    with pytest.raises(FileNotFoundError):
        tconvert.load_torch_state_dict(tmp_path / "a.safetensors")


# ---------------------------------------------------------------------------
# HuggingFace converters
# ---------------------------------------------------------------------------

def _hf_dinov2_config(transformers, **kw):
    return transformers.Dinov2Config(
        hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
        intermediate_size=128, patch_size=14, image_size=70, **kw)


def _hf_model(transformers, kind):
    torch.manual_seed(0)
    if kind == "segformer":
        return _hf_segformer(transformers)
    if kind == "dav2":
        bc = _hf_dinov2_config(
            transformers, out_indices=[1, 2, 3, 4],
            out_features=["stage1", "stage2", "stage3", "stage4"],
            reshape_hidden_states=False)
        hcfg = transformers.DepthAnythingConfig(
            backbone_config=bc, fusion_hidden_size=16,
            neck_hidden_sizes=[8, 12, 16, 16], patch_size=14,
            reassemble_hidden_size=32, reassemble_factors=[4, 2, 1, 0.5])
        return transformers.DepthAnythingForDepthEstimation(hcfg).eval()
    if kind == "dinov2":
        return transformers.Dinov2Model(_hf_dinov2_config(
            transformers, hidden_act="gelu", use_swiglu_ffn=False)).eval()
    return transformers.ConvNextModel(transformers.ConvNextConfig(
        depths=[1, 1, 2, 1], hidden_sizes=[8, 12, 16, 24],
        num_channels=3)).eval()


def _converters(kind):
    """(port converter, JAX converter, from_jax, port module, configs)."""
    if kind == "segformer":
        return (tseg.convert_segformer_hf, jseg.convert_segformer_hf,
                gsm_from_jax, tseg.Segformer,
                tseg.SegformerConfig.tiny(), jseg.SegformerConfig.tiny())
    if kind == "convnext":
        return (tconv.convert_convnext_hf, jconv.convert_convnext_hf,
                gsm_from_jax, tconv.ConvNextTower,
                tconv.ConvNextConfig.tiny_test(),
                jconv.ConvNextConfig.tiny_test())
    if kind == "dav2":
        return (tdav2.convert_dav2_hf, jdav2.convert_dav2_hf, gsm_from_jax,
                tdav2.DepthAnythingFeatures, tdav2.DAv2Config.tiny(),
                jdav2.DAv2Config.tiny())
    return (tdav2.convert_dinov2_hf, jdav2.convert_dinov2_hf, gsm_from_jax,
            tdav2.Dinov2Backbone, tdav2.DAv2Config.tiny(),
            jdav2.DAv2Config.tiny())


@pytest.mark.parametrize("kind", ["segformer", "dav2", "dinov2", "convnext"])
def test_convert_hf_equals_from_jax_of_the_jax_converter(transformers, kind):
    """The port's converter and the JAX one agree exactly on one random HF
    model, and the result loads into the port's module. HF's first DAv2
    fusion layer carries a ``residual_layer1`` that its forward never calls
    and flax's module lacks: the JAX converter copies it, the port's leaves
    it out; those are the only keys apart."""
    sd = _hf_model(transformers, kind).state_dict()
    port, ref, from_jax, module, cfg, jcfg = _converters(kind)
    got = port(sd, cfg)
    want = from_jax(ref(sd, jcfg))
    extra = set(want) - set(got)
    assert all(k.startswith("fusion0.residual_layer1.") for k in extra)
    assert len(extra) == (4 if kind == "dav2" else 0)
    module = module(cfg)
    assert set(got) == set(module.state_dict())
    for k, v in got.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    module.load_state_dict(got)
