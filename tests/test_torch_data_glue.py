"""The port's training data glue against the JAX package's on one small
synthetic clip (converted and processed by the port): the first batch of
``vae_batches``, ``diffusion_batches`` (JAX weights carried across by
``weights/from_jax``, the JAX draws injected), ``scale_by_std`` and
``gsm_batches`` on the same samples, grids and labels exact, floats within
2e-3; ``TestRecorder`` and the captions against the JAX ones."""

import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.data.specs import DatasetSpec as JSpec
from infinicube_tpu.models.diffusion import model as jdm
from infinicube_tpu.models.vae import sunet as jsunet
from infinicube_tpu.training import data_glue as jglue
from infinicube_tpu_torch.data import waymo_dataset as twd
from infinicube_tpu_torch.data_process import (
    generate_additional_attributes as tga)
from infinicube_tpu_torch.data_process import waymo2shards as tw2s
from infinicube_tpu_torch.models.diffusion import model as tdm
from infinicube_tpu_torch.models.vae import sunet as tsunet
from infinicube_tpu_torch.training import data_glue as tglue
from infinicube_tpu_torch.weights.from_jax import sparse_vae_from_jax
from tests.test_torch_sparse_vae import random_params

import torch_clip

TOL = dict(rtol=2e-3, atol=2e-3)
CROP = dict(crop_bbox_min=(-12.8, -12.8, -3.2), crop_bbox_max=(12.8, 12.8, 9.6))
VAE_SMALL = dict(f_maps=8, c_dim=8, sem_embed_dim=8,
                 capacities=(4096, 2048, 1024), neck_dims=(16, 16, 16),
                 neck_ijk_min=(-8, -8, -8),
                 finest_voxel_size=(0.4, 0.4, 0.4),
                 origin=(0.2, 0.2, 0.2), latent_channels=2,
                 dense_lookup_ijk_min=(-36, -36, -20),
                 dense_lookup_dims=(72, 72, 40))
DIFF_SMALL = dict(cube_dims=(16, 16, 16), cube_ijk_min=(-8, -8, -8),
                  latent_voxel_size=(1.6, 1.6, 0.8),
                  latent_origin=(0.8, 0.8, 0.4), latent_channels=2,
                  model_channels=8, channel_mult=(1, 2), attention_ds=(),
                  num_res_blocks=1, num_heads=2, transformer_depth=1,
                  num_map_types=3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return torch_clip.make_root(tmp_path_factory.mktemp("waymo"),
                                tw2s.FrameRecord, tw2s.convert_clip,
                                tga.process_clip, device="cpu")


@pytest.fixture(scope="module")
def samples(root):
    """Two samples of the clip with its three views, as numpy dicts, and
    the same re-keyed for the JAX glue."""
    cfg = twd.WaymoDatasetConfig(root=str(root), frame_start=0, frame_end=4,
                                 samples_per_shard=2,
                                 views=torch_clip.VIEWS, seed=1, **CROP)
    got = list(twd.WaymoClipDataset(cfg))
    assert len(got) == 2
    return got, [{JSpec[k.name]: v for k, v in s.items()} for s in got]


def _keys_equal(tgrids, jgrids):
    for tg, jg in zip(tgrids, jgrids):
        np.testing.assert_array_equal(tg.keys.numpy(),
                                      np.asarray(jg.keys).astype(np.int64))
        np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))


def test_vae_batches_equal_the_jax_ones(samples):
    tsamp, jsamp = samples
    tcfg = tsunet.SparseVAEConfig(**VAE_SMALL)
    jcfg = jsunet.SparseVAEConfig(**VAE_SMALL)
    # a capacity below the samples' points keeps the first ones
    n = min(len(s[JSpec.INPUT_PC]) for s in jsamp) - 100
    tg, ts = next(tglue.vae_batches(tsamp, tcfg, batch_size=2,
                                    point_capacity=n, device="cpu"))
    jg, js = next(jglue.vae_batches(jsamp, jcfg, batch_size=2,
                                    point_capacity=n))
    _keys_equal(tg, jg)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tg[0].mask.sum()) > 1000 and len(set(ts[0].tolist())) > 2


@pytest.fixture(scope="module")
def vae_pair(samples):
    jcfg = jsunet.SparseVAEConfig(**VAE_SMALL)
    jvae = jsunet.SparseStructureVAE(jcfg)
    pts = jnp.zeros((1, 64, 3))
    mask = jnp.ones((1, 64), bool)
    grids = jsunet.build_hash_tree(jcfg, pts, mask)
    shapes = jax.eval_shape(jvae.init, jax.random.PRNGKey(0), grids,
                            jnp.zeros((1, jcfg.capacities[0]), jnp.int32),
                            jax.random.PRNGKey(1))
    params = random_params(flax.linen.meta.unbox(shapes), 3)
    port = tsunet.SparseStructureVAE(tsunet.SparseVAEConfig(**VAE_SMALL),
                                     device="cpu")
    port.load_state_dict(sparse_vae_from_jax(params))
    return jvae, jax.tree.map(jnp.asarray, params), port.eval()


def test_diffusion_batches_and_scale_by_std_equal_the_jax_ones(samples,
                                                               vae_pair,
                                                               tmp_path):
    tsamp, jsamp = samples
    jvae, jparams, tvae = vae_pair
    jdiff = jdm.VoxelDiffusion(jdm.DiffusionConfig(**DIFF_SMALL,
                                                   dtype=jnp.float32))
    tdiff = tdm.VoxelDiffusion(tdm.DiffusionConfig(**DIFF_SMALL,
                                                   dtype=torch.float32),
                               device="cpu")
    rng = jax.random.PRNGKey(4)
    kw = dict(batch_size=2, point_capacity=4096, max_map=256, max_box=8)
    jl, jc = next(jglue.diffusion_batches(
        jsamp, jdiff, jvae, jparams, jsunet.SparseVAEConfig(**VAE_SMALL),
        rng=rng, **kw))
    _, sub = jax.random.split(rng)
    eps = [torch.tensor(np.asarray(jax.random.normal(sub, jl.shape)))]
    tl, tc = next(tglue.diffusion_batches(
        tsamp, tdiff, tvae, tsunet.SparseVAEConfig(**VAE_SMALL), eps=eps,
        **kw))
    assert tl.shape == (2, 16, 16, 16, 2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for f in ("map_cube", "box_cube"):
        got, want = getattr(tc, f).numpy(), np.asarray(getattr(jc, f))
        np.testing.assert_allclose(got, want, **TOL)
        assert np.abs(want).max() > 0, f
    # scale_by_std: 1 / the population std of the first batch, saved
    path = tmp_path / "sf" / "scale_factor.json"
    two = [(tl, tc), (2 * tl, tc)]
    out = list(tglue.scale_by_std(iter(two), save_path=path))
    jout = list(jglue.scale_by_std(iter([(jl, jc), (2 * jl, jc)])))
    sf = json.loads(path.read_text())["scale_factor"]
    np.testing.assert_allclose(sf, 1.0 / float(jnp.std(jl)), rtol=2e-3)
    assert sf == pytest.approx(1.0 / float(tl.std(correction=0)))
    for (a, _), (b, _) in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_gsm_batches_equal_the_jax_ones(samples):
    from infinicube_tpu.models.gsm.model import GSMConfig as JG
    from infinicube_tpu_torch.models.gsm.model import GSMConfig as TG
    tsamp, jsamp = samples
    tb = next(tglue.gsm_batches(tsamp, TG(), voxel_capacity=8192,
                                device="cpu"))
    jb = next(jglue.gsm_batches(jsamp, JG(), voxel_capacity=8192))
    _keys_equal([tb["grid"]], [jb["grid"]])
    for k in ("images", "masks", "Ks", "cam_to_worlds"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert tb["images"].shape == (3,) + torch_clip.HW + (3,)
    got, want = tb["depth_prior"].numpy(), np.asarray(jb["depth_prior"])
    assert (want > 0).mean() > 0.1
    np.testing.assert_allclose(got, want, **TOL)
    # no views' images, no GSM batch
    bare = [{k: v for k, v in s.items() if "IMAGES" not in k.name}
            for s in tsamp]
    assert list(tglue.gsm_batches(bare, TG(), device="cpu")) == []


def test_test_recorder_and_captions_equal_the_jax_ones(tmp_path):
    from infinicube_tpu.data_process import captions as jcap
    from infinicube_tpu.training.test_recorder import TestRecorder as JRec
    from infinicube_tpu_torch.data_process import captions as tcap
    from infinicube_tpu_torch.training.test_recorder import TestRecorder
    for rec_cls, d in ((TestRecorder, "t"), (JRec, "j")):
        rec = rec_cls(tmp_path / d)
        rec.record("a", {"psnr": 20.5, "iou": np.float32(0.25)},
                   {"grid": np.arange(3)})
        rec.record("b", {"psnr": 22.0, "iou": 0.75})
        assert rec.finalize() == {"psnr": 21.25, "iou": 0.5}
    for f in ("metrics.csv", "a.grid.pkl"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    assert TestRecorder(tmp_path / "e").finalize() == {}
    videos = [f"v{i}.mp4" for i in range(5)]
    proc = tcap.DistributedProcessor(1, 2)
    assert proc.my_items(videos) == ["v1.mp4", "v3.mp4"]
    for mod, d in ((tcap, "t"), (jcap, "j")):
        caps = mod.generate_captions(
            videos, tmp_path / d / "caps.json",
            mod.DistributedProcessor(1, 2))
        mod.generate_metadata_csv(caps, tmp_path / d / "metadata.csv")
    for f in ("caps.json", "metadata.csv"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
