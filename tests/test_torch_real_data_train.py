"""The port's three trainers on one small synthetic clip (converted and
processed by the port): ``train.main`` with ``data.root`` on it takes 2
finite steps for each model on tiny configs (the VAE's checkpoint then
frozen for the diffusion trainer, whose scale factor is written); a root
whose shards yield no sample raises; under two gloo ranks on the ``model``
axis both ranks read the whole stream and train the one-process run's
parameters, bit for bit."""

import json

import numpy as np
import pytest
import torch

from infinicube_tpu_torch.data_process import (
    generate_additional_attributes as tga)
from infinicube_tpu_torch.data_process import waymo2shards as tw2s

import torch_clip
from tests.torch_dist import real_train_rank, run_ranks

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


def _data_args(root):
    return [f"data.root={root}", "data.frame_end=3", "data.samples_per_shard=2",
            f"data.crop_bbox_min={CROP['crop_bbox_min']}",
            f"data.crop_bbox_max={CROP['crop_bbox_max']}"]


def _main(argv, tmp_path, name):
    from infinicube_tpu_torch.train import main
    state = main([*argv[:1], "--name", name, "--logdir", str(tmp_path),
                  "--exec", "max_steps=2", "log_every=1",
                  f"ckpt_dir={tmp_path}/{name}", *argv[1:]], device="cpu")
    logs = [json.loads(line) for line in
            (tmp_path / f"{name}.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["grad_finite"] == 1.0
               for r in logs), logs
    assert state.step == 2 and state.num_nan_skips == 0
    return state, logs


def _vae_args():
    return [f"vae.{k}={v}" for k, v in VAE_SMALL.items()]


@pytest.fixture(scope="module")
def vae_run(root, tmp_path_factory):
    """The VAE trainer on the clip; its checkpoint directory and log."""
    tmp = tmp_path_factory.mktemp("vae")
    _, logs = _main(["configs/train_vae.yaml", *_data_args(root),
                     *_vae_args(), "point_capacity=4096"], tmp, "vae")
    return tmp / "vae", logs


def test_vae_trains_on_the_clip(vae_run):
    _, logs = vae_run
    assert all(r["voxels0"] > 500 for r in logs)


def test_diffusion_trains_on_the_frozen_vae_latents(root, vae_run, tmp_path):
    ckpt, _ = vae_run
    _main(["configs/train_diffusion.yaml", *_data_args(root), *_vae_args(),
           f"vae_checkpoint={ckpt}", "batch_size=1",
           *[f"diffusion.{k}={v}" for k, v in DIFF_SMALL.items()]],
          tmp_path, "diff")
    sf = json.loads((tmp_path / "diff" / "scale_factor.json").read_text())
    assert np.isfinite(sf["scale_factor"]) and sf["scale_factor"] > 0


def test_gsm_trains_on_the_clip_views(root, tmp_path, monkeypatch):
    """A tiny GSM (the CLI builds the release config, as the JAX CLI) on
    the clip's three views."""
    from infinicube_tpu_torch.models.gsm import model as gsm_model
    from tests.test_torch_gsm import port_tiny_cfg
    tiny = port_tiny_cfg()
    monkeypatch.setattr(gsm_model, "GSMConfig", lambda: tiny)
    _main(["configs/train_gsm.yaml", *_data_args(root), "voxel_capacity=2048",
           f"data.views={torch_clip.VIEWS}"], tmp_path, "gsm")


def test_a_root_without_samples_raises(tmp_path):
    """A root that exists but whose shards yield no sample raises, naming
    the root, where the JAX CLI would loop for ever."""
    from infinicube_tpu_torch.train import main
    (tmp_path / "empty" / "pose").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="yielded no sample"):
        main(["configs/train_vae.yaml", "--logdir", str(tmp_path), "--exec",
              f"data.root={tmp_path / 'empty'}", "max_steps=1",
              f"ckpt_dir={tmp_path}/ck", *_vae_args()], device="cpu")




def test_ranks_of_the_model_axis_train_alike_on_the_clips(tmp_path):
    """``mesh.model=2`` on 2 ranks: the data axis has one rank, so both
    ranks read every clip (the loop's ``shard_batch`` is the only split of
    the stream) and take the steps of a run without a group. Two clips, so
    that a stream split by rank would give the ranks different batches."""
    from infinicube_tpu_torch.train import main
    root = torch_clip.make_root(tmp_path / "waymo", tw2s.FrameRecord,
                                tw2s.convert_clip, tga.process_clip,
                                clips=("clip0", "clip1"), device="cpu")
    argv = ["configs/train_vae.yaml", "--exec", *_data_args(root),
            *_vae_args(), "point_capacity=4096", "max_steps=1"]
    ranks = run_ranks(real_train_rank, 2, tmp_path / "ranks",
                      [*argv, "mesh.model=2"])
    alone = main([argv[0], "--logdir", str(tmp_path), *argv[1:],
                  f"ckpt_dir={tmp_path}/alone"], device="cpu")
    for got in ranks:
        assert got.keys() == alone.params.keys()
        for k, p in alone.params.items():
            assert torch.equal(got[k], p.detach()), k
