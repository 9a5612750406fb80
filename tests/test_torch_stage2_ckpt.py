"""Stage 2's ``--run_video --ckpt`` (``infinicube_tpu_torch/inference/
guidance_buffer_generation.py``) on a checkpoint of the port's convert CLI,
made from the released files of tests/test_torch_convert_cli.py, with a
sidecar that describes a tiny pipeline: the CLI writes the video."""

import dataclasses
import json

import numpy as np
import torch

from infinicube_tpu_torch import convert as tcli
from infinicube_tpu_torch.inference import guidance_buffer_generation as tgb
from infinicube_tpu_torch.models.wan.vae3d import VideoVAEConfig
from infinicube_tpu_torch.utils.world_grid import WorldGrid
from tests.test_torch_convert_cli import _port_cfg
from tests.test_torch_convert_cli import released  # noqa: F401
from tests.test_torch_convert_cli import tiny_variant  # noqa: F401
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from torch_mirrors.wan_vae_torch import WanVAEMirror


def test_stage2_serves_the_video_from_a_checkpoint(released, tmp_path):
    """``--run_video --ckpt`` with a sidecar that describes a tiny pipeline
    (a VAE of three downsamplings, so that 480 x 832 makes 30 x 52 DiT
    tokens): one frame of buffers on a small world, its video from the
    converted towers."""
    root, args, _ = released
    vae = dict(latent_channels=4, base_channels=4, channel_mult=(1, 1, 1, 1),
               num_res_blocks=1)
    torch.manual_seed(2)
    mirror = WanVAEMirror(dim=4, z_dim=4, dim_mult=(1, 1, 1, 1),
                          num_res_blocks=1).eval()
    torch.save(mirror.state_dict(), tmp_path / "Wan2.1_VAE.pth")
    ckpt = tmp_path / "ckpt"
    tcli.main(args[:2] + args[4:] + ["--wan-vae", str(tmp_path /
                                                    "Wan2.1_VAE.pth"),
                                     "--out", str(ckpt)])
    meta = json.loads((ckpt / "pipeline.json").read_text())
    meta["dit_overrides"].update(dtype="float32")
    cfg = _port_cfg()
    meta["pipeline_overrides"] = {
        "vae": {**vae, "dtype": "float32"},
        "t5": {**dataclasses.asdict(cfg.t5), "dtype": "float32"},
        "num_steps": 1, "max_text_len": 8}
    (ckpt / "pipeline.json").write_text(json.dumps(meta))
    got = tcli.pipeline_config_from_meta(meta)
    assert got.dit == cfg.dit and got.t5 == cfg.t5
    assert got.vae == VideoVAEConfig(**vae, dtype=torch.float32)

    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-2, 30, 4000), rng.uniform(-8, 8, 4000),
                    np.zeros(4000)], -1)
    world = WorldGrid(0.4)
    world.merge_points(pts, np.full(4000, 18))
    tgb.save_voxel_world(tmp_path / "world.npz", world)
    tgb.main(["--voxel_world", str(tmp_path / "world.npz"), "--output",
              str(tmp_path / "o"), "--num_frames", "1", "--run_video",
              "--ckpt", str(ckpt), "--device", "cpu"])
    video = tmp_path / "o" / "video.mp4"
    assert video.is_file() or (tmp_path / "o" / "video" / "000000.png"
                               ).is_file()
