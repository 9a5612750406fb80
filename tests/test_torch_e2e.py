"""Port parity of the chained pipeline (``infinicube_tpu_torch.examples``):
``e2e_pipeline``'s stages 2 and 3 (``stage2_buffers``, ``stage3_data``,
``stage3_scene``, the functions ``run_pipeline`` chains) against the JAX
package's functions chained as ``examples/e2e_pipeline.py`` chains them,
on the synthetic world of tests/test_pipeline_e2e.py (a road and a wall at
0.5 m), 12 buffer frames at 32x48 along the pipeline's 40 m path, the same
numpy random video, stage 3 on every 3rd frame, 4 views, with the tiny GSM
of tests/test_torch_dav2.py (``encoders=("conv", "dav2")``, as the
release GSM's encoder, with the tiny DAv2 tower) and the same weights on
both sides (``gsm_from_jax``):
- the buffers: the splat route (the pipeline's) on >= 99.9 % of pixels
  (the DDA route is held in tests/test_torch_buffers.py);
- the stage-3 gaussians within the stage-3 parity tests' atol / rtol 2e-3,
  which also holds the whole GSM's forward with the DAv2 tower.
Then ``run_pipeline`` at a cut-down config on the CPU (a small voxel UNet
with the demo's threshold decode, the tiny Wan towers of
tests/test_torch_wan_pipeline.py, the tiny GSM) writes the full artifact
set, and ``e2e_stage3_resume.resume`` reads it back, with and without the
``video/`` frames."""

import sys

import numpy as np
import pytest
import torch

from infinicube_tpu.camera.pinhole import PinholeCamera as JCam
from infinicube_tpu.inference import guidance_buffer_generation as jgb
from infinicube_tpu.inference import scene_gaussian_generation as jsg
from infinicube_tpu.models.gsm.model import GSM as JGSM
from infinicube_tpu_torch.examples import e2e_pipeline as e2e
from infinicube_tpu_torch.examples.e2e_stage3_resume import resume
from infinicube_tpu_torch.models.diffusion.model import DiffusionConfig
from infinicube_tpu_torch.models.wan.dit import WanDiTConfig
from infinicube_tpu_torch.models.wan.pipeline import WanPipelineConfig
from infinicube_tpu_torch.models.wan.t5 import T5Config
from infinicube_tpu_torch.models.wan.vae3d import VideoVAEConfig
from infinicube_tpu_torch.utils.gaussian_io import load_pkl, load_splat
from infinicube_tpu_torch.utils.world_grid import WorldGrid
from infinicube_tpu_torch.weights.from_jax import gsm_from_jax
from tests.test_pipeline_e2e import make_world
from tests.test_torch_dav2 import dav2_gsm_cfgs, dav2_gsm_params
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.test_torch_gsm import port_tiny_cfg
from tests.test_torch_stage3 import _hold
from tests.test_torch_voxel_diffusion import SMALL
from tests.test_torch_wan_pipeline import DIT, VAE

FRAMES, HW = 12, (32, 48)
VIEWS = e2e.Stage3Views(num_frames=4, stride=3, max_views=4)


def _port_world(jworld) -> WorldGrid:
    w = WorldGrid(jworld.voxel_size, jworld.origin)
    w.merge_ijk(jworld.ijk(), jworld.semantics)
    return w


def _jax_camera():
    c = e2e.camera_for(HW)
    return JCam(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, w=c.w, h=c.h)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The port's stages 2 and 3 (video off) and the JAX chain, as the
    reference script runs it, on the same world and weights."""
    tmp = tmp_path_factory.mktemp("e2e")
    jworld = make_world()
    jcfg, tcfg = dav2_gsm_cfgs()
    params = dav2_gsm_params(tcfg)
    cpu = torch.device("cpu")
    bufs_t = e2e.stage2_buffers(tmp / "port", _port_world(jworld), FRAMES,
                                HW, cpu)
    static_t, _, _ = e2e.stage3_scene(
        tmp / "port", e2e.stage3_data(tmp / "port", VIEWS, None), tcfg,
        VIEWS, cpu, params=gsm_from_jax(params))

    poses, cam = e2e.stage2_poses(FRAMES), _jax_camera()
    bufs = jgb.generate_buffers_for_world(jworld, poses, cam)
    jgb.write_buffer_tars(tmp / "jax" / "buffers", bufs, poses, cam)
    jgb.save_voxel_world(tmp / "jax" / "buffers" / "world.npz", jworld)
    data = jsg.load_buffer_folder(tmp / "jax" / "buffers",
                                  num_frames=VIEWS.num_frames,
                                  stride=VIEWS.stride)
    data["video"] = np.random.default_rng(0).uniform(
        size=data["depth"].shape + (3,)).astype(np.float32)
    static_j, _, _, _, _ = jsg.reconstruct_scene(
        data, params=params, model=JGSM(jcfg), cfg=jcfg,
        max_views=VIEWS.max_views)
    return dict(bufs_t={k: v.numpy() for k, v in bufs_t.items()},
                static_t=static_t,
                bufs={k: np.asarray(v) for k, v in bufs.items()},
                static_j=static_j)


def test_splat_buffers_match_the_jax_chain(chains):
    got, want = chains["bufs_t"], chains["bufs"]
    assert got["depth"].shape == (FRAMES,) + HW
    same = (got["semantic"] == want["semantic"]) & \
        (got["instance"] == want["instance"]) & \
        (np.abs(got["depth"] - want["depth"]) <= 1e-4)
    assert same.mean() >= 0.999
    assert (want["depth"] > 0).mean() > 0.2


def test_stage3_gaussians_match_the_jax_chain(chains):
    st, sj = chains["static_t"], chains["static_j"]
    _hold(st, sj)
    assert len(sj["means"]) > 100


def _tiny_wan(frames):
    return WanPipelineConfig(
        dit=WanDiTConfig(**DIT, dtype=torch.float32),
        vae=VideoVAEConfig(**VAE, dtype=torch.float32),
        t5=T5Config.tiny(d_model=32, dtype=torch.float32),
        num_frames=frames, height=HW[0], width=HW[1], num_steps=2,
        guidance_scale=2.0, max_text_len=16)


@pytest.fixture(scope="module")
def release_shaped(tmp_path_factory):
    """The pipeline at a cut-down config, every stage on: a small voxel UNet
    (2 DDIM steps) with the threshold decode, 5 buffer frames, the tiny Wan
    towers, the tiny GSM."""
    out = tmp_path_factory.mktemp("artifacts")
    dcfg = DiffusionConfig(**SMALL, dtype=torch.float32)
    res = e2e.run_pipeline(out, dcfg, None, port_tiny_cfg(), _tiny_wan(5),
                           e2e.Stage3Views(2, 2, 2), frames=5, hw=HW,
                           ddim_steps=2, device="cpu")
    return out, res


def test_pipeline_writes_the_artifact_set(release_shaped):
    out, res = release_shaped
    for name in ("world.npz", "decoded_gs_static.pkl",
                 "decoded_gs_static.splat", "render0.png",
                 "buffers/world.npz"):
        assert (out / name).is_file(), name
    for tar in ("depth", "instance", "semantic", "pose", "intrinsic",
                "dynamic_object_info"):
        assert (out / "buffers" / f"{tar}.tar").is_file(), tar
    for preview in ("semantic", "depth", "coordinate"):
        p = out / "buffers" / f"{preview}.mp4"
        assert p.is_file() or p.with_suffix("").is_dir(), preview
    assert (out / "video.mp4").is_file() or (out / "video").is_dir()
    assert res["world"].num_voxels > 0
    assert res["video"].shape == (5,) + HW + (3,)
    assert res["buffers"] is None          # dropped before the DiT
    gs = load_pkl(out / "decoded_gs_static.pkl")
    assert len(gs["means"]) == len(res["static_gs"]["means"]) > 0
    assert len(load_splat(out / "decoded_gs_static.splat")["means"]) == \
        len(gs["means"])
    assert set(res["seconds"]) >= {"stage1 world", "stage2 tars",
                                   "stage2 previews"}


@pytest.mark.parametrize("frames", ["random", "png"])
def test_stage3_resume_reads_the_artifacts(release_shaped, frames,
                                           monkeypatch):
    """Where a video writer is installed the pipeline writes ``video.mp4``,
    and the resume takes random frames, as the reference's; with the png
    frames ``write_video`` falls back to (no video writer, the card's
    machine) it reads them."""
    out, res = release_shaped
    vdir = out / "video"
    if frames == "png" and not vdir.is_dir():
        from infinicube_tpu_torch.utils import fileio
        monkeypatch.setitem(sys.modules, "imageio", None)
        monkeypatch.setitem(sys.modules, "imageio.v3", None)
        fileio.write_video(out / "video.mp4",
                           (res["video"] * 255).round().astype(np.uint8))
        assert vdir.is_dir()
    if frames == "random" and vdir.is_dir():
        # as after a run where the writer made video.mp4
        aside = out / "video_frames"
        vdir.rename(aside)
        try:
            got = resume(out, port_tiny_cfg(), e2e.Stage3Views(2, 2, 2),
                         device="cpu")
        finally:
            aside.rename(vdir)
    else:
        got = resume(out, port_tiny_cfg(), e2e.Stage3Views(2, 2, 2),
                     device="cpu")
    assert got["video"] == (frames == "png")
    assert len(got["static_gs"]["means"]) > 0
    assert (out / "render0.png").is_file()
    if frames == "png":
        # the same frames as the pipeline's stage 3 saw: the same scene
        _hold(got["static_gs"], res["static_gs"])
