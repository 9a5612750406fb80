"""Port parity for stage 3's entry points: ``utils/gaussian_io`` writes the
JAX package's bytes; ``build_gsm_masks`` and ``load_buffer_folder`` on a
small folder written by the port's stage-2 writer (a road, a wall and a
car driving as instance 10000) give the JAX package's arrays;
``read_video`` reads back the png frames ``write_video`` falls back to
without imageio; the scene grid keeps the reference's 2^18 cap;
``reconstruct_scene`` end to end (static and dynamic passes) and
``feedforward_reconstruction.reconstruct`` match the JAX ones under the
same weights (``gsm_from_jax``), and the CLIs run on the CPU. f32 at
atol/rtol 2e-3."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.grid.build import grid_from_ijk as j_grid_from_ijk
from infinicube_tpu.inference import scene_gaussian_generation as jsg
from infinicube_tpu.models.gsm.loss import psnr as j_psnr
from infinicube_tpu.models.gsm.loss import ssim as j_ssim
from infinicube_tpu.models.gsm.model import GSM as JGSM
from infinicube_tpu.utils import gaussian_io as jio
from infinicube_tpu_torch.camera.pinhole import PinholeCamera
from infinicube_tpu_torch.inference import feedforward_reconstruction as tff
from infinicube_tpu_torch.inference import guidance_buffer_generation as tgb
from infinicube_tpu_torch.inference import scene_gaussian_generation as tsg
from infinicube_tpu_torch.utils import fileio
from infinicube_tpu_torch.utils import gaussian_io as tio
from infinicube_tpu_torch.utils.buffers import DynamicObjects
from infinicube_tpu_torch.utils.world_grid import WorldGrid
from infinicube_tpu_torch.weights.from_jax import gsm_from_jax, gsm_to_jax
from tests.test_gsm import tiny_cfg
from tests.test_torch_gsm import one_torch_thread, port_tiny_cfg  # noqa

TOL = dict(atol=2e-3, rtol=2e-3)
CAM = PinholeCamera(fx=30.0, fy=30.0, cx=24.0, cy=16.0, w=48, h=32)
FRAMES = 6


def _gaussians(n, seed):
    rng = np.random.default_rng(seed)
    return {"means": rng.normal(size=(n, 3)).astype(np.float32),
            "scales": np.exp(rng.normal(size=(n, 3))).astype(np.float32),
            "quats": rng.normal(size=(n, 4)).astype(np.float32),
            "opacities": rng.uniform(size=n).astype(np.float32),
            "colors": rng.uniform(size=(n, 3)).astype(np.float32)}


def test_gaussian_io_writes_the_reference_bytes(tmp_path):
    g = _gaussians(50, 0)
    valid = np.random.default_rng(1).uniform(size=50) > 0.3
    dj, dt = jio.gaussians_to_dict(**g, valid=valid), \
        tio.gaussians_to_dict(**g, valid=valid)
    for k in dj:
        np.testing.assert_array_equal(dj[k], dt[k])
    for ext, save in (("pkl", "save_pkl"), ("splat", "save_splat"),
                      ("ply", "save_ply")):
        getattr(jio, save)(tmp_path / f"j.{ext}", dt)
        getattr(tio, save)(tmp_path / f"t.{ext}", dt)
        assert (tmp_path / f"j.{ext}").read_bytes() == \
            (tmp_path / f"t.{ext}").read_bytes(), ext
        load = save.replace("save", "load")
        lj = getattr(jio, load)(tmp_path / f"j.{ext}")
        lt = getattr(tio, load)(tmp_path / f"t.{ext}")
        for k in lj:
            np.testing.assert_array_equal(lj[k], lt[k])


@pytest.mark.parametrize("last_n", [None, 0, 1, 3, 10])
def test_build_gsm_masks_match(last_n):
    rng = np.random.default_rng(2)
    depth = rng.uniform(size=(4, 8, 12)) * (rng.uniform(size=(4, 8, 12)) > .3)
    inst = rng.integers(9998, 10002, (4, 8, 12))
    sky = (rng.uniform(size=(4, 8, 12)) > 0.8).astype(np.uint8)
    for seg in (None, sky):
        np.testing.assert_array_equal(
            tsg.build_gsm_masks(depth, inst, seg, last_n),
            jsg.build_gsm_masks(depth, inst, seg, last_n))


def test_read_video_falls_back_to_png_frames(tmp_path, monkeypatch):
    """Without imageio ``write_video`` writes ``<stem>/NNNNNN.png`` and
    ``read_video`` reads them back, equal."""
    frames = np.random.default_rng(3).integers(0, 256, (3, 8, 12, 3),
                                               dtype=np.uint8)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    fileio.write_video(tmp_path / "video.mp4", frames)
    assert not (tmp_path / "video.mp4").exists()
    assert len(list((tmp_path / "video").glob("*.png"))) == 3
    np.testing.assert_array_equal(fileio.read_video(tmp_path / "video.mp4"),
                                  frames)
    with pytest.raises(ModuleNotFoundError, match="imageio"):
        fileio.read_video(tmp_path / "other.mp4")


def _world():
    rng = np.random.default_rng(4)
    ground = np.stack([rng.uniform(-2, 25, 5000), rng.uniform(-8, 8, 5000),
                       np.zeros(5000)], -1)
    wall = np.stack([np.full(1500, 20.0), rng.uniform(-8, 8, 1500),
                     rng.uniform(0, 5, 1500)], -1)
    w = WorldGrid(0.4)
    w.merge_points(np.concatenate([ground, wall]),
                   np.concatenate([np.full(5000, 18), np.full(1500, 14)]))
    return w


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A stage-2 buffer folder written by the port on the CPU: 6 frames at
    32x48 driving along x, a car (instance 10000) crossing ahead, the
    world and a video beside them."""
    out = tmp_path_factory.mktemp("buffers")
    world = _world()
    poses = np.tile(np.eye(4), (FRAMES, 1, 1))
    poses[:, 0, 3] = np.linspace(0.05, 3.05, FRAMES)
    poses[:, 1, 3] = 0.13
    poses[:, 2, 3] = 1.77
    car = np.tile(np.eye(4, dtype=np.float32), (FRAMES, 1, 1, 1))
    car[:, 0, 0, 3] = 9.0
    car[:, 0, 1, 3] = np.linspace(-3, 1, FRAMES)
    car[:, 0, 2, 3] = 0.8
    objs = DynamicObjects(poses=torch.from_numpy(car),
                          lwh=torch.tensor([[4.0, 2.0, 1.6]]),
                          ids=torch.tensor([10000], dtype=torch.int32),
                          sem=torch.ones(1, dtype=torch.int32),
                          valid=torch.ones((FRAMES, 1), dtype=torch.bool))
    bufs = tgb.generate_buffers_for_world(world, poses, CAM, objects=objs,
                                          device="cpu")
    tgb.write_buffer_tars(out, bufs, poses, CAM)
    tgb.save_voxel_world(out / "world.npz", world)
    video = np.random.default_rng(5).integers(0, 256, (FRAMES, 32, 48, 3),
                                              dtype=np.uint8)
    from infinicube_tpu_torch.data.codec import encode_png
    (out / "video").mkdir()                 # the png-frame form
    for i, f in enumerate(video):
        (out / "video" / f"{i:06d}.png").write_bytes(encode_png(f))
    return out, video


def test_load_buffer_folder_matches(folder):
    out, video = folder
    for kw in (dict(), dict(num_frames=2, stride=2)):
        got = tsg.load_buffer_folder(out, **kw)
        want = jsg.load_buffer_folder(out, **kw)   # no video.mp4 for JAX
        for k in ("depth", "instance", "semantic", "poses_cv", "Ks"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("ijk", "voxel_size", "origin"):
            np.testing.assert_array_equal(got["world"][k],
                                          want["world"][k])
        sl = slice(None, None, kw.get("stride"))
        np.testing.assert_array_equal(
            got["video"], (video[sl][:kw.get("num_frames")] / 255.0).astype(
                np.float32))
    assert (got["instance"] == 10000).any()
    merged = tsg.merge_buffer_folders([out, out], num_frames=3)
    assert merged["depth"].shape[0] == 6 and "world" in merged


def test_scene_grid_keeps_the_reference_cap():
    """A world of 2^18 + 37 voxels: the grid holds 2^18 and drops the 37
    highest keys, as the reference's grid_from_ijk at that capacity."""
    n = (1 << 18) + 37
    ijk = np.stack(np.unravel_index(np.arange(n), (72, 64, 64)), -1) - 30
    world = {"ijk": ijk, "voxel_size": np.float32(0.2),
             "origin": np.zeros(3, np.float32)}
    grid, has = tsg.scene_grid(world, "cpu")
    assert has and grid.capacity == 1 << 18
    assert int(grid.num_dropped[0]) == 37
    want = j_grid_from_ijk(jnp.asarray(ijk, jnp.int32)[None],
                           jnp.ones((1, n), bool), 0.2, 0.0,
                           capacity=1 << 18)
    np.testing.assert_array_equal(grid.keys.numpy(), np.asarray(want.keys))


@pytest.fixture(scope="module")
def recon(folder):
    data = tsg.load_buffer_folder(folder[0])
    jdata = dict(data)
    jm = JGSM(tiny_cfg())
    static_j, objects_j, out_j, _, params = jsg.reconstruct_scene(
        jdata, params=_params(), model=jm, cfg=tiny_cfg(),
        max_views=4)
    static_t, objects_t, out_t, model, _ = tsg.reconstruct_scene(
        data, params=gsm_from_jax(params), cfg=port_tiny_cfg(),
        max_views=4, device="cpu")
    return dict(data=data, params=params, jm=jm, model=model,
                j=(static_j, objects_j, out_j), t=(static_t, objects_t,
                                                   out_t))


def _params():
    """The flax tree (``gsm_to_jax``; its layout is held against flax's in
    tests/test_torch_gsm.py) of a random port init with its biases and
    norm scales moved off 0 and 1."""
    model = tsg.GSM(port_tiny_cfg())
    g = torch.Generator().manual_seed(7)
    model.init_params(g)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return gsm_to_jax(model)


def _hold(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


def test_reconstruct_scene_static_gaussians_match(recon):
    (sj, _, oj), (st, _, ot) = recon["j"], recon["t"]
    _hold(st, sj)
    assert len(sj["means"]) > 100
    for k in ("rgb", "alpha", "depth"):
        a, b = ot["render"][k].numpy(), np.asarray(oj["render"][k])
        close = np.isclose(a, b, **TOL)
        assert (close.all(-1) if k == "rgb" else close).mean() >= 0.999, k


def test_reconstruct_scene_object_gaussians_match(recon):
    (_, objs_j, _), (_, objs_t, _) = recon["j"], recon["t"]
    assert list(objs_t) == list(objs_j) == [10000]
    _hold(objs_t[10000], objs_j[10000])
    assert len(objs_j[10000]["means"]) > 10


def test_feedforward_reconstruct_matches(recon):
    """``reconstruct`` in dual mode on the batch ``reconstruct_scene``
    built for its static pass: the JAX static pass's renders (what the
    JAX ``reconstruct`` computes on that batch under the same weights), so
    the same psnr and ssim."""
    data = recon["data"]
    out_j = recon["j"][2]
    sel = np.linspace(0, data["depth"].shape[0] - 1, 4).astype(int)
    masks = jsg.build_gsm_masks(data["depth"][sel], data["instance"][sel])
    grid, _ = tsg.scene_grid(data["world"], "cpu")
    arrays = {"images": data["video"][sel], "masks": masks,
              "Ks": data["Ks"][sel], "cam_to_worlds": data["poses_cv"][sel],
              "depth_prior": data["depth"][sel][..., None]}
    tb = {k: torch.as_tensor(np.asarray(v, np.float32))
          for k, v in arrays.items()}
    tb["grid"] = grid
    out, mt, _, _ = tff.reconstruct(tb, "dual",
                                    params=gsm_from_jax(recon["params"]),
                                    cfg=port_tiny_cfg())
    for k in ("rgb", "alpha", "depth"):
        a, b = out["render"][k].numpy(), np.asarray(out_j["render"][k])
        close = np.isclose(a, b, **TOL)
        assert (close.all(-1) if k == "rgb" else close).mean() >= 0.999, k
    rgb_j = out_j["render"]["rgb"]
    gt = jnp.asarray(arrays["images"], jnp.float32)
    assert set(mt) == {"psnr", "ssim"}
    np.testing.assert_allclose(mt["psnr"], float(j_psnr(rgb_j, gt)),
                               rtol=1e-3)
    np.testing.assert_allclose(mt["ssim"], float(j_ssim(rgb_j, gt)),
                               atol=2e-3)
    for mode, vox, pix in (("3d", True, False), ("2d", False, True)):
        cfg = tff.mode_config(mode, port_tiny_cfg())
        assert (cfg.use_voxel_branch, cfg.use_pixel_branch) == (vox, pix)
    with pytest.raises(ValueError):
        tff.mode_config("4d")


def test_clis_run_on_the_cpu(folder, tmp_path, monkeypatch):
    """The stage-3 CLIs at the tiny configuration (their model is built
    from ``GSMConfig``'s defaults, replaced here)."""
    monkeypatch.setattr(tsg, "GSMConfig", port_tiny_cfg)
    out = tmp_path / "scene"
    static, _ = tsg.main(["--buffer_folder", str(folder[0]), "--output",
                          str(out), "--num_frames", "2", "--max_views", "2",
                          "--device", "cpu"])
    for name in ("decoded_gs_static.pkl", "decoded_gs_object.pkl",
                 "decoded_gs_static.splat", "composite_frame0.png"):
        assert (out / name).exists(), name
    assert list(tio.load_pkl(out / "decoded_gs_object.pkl")) == [10000]
    assert len(tio.load_splat(out / "decoded_gs_static.splat")["means"]) \
        == len(static["means"])
    # the feed-forward eval's CLI, with the default configuration as the
    # reference's (patched to the tiny one above)
    tff.main(["--buffer_folder", str(folder[0]), "--output",
              str(tmp_path / "eval"), "--save_gs", "--device", "cpu"])
    assert sorted(p.name for p in (tmp_path / "eval").iterdir()) == \
        ["gs.pkl"] + [f"render_{i:03d}.png" for i in range(FRAMES)]
    # --segformer-ckpt reads an HF-layout .pth (tests/test_torch_segformer.py
    # runs it); a missing file and a flax .msgpack are refused
    with pytest.raises(FileNotFoundError):
        tsg.main(["--buffer_folder", str(folder[0]), "--output", str(out),
                  "--segformer-ckpt", str(tmp_path / "x.pth"),
                  "--device", "cpu"])
    with pytest.raises(ValueError, match="from_jax"):
        tsg.main(["--buffer_folder", str(folder[0]), "--output", str(out),
                  "--segformer-ckpt", "x.msgpack", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsg.main(["--buffer_folder", str(folder[0]), "--output",
                      str(out)])
