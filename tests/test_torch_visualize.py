"""Port parity: ``infinicube_tpu_torch.visualize`` against
``infinicube_tpu/visualize``: ``render_voxel_points`` and
``render_gaussian_scene`` on the CPU against the JAX renders of the same
inputs (every pixel within one uint8 step in 99.9 % of the pixels: a point
or gaussian on a pixel border may land on either side, and the two
rasterizers sum in other orders), ``transform_gaussians`` to f64 rounding,
and the four tools on ``tests/test_cli_smoke.py``'s tiny inputs, each
writing the files the JAX tool writes, with the same images by the same
gate; the renders at a quarter of the default camera where the test sets
it (``small_cameras``)."""

import numpy as np
import pytest
import torch
from PIL import Image

from infinicube_tpu.visualize import cli as jcli
from infinicube_tpu.visualize import render as jrender
from infinicube_tpu_torch.data.codec import encode_member
from infinicube_tpu_torch.data.tario import TarWriter
from infinicube_tpu_torch.utils.gaussian_io import gaussians_to_dict, save_pkl
from infinicube_tpu_torch.visualize import cli, render
from tests.test_cli_smoke import make_world
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

SHARE = 0.999
# the default camera at a quarter of its size: the rasterizers' plain CPU
# paths take seconds a frame at 640 x 480
SMALL = dict(fx=75.0, fy=75.0, cx=80, cy=60, w=160, h=120)


@pytest.fixture
def small_cameras(monkeypatch):
    """Both packages' renders on ``SMALL`` where no camera is passed."""
    from infinicube_tpu.camera.pinhole import PinholeCamera as JaxCamera
    from infinicube_tpu_torch.camera.pinhole import PinholeCamera
    monkeypatch.setattr(render, "DEFAULT_CAMERA", PinholeCamera(**SMALL))
    monkeypatch.setattr(jrender, "PinholeCamera",
                        lambda **kw: JaxCamera(**SMALL))


def _agree(got, ref, label):
    assert got.shape == ref.shape and got.dtype == np.uint8, label
    near = (np.abs(got.astype(int) - ref.astype(int)) <= 1).all(-1)
    assert near.mean() >= SHARE, (label, near.mean())


def _gaussians(seed=0, n=50):
    rng = np.random.default_rng(seed)
    return gaussians_to_dict(rng.uniform(-2, 2, (n, 3)),
                             rng.uniform(0.05, 0.2, (n, 3)),
                             np.tile([1.0, 0, 0, 0], (n, 1)),
                             rng.uniform(0.3, 0.9, n),
                             rng.uniform(0, 1, (n, 3)))


def test_renders_match_jax(small_cameras):
    rng = np.random.default_rng(1)
    ijk = rng.integers(-20, 20, (400, 3))
    sem = rng.integers(0, 23, 400)
    pose = render.orbit_poses(np.zeros(3), 12.0, 6.0, 3)[1]
    np.testing.assert_array_equal(pose, jrender.orbit_poses(
        np.zeros(3), 12.0, 6.0, 3)[1])
    _agree(render.render_voxel_points(ijk, sem, 0.2, 0.1, pose,
                                      device="cpu"),
           jrender.render_voxel_points(ijk, sem, 0.2, 0.1, pose), "voxels")
    g = _gaussians()
    gpose = render.orbit_poses(np.zeros(3), 8.0, 4.0, 2)[0]
    _agree(render.render_gaussian_scene(g, gpose, device="cpu"),
           jrender.render_gaussian_scene(g, gpose), "gaussians")
    T = np.eye(4)
    c, s = np.cos(0.7), np.sin(0.7)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = [1.0, -2.0, 0.5]
    g["quats"] = rng.normal(size=g["quats"].shape)
    got, ref = render.transform_gaussians(g, T), \
        jrender.transform_gaussians(g, T)
    for k in ("means", "quats"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, atol=1e-12)


def _same_images(a, b):
    for pa, pb in zip(sorted(a.rglob("*.png")), sorted(b.rglob("*.png"))):
        assert pa.name == pb.name
        _agree(np.asarray(Image.open(pa)), np.asarray(Image.open(pb)),
               pa.name)
    assert len(list(a.rglob("*.png"))) == len(list(b.rglob("*.png")))


def test_tools_write_what_the_jax_tools_write(tmp_path):
    world = make_world(tmp_path)
    for tag, tools in (("port", cli), ("jax", jcli)):
        dev = ["--device", "cpu"] if tools is cli else []
        tools.vis_grid([str(world), "--output", str(tmp_path / tag / "v"),
                        "--views", "1", *dev])
        tools.vis_compare([str(world), str(world), "--output",
                           str(tmp_path / tag / "c"), *dev])
    for sub in ("v", "c"):
        _same_images(tmp_path / "port" / sub, tmp_path / "jax" / sub)
    assert (tmp_path / "port" / "v" / "view_00.png").exists()
    assert (tmp_path / "port" / "c" / "compare.png").exists()


def test_wds_and_dynamic_tools(tmp_path, small_cameras):
    rng = np.random.default_rng(2)
    with TarWriter(tmp_path / "root" / "pc" / "clip0.tar") as w:
        w.add("000000.npz", encode_member("npz", {
            "xyz": rng.uniform(-20, 20, (500, 3)).astype(np.float32),
            "semantic": rng.integers(0, 23, 500).astype(np.int32)}))
    cli.main(["wds", str(tmp_path / "root"), "clip0", "--output",
              str(tmp_path / "port"), "--device", "cpu"])
    jcli.vis_wds([str(tmp_path / "root"), "clip0", "--output",
                  str(tmp_path / "jax")])
    _same_images(tmp_path / "port", tmp_path / "jax")
    assert (tmp_path / "port" / "clip0_000000.png").exists()
    save_pkl(tmp_path / "static.pkl", _gaussians())
    save_pkl(tmp_path / "objects.pkl", {3: _gaussians(4, 10)})
    T = np.tile(np.eye(4), (2, 1, 1))
    T[:, 0, 3] = [0.0, 1.0]
    np.savez(tmp_path / "tracks.npz", **{"3": T})
    args = [str(tmp_path / "static.pkl"), "--objects_pkl",
            str(tmp_path / "objects.pkl"), "--object_tracks",
            str(tmp_path / "tracks.npz"), "--frames", "2"]
    cli.vis_dynamic(args + ["--output", str(tmp_path / "dyn.mp4"),
                            "--device", "cpu"])
    jcli.vis_dynamic(args + ["--output", str(tmp_path / "jdyn.mp4")])
    # a video, or the frames where no video writer is installed
    for name in ("dyn", "jdyn"):
        assert (tmp_path / f"{name}.mp4").exists() or \
            (tmp_path / name).exists()
    if (tmp_path / "dyn").exists():
        _same_images(tmp_path / "dyn", tmp_path / "jdyn")


def test_tools_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    world = make_world(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["grid", str(world), "--output", str(tmp_path / "v")])
    with pytest.raises(SystemExit):
        cli.main(["nope"])
