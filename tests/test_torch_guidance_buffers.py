"""Port parity: the stage-2 entry points of
``infinicube_tpu_torch.inference.guidance_buffer_generation`` against the
JAX package's: ``generate_buffers_for_world`` on a small world with a
moving car (the gates of tests/test_torch_buffers.py), the trajectory
resampling and the instance stamping exactly, and the CLI (``--device
cpu``): its six tars, read by the JAX package's ``TarReader`` and
``decode_member``, hold the JAX CLI's member names and its buffers, and
exactly the port's own buffers. Without a card the CLI's default device
raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.data.codec import decode_member
from infinicube_tpu.data.tario import TarReader
from infinicube_tpu.inference import guidance_buffer_generation as jgb
from infinicube_tpu.utils.buffers import DynamicObjects as JaxObjects
from infinicube_tpu.utils.world_grid import WorldGrid as JaxWorldGrid
from infinicube_tpu_torch.camera.pinhole import PinholeCamera
from infinicube_tpu_torch.inference import guidance_buffer_generation as tgb
from infinicube_tpu_torch.utils.buffers import DynamicObjects
from infinicube_tpu_torch.utils.world_grid import WorldGrid
from tests.test_torch_buffers import _hold_buffers
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

ROAD, BUILDING, CAR = 18, 14, 1
TARS = ("depth", "instance", "semantic", "pose", "intrinsic",
        "dynamic_object_info")


def _world_points(seed=0):
    """A road, a wall ahead and a parked car-like block, FLU world."""
    rng = np.random.default_rng(seed)
    ground = np.stack([rng.uniform(-5, 40, 6000), rng.uniform(-10, 10, 6000),
                       np.zeros(6000)], -1)
    wall = np.stack([np.full(2000, 30.0), rng.uniform(-10, 10, 2000),
                     rng.uniform(0, 6, 2000)], -1)
    car = np.stack([rng.uniform(10, 14, 800), rng.uniform(3, 5, 800),
                    rng.uniform(0.2, 1.6, 800)], -1)
    pts = np.concatenate([ground, wall, car])
    sem = np.concatenate([np.full(6000, ROAD), np.full(2000, BUILDING),
                          np.full(800, CAR)])
    return pts, sem


@pytest.fixture(scope="module")
def worlds():
    pts, sem = _world_points()
    out = []
    for cls in (JaxWorldGrid, WorldGrid):
        w = cls(0.2)
        w.merge_points(pts, sem)
        out.append(w)
    np.testing.assert_array_equal(out[0].keys, out[1].keys)
    return out


def _trajectory(T, yaw=0.0, offset=(0.0, 0.0)):
    """T FLU camera poses driving 6 m along x at 1.8 m height, turned by
    ``yaw`` and shifted by ``offset`` (y, z)."""
    poses = np.tile(np.eye(4), (T, 1, 1))
    c, s = np.cos(yaw), np.sin(yaw)
    poses[:, :2, :2] = [[c, -s], [s, c]]
    poses[:, 0, 3] = np.linspace(0, 6, T)
    poses[:, 1, 3] = offset[0]
    poses[:, 2, 3] = 1.8 + offset[1]
    return poses


def test_resample_trajectory_and_stamping_are_exact(worlds):
    jw, tw = worlds
    rng = np.random.default_rng(4)
    keys = _trajectory(6)
    keys[:, 1, 3] = rng.uniform(-1, 1, 6)
    for args in ((40, 0, 0.0), (17, 1, 2.5)):
        np.testing.assert_array_equal(tgb.resample_trajectory(keys, *args),
                                      jgb.resample_trajectory(keys, *args))
    info = {"a": {"object_to_world": np.eye(4).tolist(),
                  "object_lwh": [1.0, 1.0, 1.0], "object_id_int": 3}}
    info["a"]["object_to_world"][0][3] = 12.0
    info["a"]["object_to_world"][1][3] = 4.0
    info["b"] = {"object_to_world": np.eye(4).tolist(),
                 "object_lwh": [3.0, 1.0, 2.0], "object_id_int": 7}
    info["b"]["object_to_world"][0][3] = 13.0
    info["b"]["object_to_world"][1][3] = 4.2
    got = tgb.stamp_static_instances(tw, info)
    np.testing.assert_array_equal(got, jgb.stamp_static_instances(jw, info))
    assert set(np.unique(got)) == {0, 3, 7}
    assert (tgb.stamp_static_instances(tw, {}) == 0).all()


def test_buffers_for_a_world_match_the_reference(worlds):
    """80 x 60, 5 frames, the parked car stamped with an id and a car
    driving ahead (id 10001): splat route. The camera is turned and
    shifted off the voxel lattice: an axis-aligned camera at multiples of
    the voxel pitch projects voxel centers exactly onto pixel borders,
    where the rounding follows the last bit of the projection, and the
    reference's own last bit depends on how XLA fuses it (its eager and
    compiled projections differ there)."""
    jw, tw = worlds
    T = 5
    cam = dict(fx=60.0, fy=60.0, cx=40.0, cy=30.0, w=80, h=60)
    poses = _trajectory(T, yaw=0.013, offset=(0.037, 0.011))
    obj = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1, 1))
    obj[:, 0, :3, 3] = np.stack([np.linspace(9, 12, T), np.full(T, -1.5),
                                 np.full(T, 0.8)], -1)
    fields = dict(poses=obj, lwh=np.array([[4.5, 2.0, 1.6]], np.float32),
                  ids=np.array([10001], np.int32),
                  sem=np.array([CAR], np.int32), valid=np.ones((T, 1), bool))
    inst = np.where(tw.semantics == CAR, 5, 0).astype(np.int32)
    ref = jgb.generate_buffers_for_world(
        jw, poses, jgb.PinholeCamera(**cam),
        JaxObjects(**{k: jnp.asarray(v) for k, v in fields.items()}), inst)
    got = tgb.generate_buffers_for_world(
        tw, poses, PinholeCamera(**cam),
        DynamicObjects(**{k: torch.from_numpy(v) for k, v in fields.items()}),
        inst, device="cpu")
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert got["depth"].shape == (T, 60, 80)
    assert got["coordinate"].shape == (T, 60, 80, 3)
    _hold_buffers(ref, got)
    assert (got["instance"] == 10001).any() and (got["instance"] == 5).any()


def test_cli_writes_the_reference_tars(worlds, tmp_path):
    """Both CLIs on the same world file, 3 frames of the default 480 x 832
    camera: the same six tars of the same member names; the port's members
    decode (through the JAX package's reader and decoder) exactly to the
    port's buffers and within the buffer gates to the JAX CLI's."""
    jw, tw = worlds
    world = tmp_path / "world.npz"
    tgb.save_voxel_world(world, tw)
    loaded = tgb.load_voxel_world(world)
    np.testing.assert_array_equal(loaded.keys, tw.keys)
    args = ["--voxel_world", str(world), "--num_frames", "3"]
    jgb.main(args + ["--output", str(tmp_path / "jax")])
    bufs = tgb.main(args + ["--output", str(tmp_path / "port"),
                            "--device", "cpu"])
    read = {}
    for side in ("jax", "port"):
        for name in TARS:
            with TarReader(tmp_path / side / f"{name}.tar") as r:
                read[side, name] = {n: decode_member(n.split(".")[-1],
                                                     r.read(n))
                                    for n in r.names()}
    for name in TARS:
        assert list(read["port", name]) == list(read["jax", name])
        assert len(read["port", name]) == 3
    got = {k: np.stack(list(read["port", k].values()))
           for k in ("depth", "semantic", "instance")}
    np.testing.assert_array_equal(got["semantic"], bufs["semantic"].numpy())
    np.testing.assert_array_equal(got["instance"], bufs["instance"].numpy())
    np.testing.assert_array_equal(got["depth"], np.clip(
        bufs["depth"].numpy() * 100.0, 0, 65535).astype(np.uint16))
    ref = {k: np.stack(list(read["jax", k].values()))
           for k in ("depth", "semantic", "instance")}
    for k in ("semantic", "instance"):
        assert got[k].dtype == ref[k].dtype
        assert (got[k] == ref[k]).mean() >= 0.999
    dd = np.abs(got["depth"].astype(np.int64) - ref["depth"])
    assert (dd <= 1).mean() >= 0.999 and (got["semantic"] > 0).mean() > 0.05
    for name in ("pose", "intrinsic", "dynamic_object_info"):
        for a, b in zip(read["port", name].values(),
                        read["jax", name].values()):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def test_cli_runs_on_the_card_unless_asked(worlds, tmp_path):
    _, tw = worlds
    world = tmp_path / "world.npz"
    tgb.save_voxel_world(world, tw)
    args = ["--voxel_world", str(world), "--output", str(tmp_path / "o"),
            "--num_frames", "2"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tgb.main(args)
    # --ckpt serves the video from a converted checkpoint
    # (tests/test_torch_convert_cli.py); a missing one raises
    with pytest.raises(FileNotFoundError, match="pipeline.json"):
        tgb.main(args + ["--run_video", "--ckpt", str(tmp_path / "none"),
                         "--device", "cpu"])
