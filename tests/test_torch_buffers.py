"""Port parity: stage 2's buffers (``infinicube_tpu_torch.utils.buffers``)
against ``infinicube_tpu.utils.buffers`` on the scene of
tests/test_buffers.py (a road and a wall at 80 x 60, 4 frames, one moving
car): the splat route (the main path) and the DDA route, semantic and
instance equal on >= 99.9 % of pixels and depth within 1e-4 where the
winners agree; the coordinate buffer within 1e-5 where the depth agrees;
the packed z-buffer at its edges: a far voxel in the last slot below 2^20
is a hit, and beyond 2^20 slots the port picks the right winner where the
reference's 20-bit slot field aliases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.utils import buffers as jb
from infinicube_tpu_torch.camera.pinhole import PinholeCamera
from infinicube_tpu_torch.grid.grid import make_grid
from infinicube_tpu_torch.utils import buffers as tb
from tests.test_buffers import (BUILDING, CAR, ROAD, camera_looking_forward,
                                make_scene)
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

T = 4


@pytest.fixture(scope="module")
def scene():
    """The JAX scene and its port twin: grid, voxel semantics, camera,
    4 poses moving forward, a car driving ahead (id 10001)."""
    g, vox_sem = make_scene()
    cam, pose = camera_looking_forward()
    tg = make_grid(*(torch.from_numpy(np.array(a)) for a in (
        g.ijk, g.mask, g.voxel_size, g.origin)))
    poses = np.repeat(np.asarray(pose)[None], T, 0)
    poses[:, 0, 3] = np.linspace(0, 3, T)
    obj = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1, 1))
    obj[:, 0, :3, 3] = np.stack([np.linspace(8, 10, T), np.zeros(T),
                                 np.full(T, 0.8)], -1)
    fields = dict(poses=obj, lwh=np.array([[4.5, 2.0, 1.6]], np.float32),
                  ids=np.array([10001], np.int32),
                  sem=np.array([CAR], np.int32), valid=np.ones((T, 1), bool))
    jobj = jb.DynamicObjects(**{k: jnp.asarray(v) for k, v in fields.items()})
    tobj = tb.DynamicObjects(**{k: torch.from_numpy(v)
                                for k, v in fields.items()})
    tcam = PinholeCamera(cam.fx, cam.fy, cam.cx, cam.cy, cam.w, cam.h)
    return dict(g=g, sem=vox_sem, tg=tg, tsem=torch.from_numpy(
        np.array(vox_sem)), cam=cam, tcam=tcam, poses=poses, jobj=jobj,
        tobj=tobj)


def _both(scene, method):
    s = scene
    ref = jb.generate_guidance_buffers(
        s["g"], s["sem"], jnp.zeros_like(s["sem"]), s["cam"],
        jnp.asarray(s["poses"]), s["jobj"], method=method)
    got = tb.generate_guidance_buffers(
        s["tg"], s["tsem"], torch.zeros_like(s["tsem"]), s["tcam"],
        torch.from_numpy(s["poses"]), s["tobj"], method=method)
    return {k: np.asarray(v) for k, v in ref.items()}, \
        {k: v.numpy() for k, v in got.items()}


def _hold_buffers(ref, got):
    """Semantic and instance equal on >= 99.9 % of pixels; the depth within
    1e-4 where the winners agree. The winner is seen through what it
    writes: a pixel whose semantic, instance or depth (beyond 1e-4)
    differs has another winner, and such pixels are at most 0.1 %."""
    for k in ("semantic", "instance"):
        assert got[k].dtype == np.int32 and got[k].shape == ref[k].shape
        assert (got[k] == ref[k]).mean() >= 0.999
    same = (got["semantic"] == ref["semantic"]) & \
        (got["instance"] == ref["instance"])
    agree = same & (np.abs(got["depth"] - ref["depth"]) <= 1e-4)
    assert agree.mean() >= 0.999
    # the coordinate buffer where the depth agrees
    np.testing.assert_allclose(got["coordinate"][agree],
                               ref["coordinate"][agree], atol=1e-5, rtol=0)


@pytest.mark.parametrize("method", ["splat", "dda"])
def test_sequence_matches_the_reference(scene, method):
    ref, got = _both(scene, method)
    _hold_buffers(ref, got)
    sem, ins, dep = got["semantic"], got["instance"], got["depth"]
    # the car is in view, nearer than the wall, and marked dynamic
    assert (sem == CAR).any() and (ins[sem == CAR] == 10001).all()
    assert (sem == ROAD).any() and (sem == BUILDING).any()
    assert (dep[sem == CAR] < 12.0).all()


def test_splat_winner_slots_match_the_reference(scene):
    """The z-buffer alone, on the same points (static centers and the posed
    car's points): winner slots equal on >= 99.9 % of pixels, z within
    1e-4 where they agree."""
    from infinicube_tpu.utils.cad_car import canonical_car_points
    s = scene
    centers = np.asarray(s["g"].voxel_centers()[0])
    C = len(centers)
    car = canonical_car_points() * np.array([4.5, 2.0, 1.6], np.float32)
    K = s["cam"].intrinsics_matrix()
    for f in range(T):
        op = s["jobj"].poses[f, 0]
        cp = np.asarray(car @ np.asarray(op[:3, :3]).T + np.asarray(op[:3, 3]))
        pts = np.concatenate([centers, cp]).astype(np.float32)
        val = np.concatenate([np.asarray(s["g"].mask[0]),
                              np.ones(len(cp), bool)])
        rad = np.concatenate([np.full(C, 0.2), np.full(len(cp), 1.6 / 12)]
                             ).astype(np.float32)
        w1, z1 = (np.asarray(a) for a in jb.splat_winner_slots(
            jnp.asarray(pts), jnp.asarray(val), jnp.asarray(rad), K,
            jnp.asarray(s["poses"][f]), (60, 80)))
        w2, z2 = (a.numpy() for a in tb.splat_winner_slots(
            torch.from_numpy(pts), torch.from_numpy(val),
            torch.from_numpy(rad), s["tcam"].intrinsics_matrix(),
            torch.from_numpy(s["poses"][f]), (60, 80)))
        assert (w1 == w2).mean() >= 0.999 and (w2 >= 0).mean() > 0.3
        np.testing.assert_allclose(z2[w1 == w2], z1[w1 == w2], atol=1e-4,
                                   rtol=0)


def test_coordinate_buffer_matches_the_reference(scene):
    """The same depths in: the same normalized point map out (1e-5), sky
    pixels white."""
    s = scene
    rng = np.random.default_rng(1)
    depth = rng.uniform(2, 30, size=(3, 60, 80)).astype(np.float32)
    depth[:, :5] = 0.0
    poses = s["poses"][:3]
    ref = np.asarray(jb.generate_coordinate_buffer(
        jnp.asarray(depth), s["cam"].intrinsics_matrix(), jnp.asarray(poses)))
    got = tb.generate_coordinate_buffer(
        torch.from_numpy(depth), s["tcam"].intrinsics_matrix(),
        torch.from_numpy(poses)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert (got[:, :5] == 1.0).all()


def test_static_buffers_ground_and_wall(scene):
    """tests/test_buffers.py's DDA frame, through the port."""
    s = scene
    blocks = tb.build_static_blocks(s["tg"], s["tsem"],
                                    torch.zeros_like(s["tsem"]),
                                    (-20, -30, -5), (96, 60, 24))
    fb = tb.render_frame(blocks, tb.DynamicObjects.empty(1), 0,
                         s["tcam"].intrinsics_matrix(),
                         torch.from_numpy(s["poses"][0]), (60, 80))
    depth, sem = fb.depth.numpy(), fb.semantic.numpy()
    assert abs(depth[30, 40] - 20.0) < 1.0 and sem[30, 40] == BUILDING
    assert sem[55, 40] == ROAD and 0 < depth[55, 40] < 20.0
    assert sem[0, 40] == 0 and depth[0, 40] == 0.0


def test_packed_splat_far_voxel_last_slot_is_not_a_miss():
    """A far-clipped depth (z = 1e9) in the last slot below 2^20 stays a hit
    by that slot with the quantized depth 2046, and a NaN depth quantizes
    to 0, as the reference's (XLA's cast saturates; torch's cast gives
    INT32_MIN for both, which the clip would turn into 0)."""
    slot = torch.tensor([(1 << 20) - 1, (1 << 20) - 1])
    buf = tb._packed_splat(torch.tensor([0, 1]),
                           torch.tensor([1e9, float("nan")]), slot,
                           torch.tensor([True, True]), 1, 2)
    assert (buf != tb._MISS).all()
    assert ((buf & tb._SLOT_MASK) == (1 << 20) - 1).all()
    assert (buf[0] >> 32).item() == 2046 and (buf[1] >> 32).item() == 0
    ref = jb._packed_splat(jnp.asarray([0, 1]), jnp.asarray([1e9, np.nan]),
                           jnp.asarray(slot.numpy(), jnp.int32),
                           jnp.asarray([True, True]), 1, 2)
    assert (np.asarray(ref) >> 20).tolist() == [2046, 0]


def test_winners_on_each_side_of_2_pow_20_slots():
    """Two points on one pixel, the nearer at 2.0 m (zq 10), the farther at
    2.2 m (zq 11) in slot 3. Below 2^20 both packings pick the nearer;
    at slot 2^20 + 5 the reference's (10 << 20) | slot reads as
    (11 << 20) | 5 and loses to the farther point, the port's int64
    packing still picks the nearer."""
    z = np.array([2.0, 2.2], np.float32)
    for near_slot, ref_right in (((1 << 20) - 7, True), ((1 << 20) + 5,
                                                         False)):
        slot = np.array([near_slot, 3])
        ref = int(np.asarray(jb._packed_splat(
            jnp.asarray([0, 0]), jnp.asarray(z), jnp.asarray(slot,
                                                             jnp.int32),
            jnp.asarray([True, True]), 1, 1))[0])
        assert ((ref & ((1 << 20) - 1)) == (near_slot & ((1 << 20) - 1))) \
            == ref_right
        got = tb._packed_splat(torch.tensor([0, 0]), torch.from_numpy(z),
                               torch.from_numpy(slot),
                               torch.tensor([True, True]), 1, 1)
        assert (got[0] & tb._SLOT_MASK).item() == near_slot


def test_splat_frame_beyond_2_pow_20_points():
    """A frame of 2^20 + 16 points, all but the last three invalid: a far
    static point (slot 3) and two nearer car points beyond 2^20 on the same
    pixel. The port's buffer holds the nearest point's class and depth."""
    C = (1 << 20) + 16
    pts = np.zeros((C, 3), np.float32)
    valid = np.zeros(C, bool)
    attrs = np.zeros((C, 2), np.int32)
    # OpenCV camera at the origin looking along +z: points on the axis
    pts[3], attrs[3], valid[3] = (0, 0, 2.2), (ROAD, 0), True
    pts[C - 2], attrs[C - 2], valid[C - 2] = (0, 0, 2.0), (CAR, 10001), True
    pts[C - 1], attrs[C - 1], valid[C - 1] = (0, 0, 2.1), (CAR, 10002), True
    K = PinholeCamera(10.0, 10.0, 2.0, 2.0, 5, 5).intrinsics_matrix()
    fb = tb.splat_frame(torch.from_numpy(pts), torch.from_numpy(attrs),
                        torch.from_numpy(valid), torch.full((C,), 0.01), K,
                        torch.eye(4), (5, 5))
    assert fb.semantic[2, 2].item() == CAR
    assert fb.instance[2, 2].item() == 10001
    assert abs(fb.depth[2, 2].item() - 2.0) < 1e-6
    win, zd = tb.splat_winner_slots(torch.from_numpy(pts),
                                    torch.from_numpy(valid),
                                    torch.full((C,), 0.01), K, torch.eye(4),
                                    (5, 5))
    assert win[2, 2].item() == C - 2 and (win >= 0).sum().item() == 1
