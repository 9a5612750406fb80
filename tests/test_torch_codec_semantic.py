"""Port parity: the port's own copies of the JAX package's host-side
modules that stage 2 needs: the png codec (through PIL, the reference's
decoder), the other member encodings and the tar writer, the semantic
palette, ``vis_depth``, the box helpers (``assign_instance_ids``,
``corners_from_lwh_pose``, ``crop_points_aabb``, ``box3d_overlap`` within
1e-6) and ``WorldGrid``'s ``merge_points`` / ``crop`` / ``occupancy_in``."""

import numpy as np
import pytest
import torch

from infinicube_tpu.data import codec as jcodec
from infinicube_tpu.data.tario import TarReader as JaxTarReader
from infinicube_tpu.utils import bbox as jbbox
from infinicube_tpu.utils import depth_vis as jdv
from infinicube_tpu.utils import semantic as jsem
from infinicube_tpu.utils.world_grid import WorldGrid as JaxWorldGrid
from infinicube_tpu_torch.data import codec
from infinicube_tpu_torch.data.tario import TarReader, TarWriter
from infinicube_tpu_torch.utils import bbox, depth_vis, semantic
from infinicube_tpu_torch.utils.interpolate import quat_to_rot
from infinicube_tpu_torch.utils.world_grid import WorldGrid


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (37, 23)),
                                         (np.uint16, (37, 23)),
                                         (np.uint8, (19, 31, 3)),
                                         (np.uint8, (5, 7, 4))])
def test_png_round_trip_through_pil(dtype, shape):
    """The port's png bytes decode through PIL (the reference's
    ``decode_member``) and through its own decoder to the same array, uint16
    kept."""
    rng = np.random.default_rng(shape[0])
    arr = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    data = codec.encode_member("png", arr)
    ref = jcodec.decode_member("png", data)
    assert ref.dtype == dtype
    np.testing.assert_array_equal(ref, arr)
    got = codec.decode_member("png", data)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, arr)


def _png_from_rows(shape, depth, ctype, raw):
    """A png of the header fields given around the row bytes ``raw``."""
    import struct
    import zlib

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", shape[1], shape[0], depth, ctype, 0, 0, 0)) +
        chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def _filter_rows(img, bpp, filters):
    """The png spec's forward filters, byte by byte: uint8 rows [H, n] and
    a filter type a row -> the stored bytes, each row led by its type."""
    out, prev = bytearray(), [0] * img.shape[1]
    for row, ft in zip(img.tolist(), filters):
        out.append(ft)
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = [0, a, b, (a + b) // 2,
                    a if pa <= pb and pa <= pc else b if pb <= pc else c][ft]
            out.append((x - pred) % 256)
        prev = row
    return out


def test_png_decoder_refuses_filtered_rows():
    """A row filter type the format does not define (5 and up) is refused,
    not misread; the five it defines are read."""
    img = np.zeros((2, 3), np.uint8)
    for ft in range(5):
        data = _png_from_rows(img.shape, 8, 0, _filter_rows(img, 1, [ft] * 2))
        np.testing.assert_array_equal(codec.decode_png(data), img)
    raw = _filter_rows(img, 1, [0, 0])
    raw[4] = 5
    with pytest.raises(ValueError, match="filter 5"):
        codec.decode_png(_png_from_rows(img.shape, 8, 0, raw))


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (13, 11)),
                                         (np.uint16, (13, 11)),
                                         (np.uint8, (9, 14, 3)),
                                         (np.uint8, (7, 5, 4))])
def test_png_decoder_undoes_every_row_filter(dtype, shape):
    """Rows stored under each of the five filters, one type throughout and
    mixed row by row, decode to the image, as they do through PIL; and a
    png that PIL writes with its own filter choice (smooth images, so it
    picks filters other than None) decodes as PIL decodes it."""
    import io

    from PIL import Image
    rng = np.random.default_rng(shape[1])
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    c = shape[2] if len(shape) == 3 else 1
    depth = 8 * img.dtype.itemsize
    ctype = {1: 0, 3: 2, 4: 6}[c]
    rows = img.astype(img.dtype.newbyteorder(">")).reshape(
        shape[0], -1).view(np.uint8)
    bpp = c * depth // 8
    for filters in [[ft] * shape[0] for ft in range(5)] + [
            rng.integers(0, 5, shape[0]).tolist()]:
        data = _png_from_rows(shape, depth, ctype,
                              _filter_rows(rows, bpp, filters))
        got = codec.decode_png(data)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(jcodec.decode_member("png", data), img)
    ramp = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 3
    smooth = (ramp if c == 1 else np.stack(
        [ramp * (k + 1) for k in range(c)], -1)).astype(dtype)
    buf = io.BytesIO()
    Image.fromarray(smooth).save(buf, format="PNG")
    got = codec.decode_png(buf.getvalue())
    np.testing.assert_array_equal(got, smooth)
    np.testing.assert_array_equal(
        got, jcodec.decode_member("png", buf.getvalue()))


def test_other_members_and_tars(tmp_path):
    """npy, npz, json, txt and pkl encode to what the reference decodes;
    the tar the port writes reads back through the reference's reader."""
    values = {"npy": np.arange(12, dtype=np.float32).reshape(3, 4),
              "json": {"a": [1, 2], "b": "c"}, "txt": "hello",
              "npz": {"x": np.ones(3), "y": np.zeros((2, 2), np.int32)},
              "pkl": {"k": (1, 2.5)}}
    with TarWriter(tmp_path / "s.tar") as w:
        for ext, v in values.items():
            w.add(f"000000.{ext}", codec.encode_member(ext, v))
    with JaxTarReader(tmp_path / "s.tar") as r, \
            TarReader(tmp_path / "s.tar") as r2:
        assert r.names() == r2.names() == [f"000000.{e}" for e in values]
        for ext, v in values.items():
            for dec, raw in ((jcodec.decode_member, r.read(f"000000.{ext}")),
                             (codec.decode_member,
                              r2.read(f"000000.{ext}"))):
                got = dec(ext, raw)
                if ext == "npz":
                    assert got.keys() == v.keys()
                    for k in v:
                        np.testing.assert_array_equal(got[k], v[k])
                elif ext == "npy":
                    np.testing.assert_array_equal(got, v)
                else:
                    assert got == v


def test_semantic_palette_and_depth_vis():
    rng = np.random.default_rng(3)
    sem = rng.integers(0, 23, (2, 9, 11))
    inst = np.where(rng.random((2, 9, 11)) < 0.3,
                    rng.integers(1, 20000, (2, 9, 11)), 0)
    np.testing.assert_array_equal(
        semantic.generate_rgb_semantic_buffer(sem, inst),
        jsem.generate_rgb_semantic_buffer(sem, inst))
    np.testing.assert_array_equal(semantic.instance_colors(inst),
                                  jsem.instance_colors(inst))
    assert semantic.CAR_LIKE_IDS == jsem.CAR_LIKE_IDS
    depth = rng.uniform(0, 60, (9, 11)).astype(np.float32)
    depth[:2] = 0
    for md in (None, 30.0):
        np.testing.assert_array_equal(depth_vis.vis_depth(depth, md),
                                      jdv.vis_depth(depth, md))
    mono = rng.uniform(0.1, 1, (9, 11))
    assert depth_vis.align_depth_lstsq(mono, depth) == \
        jdv.align_depth_lstsq(mono, depth)


def _boxes(seed, n):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        yaw = rng.uniform(-np.pi, np.pi)
        poses[i, :3, :3] = quat_to_rot(np.array([np.cos(yaw / 2), 0, 0,
                                                 np.sin(yaw / 2)]))
        poses[i, :3, 3] = rng.uniform(-4, 4, 3)
    return poses, rng.uniform(1, 5, (n, 3))


def test_box_helpers():
    poses, lwhs = _boxes(0, 4)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-8, 8, (3000, 3))
    sem = rng.integers(0, 5, 3000)
    ids = np.array([11, 12, 13, 14])
    ref = jbbox.assign_instance_ids(pts, sem, poses, lwhs, ids,
                                    jsem.CAR_LIKE_IDS)
    np.testing.assert_array_equal(bbox.assign_instance_ids(
        pts, sem, poses, lwhs, ids, semantic.CAR_LIKE_IDS), ref)
    got = bbox.assign_instance_ids(torch.from_numpy(pts),
                                   torch.from_numpy(sem),
                                   torch.from_numpy(poses),
                                   torch.from_numpy(lwhs), ids,
                                   semantic.CAR_LIKE_IDS)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref > 0).sum() > 10
    ref_c = jbbox.corners_from_lwh_pose(lwhs, poses)
    np.testing.assert_allclose(bbox.corners_from_lwh_pose(lwhs, poses),
                               ref_c, atol=1e-6)
    np.testing.assert_allclose(bbox.corners_from_lwh_pose(
        torch.from_numpy(lwhs), torch.from_numpy(poses)).numpy(), ref_c,
        atol=1e-6)
    lo, hi = (-2, -1, 0), (3, 4, 5)
    np.testing.assert_array_equal(bbox.crop_points_aabb(pts, lo, hi),
                                  jbbox.crop_points_aabb(pts, lo, hi))
    np.testing.assert_array_equal(
        bbox.crop_points_aabb(torch.from_numpy(pts), lo, hi).numpy(),
        jbbox.crop_points_aabb(pts, lo, hi))
    np.testing.assert_array_equal(
        bbox.points_in_obb(pts, poses[0], lwhs[0], 1.2),
        jbbox.points_in_obb(pts, poses[0], lwhs[0], 1.2))


@pytest.mark.parametrize("pair", [(0, 1), (1, 2), (0, 0), (2, 3)])
def test_box3d_overlap(pair):
    poses, lwhs = _boxes(5, 4)
    poses[1, :3, 3] = poses[0, :3, 3] + 0.5        # overlapping pair
    i, j = pair
    ref = jbbox.box3d_overlap(lwhs[i], poses[i], lwhs[j], poses[j])
    for args in ((lwhs[i], poses[i], lwhs[j], poses[j]),
                 tuple(map(torch.from_numpy, (lwhs[i], poses[i], lwhs[j],
                                              poses[j])))):
        got = bbox.box3d_overlap(*args)
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    if i == j:
        assert abs(ref[1] - 1.0) < 1e-6


def test_world_grid_merge_crop_occupancy():
    rng = np.random.default_rng(7)
    pts = rng.uniform(-10, 10, (4000, 3))
    sem = rng.integers(0, 23, 4000)
    worlds = [WorldGrid(0.4), JaxWorldGrid(0.4)]
    for w in worlds:
        w.merge_points(pts[:3000], sem[:3000])
        w.merge_points(pts[2000:], sem[2000:] + 1, keep_existing=False)
    a, b = worlds
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.semantics, b.semantics)
    for lo, hi in (((-3, -3, -3), (2, 5, 1)), ((20, 20, 20), (30, 30, 30))):
        for got, ref in zip(a.crop(lo, hi), b.crop(lo, hi)):
            np.testing.assert_array_equal(got, ref)
        assert a.occupancy_in(lo, hi) == b.occupancy_in(lo, hi)
    assert a.occupancy_in((-3, -3, -3), (2, 5, 1))
    assert not a.occupancy_in((20, 20, 20), (30, 30, 30))
