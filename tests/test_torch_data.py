"""The port's data path against the JAX package's on one small clip made
from a seed: the converter's and the attribute generator's tar members,
the clip dataset's samples in the train and val splits (every key,
exactly), the tar reader and the collation."""

import numpy as np
import pytest
import torch

from infinicube_tpu.data import specs as jspecs
from infinicube_tpu.data import tario as jtario
from infinicube_tpu.data import waymo_dataset as jwd
from infinicube_tpu.data.codec import decode_member as jdecode
from infinicube_tpu.data_process import generate_additional_attributes as jga
from infinicube_tpu.data_process import waymo2shards as jw2s
from infinicube_tpu_torch.data import specs as tspecs
from infinicube_tpu_torch.data import tario as ttario
from infinicube_tpu_torch.data import waymo_dataset as twd
from infinicube_tpu_torch.data.codec import decode_member as tdecode
from infinicube_tpu_torch.data_process import (
    generate_additional_attributes as tga)
from infinicube_tpu_torch.data_process import waymo2shards as tw2s

import torch_clip


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same clips converted and processed by the port and by the JAX
    package, each into its own root."""
    base = tmp_path_factory.mktemp("clips")
    t = torch_clip.make_root(base / "port", tw2s.FrameRecord,
                             tw2s.convert_clip, tga.process_clip,
                             clips=("clipA", "clipB"), device="cpu")
    j = torch_clip.make_root(base / "jax", jw2s.FrameRecord,
                             jw2s.convert_clip, jga.process_clip,
                             clips=("clipA", "clipB"))
    return t, j


def _members(tar):
    with ttario.TarReader(tar) as r:
        return {n: r.read(n) for n in r.names()}


def test_converter_and_attributes_write_the_same_members(roots):
    t, j = roots
    tars_t = sorted(p.relative_to(t) for p in t.rglob("*.tar"))
    tars_j = sorted(p.relative_to(j) for p in j.rglob("*.tar"))
    assert tars_t == tars_j and len(tars_t) == 2 * 18
    for rel in tars_t:
        mt, mj = _members(t / rel), _members(j / rel)
        assert list(mt) == list(mj), rel
        for name, data in mt.items():
            ext = name.rsplit(".", 1)[-1]
            if ext == "png":
                # the JAX package writes pngs through PIL (filtered rows),
                # the port on zlib; each decoder reads both
                want = jdecode("png", mj[name])
                for png in (data, mj[name]):
                    np.testing.assert_array_equal(tdecode("png", png), want)
                    np.testing.assert_array_equal(jdecode("png", png), want)
            else:
                assert data == mj[name], (rel, name)


def _assert_samples_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, dict):
            assert list(va) == list(vb), k
            for kk in va:
                assert va[kk].dtype == vb[kk].dtype, (k, kk)
                np.testing.assert_array_equal(va[kk], vb[kk])
        elif isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, k
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb, k


def _key_map(sample):
    """A JAX sample re-keyed by the port's DatasetSpec."""
    return {tspecs.DatasetSpec[k.name]: v for k, v in sample.items()}


@pytest.mark.parametrize("kw", [
    dict(split="train", samples_per_shard=2, crop_augment=True, seed=3),
    dict(split="train", samples_per_shard=1, views=torch_clip.VIEWS,
         replace_all_car_with_cad=True, seed=5),
    dict(split="val", val_starting_frame=1, views=torch_clip.VIEWS)],
    ids=["train", "train_views_cad", "val_views"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dataset_samples_equal_the_jax_ones(roots, kw, writer):
    """On the clips the port wrote and on those the JAX package wrote."""
    root = roots[writer == "jax"]
    common = dict(root=str(root), frame_start=0, frame_end=4,
                  crop_bbox_min=(-12.8, -12.8, -3.2),
                  crop_bbox_max=(12.8, 12.8, 9.6), **kw)
    got = list(twd.WaymoClipDataset(twd.WaymoDatasetConfig(**common)))
    want = list(jwd.WaymoClipDataset(jwd.WaymoDatasetConfig(**common)))
    assert len(got) == len(want) == 2 * (
        kw["samples_per_shard"] if kw["split"] == "train" else 1)
    for a, b in zip(got, want):
        _assert_samples_equal(a, _key_map(b))
    assert all(tspecs.DatasetSpec.BOXES_3D in s and
               tspecs.DatasetSpec.MAPS_3D in s for s in got)
    if "views" in kw:
        s = got[0]
        assert s[tspecs.DatasetSpec.IMAGES_INPUT].shape == (
            3,) + torch_clip.HW + (3,)
        # LiDAR depth is written for the front camera only
        assert tspecs.DatasetSpec.IMAGES_INPUT_DEPTH not in s


def test_build_dataset_splits_clips_by_process(roots):
    t, _ = roots
    cfg = twd.WaymoDatasetConfig(root=str(t), frame_start=0, frame_end=4,
                                 samples_per_shard=1)
    assert len(twd.build_dataset(cfg).scenes) == 2
    halves = [twd.build_dataset(cfg, host_index=i, num_hosts=2).scenes
              for i in range(2)]
    assert sorted(halves[0] + halves[1]) == ["clipA", "clipB"]
    assert len(list(twd.build_dataset(cfg, 1, 2))) == 1


def test_get_sample_and_collation(roots, tmp_path):
    t, _ = roots
    tar = t / "pose" / "clipA.tar"
    got = ttario.get_sample(tar, "000001")
    assert got == jtario.get_sample(tar, "000001")
    assert set(got) == {"npy", "front_left.npy", "front_right.npy"}
    rng = np.random.default_rng(0)
    samples = [{spec.INPUT_PC: rng.normal(size=(n, 3)).astype(np.float32),
                spec.CLASS: i} for i, n in enumerate((5, 3))
               for spec in [tspecs.DatasetSpec]]
    jsamples = [{jspecs.DatasetSpec[k.name]: v for k, v in s.items()}
                for s in samples]
    for caps in (None, 4):
        a = tspecs.pad_collate(samples, caps and {
            tspecs.DatasetSpec.INPUT_PC: caps})
        b = jspecs.pad_collate(jsamples, caps and {
            jspecs.DatasetSpec.INPUT_PC: caps})
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert tspecs.pad_collate(samples, {tspecs.DatasetSpec.INPUT_PC: 4}
                              )["input_pc_mask"].sum() == 7


def _header(name, size_field, typeflag=b"0"):
    hdr = bytearray(512)
    hdr[0:len(name)] = name
    hdr[100:108] = b"0000644\x00"
    hdr[108:116] = b"0000000\x00"
    hdr[116:124] = b"0000000\x00"
    hdr[124:136] = size_field
    hdr[136:148] = b"00000000000\x00"
    hdr[156:157] = typeflag
    hdr[257:262] = b"ustar"
    hdr[148:156] = b"        "
    hdr[148:156] = ("%06o" % sum(hdr)).encode() + b"\x00 "
    return bytes(hdr)


def test_tar_reader_refuses_truncated_and_malformed_members(tmp_path):
    """What the JAX reader refuses, the port's refuses: a member whose data
    runs past the end of the file, and one whose size field is neither
    octal nor base-256; members before them still read."""
    ok = _header(b"ok.bin", b"00000000005\x00") + b"hello" + b"\0" * 507
    cases = {
        "trunc": ok + _header(b"big.bin", b"00004000000\x00") + b"0123",
        "garbage": ok + _header(b"bad.bin", b"zzzzzzzzzzz\x00") +
        b"\0" * 1024,
        "base256": _header(b"b256.bin", b"\x80" + b"\0" * 10 + b"\x03") +
        b"abc" + b"\0" * 509 + b"\0" * 1024,
    }
    for name, data in cases.items():
        p = tmp_path / f"{name}.tar"
        p.write_bytes(data)
        with ttario.TarReader(p) as r, jtario.TarReader(p) as rj:
            assert r.names() == rj.names(), name
            for n in r.names():
                assert r.read(n) == rj.read(n)
    with ttario.TarReader(tmp_path / "trunc.tar") as r:
        assert r.names() == ["ok.bin"] and r.read("ok.bin") == b"hello"
        assert "big.bin" not in r
        with pytest.raises(KeyError):
            r.read("big.bin")
    with ttario.TarReader(tmp_path / "base256.tar") as r:
        assert r.read("b256.bin") == b"abc"


def test_voxel_buffers_equal_the_jax_ones(tmp_path):
    """The 0.2 m voxel depth, semantic and instance buffers of two frames,
    decoded, equal."""
    fr = torch_clip.frames(jw2s.FrameRecord, 2)
    args = (np.stack([f.cam_to_world_opencv for f in fr]), fr[0].intrinsic,
            torch_clip.HW, np.concatenate([f.points for f in fr]),
            np.concatenate([f.point_semantics for f in fr]))
    jga.generate_voxel_buffers(tmp_path / "j", "c", *args, capacity=1 << 14)
    tga.generate_voxel_buffers(tmp_path / "t", "c", *args, capacity=1 << 14,
                               device="cpu")
    for attr in ("voxel_depth_100", "semantic_buffer", "instance_buffer"):
        mt = _members(tmp_path / "t" / attr / "c.tar")
        mj = _members(tmp_path / "j" / attr / "c.tar")
        assert list(mt) == list(mj) == ["000000.png", "000001.png"]
        for name in mt:
            a = tdecode("png", mt[name])
            np.testing.assert_array_equal(a, jdecode("png", mj[name]))
            assert a.dtype == np.uint16
            if attr != "instance_buffer":
                assert (a > 0).mean() > 0.1
