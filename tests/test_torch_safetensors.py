"""The port's checkpoint readers (``infinicube_tpu_torch/weights/convert.py``):
``.safetensors`` read without the ``safetensors`` package equal
``safetensors.torch.load_file`` bit for bit in F32, F16 and BF16 (and the
other dtypes of the format), as a single file, as shards with their index
json and as a directory; damaged files raise naming the file and the key.
Pickles load with ``weights_only=True`` and are refused, never retried, when
they hold another object."""

import argparse
import json
import pickle
import struct
import sys

import pytest
import torch

from infinicube_tpu import convert as jax_cli
from infinicube_tpu_torch.weights import convert as tconv
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

st = pytest.importorskip("safetensors.torch")

DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def _tensors(seed=0) -> dict:
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        out[f"blocks.{i}.w"] = torch.randn(3 + i, 5, generator=g).to(dt)
        out[f"blocks.{i}.b"] = torch.randn(7, generator=g).to(dt)
    out["scalar"] = torch.tensor(2.5)
    out["empty"] = torch.zeros(0, 4)
    return out


def _other_dtypes() -> dict:
    g = torch.Generator().manual_seed(1)
    return {"f64": torch.randn(4, generator=g, dtype=torch.float64),
            "i64": torch.arange(-3, 3), "i32": torch.arange(5).int(),
            "i16": torch.arange(6).short(), "i8": torch.arange(-4, 4).char(),
            "u8": torch.arange(200, 209).byte(),
            "bool": torch.tensor([True, False, True])}


def _hold_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def _write_shards(sd: dict, folder, shards=3):
    """The released 14B layout: shards and their weight-map index."""
    folder.mkdir()
    keys = sorted(sd)
    weight_map = {}
    for s in range(shards):
        name = f"diffusion_pytorch_model-{s + 1:05d}-of-{shards:05d}" \
               ".safetensors"
        st.save_file({k: sd[k] for k in keys[s::shards]}, folder / name)
        weight_map.update({k: name for k in keys[s::shards]})
    (folder / "diffusion_pytorch_model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))


def test_single_file_equals_the_package(tmp_path):
    sd = {**_tensors(), **_other_dtypes()}
    path = tmp_path / "diffusion_pytorch_model.safetensors"
    st.save_file(sd, path, metadata={"format": "pt"})
    _hold_equal(tconv.load_safetensors(path), st.load_file(path))
    _hold_equal(tconv.load_safetensors(path), sd)


def test_sharded_index_and_directory_equal_the_package(tmp_path):
    sd = _tensors(seed=2)
    _write_shards(sd, tmp_path / "sharded")
    index = tmp_path / "sharded" / \
        "diffusion_pytorch_model.safetensors.index.json"
    want = {}
    for f in sorted((tmp_path / "sharded").glob("*.safetensors")):
        want.update(st.load_file(f))
    _hold_equal(tconv.load_safetensors_any(index), want)
    _hold_equal(tconv.load_safetensors_any(tmp_path / "sharded"), want)
    # a directory without an index: every file in it
    (tmp_path / "plain").mkdir()
    items = list(sd.items())
    st.save_file(dict(items[:3]), tmp_path / "plain" / "a.safetensors")
    st.save_file(dict(items[3:]), tmp_path / "plain" / "b.safetensors")
    _hold_equal(tconv.load_released_state_dict(tmp_path / "plain"), sd)
    # the JAX loader reads the same shards to the same numbers
    ref = jax_cli.load_released_state_dict(tmp_path / "sharded")
    got = tconv.load_released_state_dict(tmp_path / "sharded")
    assert ref.keys() == got.keys()
    for k in ref:
        if got[k].dtype != torch.bfloat16:
            assert (got[k].numpy() == ref[k]).all(), k


def test_reader_needs_no_package(tmp_path, monkeypatch):
    sd = _tensors(seed=3)
    path = tmp_path / "a.safetensors"
    st.save_file(sd, path)
    for name in [m for m in sys.modules if m.split(".")[0] == "safetensors"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    _hold_equal(tconv.load_torch_state_dict(path), sd)


def test_damaged_files_raise_naming_file_and_key(tmp_path):
    sd = _tensors(seed=4)
    path = tmp_path / "a.safetensors"
    st.save_file(sd, path)
    data = path.read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])

    cut = tmp_path / "cut.safetensors"
    cut.write_bytes(data[:-10])
    with pytest.raises(ValueError, match=r"cut\.safetensors.*past the end"):
        tconv.load_safetensors(cut)
    short = tmp_path / "short.safetensors"
    short.write_bytes(data[:8 + n // 2])
    with pytest.raises(ValueError, match="short.safetensors: header"):
        tconv.load_safetensors(short)

    def rewrite(name, hdr):
        body = json.dumps(hdr).encode()
        p = tmp_path / name
        p.write_bytes(struct.pack("<Q", len(body)) + body + data[8 + n:])
        return p

    key = "blocks.1.w"
    odd = dict(header, **{key: dict(header[key], dtype="F8_E4M3")})
    with pytest.raises(ValueError, match=r"odd\.safetensors.*blocks\.1\.w.*"
                                         r"F8_E4M3"):
        tconv.load_safetensors(rewrite("odd.safetensors", odd))
    lo, hi = header[key]["data_offsets"]
    wrong = dict(header, **{key: dict(header[key],
                                      data_offsets=[lo, hi + 2])})
    with pytest.raises(ValueError, match=r"blocks\.1\.w.*data_offsets"):
        tconv.load_safetensors(rewrite("wrong.safetensors", wrong))
    junk = tmp_path / "junk.safetensors"
    junk.write_bytes(struct.pack("<Q", 5) + b"{oops" + data[8 + n:])
    with pytest.raises(ValueError, match="junk.safetensors.*does not parse"):
        tconv.load_safetensors(junk)
    with pytest.raises(FileNotFoundError):
        tconv.load_safetensors_any(tmp_path / "nothing")


def test_misaligned_tensors_are_copied_out(tmp_path):
    """A writer other than the package may place a tensor at an offset that
    is no multiple of its element size."""
    a = torch.arange(3, dtype=torch.uint8)
    b = torch.randn(5, generator=torch.Generator().manual_seed(5))
    hdr = {"a": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
           "b": {"dtype": "F32", "shape": [5], "data_offsets": [3, 23]}}
    body = json.dumps(hdr).encode()
    body += b" " * (-len(body) % 8)
    path = tmp_path / "odd.safetensors"
    path.write_bytes(struct.pack("<Q", len(body)) + body +
                     a.numpy().tobytes() + b.numpy().tobytes())
    _hold_equal(tconv.load_safetensors(path), {"a": a, "b": b})


def test_pickles_load_weights_only_and_refuse_other_objects(tmp_path):
    sd = {"w": torch.arange(3.0), "b": torch.ones(2, dtype=torch.bfloat16)}
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "a.ckpt")
    _hold_equal(tconv.load_torch_state_dict(tmp_path / "a.ckpt"), sd)
    torch.save(sd, tmp_path / "old.pt", _use_new_zipfile_serialization=False)
    _hold_equal(tconv.load_released_state_dict(tmp_path / "old.pt"), sd)
    torch.save({"state_dict": sd,
                "hyper_parameters": argparse.Namespace(lr=1e-4)},
               tmp_path / "lightning.ckpt")
    with pytest.raises(pickle.UnpicklingError,
                       match=r"lightning\.ckpt.*argparse\.Namespace"):
        tconv.load_torch_state_dict(tmp_path / "lightning.ckpt")
