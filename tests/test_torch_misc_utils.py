"""Port parity: ``infinicube_tpu_torch.utils.model_merge.merge_gsm_params``
and ``utils.run_resolve.resolve_checkpoint`` against the JAX package's on the
same trees and folders: the merge of a GSM's ``state_dict``s equals the JAX
merge of the flax trees carried through ``weights.from_jax.gsm_from_jax``,
and every reference resolves to the same path."""

import sys
import types

import numpy as np
import pytest
import torch

from infinicube_tpu.utils.model_merge import merge_gsm_params as jax_merge
from infinicube_tpu.utils.run_resolve import \
    resolve_checkpoint as jax_resolve
from infinicube_tpu_torch.utils.model_merge import merge_gsm_params
from infinicube_tpu_torch.utils.run_resolve import resolve_checkpoint
from infinicube_tpu_torch.weights.from_jax import gsm_from_jax
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

BRANCHES = ("voxel_branch", "pixel_branch", "sky", "encoder")


def _tree(seed, names=BRANCHES):
    """A GSM-shaped flax tree: a Dense, a norm and a sparse conv a branch."""
    rng = np.random.default_rng(seed)
    return {"params": {name: {
        "proj": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                 "bias": rng.normal(size=3).astype(np.float32)},
        "norm": {"scale": rng.normal(size=3).astype(np.float32)},
        "conv": {"kernel": rng.normal(size=(27, 3, 2)).astype(np.float32)},
    } for name in names}}


def _hold_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("take_sky_from", ["voxel", "pixel"])
@pytest.mark.parametrize("given", ["both", "voxel", "pixel"])
def test_merge_equals_the_jax_merge(take_sky_from, given):
    dual = _tree(0)
    vox = _tree(1, ("voxel_branch", "sky", "encoder"))
    pix = _tree(2, ("pixel_branch", "sky", "encoder"))
    vox_in = vox if given != "pixel" else None
    pix_in = pix if given != "voxel" else None
    want = gsm_from_jax(jax_merge(dual, vox_in, pix_in, take_sky_from))
    dual_sd = gsm_from_jax(dual)
    got = merge_gsm_params(
        dual_sd, None if vox_in is None else gsm_from_jax(vox),
        None if pix_in is None else gsm_from_jax(pix), take_sky_from)
    _hold_equal(got, want)
    # the inputs are left as they were, the result shares no storage
    _hold_equal(dual_sd, gsm_from_jax(dual))
    assert all(got[k].data_ptr() != dual_sd[k].data_ptr() for k in got)


def test_merge_grafts_only_what_both_hold():
    dual = _tree(0, ("voxel_branch", "sky"))
    vox = _tree(1, ("voxel_branch", "encoder"))
    want = gsm_from_jax(jax_merge(dual, vox))
    got = merge_gsm_params(gsm_from_jax(dual), gsm_from_jax(vox))
    _hold_equal(got, want)
    assert not any(k.startswith("encoder.") for k in got)


def test_resolve_matches_the_jax_resolver(tmp_path):
    (tmp_path / "a").mkdir()
    for step in (5, 9):
        (tmp_path / "a" / f"ckpt_{step}.npz").write_bytes(b"x")
    (tmp_path / "b" / "run" / "100").mkdir(parents=True)
    (tmp_path / "b" / "run" / "20").mkdir()
    for ref in (f"tb:{tmp_path / 'a'}", f"tb:{tmp_path / 'b'}",
                "/some/local/path", "relative/ckpt"):
        assert resolve_checkpoint(ref) == jax_resolve(ref), ref
    for bad in (f"tb:{tmp_path}/empty", f"tb:{tmp_path / 'a' / 'none'}"):
        with pytest.raises(FileNotFoundError):
            jax_resolve(bad)
        with pytest.raises(FileNotFoundError):
            resolve_checkpoint(bad)


def test_resolve_finds_the_ports_latest_checkpoint(tmp_path):
    """The port's trainer writes ``ckpt_{step}.pt``: the highest step wins."""
    for step in (5, 9, 10):
        (tmp_path / f"ckpt_{step}.pt").write_bytes(b"x")
    (tmp_path / "ckpt_5.tmp").write_bytes(b"x")
    assert resolve_checkpoint(f"tb:{tmp_path}").name == "ckpt_10.pt"


def test_resolve_wandb_as_the_jax_resolver(tmp_path, monkeypatch):
    class Art:
        def __init__(self, type_, version, path):
            self.type, self.version, self._p = type_, version, path

        def download(self):
            return str(self._p)

    arts = [Art("dataset", "v0", tmp_path / "d"),
            Art("model", "v0", tmp_path / "m0"),
            Art("model", "v1", tmp_path / "m1")]

    class Api:
        def run(self, run_path):
            assert run_path == "ent/proj/run7"
            return types.SimpleNamespace(logged_artifacts=lambda: arts)

    monkeypatch.setitem(sys.modules, "wandb",
                        types.SimpleNamespace(Api=Api))
    for ref in ("wdb:ent/proj/run7", "wdb:ent/proj/run7:v0"):
        assert resolve_checkpoint(ref) == jax_resolve(ref)
    assert resolve_checkpoint("wdb:ent/proj/run7").name == "m1"
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint("wdb:ent/proj/run7:v9")
    # without the package, as the JAX resolver, it raises naming it
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(RuntimeError, match="wandb"):
        resolve_checkpoint("wdb:ent/proj/run7")
    with pytest.raises(RuntimeError, match="wandb"):
        jax_resolve("wdb:ent/proj/run7")
