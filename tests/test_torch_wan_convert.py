"""Port parity: the released-weights converters of
``infinicube_tpu_torch/weights/{convert,wan_convert}.py`` against the JAX
package's on the same state dicts, and the towers they load against the
torch mirrors of the released models.

The port's ``state_dict``s must equal the JAX converters' trees carried
through ``weights.from_jax`` bit for bit (``torch.equal``): the DiT with and
without a buffer embedder and with a finetune overlay, the VAE, and umt5 in
Wan's and HuggingFace's layouts. The port's DiT and VAE loaded through the
converter match ``WanModelMirror`` and ``WanVAEMirror`` at f32 within atol
and rtol 2e-3 (the tolerance of tests/test_wan_torch_parity.py); its
T5Encoder against ``transformers`` is tests/test_torch_umt5_hf.py's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu import convert as jax_cli
from infinicube_tpu.models.wan.dit import WanDiTConfig as JaxDiTCfg
from infinicube_tpu.weights import convert as jconv
from infinicube_tpu.weights import wan_convert as jwan
from infinicube_tpu_torch import convert as tcli
from infinicube_tpu_torch.models.wan.dit import WanDiT, WanDiTConfig
from infinicube_tpu_torch.models.wan.t5 import T5Config, T5Encoder
from infinicube_tpu_torch.models.wan.vae3d import VideoVAE, VideoVAEConfig
from infinicube_tpu_torch.weights import convert as tconv
from infinicube_tpu_torch.weights import wan_convert as twan
from infinicube_tpu_torch.weights.from_jax import (dit_from_jax, t5_from_jax,
                                                   vae_from_jax)
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from torch_mirrors.umt5_keys import random_umt5, to_hf, umt5_shapes
from torch_mirrors.wan_dit_torch import WanModelMirror
from torch_mirrors.wan_vae_torch import WanVAEMirror

DIT = dict(dim=64, ffn_dim=128, num_layers=2, num_heads=2, in_channels=4,
           out_channels=4, text_dim=32, freq_dim=32, patch_size=(1, 2, 2),
           buffer_channels=6)
MIRROR = dict(dim=64, ffn_dim=128, num_layers=2, num_heads=2, in_dim=4,
              out_dim=4, text_dim=32, freq_dim=32)
VAE_MIRROR = dict(dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1,
                  temperal_downsample=(False, True))
VAE = dict(latent_channels=4, base_channels=8, channel_mult=(1, 2, 2),
           num_res_blocks=1, temporal_down=(False, True))
# f32 on both sides, differing only in summation order
TOL = dict(atol=2e-3, rtol=2e-3)


def _jax_dit_cfg():
    return JaxDiTCfg(**DIT, dtype=jnp.float32)


def _port_dit_cfg(**kw):
    return WanDiTConfig(**{**DIT, "dtype": torch.float32, **kw})


def _hold_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def mirrors():
    torch.manual_seed(0)
    dit = WanModelMirror(**MIRROR, buffer_dim=6).eval()
    vanilla = WanModelMirror(**MIRROR).eval()
    vae = WanVAEMirror(**VAE_MIRROR).eval()
    return dit, vanilla, vae


@pytest.fixture(scope="module")
def umt5():
    """Random tiny umt5 weights in Wan's layout and in HuggingFace's."""
    wsd = random_umt5(umt5_shapes(512, 64, 128, 2, 4, 16),
                      torch.Generator().manual_seed(1))
    return to_hf(wsd), wsd


def _dit_inputs(seed=1, T=2, H=4, W=6):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(1, 4, T, H, W)).astype(np.float32)
    buf = rng.normal(size=(1, 6, T, H, W)).astype(np.float32)
    txt = rng.normal(size=(1, 7, 32)).astype(np.float32)
    return lat, buf, txt, np.array([700.0], np.float32)


# ---------------------------------------------------------------------------
# the JAX-layout converters, each followed by from_jax, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan_layers", [True, False])
def test_dit_tree_equals_the_jax_converters(mirrors, scan_layers):
    dit, _, _ = mirrors
    sd = dit.state_dict()
    got = tconv.convert_wan_dit(sd, 2, 2, scan_layers=scan_layers)
    want = jconv.convert_wan_dit(sd, 2, 2, scan_layers=scan_layers)
    _hold_equal(dit_from_jax(got), dit_from_jax(want))
    _hold_equal(dit_from_jax(got), twan.wan_dit_state_dict(
        dict(sd), _port_dit_cfg()))


def test_vanilla_dit_gets_the_zero_buffer_embedder(mirrors):
    _, vanilla, _ = mirrors
    sd = vanilla.state_dict()
    want = dit_from_jax(jconv.initialize_buffer_embedder(
        jconv.convert_wan_dit(sd, 2, 2), _jax_dit_cfg()))
    got = twan.wan_dit_state_dict(dict(sd), _port_dit_cfg())
    _hold_equal(got, want)
    assert not got["buffer_embed.weight"].any()
    assert got["buffer_embed.weight"].shape == (64, 24)


def test_finetune_overlay_equals_the_jax_one(mirrors):
    dit, _, _ = mirrors
    g = torch.Generator().manual_seed(7)
    ft = {"buffer_embedder.weight": torch.randn(64, 6, 1, 2, 2, generator=g),
          "buffer_embedder.bias": torch.randn(64, generator=g),
          "dit.head.head.weight": torch.randn(16, 64, generator=g),
          "dit.blocks.1.self_attn.q.bias": torch.randn(64, generator=g),
          "optimizer.step": torch.tensor(1000)}
    sd = {k: v.detach() for k, v in dit.state_dict().items()}
    got, n_be, n_dit = tcli.overlay_finetune(sd, ft)
    want, *counts = jax_cli.overlay_finetune(sd, ft)
    assert (n_be, n_dit) == tuple(counts) == (2, 2)
    assert got.keys() == want.keys() and "optimizer.step" not in got
    _hold_equal(twan.wan_dit_state_dict(got, _port_dit_cfg()), dit_from_jax(
        jwan.convert_wan_pipeline(want, None, None, _jax_dit_cfg())["dit"]))


def test_vae_tree_equals_the_jax_converter(mirrors):
    _, _, vae = mirrors
    sd = vae.state_dict()
    want = vae_from_jax(jwan.convert_wan_vae(sd))
    _hold_equal(vae_from_jax(twan.convert_wan_vae(sd)), want)
    _hold_equal(twan.wan_vae_state_dict(sd), want)


@pytest.mark.parametrize("layout", ["wan", "hf"])
def test_umt5_tree_equals_the_jax_converters(umt5, layout):
    hsd, wsd = umt5
    sd = wsd if layout == "wan" else hsd
    conv = {"wan": "convert_umt5_wan", "hf": "convert_umt5_hf"}[layout]
    want = t5_from_jax(getattr(jwan, conv)(sd, 2))
    _hold_equal(t5_from_jax(getattr(twan, conv)(sd, 2)), want)
    _hold_equal(twan.umt5_state_dict(dict(sd), layout), want)
    # the bf16 tower holds its projections and embedding in bf16
    held = {k: v.dtype for k, v in T5Encoder(
        T5Config.tiny(), device="meta").state_dict().items()}
    cast = twan.umt5_state_dict(dict(sd), layout, dtypes=held)
    assert cast["embed.weight"].dtype == torch.bfloat16
    assert cast["layers.0.ln1.weight"].dtype == torch.float32
    _hold_equal(cast, {k: v.to(held[k]) for k, v in want.items()})


def test_pipeline_state_dicts_equal_the_jax_pipeline(mirrors, umt5):
    dit, _, vae = mirrors
    _, wsd = umt5
    want = jwan.convert_wan_pipeline(dit.state_dict(), vae.state_dict(),
                                     wsd, _jax_dit_cfg())
    got = twan.wan_pipeline_state_dict(dict(dit.state_dict()),
                                       vae.state_dict(), dict(wsd),
                                       _port_dit_cfg())
    tree = twan.convert_wan_pipeline(dit.state_dict(), vae.state_dict(),
                                     wsd, _port_dit_cfg())
    assert tree.keys() == want.keys() == got.keys()
    for tower, from_jax in (("dit", dit_from_jax), ("vae", vae_from_jax),
                            ("t5", t5_from_jax)):
        _hold_equal(got[tower], from_jax(want[tower]))
        _hold_equal(from_jax(tree[tower]), from_jax(want[tower]))


def test_generic_converters_equal_the_jax_ones():
    rng = np.random.default_rng(0)
    sd = {"lin.weight": torch.from_numpy(rng.normal(size=(4, 3))),
          "lin.bias": torch.zeros(4),
          "c3.weight": torch.from_numpy(rng.normal(size=(8, 2, 3, 3, 3))),
          "c2.weight": torch.from_numpy(rng.normal(size=(8, 2, 3, 3))),
          "c2.bias": torch.ones(8),
          "sc.weight": torch.arange(8 * 2 * 27.0).reshape(8, 2, 3, 3, 3),
          "n.weight": torch.ones(5), "n.bias": torch.zeros(5),
          "e.weight": torch.from_numpy(rng.normal(size=(10, 4))).bfloat16()}
    for name, prefix in (("convert_linear", "lin"),
                         ("convert_conv3d", "c3"), ("convert_conv2d", "c2"),
                         ("convert_sparse_conv3d", "sc"),
                         ("convert_norm", "n"), ("convert_embedding", "e")):
        got = getattr(tconv, name)(sd, prefix)
        want = getattr(jconv, name)(sd, prefix)
        assert got.keys() == want.keys(), name
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
    # the fvdb tap order: row-major over the window
    s = tconv.convert_sparse_conv3d(sd, "sc")["kernel"]
    np.testing.assert_array_equal(s[5], sd["sc.weight"][:, :, 0, 1, 2].T)
    x = rng.normal(size=(3, 4 * 8)).astype(np.float32)
    np.testing.assert_array_equal(tconv._rope_interleave_to_halfsplit(x, 4),
                                  jconv._rope_interleave_to_halfsplit(x, 4))


# ---------------------------------------------------------------------------
# numerics against the mirrors
# ---------------------------------------------------------------------------

def _port_dit(sd: dict, **kw) -> WanDiT:
    cfg = _port_dit_cfg(**kw)
    model = WanDiT(cfg, device="cpu").eval()
    model.load_state_dict(twan.wan_dit_state_dict(dict(sd), cfg))
    return model


def _channels_last(x):
    return torch.from_numpy(x.transpose(0, 2, 3, 4, 1).copy())


def test_converted_dit_matches_the_mirror(mirrors):
    dit, _, _ = mirrors
    lat, buf, txt, t = _dit_inputs()
    with torch.no_grad():
        ref = dit(*map(torch.from_numpy, (lat, t, txt, buf))).numpy()
        out = _port_dit(dit.state_dict())(
            _channels_last(lat), torch.from_numpy(t), torch.from_numpy(txt),
            _channels_last(buf)).numpy()
    np.testing.assert_allclose(out.transpose(0, 4, 1, 2, 3), ref, **TOL)


def test_converted_vanilla_dit_keeps_its_t2v_output(mirrors):
    """A vanilla T2V checkpoint with the zero buffer embedder: its output
    with buffers equals its output without, and the mirror's."""
    _, vanilla, _ = mirrors
    lat, buf, txt, t = _dit_inputs(seed=2)
    with torch.no_grad():
        ref = vanilla(*map(torch.from_numpy, (lat, t, txt))).numpy()
        model = _port_dit(vanilla.state_dict())
        args = (_channels_last(lat), torch.from_numpy(t),
                torch.from_numpy(txt))
        with_buf = model(*args, _channels_last(buf))
        without = model(*args)
    assert torch.equal(with_buf, without)
    np.testing.assert_allclose(without.numpy().transpose(0, 4, 1, 2, 3), ref,
                               **TOL)


def test_converted_vae_matches_the_mirror(mirrors):
    _, _, vae = mirrors
    model = VideoVAE(VideoVAEConfig(**VAE, dtype=torch.float32),
                     device="cpu").eval()
    model.load_state_dict(twan.wan_vae_state_dict(vae.state_dict()))
    rng = np.random.default_rng(0)
    vid = rng.uniform(-1, 1, (1, 3, 5, 16, 16)).astype(np.float32)
    with torch.no_grad():
        mu_ref = vae.encode(torch.from_numpy(vid))
        dec_ref = vae.decode(mu_ref).numpy()
        mu = model.encode(_channels_last(vid))
        dec = model.decode(mu)
    assert mu_ref.shape == (1, 4, 3, 4, 4)
    np.testing.assert_allclose(mu.numpy().transpose(0, 4, 1, 2, 3),
                               mu_ref.numpy(), **TOL)
    np.testing.assert_allclose(dec.numpy().transpose(0, 4, 1, 2, 3),
                               dec_ref, **TOL)


def test_dataclass_defaults_match_the_release():
    """The converter's release widths are the DiT's defaults."""
    cfg = WanDiTConfig.wan_1_3b()
    assert dataclasses.astuple(cfg)[:8] == (1536, 8960, 30, 12, 16, 16,
                                            4096, 256)
    assert (cfg.buffer_channels, cfg.patch_size) == (32, (1, 2, 2))
