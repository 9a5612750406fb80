"""The port's released-weights CLI (``python -m infinicube_tpu_torch.convert``)
against the JAX package's (``infinicube_tpu/convert.py``) on the same files,
written in the released layouts by the torch mirrors: a sharded safetensors
DiT with its index, a ``Wan2.1_VAE.pth`` and a Wan-layout umt5 ``.pth`` in
bf16.

- Each tower file the port writes equals its in-memory conversion, and the
  JAX CLI's Orbax tree carried through ``weights.from_jax``, bit for bit (in
  the dtypes the port's towers hold); with ``--no-buffer-embedder`` and with
  a finetune ``.ckpt`` too. The sidecar holds the JAX CLI's keys and values.
- ``WanVideoGenerator.from_checkpoint(..., device="cpu")``: ``generate``
  equals, bit for bit, a generator loaded in memory with the same
  ``state_dict``s; the text and buffer encodes, a 2-step CFG denoise from the
  same noise and the decode match the JAX package's CLI -> ``from_checkpoint``
  on the same files within atol and rtol 2e-3 (f32 on both sides, the
  tolerance of tests/test_torch_wan_pipeline.py), and the uint8 frames
  within one level.
- A VAE-only checkpoint serves, its other towers from the given generator.

Stage 2's ``--ckpt`` is tests/test_torch_stage2_ckpt.py's."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu import convert as jax_cli
from infinicube_tpu.models.wan.dit import WanDiTConfig as JaxDiTCfg
from infinicube_tpu.models.wan.pipeline import WanPipelineConfig as JaxCfg
from infinicube_tpu.models.wan.pipeline import WanVideoGenerator as JaxGen
from infinicube_tpu.models.wan.t5 import T5Config as JaxT5Cfg
from infinicube_tpu.models.wan.vae3d import VideoVAEConfig as JaxVAECfg
from infinicube_tpu_torch import convert as tcli
from infinicube_tpu_torch.models.wan.dit import WanDiTConfig
from infinicube_tpu_torch.models.wan.pipeline import (WanPipelineConfig,
                                                      WanVideoGenerator)
from infinicube_tpu_torch.models.wan.t5 import T5Config
from infinicube_tpu_torch.models.wan.vae3d import VideoVAEConfig
from infinicube_tpu_torch.weights.from_jax import pipeline_from_jax
from infinicube_tpu_torch.weights.wan_convert import wan_pipeline_state_dict
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.test_torch_wan_pipeline import _Tokenizer
from torch_mirrors.umt5_keys import random_umt5, umt5_shapes
from torch_mirrors.wan_dit_torch import WanModelMirror
from torch_mirrors.wan_vae_torch import WanVAEMirror

st = pytest.importorskip("safetensors.torch")

DIT = dict(dim=64, ffn_dim=128, num_layers=2, num_heads=2, in_channels=4,
           out_channels=4, text_dim=32, freq_dim=32, patch_size=(1, 2, 2),
           buffer_channels=8)
VAE = dict(latent_channels=4, base_channels=8, channel_mult=(1, 2, 2),
           num_res_blocks=1, temporal_down=(False, True))
T5 = dict(d_model=32, d_ff=64)
PIPE = dict(num_frames=5, height=16, width=16, num_steps=2,
            guidance_scale=2.0, max_text_len=16)
# f32 on both sides, differing only in summation order
TOL = dict(atol=2e-3, rtol=2e-3)


def _port_cfg():
    return WanPipelineConfig(
        dit=WanDiTConfig(**DIT, dtype=torch.float32),
        vae=VideoVAEConfig(**VAE, dtype=torch.float32),
        t5=T5Config.tiny(**T5, dtype=torch.float32), **PIPE)


def _jax_cfg():
    return JaxCfg(dit=JaxDiTCfg(**DIT, dtype=jnp.float32),
                  vae=JaxVAECfg(**VAE, dtype=jnp.float32),
                  t5=JaxT5Cfg.tiny(**T5, dtype=jnp.float32), **PIPE)


@pytest.fixture(autouse=True)
def tiny_variant(monkeypatch):
    """Both CLIs convert the 1.3b variant; here it has the mirror's widths
    (the sidecar's overrides still apply)."""
    monkeypatch.setattr(WanDiTConfig, "wan_1_3b", staticmethod(
        lambda **kw: WanDiTConfig(**{**DIT, "dtype": torch.float32, **kw})))
    monkeypatch.setattr(JaxDiTCfg, "wan_1_3b", staticmethod(
        lambda **kw: JaxDiTCfg(**{**DIT, "dtype": jnp.float32, **kw})))


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    root = tmp_path_factory.mktemp("released")
    torch.manual_seed(0)
    dit = WanModelMirror(dim=64, ffn_dim=128, num_layers=2, num_heads=2,
                         in_dim=4, out_dim=4, text_dim=32, freq_dim=32,
                         buffer_dim=8).eval()
    sd = dit.state_dict()
    folder = root / "Wan2.1-T2V-tiny"
    folder.mkdir()
    keys, weight_map = sorted(sd), {}
    for s in range(3):
        name = f"diffusion_pytorch_model-{s + 1:05d}-of-00003.safetensors"
        st.save_file({k: sd[k].contiguous() for k in keys[s::3]},
                     folder / name)
        weight_map.update({k: name for k in keys[s::3]})
    (folder / "diffusion_pytorch_model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))
    vae = WanVAEMirror(dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1,
                       temperal_downsample=(False, True)).eval()
    torch.save(vae.state_dict(), root / "Wan2.1_VAE.pth")
    t5 = random_umt5(umt5_shapes(512, 32, 64, 2, 4, 16),
                     torch.Generator().manual_seed(1), dtype=torch.bfloat16)
    torch.save(t5, root / "models_t5_umt5-xxl-enc-bf16.pth")
    g = torch.Generator().manual_seed(7)
    torch.save({"state_dict": {
        "buffer_embedder.weight": torch.randn(64, 8, 1, 2, 2, generator=g),
        "buffer_embedder.bias": torch.randn(64, generator=g),
        "dit.head.head.weight": torch.randn(16, 64, generator=g),
        "dit.blocks.0.cross_attn.k.weight": torch.randn(64, 64, generator=g),
    }, "epoch": 3}, root / "buffer_dit_finetune.ckpt")
    args = ["--wan-dit", str(folder),
            "--wan-vae", str(root / "Wan2.1_VAE.pth"),
            "--umt5", str(root / "models_t5_umt5-xxl-enc-bf16.pth")]
    return root, args, {"dit": sd, "vae": vae.state_dict(), "t5": t5}


def _converted(root, name, argv):
    """Run both CLIs -> (the port's towers, the port's sidecar, the JAX
    CLI's params, the JAX CLI's sidecar)."""
    out, jout = root / f"port_{name}", root / f"jax_{name}"
    tcli.main(argv + ["--out", str(out)])
    jax_cli.main(argv + ["--out", str(jout)])
    towers, meta = tcli.load_pipeline_checkpoint(out, device="cpu")
    jparams, jmeta = jax_cli.load_pipeline_checkpoint(jout)
    return out, towers, meta, jparams, jmeta


@pytest.mark.parametrize("extra", [[], ["--no-buffer-embedder"], ["ft"]],
                         ids=["default", "no_buffer_embedder", "finetune"])
def test_cli_towers_equal_the_jax_cli_and_the_in_memory_conversion(
        released, extra):
    root, args, sds = released
    if extra == ["ft"]:
        extra = ["--finetune-ckpt", str(root / "buffer_dit_finetune.ckpt")]
        argv = args[:2] + extra
    else:
        argv = args + extra
    name = "_".join(a.strip("-") for a in extra[:1]) or "default"
    out, towers, meta, jparams, jmeta = _converted(root, name, argv)
    assert meta == jmeta
    assert meta["towers"] == sorted(towers)
    want = pipeline_from_jax({k: jparams.get(k, {}) for k in
                              ("dit", "vae", "t5")})
    dit_sd = dict(sds["dit"])
    if "--finetune-ckpt" in extra:
        dit_sd, n_be, n_dit = tcli.overlay_finetune(
            dit_sd, tcli.load_released_state_dict(extra[1]))
        assert (n_be, n_dit) == (2, 2)
    memory = wan_pipeline_state_dict(
        dit_sd, sds["vae"] if "vae" in towers else None,
        dict(sds["t5"]) if "t5" in towers else None,
        WanDiTConfig(**DIT, dtype=torch.float32))
    for tower, sd in towers.items():
        assert sd.keys() == want[tower].keys() == memory[tower].keys()
        for k, v in sd.items():
            assert torch.equal(v, memory[tower][k].to(v.dtype)), (tower, k)
            assert torch.equal(v, want[tower][k].to(v.dtype)), (tower, k)
    # the bf16 umt5 is written in bf16, as the tower holds it
    if "t5" in towers:
        assert towers["t5"]["embed.weight"].dtype == torch.bfloat16
        assert towers["t5"]["layers.0.ln1.weight"].dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in towers["dit"].values())
    cfg = tcli.pipeline_config_from_meta(meta)
    assert cfg.dit.use_buffer_embedder == ("--no-buffer-embedder" not in
                                           extra)
    if "--finetune-ckpt" in extra:
        ft = torch.load(extra[1])["state_dict"]
        assert torch.equal(towers["dit"]["buffer_embed.bias"],
                           ft["buffer_embedder.bias"])
        assert torch.equal(towers["dit"]["head.weight"],
                           ft["dit.head.head.weight"])


def _in_memory(sds):
    gen = WanVideoGenerator(_port_cfg(), device="cpu", tokenizer=_Tokenizer())
    gen.load_params(wan_pipeline_state_dict(
        dict(sds["dit"]), sds["vae"], dict(sds["t5"]),
        WanDiTConfig(**DIT, dtype=torch.float32)))
    return gen


def _buffers(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (5, 16, 16, 3), dtype=np.uint8),
            rng.integers(0, 255, (5, 16, 16, 3), dtype=np.uint8))


def test_from_checkpoint_generates_as_the_in_memory_pipeline_and_jax(
        released):
    root, args, sds = released
    out, jout = root / "port_serve", root / "jax_serve"
    tcli.main(args + ["--out", str(out)])
    gen = WanVideoGenerator.from_checkpoint(out, cfg=_port_cfg(),
                                            device="cpu",
                                            tokenizer=_Tokenizer())
    ref = _in_memory(sds)
    for tower in ("dit", "vae", "t5"):
        a, b = getattr(gen, tower).state_dict(), \
            getattr(ref, tower).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in b), tower
    sem, coo = _buffers()
    frames = gen.generate(sem, coo, "a road at dusk", seed=3)
    assert frames.shape == (5, 16, 16, 3) and frames.dtype == np.uint8
    np.testing.assert_array_equal(
        frames, ref.generate(sem, coo, "a road at dusk", seed=3))

    # the JAX package's CLI -> from_checkpoint on the same files
    jax_cli.main(args + ["--out", str(jout)])
    jgen = JaxGen.from_checkpoint(jout, cfg=_jax_cfg(),
                                  tokenizer=_Tokenizer())
    params = jgen.params
    text_j = jgen.encode_text(params, "a road at dusk")
    null_j = jgen.encode_text(params, "")
    text_t, null_t = gen.encode_text("a road at dusk"), gen.encode_text("")
    np.testing.assert_allclose(text_t.numpy(), np.asarray(text_j), **TOL)
    buf_j = np.asarray(jgen.encode_buffers(params, sem, coo))
    buf_t = gen.encode_buffers(sem, coo)
    np.testing.assert_allclose(buf_t.numpy(), buf_j, **TOL)
    noise = np.random.default_rng(2).standard_normal(
        buf_j.shape[:4] + (4,)).astype(np.float32)
    sig = jgen.schedule.sigmas(2)
    ts = sig[:-1] * jgen.schedule.num_train_timesteps
    z_j = np.asarray(jgen._denoise_chunk(
        params["dit"], jnp.asarray(noise), (ts, sig[:-1], sig[1:]), text_j,
        null_j, jnp.asarray(buf_j), guidance_scale=2.0))
    z_t = gen._denoise(text_t, null_t, torch.from_numpy(buf_j), 2, 2.0,
                       noise=torch.from_numpy(noise))
    np.testing.assert_allclose(z_t.numpy(), z_j, **TOL)
    assert np.abs(z_j - noise).max() > 1e-2      # the DiT moved the latents
    vid_j = np.asarray(jgen.vae.apply(params["vae"], jnp.asarray(z_j),
                                      method=type(jgen.vae).decode))[0]
    u8_j = (np.clip(vid_j * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8)
    with torch.no_grad():
        u8_t = gen.vae.decode(torch.from_numpy(z_j))[0]
    u8_t = (torch.clamp(u8_t * 0.5 + 0.5, 0, 1) * 255).to(torch.uint8)
    assert np.abs(u8_t.numpy().astype(int) - u8_j.astype(int)).max() <= 1


def test_partial_checkpoint_serves_with_the_given_generator(released):
    root, args, sds = released
    out = root / "port_vae_only"
    tcli.main(args[2:4] + ["--out", str(out)])
    assert json.loads((out / "pipeline.json").read_text())["towers"] == \
        ["vae"]
    assert not (out / "dit.pt").exists()
    for seed in (5, None):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        gen = WanVideoGenerator.from_checkpoint(out, cfg=_port_cfg(),
                                                device="cpu", generator=g)
        ref = WanVideoGenerator(_port_cfg(), device="cpu")
        ref.init_params(torch.Generator().manual_seed(seed or 0))
        ref.load_params({"vae": tcli.load_pipeline_checkpoint(
            out, device="cpu")[0]["vae"]})
        for tower in ("dit", "vae", "t5"):
            a, b = getattr(gen, tower).state_dict(), \
                getattr(ref, tower).state_dict()
            assert all(torch.equal(a[k], b[k]) for k in b), (seed, tower)
    sem, coo = _buffers(4)
    frames = gen.generate(sem, coo, "a road", num_steps=1)
    assert frames.shape == (5, 16, 16, 3)
