"""Port parity of the whole video slice at tiny size: the port's
``WanVideoGenerator`` against the JAX pipeline on the same weights, token ids
and numpy noise. Text encode, buffer encode, a 2-step CFG denoise (the JAX
side through ``_denoise_chunk``, both ``cfg_batch`` modes) and the decode to
uint8 frames."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.wan.dit import WanDiTConfig as JaxDiTCfg
from infinicube_tpu.models.wan.pipeline import WanPipelineConfig as JaxCfg
from infinicube_tpu.models.wan.pipeline import WanVideoGenerator as JaxGen
from infinicube_tpu.models.wan.t5 import T5Config as JaxT5Cfg
from infinicube_tpu.models.wan.vae3d import VideoVAEConfig as JaxVAECfg
from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.models.wan.dit import WanDiTConfig
from infinicube_tpu_torch.models.wan.pipeline import (WanPipelineConfig,
                                                      WanVideoGenerator)
from infinicube_tpu_torch.models.wan.t5 import T5Config
from infinicube_tpu_torch.models.wan.vae3d import VideoVAEConfig
from infinicube_tpu_torch.weights.from_jax import pipeline_from_jax
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

# the tiny towers of tests/test_wan.py, f32
DIT = dict(dim=64, ffn_dim=128, num_layers=2, num_heads=4, in_channels=4,
           out_channels=4, text_dim=32, freq_dim=32, buffer_channels=8)
VAE = dict(latent_channels=4, base_channels=8, channel_mult=(1, 1, 2, 2),
           num_res_blocks=1)
PIPE = dict(num_frames=5, height=16, width=16, num_steps=2,
            guidance_scale=2.0, max_text_len=16)
# f32 on both sides, differing only in summation order
TOL = dict(atol=2e-3, rtol=2e-3)


class _Tokenizer:
    """Deterministic word-hash tokenizer shared by both sides."""

    def __call__(self, prompt, return_tensors, padding, truncation,
                 max_length):
        ids = [1 + sum(map(ord, w)) % 97 for w in prompt.split()]
        ids = ids[:max_length] or [0]
        return {"input_ids": np.asarray([ids]),
                "attention_mask": np.ones((1, len(ids)), np.int64)}


def _build(cfg_batch):
    jcfg = JaxCfg(dit=JaxDiTCfg(**DIT, dtype=jnp.float32),
                  vae=JaxVAECfg(**VAE, dtype=jnp.float32),
                  t5=JaxT5Cfg.tiny(d_model=32, dtype=jnp.float32),
                  cfg_batch=cfg_batch, **PIPE)
    jgen = JaxGen(jcfg, tokenizer=_Tokenizer())
    params = jgen.init_params(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, flax.linen.meta.unbox(params))
    # fill the zero-init buffer embedder and head so the DiT output and the
    # buffer path show in the result
    rng = np.random.default_rng(0)
    for name in ("buffer_embed", "head"):
        layer = params["dit"]["params"][name]
        layer["kernel"] = 0.1 * rng.standard_normal(
            layer["kernel"].shape).astype(np.float32)
    jgen.params = params

    tcfg = WanPipelineConfig(dit=WanDiTConfig(**DIT, dtype=torch.float32),
                             vae=VideoVAEConfig(**VAE, dtype=torch.float32),
                             t5=T5Config.tiny(d_model=32,
                                              dtype=torch.float32),
                             cfg_batch=cfg_batch, **PIPE)
    tgen = WanVideoGenerator(tcfg, device="cpu", tokenizer=_Tokenizer())
    tgen.load_params(pipeline_from_jax(params))
    return jgen, tgen


@pytest.mark.parametrize("cfg_batch", [True, False])
def test_pipeline_matches_jax(cfg_batch):
    jgen, tgen = _build(cfg_batch)
    params = jgen.params
    rng = np.random.default_rng(1)
    sem = rng.integers(0, 255, (5, 16, 16, 3), dtype=np.uint8)
    coo = rng.integers(0, 255, (5, 16, 16, 3), dtype=np.uint8)

    text_j = jgen.encode_text(params, "a driving scene at dusk")
    null_j = jgen.encode_text(params, "")
    text_t = tgen.encode_text("a driving scene at dusk")
    null_t = tgen.encode_text("")
    assert text_t.shape == (1, 16, 32)
    np.testing.assert_allclose(text_t.numpy(), np.asarray(text_j), **TOL)
    assert tgen.encode_text("a driving scene at dusk") is text_t   # cached

    buf_j = np.asarray(jgen.encode_buffers(params, sem, coo))
    buf_t = tgen.encode_buffers(sem, coo)
    assert buf_t.shape == buf_j.shape == (1, 2, 2, 2, 8)
    np.testing.assert_allclose(buf_t.numpy(), buf_j, **TOL)

    noise = rng.standard_normal((1, 2, 2, 2, 4)).astype(np.float32)
    sig = jgen.schedule.sigmas(2)
    ts = sig[:-1] * jgen.schedule.num_train_timesteps
    z_j = np.asarray(jgen._denoise_chunk(
        params["dit"], jnp.asarray(noise), (ts, sig[:-1], sig[1:]), text_j,
        null_j, jnp.asarray(buf_j), guidance_scale=2.0))
    z_t = tgen._denoise(text_t, null_t, torch.from_numpy(buf_j), 2, 2.0,
                        noise=torch.from_numpy(noise))
    np.testing.assert_allclose(z_t.numpy(), z_j, **TOL)
    assert np.abs(z_j - noise).max() > 1e-2   # the DiT moved the latents

    # decode to uint8: f32 rounding may flip a pixel across a level
    vid_j = np.asarray(jgen.vae.apply(params["vae"], jnp.asarray(z_j),
                                      method=type(jgen.vae).decode))[0]
    u8_j = (np.clip(vid_j * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8)
    u8_t = tgen.vae.decode(torch.from_numpy(z_j))[0]
    u8_t = (torch.clamp(u8_t * 0.5 + 0.5, 0, 1) * 255).to(torch.uint8)
    assert np.abs(u8_t.numpy().astype(int) - u8_j.astype(int)).max() <= 1
    assert kernels.launches and all(v == 0 for v in kernels.launches.values())


def test_generate_runs_and_caches_text():
    _, tgen = _build(False)
    rng = np.random.default_rng(2)
    sem = rng.integers(0, 255, (5, 16, 16, 3), dtype=np.uint8)
    frames = tgen.generate(sem, sem, "a road", num_steps=2)
    assert frames.shape == (5, 16, 16, 3) and frames.dtype == np.uint8
    assert set(tgen.last_phase_seconds) == {"text_encode", "buffer_encode",
                                            "denoise", "decode"}
    for p in ("p1", "p2", "p3", "p4", "p5"):
        tgen.encode_text(p)
    assert list(tgen._text_cache) == ["p2", "p3", "p4", "p5"]   # LRU of 4
    tgen.cast_params_bf16()
    assert not tgen._text_cache
    assert all(p.dtype == torch.bfloat16 for p in tgen.dit.parameters())


def test_serving_profile_config():
    cfg = WanPipelineConfig.serving()
    assert cfg.dit.attn_quant == "qk" and cfg.dit.quant_linear
    assert cfg.dit.residual_dtype == torch.bfloat16 and not cfg.cfg_batch
    assert (cfg.dit.dim, cfg.dit.num_layers, cfg.dit.num_heads) == \
        (1536, 30, 12)
    assert cfg.latent_thw == (24, 60, 104)
    assert dataclasses.replace(cfg, num_frames=17).latent_thw == (5, 60, 104)
