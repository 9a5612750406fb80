"""Wan video generation pipeline: text + guidance buffers -> RGB video;
counterpart of ``infinicube_tpu/models/wan/pipeline.py``.

``generate(semantic_buffer, coordinate_buffer, prompt)`` encodes the prompt
with umt5 (memoized per prompt), VAE-encodes the two buffer videos into the
DiT's 32-channel conditioning, denoises with flow-matching Euler steps and
classifier-free guidance against the negative prompt, and decodes the
latents to uint8 frames (tiled at serving sizes). All three towers live on
the card: the H100's 80 GB hold them together.

``train_loss`` is the video stage's training objective, the flow-matching
velocity MSE with text dropout; it differentiates the DiT's parameters when
the caller enables their gradients (``__init__`` freezes every tower for
serving)."""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.models.wan.dit import WanDiT, WanDiTConfig
from infinicube_tpu_torch.models.wan.flow_match import (FlowMatchSchedule,
                                                        euler_sample)
from infinicube_tpu_torch.models.wan.t5 import T5Config, T5Encoder
from infinicube_tpu_torch.models.wan.vae3d import (VideoVAE, VideoVAEConfig,
                                                   decode_tiled_host,
                                                   encode_tiled_host)


@dataclasses.dataclass(frozen=True)
class WanPipelineConfig:
    dit: WanDiTConfig = WanDiTConfig()
    vae: VideoVAEConfig = VideoVAEConfig()
    t5: T5Config = T5Config()
    num_frames: int = 93
    height: int = 480
    width: int = 832
    num_steps: int = 50
    guidance_scale: float = 5.0
    shift: float = 5.0
    max_text_len: int = 512
    # CFG pair as one batched forward (True) or two sequential forwards
    cfg_batch: bool = True

    @property
    def latent_thw(self):
        return (1 + (self.num_frames - 1) // 4, self.height // 8,
                self.width // 8)

    @staticmethod
    def serving(**kw) -> "WanPipelineConfig":
        """The int8 serving profile: int8-QK attention (K1), int8
        projections and FFN, a bf16 residual stream, sequential CFG."""
        base: dict = dict(dit=WanDiTConfig.wan_1_3b(
            attn_quant="qk", quant_linear=True,
            residual_dtype=torch.bfloat16), cfg_batch=False)
        base.update(kw)
        return WanPipelineConfig(**base)


class WanVideoGenerator:
    """Holds the three towers; ``generate`` is the user entry point."""

    def __init__(self, cfg: WanPipelineConfig = WanPipelineConfig(),
                 device="cuda", tokenizer=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dit = WanDiT(cfg.dit, device=self.device).eval()
        self.vae = VideoVAE(cfg.vae, device=self.device).eval()
        self.t5 = T5Encoder(cfg.t5, device=self.device).eval()
        for tower in (self.dit, self.vae, self.t5):
            tower.requires_grad_(False)
        self.schedule = FlowMatchSchedule(shift=cfg.shift)
        self.tokenizer = tokenizer
        self._text_cache: OrderedDict[str, torch.Tensor] = OrderedDict()
        self.last_phase_seconds: dict[str, float] = {}

    # ---- parameters --------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, path, cfg: WanPipelineConfig | None = None,
                        device="cuda", tokenizer=None,
                        generator: torch.Generator | None = None
                        ) -> "WanVideoGenerator":
        """A generator from a checkpoint of ``python -m
        infinicube_tpu_torch.convert`` (the released weights). The config
        comes from its sidecar unless ``cfg`` is given. Where the checkpoint
        lacks a tower (a partial conversion, say VAE-only), every tower is
        first initialized from ``generator`` (by default one on the device
        seeded with 0) and the checkpoint's towers are loaded over them."""
        from infinicube_tpu_torch.convert import (load_pipeline_checkpoint,
                                                  pipeline_config_from_meta)
        dev = resolve_device(device)
        state_dicts, meta = load_pipeline_checkpoint(path, device="cpu")
        gen = cls(cfg or pipeline_config_from_meta(meta), device=dev,
                  tokenizer=tokenizer)
        if set(state_dicts) != {"dit", "vae", "t5"}:
            gen.init_params(generator if generator is not None else
                            torch.Generator(device=dev).manual_seed(0))
        gen.load_params(state_dicts)
        return gen

    def init_params(self, generator: torch.Generator) -> None:
        """Random weights for all three towers from one generator (on the
        towers' device)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, towers on "
                             f"{self.device}")
        self.dit.init_params(generator)
        self.vae.init_params(generator)
        self.t5.init_params(generator)
        self._text_cache.clear()

    def load_params(self, state_dicts: dict) -> None:
        """Load {'dit', 'vae', 't5'} state dicts (``weights.from_jax``)."""
        for name, sd in state_dicts.items():
            getattr(self, name).load_state_dict(sd)
        self._text_cache.clear()

    def cast_params_bf16(self) -> None:
        """Serving residency: every f32 parameter of the towers in bf16."""
        for tower in (self.dit, self.vae, self.t5):
            tower.to(torch.bfloat16)
        self._text_cache.clear()

    # ---- text ---------------------------------------------------------------
    @torch.no_grad()
    def encode_text(self, prompt: str) -> torch.Tensor:
        """Prompt -> f32 [1, max_text_len, d_model] on the device. umt5 runs
        at the real token length (it masks padded keys and zeroes padded
        outputs, so trimming is exact) and the result is zero-padded to
        ``max_text_len``. Memoized per prompt in an LRU of 4 entries, cleared
        whenever the parameters change."""
        cache = self._text_cache
        if prompt in cache:
            cache.move_to_end(prompt)
            return cache[prompt]
        cfg = self.cfg
        if self.tokenizer is not None:
            ids = self.tokenizer(prompt, return_tensors="np",
                                 padding="longest", truncation=True,
                                 max_length=cfg.max_text_len)
            tok = np.asarray(ids["input_ids"], np.int64)
            mask = np.asarray(ids["attention_mask"], bool)
        else:  # deterministic hash tokenization fallback (no-weights mode)
            words = prompt.split()[: cfg.max_text_len]
            tok = np.asarray([[abs(hash(w)) % cfg.t5.vocab_size
                               for w in words] or [0]], np.int64)
            mask = np.ones_like(tok, bool)
        out = self.t5(torch.from_numpy(tok).to(self.device),
                      torch.from_numpy(mask).to(self.device))
        pad = cfg.max_text_len - out.shape[1]
        if pad > 0:
            out = torch.nn.functional.pad(out, (0, 0, 0, pad))
        cache[prompt] = out
        while len(cache) > 4:
            cache.popitem(last=False)
        return out

    # ---- buffers ------------------------------------------------------------
    @torch.no_grad()
    def encode_buffers(self, semantic_rgb, coordinate_rgb,
                       tiled: bool | None = None) -> torch.Tensor:
        """uint8/float [T, H, W, 3] buffer videos -> [1, T', H/8, W/8, 32].
        ``tiled`` defaults to tiling above 16 x 128 x 128 pixels."""
        def norm(v):
            v = torch.as_tensor(np.asarray(v), device=self.device).float()
            v = v / 127.5 - 1.0 if float(v.max()) > 1.5 else v * 2.0 - 1.0
            return v[None]

        if tiled is None:
            tiled = int(np.prod(np.shape(semantic_rgb)[:3])) > 16 * 128 * 128
        enc = (lambda x: encode_tiled_host(self.vae, x)) if tiled \
            else self.vae.encode
        sem = enc(norm(semantic_rgb))
        coo = enc(norm(coordinate_rgb))
        return torch.cat([sem, coo], dim=-1)

    # ---- training -----------------------------------------------------------
    def train_loss(self, video_latents: torch.Tensor, text_emb: torch.Tensor,
                   buffer_latents: torch.Tensor | None,
                   text_drop_prob: float = 0.1,
                   generator: torch.Generator | None = None,
                   u: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None,
                   drop: torch.Tensor | None = None):
        """Flow-matching velocity MSE (the buffer-conditioned finetuning
        objective): sigma = shift*u / (1 + (shift-1)*u) for u ~ U[0, 1),
        x_t = (1 - sigma) x0 + sigma noise, target noise - x0, the text
        embedding zeroed where ``drop`` (u' < ``text_drop_prob``), the DiT at
        t = 1000 sigma. The draws u [B], noise (like the latents) and drop
        [B] come from ``generator`` in that order, or are injected (the
        tests hand both implementations the same numbers). Returns
        (loss, {"fm_mse": loss})."""
        B = video_latents.shape[0]
        dev = video_latents.device
        sch = self.schedule
        if u is None:
            u = torch.rand((B,), generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(video_latents.shape, generator=generator,
                                device=dev)
        if drop is None:
            drop = torch.rand((B,), generator=generator,
                              device=dev) < text_drop_prob
        u, noise = u.to(dev, torch.float32), noise.to(dev, torch.float32)
        sigma = sch.shift * u / (1.0 + (sch.shift - 1) * u)
        x_t = sch.add_noise(video_latents, noise, sigma)
        target = sch.velocity_target(video_latents, noise)
        ctx = text_emb.masked_fill(drop.to(dev)[:, None, None], 0.0)
        pred = self.dit(x_t, sigma * sch.num_train_timesteps, ctx,
                        buffer_latents)
        loss = torch.mean((pred - target) ** 2)
        return loss, {"fm_mse": loss}

    # ---- sampling -----------------------------------------------------------
    @torch.no_grad()
    def _denoise(self, text_emb, null_emb, buffer_latents, num_steps: int,
                 guidance_scale: float, generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
        """Flow-matching Euler loop with classifier-free guidance. Starts
        from ``noise`` [1, T, H, W, C_in] when given (tests hand both
        implementations the same numbers), else from ``generator``."""
        cfg = self.cfg
        T, H, W = buffer_latents.shape[1:4]
        if noise is None:
            x = torch.randn((1, T, H, W, cfg.dit.in_channels),
                            generator=generator, device=self.device)
        else:
            x = noise.to(self.device, torch.float32)

        def model_fn(x, t):
            if cfg.cfg_batch:
                out = self.dit(torch.cat([x, x]), torch.cat([t, t]),
                               torch.cat([text_emb, null_emb]),
                               torch.cat([buffer_latents, buffer_latents]))
                c, u = out.chunk(2)
            else:
                c = self.dit(x, t, text_emb, buffer_latents)
                u = self.dit(x, t, null_emb, buffer_latents)
            return u + guidance_scale * (c - u)

        return euler_sample(self.schedule, model_fn, x, num_steps)

    @torch.no_grad()
    def generate(self, semantic_buffer, coordinate_buffer, prompt: str,
                 negative_prompt: str = "", seed: int = 0,
                 num_steps: int | None = None,
                 guidance_scale: float | None = None,
                 tiled: bool | None = None) -> np.ndarray:
        """Buffers [T, H, W, 3] -> uint8 frames [T, H, W, 3]. ``tiled``
        defaults to the tiled decode above 3 x 16 x 16 latents. Wall-clock
        seconds per phase (text, buffer encode, denoise, decode) land in
        ``last_phase_seconds``; each phase ends with a device sync."""
        cfg = self.cfg
        sync = torch.cuda.synchronize if self.device.type == "cuda" \
            else (lambda: None)
        marks = [time.perf_counter()]

        def tick():
            sync()
            marks.append(time.perf_counter())

        text = self.encode_text(prompt)
        null = self.encode_text(negative_prompt)
        tick()
        buf = self.encode_buffers(semantic_buffer, coordinate_buffer)
        tick()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        z = self._denoise(text, null, buf, num_steps or cfg.num_steps,
                          guidance_scale if guidance_scale is not None
                          else cfg.guidance_scale, generator=gen)
        tick()
        if tiled is None:
            tiled = int(np.prod(z.shape[1:4])) > 3 * 16 * 16
        if tiled:
            video = decode_tiled_host(self.vae, z, tile=(32, 32),
                                      to_uint8=True)[0]
        else:
            video = self.vae.decode(z)[0]
            video = (torch.clamp(video * 0.5 + 0.5, 0, 1) * 255).to(
                torch.uint8).cpu().numpy()
        tick()
        names = ("text_encode", "buffer_encode", "denoise", "decode")
        self.last_phase_seconds = {n: b - a for n, a, b in
                                   zip(names, marks, marks[1:])}
        return video
