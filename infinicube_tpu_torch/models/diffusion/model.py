"""Voxel latent diffusion model: conditioning, the training loss and guided
sampling; counterpart of ``infinicube_tpu/models/diffusion/model.py``.

Release conditioning (concat of pos-embed, map cube and box cube onto the
8-channel 64^3 latent cube), v-prediction, DDIM, DDPM or DPM-Solver++ with
classifier-free guidance as a doubled batch when the guidance scale is not
1, and SDEdit overlap injection, and ``train_loss`` (per-sample timesteps,
v-prediction or epsilon target, classifier-free dropout of the map and box
cubes). ``sample`` always runs the serving twin of the UNet, which is the
UNet itself unless ``serve_quant`` makes its convs int8 (K7); training and
``train_loss`` keep full precision. The random numbers (x_T, the per-step
SDEdit and DDPM noise; the timesteps, noise and drop masks of the loss) come
from a ``torch.Generator`` unless the caller passes them in, which is how
the tests feed the JAX package's numbers through.

Waits: the alt condition encoders (semantic, single scan, image, class,
context)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
from torch.func import functional_call

from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.models.diffusion import encoders
from infinicube_tpu_torch.models.diffusion.schedulers import (NoiseSchedule,
                                                              ddim_sample,
                                                              ddpm_sample,
                                                              dpmpp_sample)
from infinicube_tpu_torch.models.diffusion.sdedit import (SDEditState,
                                                          make_sdedit_callback)
from infinicube_tpu_torch.models.diffusion.unet3d import UNet3D


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    latent_channels: int = 8
    cube_dims: tuple = (64, 64, 64)
    cube_ijk_min: tuple = (-32, -32, -32)
    latent_voxel_size: tuple = (0.8, 0.8, 0.4)
    latent_origin: tuple = (0.4, 0.4, 0.2)
    model_channels: int = 192
    channel_mult: tuple = (1, 2, 4, 4)
    attention_ds: tuple = (4, 8)
    num_res_blocks: int = 2
    num_heads: int = 8
    transformer_depth: int = 12
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False      # recompute res / transformer blocks in backward
    serve_quant: bool = False  # int8 convs (K7) in sample() only
    num_map_types: int = 3
    use_map_cond: bool = True
    use_box_cond: bool = True
    use_pos_embed: bool = True
    classifier_free_prob: float = 0.1
    num_train_timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    prediction_type: str = "v_prediction"

    @property
    def cond_channels(self) -> int:
        return 3 * self.use_pos_embed + \
            self.num_map_types * self.use_map_cond + 2 * self.use_box_cond


@dataclasses.dataclass(frozen=True)
class CondCubes:
    """Encoded conditioning (zeros = the null condition)."""
    map_cube: torch.Tensor   # f32 [B, D, H, W, n_types]
    box_cube: torch.Tensor   # f32 [B, D, H, W, 2]

    @staticmethod
    def null(batch: int, cfg: DiffusionConfig, device=None) -> "CondCubes":
        D, H, W = cfg.cube_dims
        return CondCubes(
            torch.zeros((batch, D, H, W, cfg.num_map_types), device=device),
            torch.zeros((batch, D, H, W, 2), device=device))


class VoxelDiffusion:
    """The UNet denoiser with its schedule, loss and samplers. Built on the
    card unless ``device="cpu"``. The parameters are frozen (serving) unless
    ``trainable``."""

    def __init__(self, cfg: DiffusionConfig = DiffusionConfig(),
                 device="cuda", trainable: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.unet = UNet3D(
            in_channels=cfg.latent_channels + cfg.cond_channels,
            out_channels=cfg.latent_channels,
            model_channels=cfg.model_channels, channel_mult=cfg.channel_mult,
            num_res_blocks=cfg.num_res_blocks, attention_ds=cfg.attention_ds,
            num_heads=cfg.num_heads, transformer_depth=cfg.transformer_depth,
            dtype=cfg.dtype, remat=cfg.remat,
            device=self.device).eval().requires_grad_(trainable)
        # serving twin: the same parameters, int8 convs under serve_quant
        self.unet_serve = self.unet.serving_twin() if cfg.serve_quant \
            else self.unet
        self.schedule = NoiseSchedule.linear(
            cfg.num_train_timesteps, cfg.beta_start, cfg.beta_end,
            device=self.device)
        self.pos_embed = encoders.pos_embed_cube(cfg.cube_dims,
                                                 device=self.device) \
            if cfg.use_pos_embed else None

    # ---- parameters -------------------------------------------------------
    def init_params(self, generator: torch.Generator,
                    zero_init_layers: bool = True) -> None:
        """Random UNet weights (``UNet3D.init_params``)."""
        self.unet.init_params(generator, zero_init_layers)

    def load_params(self, state_dict: dict) -> None:
        self.unet.load_state_dict(state_dict)

    # ---- conditioning -----------------------------------------------------
    def encode_conditions(self, map_points, map_mask, box_poses, box_lwhs,
                          box_mask) -> CondCubes:
        cfg = self.cfg
        geo = (cfg.cube_dims, cfg.cube_ijk_min, cfg.latent_voxel_size,
               cfg.latent_origin)
        dev = self.device
        B = map_points.shape[0] if cfg.use_map_cond else box_poses.shape[0]
        null = CondCubes.null(B, cfg, dev)
        mc = encoders.encode_map(map_points.to(dev), map_mask.to(dev), *geo) \
            if cfg.use_map_cond else null.map_cube
        bc = encoders.encode_boxes(box_poses.to(dev), box_lwhs.to(dev),
                                   box_mask.to(dev), *geo) \
            if cfg.use_box_cond else null.box_cube
        return CondCubes(map_cube=mc, box_cube=bc)

    def _assemble(self, x: torch.Tensor, cond: CondCubes) -> torch.Tensor:
        cfg = self.cfg
        parts = [x]
        if cfg.use_pos_embed:
            parts.append(self.pos_embed[None].expand(x.shape[:4] + (3,)))
        if cfg.use_map_cond:
            parts.append(cond.map_cube)
        if cfg.use_box_cond:
            parts.append(cond.box_cube)
        return torch.cat(parts, dim=-1)

    def denoise(self, x: torch.Tensor, t: torch.Tensor, cond: CondCubes,
                params: dict | None = None,
                serve: bool = False) -> torch.Tensor:
        """The UNet (its serving twin with ``serve``) on the assembled
        input; with ``params`` (name -> tensor) on those instead of the
        model's own (EMA validation)."""
        inp = self._assemble(x, cond)
        net = self.unet_serve if serve else self.unet
        if params is None:
            return net(inp, t)
        return functional_call(net, params, (inp, t))

    def named_parameters(self) -> dict[str, torch.Tensor]:
        return dict(self.unet.named_parameters())

    # ---- training ---------------------------------------------------------
    def train_loss(self, latents: torch.Tensor, cond: CondCubes,
                   scale_factor: float = 1.0,
                   generator: torch.Generator | None = None,
                   t: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None,
                   drop: tuple | None = None, params: dict | None = None):
        """v-prediction (or epsilon) MSE with per-sample timesteps and
        classifier-free dropout of the map and box cubes, each on its own
        draw. ``scale_factor`` is the scale_by_std normalizer and must match
        the one given to ``sample``. The three draws come from ``generator``
        unless injected: ``t`` int [B], ``noise`` like latents, ``drop`` =
        (map mask, box mask), bool [B] each. Returns ``(loss, {"mse":
        loss})``."""
        cfg, dev = self.cfg, self.device
        latents = latents.to(dev, torch.float32) * scale_factor
        B = latents.shape[0]
        if t is None:
            t = torch.randint(0, cfg.num_train_timesteps, (B,),
                              generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=dev)
        t, noise = t.to(dev), noise.to(dev, torch.float32)
        x_t = self.schedule.add_noise(latents, noise, t)
        target = self.schedule.v_target(latents, noise, t) \
            if cfg.prediction_type == "v_prediction" else noise
        drop_map, drop_box = drop if drop is not None else (None, None)
        p = cfg.classifier_free_prob
        cond = CondCubes(
            encoders.classifier_free_drop(cond.map_cube.to(dev), p,
                                          generator, drop_map),
            encoders.classifier_free_drop(cond.box_cube.to(dev), p,
                                          generator, drop_box))
        pred = self.denoise(x_t, t, cond, params)
        loss = torch.mean((pred - target) ** 2)
        return loss, {"mse": loss}

    # ---- sampling ---------------------------------------------------------
    @torch.no_grad()
    def sample(self, cond: CondCubes, num_steps: int = 100,
               guidance_scale: float = 1.0, scale_factor: float = 1.0,
               sdedit: SDEditState | None = None,
               generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None,
               sdedit_noise: Sequence[torch.Tensor] | None = None,
               sampler: str = "ddim",
               step_noise: Sequence[torch.Tensor] | None = None
               ) -> torch.Tensor:
        """Generate latents (divided by scale_factor back to VAE space) with
        ``sampler`` "ddim", "ddpm" or "dpmpp" through the serving twin.
        ``noise`` is x_T [B, D, H, W, latent], ``sdedit_noise[i]`` the
        re-noising of step i and ``step_noise[i]`` DDPM's noise of step i;
        each is drawn from ``generator`` when not given."""
        if sampler not in ("ddim", "ddpm", "dpmpp"):
            raise ValueError(f"unknown sampler {sampler!r}")
        cfg = self.cfg
        dev = self.device
        B = cond.map_cube.shape[0]
        shape = (B, *cfg.cube_dims, cfg.latent_channels)

        def draw(shp):
            return torch.randn(shp, generator=generator, device=dev)

        x_T = draw(shape) if noise is None else noise.to(dev, torch.float32)
        if guidance_scale != 1.0:
            null = CondCubes.null(B, cfg, dev)
            cond2 = CondCubes(torch.cat([cond.map_cube, null.map_cube]),
                              torch.cat([cond.box_cube, null.box_cube]))

            def model_fn(x, t):
                c, u = self.denoise(torch.cat([x, x]), torch.cat([t, t]),
                                    cond2, serve=True).chunk(2)
                return u + guidance_scale * (c - u)
        else:
            def model_fn(x, t):
                return self.denoise(x, t, cond, serve=True)

        callback = None
        if sdedit is not None:
            sd = SDEditState(sdedit.warped_latents.to(dev) * scale_factor,
                             sdedit.overlap_mask.to(dev))
            noise_fn: Callable = \
                (lambda i, shp: sdedit_noise[i].to(dev, torch.float32)) \
                if sdedit_noise is not None else (lambda i, shp: draw(shp))
            callback = make_sdedit_callback(sd, self.schedule, noise_fn)
        kw = dict(prediction_type=cfg.prediction_type, step_callback=callback)
        if sampler == "ddim":
            x = ddim_sample(self.schedule, model_fn, x_T, num_steps, **kw)
        elif sampler == "ddpm":
            x = ddpm_sample(self.schedule, model_fn, x_T, num_steps,
                            generator=generator, step_noise=step_noise, **kw)
        else:
            x = dpmpp_sample(self.schedule, model_fn, x_T, num_steps, **kw)
        return x / scale_factor

    @staticmethod
    def compute_scale_factor(latents: torch.Tensor) -> torch.Tensor:
        """scale_by_std: 1 / std of the first batch of latents."""
        return 1.0 / latents.float().std(correction=0).clamp_min(1e-6)

    def evaluation_api(self, cond: CondCubes, decode_fn=None,
                       num_steps: int = 100, guidance_scale: float = 1.0,
                       scale_factor: float = 1.0,
                       sdedit: SDEditState | None = None,
                       sampler: str = "ddim", **noise_kw):
        """Sample latents, then decode them with ``decode_fn(latents) ->
        (ijk, semantics)`` when given. ``noise_kw``: ``generator``,
        ``noise``, ``sdedit_noise``, ``step_noise`` as for ``sample``."""
        latents = self.sample(cond, num_steps, guidance_scale, scale_factor,
                              sdedit, sampler=sampler, **noise_kw)
        return latents, (decode_fn(latents) if decode_fn is not None
                         else None)
