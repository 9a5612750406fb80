"""Voxel latent diffusion model: conditioning, the training loss and guided
sampling; counterpart of ``infinicube_tpu/models/diffusion/model.py``.

Release conditioning (concat of pos-embed, map cube and box cube onto the
8-channel 64^3 latent cube) and the alternative conditioning (an extra cube
from ``CondEncoders``: semantic, single scan, lift3d or LSS image lift;
an adm class one-hot; cross-attention context), v-prediction, DDIM, DDPM or
DPM-Solver++ with classifier-free guidance as a doubled batch when the
guidance scale is not 1, and SDEdit overlap injection, and ``train_loss``
(per-sample timesteps, v-prediction or epsilon target, classifier-free
dropout of every condition). ``sample`` always runs the serving twin of
the UNet, which is the UNet itself unless ``serve_quant`` makes its convs
int8 (K7); training and ``train_loss`` keep full precision. The random numbers (x_T, the per-step
SDEdit and DDPM noise; the timesteps, noise and drop masks of the loss) come
from a ``torch.Generator`` unless the caller passes them in, which is how
the tests feed the JAX package's numbers through."""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
from torch.func import functional_call

from torch import nn

from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.models.diffusion import alt_encoders as alt
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
    # the alternative conditioning (all off at release): dense cubes from
    # the condition encoders concatenated after the release channels, an
    # adm one-hot class added to the time embedding, cross-attention tokens
    use_semantic_cond: bool = False     # semantic cube -> embedding
    num_semantic: int = 23
    semantic_embed_dim: int = 8
    use_single_scan_cond: bool = False  # one lidar scan -> PointNet
    single_scan_dim: int = 8
    use_image_cond: str | None = None   # "lift3d" | "lss"
    image_cond_dim: int = 8
    num_classes: int = 0                # > 0: adm one-hot class
    context_dim: int | None = None      # cross-attention context width
    classifier_free_prob: float = 0.1
    num_train_timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    prediction_type: str = "v_prediction"
    ema_decay: float = 0.9999

    @property
    def extra_cond_channels(self) -> int:
        return self.semantic_embed_dim * self.use_semantic_cond + \
            self.single_scan_dim * self.use_single_scan_cond + \
            self.image_cond_dim * bool(self.use_image_cond)

    @property
    def cond_channels(self) -> int:
        return self.extra_cond_channels + 3 * self.use_pos_embed + \
            self.num_map_types * self.use_map_cond + 2 * self.use_box_cond


@dataclasses.dataclass(frozen=True)
class CondCubes:
    """Encoded conditioning (zeros = the null condition). ``extra_cube``
    carries the alternative concat conditions (semantic, single scan,
    image), ``class_oh`` the adm one-hot, ``context`` the cross-attention
    tokens."""
    map_cube: torch.Tensor                  # f32 [B, D, H, W, n_types]
    box_cube: torch.Tensor                  # f32 [B, D, H, W, 2]
    extra_cube: torch.Tensor | None = None  # f32 [B, D, H, W, E]
    class_oh: torch.Tensor | None = None    # f32 [B, num_classes]
    context: torch.Tensor | None = None     # f32 [B, L, context_dim]

    @staticmethod
    def null(batch: int, cfg: DiffusionConfig, device=None,
             context_len: int = 1) -> "CondCubes":
        D, H, W = cfg.cube_dims
        ec = cfg.extra_cond_channels

        def zeros(*shape):
            return torch.zeros(shape, device=device)

        return CondCubes(
            zeros(batch, D, H, W, cfg.num_map_types),
            zeros(batch, D, H, W, 2),
            extra_cube=zeros(batch, D, H, W, ec) if ec else None,
            class_oh=zeros(batch, cfg.num_classes) if cfg.num_classes
            else None,
            context=zeros(batch, context_len, cfg.context_dim)
            if cfg.context_dim else None)

    def cat_null(self, cfg: DiffusionConfig) -> "CondCubes":
        """This condition followed by the null one along the batch: the
        doubled batch of classifier-free guidance (the null context as
        long as this one)."""
        B = self.map_cube.shape[0]
        null = CondCubes.null(
            B, cfg, self.map_cube.device, self.context.shape[1]
            if self.context is not None else 1)

        def cat(a, b):
            return None if a is None else torch.cat([a, b])

        return CondCubes(*(cat(getattr(self, f.name), getattr(null, f.name))
                           for f in dataclasses.fields(self)))


class CondEncoders(nn.Module):
    """The parameter-bearing alternative condition encoders -> one dense
    extra cube [B, D, H, W, extra_cond_channels]: the semantic embedding,
    the single scan's PointNet feature broadcast over the cube, and the
    image lift (``"lift3d"`` or ``"lss"``), in that order. Run once per
    sample or loss call; the cube rides the concat path at every denoise
    step. Built on the card unless ``device="cpu"``."""

    def __init__(self, cfg: DiffusionConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        if cfg.use_semantic_cond:
            self.semantic = alt.SemanticEncoder(
                cfg.num_semantic, cfg.semantic_embed_dim, device=dev)
        if cfg.use_single_scan_cond:
            self.single_scan = alt.PointNetEncoder(
                out_dim=cfg.single_scan_dim, device=dev)
        if cfg.use_image_cond == "lift3d":
            self.lift3d = alt.Lift3DEncoder(cfg.image_cond_dim, device=dev)
        elif cfg.use_image_cond == "lss":
            self.lss = alt.LssEncoder(
                alt.LssConfig(feat_dim=cfg.image_cond_dim), device=dev)
        elif cfg.use_image_cond:
            raise ValueError(f"unknown use_image_cond "
                             f"{cfg.use_image_cond!r}")

    def _cube_centers(self, device) -> torch.Tensor:
        """World centres [D, H, W, 3] of the latent cube's cells: the
        integer grid plus ``cube_ijk_min``, then ``* voxel_size + origin``,
        in the reference's order."""
        cfg = self.cfg
        D, H, W = cfg.cube_dims
        ii, jj, kk = torch.meshgrid(torch.arange(D, device=device),
                                    torch.arange(H, device=device),
                                    torch.arange(W, device=device),
                                    indexing="ij")
        ijk = torch.stack([ii, jj, kk], -1) + torch.tensor(
            cfg.cube_ijk_min, device=device)
        return ijk.float() * torch.tensor(cfg.latent_voxel_size,
                                          device=device) + \
            torch.tensor(cfg.latent_origin, device=device)

    def forward(self, semantics=None, scan_points=None, scan_mask=None,
                images=None, Ks=None, cam_to_worlds=None):
        """semantics int [B, D, H, W]; scan_points f32 [B, N, 3] with
        scan_mask bool [B, N]; images f32 [B, V, H, W, 3] with Ks
        [B, V, 3, 3] and cam_to_worlds [B, V, 4, 4]. Each view is lifted on
        its own (an LSS view at 480x832 holds 0.4 GB of contributions)."""
        cfg = self.cfg
        dev = next(self.parameters()).device
        D, H, W = cfg.cube_dims
        parts = []
        if cfg.use_semantic_cond:
            parts.append(self.semantic(semantics.to(dev)))
        if cfg.use_single_scan_cond:
            g = self.single_scan(scan_points.to(dev), scan_mask.to(dev))
            parts.append(g[:, None, None, None, :].expand(
                g.shape[0], D, H, W, g.shape[-1]))
        if cfg.use_image_cond:
            images, Ks, poses = (a.to(dev, torch.float32)
                                 for a in (images, Ks, cam_to_worlds))
            if cfg.use_image_cond == "lift3d":
                centers = self._cube_centers(dev)
                parts.append(torch.stack([
                    self.lift3d(im, K, p, centers)
                    for im, K, p in zip(images, Ks, poses)]))
            else:
                geo = (cfg.cube_dims, cfg.cube_ijk_min,
                       cfg.latent_voxel_size, cfg.latent_origin)
                parts.append(torch.stack([
                    self.lss(im, K, p, *geo)[0]
                    for im, K, p in zip(images, Ks, poses)]))
        return torch.cat(parts, dim=-1) if parts else None


class VoxelDiffusion:
    """The UNet denoiser with its schedule, loss and samplers, and the
    condition encoders where the config has extra channels. Built on the
    card unless ``device="cpu"``. The parameters are frozen (serving)
    unless ``trainable``. Parameter names are the UNet's, or, with condition
    encoders, ``unet.*`` and ``cond_enc.*`` (the JAX tree's two
    subtrees)."""

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
            context_dim=cfg.context_dim, num_classes=cfg.num_classes,
            dtype=cfg.dtype, remat=cfg.remat,
            device=self.device).eval().requires_grad_(trainable)
        # serving twin: the same parameters, int8 convs under serve_quant
        self.unet_serve = self.unet.serving_twin() if cfg.serve_quant \
            else self.unet
        self.cond_enc = CondEncoders(cfg, self.device).eval() \
            .requires_grad_(trainable) if cfg.extra_cond_channels else None
        self.schedule = NoiseSchedule.linear(
            cfg.num_train_timesteps, cfg.beta_start, cfg.beta_end,
            device=self.device)
        self.pos_embed = encoders.pos_embed_cube(cfg.cube_dims,
                                                 device=self.device) \
            if cfg.use_pos_embed else None

    # ---- parameters -------------------------------------------------------
    def init_params(self, generator: torch.Generator,
                    zero_init_layers: bool = True) -> None:
        """Random UNet weights (``UNet3D.init_params``), then the condition
        encoders'."""
        self.unet.init_params(generator, zero_init_layers)
        if self.cond_enc is not None:
            alt.init_params(self.cond_enc, generator)

    def load_params(self, state_dict: dict) -> None:
        """A state dict in ``named_parameters``' names (strict)."""
        if self.cond_enc is None:
            self.unet.load_state_dict(state_dict)
            return
        for prefix, m in (("unet.", self.unet), ("cond_enc.", self.cond_enc)):
            m.load_state_dict({k[len(prefix):]: v for k, v in
                               state_dict.items() if k.startswith(prefix)})
        other = [k for k in state_dict
                 if not k.startswith(("unet.", "cond_enc."))]
        if other:
            raise KeyError(f"unexpected keys {other[:5]}")

    def named_parameters(self) -> dict[str, torch.Tensor]:
        if self.cond_enc is None:
            return dict(self.unet.named_parameters())
        return {**{f"unet.{k}": p for k, p in self.unet.named_parameters()},
                **{f"cond_enc.{k}": p
                   for k, p in self.cond_enc.named_parameters()}}

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

    def encode_extra(self, **raw) -> torch.Tensor | None:
        """The condition encoders on their raw inputs (``CondEncoders``'
        keywords) -> the dense extra cube; call once and reuse it at every
        denoise step. None without extra channels."""
        return None if self.cond_enc is None else self.cond_enc(**raw)

    def _assemble(self, x: torch.Tensor, cond: CondCubes) -> torch.Tensor:
        cfg = self.cfg
        parts = [x]
        if cfg.use_pos_embed:
            parts.append(self.pos_embed[None].expand(x.shape[:4] + (3,)))
        if cfg.use_map_cond:
            parts.append(cond.map_cube)
        if cfg.use_box_cond:
            parts.append(cond.box_cube)
        if cfg.extra_cond_channels:
            parts.append(cond.extra_cube if cond.extra_cube is not None else
                         x.new_zeros(x.shape[:4] +
                                     (cfg.extra_cond_channels,)))
        return torch.cat(parts, dim=-1)

    def denoise(self, x: torch.Tensor, t: torch.Tensor, cond: CondCubes,
                params: dict | None = None,
                serve: bool = False) -> torch.Tensor:
        """The UNet (its serving twin with ``serve``) on the assembled
        input, with the condition's context and class one-hot where the
        config takes them; with ``params`` (``named_parameters``' names ->
        tensors) on those instead of the model's own (EMA validation)."""
        cfg = self.cfg
        inp = self._assemble(x, cond)
        kw = {}
        if cfg.context_dim and cond.context is not None:
            kw["context"] = cond.context.to(self.device)
        if cfg.num_classes and cond.class_oh is not None:
            kw["y_emb"] = cond.class_oh.to(self.device)
        net = self.unet_serve if serve else self.unet
        if params is None:
            return net(inp, t, **kw)
        if self.cond_enc is not None:
            params = {k[len("unet."):]: v for k, v in params.items()
                      if k.startswith("unet.")}
        return functional_call(net, params, (inp, t), kw)

    # ---- training ---------------------------------------------------------
    def train_loss(self, latents: torch.Tensor, cond: CondCubes,
                   scale_factor: float = 1.0,
                   generator: torch.Generator | None = None,
                   t: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None,
                   drop: tuple | None = None, params: dict | None = None):
        """v-prediction (or epsilon) MSE with per-sample timesteps and
        classifier-free dropout of each condition on its own draw: the map
        and box cubes, and the extra cube, class one-hot and context where
        the condition has them. ``scale_factor`` is the scale_by_std
        normalizer and must match the one given to ``sample``. The draws
        come from ``generator`` unless injected: ``t`` int [B], ``noise``
        like latents, ``drop`` = (map, box[, extra, class, context]) masks,
        bool [B] each. Returns ``(loss, {"mse": loss})``."""
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
        drops = list(drop) if drop is not None else []
        drops += [None] * (5 - len(drops))
        p = cfg.classifier_free_prob

        def dropped(v, mask):
            return None if v is None else encoders.classifier_free_drop(
                v.to(dev), p, generator, mask)

        cond = CondCubes(*(dropped(getattr(cond, f.name), m) for f, m in
                           zip(dataclasses.fields(cond), drops)))
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
            cond2 = cond.cat_null(cfg)

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
