"""GSM: feed-forward 3D Gaussian scene reconstruction (pipeline stage 3);
counterpart of ``infinicube_tpu/models/gsm/model.py``.

forward: UnifiedEncoder -> voxel branch (lift, visibility, guided sparse
UNet, K gaussians per voxel) and pixel branch (2D UNet, K gaussians per
pixel) -> merged gaussians -> sky token and sky backgrounds -> renders of
the target views. ``decode_all_pixels`` makes every pixel emit gaussians
(the dynamic-object pass).

Serving runs under ``torch.inference_mode()`` (the JAX package's jitted
apply); the release configuration is f32 throughout, its voxel branch on
K4 and its pixel-branch attention on ``flash_attn_f32`` on the card.
``gsm_bf16_config`` is the reference's training configuration: the voxel,
pixel and sky branches compute in bf16 (the sparse convs on the bf16
twins of K4 and K6, the attention on K2 and K5), the parameters, norms
and the branches' outputs stay f32."""

from __future__ import annotations

import dataclasses
import math
import time

import torch
from torch import nn

from infinicube_tpu_torch.camera import projection as proj
from infinicube_tpu_torch.grid import keys as K
from infinicube_tpu_torch.grid.build import coarsened_grid, grid_from_keys
from infinicube_tpu_torch.grid.grid import Grid
from infinicube_tpu_torch.grid.ops import neighbor_indexes
from infinicube_tpu_torch.models.gsm.encoders import (UnifiedEncoder,
                                                      UnifiedEncoderConfig)
from infinicube_tpu_torch.models.gsm.lifter import (lift_features,
                                                    visible_voxel_mask)
from infinicube_tpu_torch.models.gsm.pixel_branch import (PixelBranch,
                                                          PixelBranchConfig)
from infinicube_tpu_torch.models.gsm.renderer import (merge_gaussians,
                                                      render_views)
from infinicube_tpu_torch.models.gsm.sky import (SkyboxMlpModulator,
                                                 SkyboxNull, SkyboxPanorama,
                                                 SkyConfig)
from infinicube_tpu_torch.models.gsm.voxel_branch import (VoxelBranch,
                                                          VoxelBranchConfig)
from infinicube_tpu_torch.nn.layers import Conv2d
from infinicube_tpu_torch.nn.sparse import SparseConv3d


@dataclasses.dataclass(frozen=True)
class GSMConfig:
    encoder: UnifiedEncoderConfig = UnifiedEncoderConfig()
    voxel: VoxelBranchConfig = VoxelBranchConfig()
    pixel: PixelBranchConfig = PixelBranchConfig()
    sky: SkyConfig = SkyConfig()
    use_voxel_branch: bool = True
    use_pixel_branch: bool = True
    grid_levels: int = 3
    dense_dims: tuple = (128, 64, 32)     # raycast crop of the scene grid
    dense_ijk_min: tuple = (-16, -32, -8)
    render_tile_capacity: int = 256
    render_tile: int = 16
    render_span: int = 4
    render_remat: bool = False            # recompute view renders (train)


def gsm_bf16_config(cfg: GSMConfig | None = None) -> GSMConfig:
    """bf16 compute in the voxel, pixel and sky branches, the parameters
    and the norms in f32: the reference's training configuration."""
    cfg = cfg or GSMConfig()
    return dataclasses.replace(
        cfg,
        voxel=dataclasses.replace(cfg.voxel, dtype=torch.bfloat16),
        pixel=dataclasses.replace(cfg.pixel, dtype=torch.bfloat16),
        sky=dataclasses.replace(cfg.sky, dtype=torch.bfloat16))


def feature_width(cfg: UnifiedEncoderConfig) -> int:
    """Channels of the encoder's concatenated per-pixel features."""
    return sum(w for kind, w in (("conv", cfg.conv_width),
                                 ("vit", cfg.vit_width),
                                 ("dav2", cfg.dav2_width),
                                 ("dino", cfg.dino_width),
                                 ("convnext", cfg.convnext_width),
                                 ("plucker", cfg.plucker_width))
               if kind in cfg.encoders)


class GSM(nn.Module):
    """``image_hw`` is needed only by the "vit" encoder kind (its position
    table). ``forward`` records the wall-clock seconds of its parts in
    ``last_phase_seconds``; each part ends with a device sync."""

    def __init__(self, cfg: GSMConfig = GSMConfig(), device=None,
                 image_hw: tuple[int, int] | None = None):
        super().__init__()
        self.cfg = cfg
        vit_patches = None if image_hw is None else \
            (image_hw[0] // 14) * (image_hw[1] // 14)
        self.encoder = UnifiedEncoder(cfg.encoder, vit_patches=vit_patches,
                                      device=device)
        fw = feature_width(cfg.encoder)
        if cfg.use_voxel_branch:
            self.voxel_branch = VoxelBranch(cfg.voxel, fw, device=device)
        if cfg.use_pixel_branch:
            self.pixel_branch = PixelBranch(cfg.pixel, device=device)
        if cfg.sky.kind == "mlp_modulator":
            self.sky = SkyboxMlpModulator(cfg.sky, device=device)
        elif cfg.sky.kind == "panorama":
            self.sky = SkyboxPanorama(cfg.sky, device=device)
        else:
            self.sky = SkyboxNull()
        self.last_phase_seconds: dict[str, float] = {}

    def init_params(self, generator: torch.Generator) -> None:
        """Random weights in the manner of flax's defaults: kernels
        N(0, 1/fan_in), the sparse convs U(-s, s) with s = 1/sqrt(27 F_in),
        biases 0, norm scales 1, the sky query and position tables
        N(0, 0.02^2); the panorama 0.5 and ConvNeXt's layer scales 1 stay
        as built."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, SparseConv3d):
                    m.reset_parameters(generator)
                elif isinstance(m, (nn.Linear, Conv2d)):
                    fan_in = m.weight[0].numel()
                    m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                     generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
            for name, p in self.named_parameters():
                if name.endswith(("sky_query", ".pos")):
                    p.normal_(0.0, 0.02, generator=generator)

    # -- pieces ----------------------------------------------------------
    def grid_pyramid(self, grid: Grid) -> list[Grid]:
        grids = [grid]
        for _ in range(self.cfg.grid_levels - 1):
            grids.append(coarsened_grid(grids[-1],
                                        self.cfg.voxel.pooling_factor,
                                        capacity=grids[-1].capacity))
        return grids

    @staticmethod
    def voxel_preprocess(grid: Grid, crop_min=None, crop_max=None,
                         surface_only: bool = False, coarsen=None) -> Grid:
        """Clip / surface-keep / coarsen the scene grid. surface_only keeps
        voxels with at least one empty 6-neighbour."""
        mask = grid.mask
        if crop_min is not None:
            c = grid.voxel_centers()
            lo = c.new_tensor(crop_min)
            hi = c.new_tensor(crop_max)
            mask = mask & ((c >= lo) & (c <= hi)).all(-1)
        if surface_only:
            nbr = neighbor_indexes(grid, 3)
            # the 6 face neighbours in the row-major 3x3x3 window
            faces = torch.tensor([4, 10, 12, 14, 16, 22],
                                 device=grid.ijk.device)
            mask = mask & ~(nbr[:, :, faces] >= 0).all(-1)
        g = grid_from_keys(torch.where(mask, grid.keys,
                                       torch.full_like(grid.keys,
                                                       K.INVALID_KEY)),
                           grid.capacity, grid.voxel_size, grid.origin)
        if coarsen is not None:
            g = coarsened_grid(g, tuple(coarsen), capacity=g.capacity)
        return g

    def sky_token(self, images, sky_mask, Ks, cam_to_worlds):
        H, W = images.shape[1:3]
        dirs = torch.stack([proj.posed_rays_from_intrinsics(K, p, (H, W))[1]
                            for K, p in zip(Ks, cam_to_worlds)])
        return self.sky.encode(images, sky_mask, dirs)

    def _phase(self, name: str, t0: float, device: torch.device) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        self.last_phase_seconds[name] = t - t0
        return t

    def forward(self, batch: dict, decode_all_pixels: bool = False) -> dict:
        """batch (one scene, V input views): grid (batch-1 Grid), images
        [V, H, W, 3], masks [V, H, W, 4], Ks [V, 3, 3], cam_to_worlds
        [V, 4, 4], depth_prior [V, H, W, 1], and optionally target_Ks
        [Vt, 3, 3], target_poses [Vt, 4, 4] (default: the inputs). Returns
        gaussians, renders, the sky token and the masks."""
        cfg = self.cfg
        self.last_phase_seconds = {}
        t = time.perf_counter()
        images = batch["images"]
        V, H, W = images.shape[:3]
        depth_prior = batch.get("depth_prior")
        if depth_prior is None:
            depth_prior = images.new_zeros((V, H, W, 1))
        Ks, poses = batch["Ks"], batch["cam_to_worlds"]
        enc = self.encoder(images[None], batch["masks"][None], Ks=Ks[None],
                           cam_to_worlds=poses[None],
                           depth=depth_prior[None])
        feats = enc["features"][0]                       # [V, H, W, F]
        sky_mask = enc["sky_mask"][0]
        eff_mask = enc["effective_mask"][0]
        t = self._phase("encoder", t, images.device)

        sets = []
        if cfg.use_voxel_branch:
            grid = batch["grid"]
            grids = self.grid_pyramid(grid)
            lifted = lift_features(grid, feats, Ks, poses,
                                   cfg.dense_ijk_min, cfg.dense_dims)
            visible = visible_voxel_mask(grid, Ks, poses, cfg.dense_ijk_min,
                                         cfg.dense_dims,
                                         ray_hw=(H // 2, W // 2))
            sets.append(self.voxel_branch(grids, lifted, visible, feats, Ks,
                                          poses))
            del lifted
            t = self._phase("voxel_branch", t, images.device)
        del feats
        if cfg.use_pixel_branch:
            if cfg.use_voxel_branch:
                # joint inference: the pixel branch covers the midground
                pixel_mask = enc["midground"][0] & (eff_mask > 0)
            else:  # 2D only: every non-sky foreground pixel
                pixel_mask = (eff_mask > 0) & ~sky_mask
            sets.append(self.pixel_branch(images, depth_prior, Ks, poses,
                                          pixel_mask=pixel_mask,
                                          decode_all=decode_all_pixels))
            t = self._phase("pixel_branch", t, images.device)
        gaussians = merge_gaussians(*sets)
        del sets

        t_Ks = batch.get("target_Ks", Ks)
        t_poses = batch.get("target_poses", poses)
        # the sky per target view: its MLP runs at every pixel
        t_dirs = [proj.posed_rays_from_intrinsics(K, p, (H, W))[1]
                  for K, p in zip(t_Ks, t_poses)]
        if cfg.sky.kind == "mlp_modulator":
            token = self.sky_token(images, sky_mask, Ks, poses)
            sky_images = torch.stack([self.sky.sample(token, d)
                                      for d in t_dirs])
        else:
            token = None
            sky_images = torch.stack([self.sky(d) for d in t_dirs])
        t = self._phase("sky", t, images.device)
        render = render_views(gaussians, t_Ks, t_poses, (H, W),
                              sky_images=sky_images,
                              tile_capacity=cfg.render_tile_capacity,
                              tile=cfg.render_tile, max_span=cfg.render_span,
                              remat=cfg.render_remat)
        self._phase("render", t, images.device)
        return {"gaussians": gaussians, "render": render, "sky_token": token,
                "sky_mask": sky_mask, "effective_mask": eff_mask}
