"""GSM RGB renderer; counterpart of ``infinicube_tpu/models/gsm/renderer.py``:
rasterize the merged gaussians for each target view (RGB + expected depth)
and composite ``render + (1 - alpha) * sky``. Views run one after another,
which bounds the rasterizer's sort to one view's instances."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from infinicube_tpu_torch.camera.conventions import invert_pose
from infinicube_tpu_torch.ops.gsplat import project_gaussians, rasterize

_KEYS = ("means", "scales", "quats", "opacities", "colors", "valid")


def merge_gaussians(*sets) -> dict:
    """Concatenate flat gaussian dicts (means / scales / quats / opacities /
    colors / valid), each flattened over its leading axes."""
    out = {}
    for k in _KEYS:
        parts = []
        for s in sets:
            v = s[k]
            lead = s["means"].dim() - 1
            parts.append(v.reshape((-1,) + tuple(v.shape[lead:]))
                         if k in ("means", "scales", "quats", "colors")
                         else v.reshape(-1))
        out[k] = torch.cat(parts, 0)
    return out


def render_views(gaussians: dict, Ks: torch.Tensor,
                 cam_to_worlds: torch.Tensor, image_hw: tuple[int, int],
                 sky_images: torch.Tensor | None = None,
                 tile_capacity: int = 256, tile: int = 16,
                 max_span: int = 4, remat: bool = True) -> dict:
    """gaussians: flat dict; Ks [V, 3, 3]; cam_to_worlds [V, 4, 4];
    sky_images f32 [V, H, W, 3] backgrounds (zeros when None). Invalid
    gaussians get opacity 0 and no tile. With ``remat`` a view's render is
    recomputed in the backward instead of kept. Returns dict rgb
    [V, H, W, 3], alpha [V, H, W], depth [V, H, W]."""
    op = torch.where(gaussians["valid"], gaussians["opacities"],
                     torch.zeros_like(gaussians["opacities"]))

    def one_view(K, pose, sky):
        p = project_gaussians(gaussians["means"], gaussians["quats"],
                              gaussians["scales"], invert_pose(pose), K,
                              image_hw)
        p = p._replace(valid=p.valid & gaussians["valid"])
        color, alpha, depth = rasterize(p, op, gaussians["colors"],
                                        image_hw, tile=tile,
                                        max_span=max_span,
                                        tile_capacity=tile_capacity)
        color = color + (1.0 - alpha)[..., None] * sky
        return color, alpha, depth

    outs = []
    for v in range(Ks.shape[0]):
        sky = sky_images[v] if sky_images is not None else \
            op.new_zeros(tuple(image_hw) + (3,))
        if remat and torch.is_grad_enabled():
            outs.append(checkpoint(one_view, Ks[v], cam_to_worlds[v], sky,
                                   use_reentrant=False))
        else:
            outs.append(one_view(Ks[v], cam_to_worlds[v], sky))
    rgb, alpha, depth = (torch.stack(o) for o in zip(*outs))
    return {"rgb": rgb, "alpha": alpha, "depth": depth}
