"""GSM unified loss; counterpart of ``infinicube_tpu/models/gsm/loss.py``:
masked alpha L1, pixel L1 + masked SSIM (its 11 x 11 gaussian window),
depth L1, the perceptual term, PSNR, the gaussian statistics.

The perceptual term is the checkpoint-shaped LPIPS-VGG16
(``models/gsm/lpips.py``) when an ``LPIPS`` module is passed, on
``lpips_crop``-square crops at random offsets per view when a
``torch.Generator`` is passed (the centre otherwise), its forward recomputed
in the backward; else a multi-scale gradient-magnitude proxy. The same seed
draws other offsets than ``jax.random`` does."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class GSMLossConfig:
    rgb_l1_weight: float = 1.0
    ssim_weight: float = 0.2
    alpha_weight: float = 0.5
    depth_weight: float = 0.1
    perceptual_weight: float = 0.05
    # real-LPIPS images are cropped to lpips_crop^2 (random offsets when a
    # generator is passed to gsm_loss, the centre otherwise), which bounds
    # the VGG's activations at release scale; None = full images
    lpips_crop: int | None = 224


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    return g[:, None] * g[None, :]


def ssim(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor | None = None):
    """Masked SSIM over (..., H, W, C) images in [0, 1] (a 3-D image is one
    of a batch); the window is SAME-padded with zeros, channel by
    channel."""
    a4 = a if a.dim() == 4 else a[None]
    b4 = b if b.dim() == 4 else b[None]
    C = a4.shape[-1]
    k = _gaussian_kernel(device=a.device)
    kc = k[None, None].expand(C, 1, *k.shape)

    def filt(x):
        y = F.conv2d(x.permute(0, 3, 1, 2), kc, padding=k.shape[0] // 2,
                     groups=C)
        return y.permute(0, 2, 3, 1)

    mu_a, mu_b = filt(a4), filt(b4)
    var_a = filt(a4 * a4) - mu_a ** 2
    var_b = filt(b4 * b4) - mu_b ** 2
    cov = filt(a4 * b4) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / \
        ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    if mask is not None:
        m = mask[..., None] if mask.dim() == s.dim() - 1 else mask
        m = torch.broadcast_to(m.to(s.dtype), s.shape)
        return torch.sum(s * m) / torch.sum(m).clamp_min(1.0)
    return torch.mean(s)


def psnr(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor | None = None):
    if mask is not None:
        m = torch.broadcast_to(mask[..., None].to(a.dtype), a.shape)
        mse = torch.sum(((a - b) ** 2) * m) / torch.sum(m).clamp_min(1.0)
    else:
        mse = torch.mean((a - b) ** 2)
    return -10.0 * torch.log10(mse.clamp_min(1e-10))


def perceptual_proxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Multi-scale gradient-magnitude distance (the LPIPS stand-in) over
    (..., H, W, C) images."""
    total = 0.0
    for _ in range(3):
        d = a - b
        total = total + torch.diff(d, dim=-2).abs().mean() + \
            torch.diff(d, dim=-3).abs().mean()
        a = a[..., ::2, ::2, :]
        b = b[..., ::2, ::2, :]
    return total / 3.0


def lpips_crop(a: torch.Tensor, b: torch.Tensor, c: int | None,
               generator: torch.Generator | None = None):
    """[V, H, W, C] images cut to min(c, H) x min(c, W) at one offset per
    view, drawn from ``generator`` where one is given (uniform over the
    valid offsets), the centre otherwise; the images as they are when
    ``c`` is None or neither side exceeds it."""
    V, H, W = a.shape[-4:-1]
    if c is None or (H <= c and W <= c):
        return a, b
    cy, cx = min(c, H), min(c, W)
    if generator is not None:
        dev = generator.device
        ys = torch.randint(0, H - cy + 1, (V,), generator=generator,
                           device=dev).tolist()
        xs = torch.randint(0, W - cx + 1, (V,), generator=generator,
                           device=dev).tolist()
    else:
        ys, xs = [(H - cy) // 2] * V, [(W - cx) // 2] * V

    def crop(img):
        return torch.stack([img[i, y:y + cy, x:x + cx]
                            for i, (y, x) in enumerate(zip(ys, xs))])

    return crop(a), crop(b)


def gsm_loss(cfg: GSMLossConfig, render: dict, gt_rgb: torch.Tensor,
             gt_mask: torch.Tensor, sky_mask: torch.Tensor,
             gt_depth: torch.Tensor | None = None,
             gaussians: dict | None = None, lpips=None,
             generator: torch.Generator | None = None):
    """render: the renderer's dict (rgb [V, H, W, 3], alpha and depth
    [V, H, W]); gt_mask bool [V, H, W], the effective supervision mask;
    sky_mask bool [V, H, W]; ``lpips`` an ``LPIPS`` module or None;
    ``generator`` draws the LPIPS crop offsets. Returns (total, metrics)."""
    m = gt_mask.float()
    rgb_l1 = torch.sum(torch.abs(render["rgb"] - gt_rgb) * m[..., None]) / \
        (torch.sum(m) * 3).clamp_min(1.0)
    s = ssim(render["rgb"], gt_rgb, gt_mask)
    # alpha: 1 on non-sky foreground, 0 on sky
    alpha_target = (~sky_mask).float()
    alpha_l1 = torch.sum(torch.abs(render["alpha"] - alpha_target) * m) / \
        torch.sum(m).clamp_min(1.0)
    total = cfg.rgb_l1_weight * rgb_l1 + cfg.ssim_weight * (1.0 - s) + \
        cfg.alpha_weight * alpha_l1
    metrics = {"rgb_l1": rgb_l1, "ssim": s, "alpha_l1": alpha_l1,
               "psnr": psnr(render["rgb"], gt_rgb, gt_mask)}
    if cfg.perceptual_weight > 0:
        if lpips is not None:
            a, b = lpips_crop(render["rgb"], gt_rgb, cfg.lpips_crop,
                              generator)
            dtype = lpips.lin0.dtype

            def distance(a_, b_):
                return torch.mean(lpips(a_, b_))

            # the VGG's activations are recomputed in the backward instead
            # of kept
            p = checkpoint(distance, lpips.from_unit_range(a).to(dtype),
                           lpips.from_unit_range(b).to(dtype),
                           use_reentrant=False).float()
        else:
            p = perceptual_proxy(render["rgb"], gt_rgb)
        total = total + cfg.perceptual_weight * p
        metrics["perceptual"] = p
    if gt_depth is not None and cfg.depth_weight > 0:
        dm = m * (gt_depth > 0)
        dl = torch.sum(torch.abs(render["depth"] - gt_depth) * dm) / \
            torch.sum(dm).clamp_min(1.0)
        total = total + cfg.depth_weight * dl
        metrics["depth_l1"] = dl
    if gaussians is not None:
        v = gaussians["valid"].float()
        n = v.sum().clamp_min(1.0)
        metrics["gs_mean_scale"] = torch.sum(
            gaussians["scales"].mean(-1) * v) / n
        metrics["gs_mean_opacity"] = torch.sum(
            gaussians["opacities"] * v) / n
    metrics["total"] = total
    return total, metrics
