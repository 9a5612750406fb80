"""The GSM's image metrics; counterpart of the part of
``infinicube_tpu/models/gsm/loss.py`` that stage-3 inference imports:
``psnr`` and the masked ``ssim`` with its 11 x 11 gaussian window. The
training loss (``gsm_loss``, the perceptual terms) comes with the GSM
trainer."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
