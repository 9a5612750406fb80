"""Depth visualization and alignment utilities (numpy); the port's copy of
``infinicube_tpu/utils/depth_vis.py``: the ``vis_depth`` colormap
(matplotlib's turbo where matplotlib is installed, a closed-form ramp
otherwise, as the reference) and least-squares scale / shift alignment of
monocular depth against sparse metric depth."""

from __future__ import annotations

import numpy as np


def vis_depth(depth: np.ndarray, max_depth: float | None = None) -> np.ndarray:
    """f32 [H, W] depth (0 = invalid) -> uint8 [H, W, 3] turbo-ish colormap."""
    d = np.asarray(depth, np.float32)
    valid = d > 0
    if max_depth is None:
        max_depth = np.percentile(d[valid], 97) if valid.any() else 1.0
    x = np.clip(d / max(max_depth, 1e-6), 0, 1)
    try:
        from matplotlib import colormaps
        rgb = colormaps["turbo"](1.0 - x)[..., :3]
    except Exception:
        rgb = np.stack([1 - x, np.abs(0.5 - x) * 2, x], axis=-1)
    rgb = np.where(valid[..., None], rgb, 1.0)
    return (rgb * 255).astype(np.uint8)


def align_depth_lstsq(mono: np.ndarray, metric: np.ndarray,
                      valid: np.ndarray | None = None,
                      inverse: bool = True) -> tuple[float, float]:
    """Fit (scale, shift) minimizing || s * mono + t - metric ||^2 over valid
    pixels; with inverse=True the fit runs in inverse-depth space (the
    standard monocular-depth alignment).
    Returns (scale, shift)."""
    m = np.asarray(mono, np.float64).ravel()
    g = np.asarray(metric, np.float64).ravel()
    v = (g > 0) & np.isfinite(m)
    if valid is not None:
        v &= np.asarray(valid).ravel()
    if inverse:
        g = np.where(v, 1.0 / np.maximum(g, 1e-6), 0.0)
    A = np.stack([m[v], np.ones(v.sum())], axis=1)
    sol, *_ = np.linalg.lstsq(A, g[v], rcond=None)
    return float(sol[0]), float(sol[1])


def apply_depth_alignment(mono: np.ndarray, scale: float, shift: float,
                          inverse: bool = True) -> np.ndarray:
    out = scale * np.asarray(mono, np.float64) + shift
    if inverse:
        out = 1.0 / np.maximum(out, 1e-6)
    return out.astype(np.float32)


def _quantile_band_mask(values: np.ndarray, mask: np.ndarray,
                        lo: float = 0.1, hi: float = 0.9) -> np.ndarray:
    """Keep values inside the [lo, hi] quantile band of the masked set
    (outlier removal)."""
    if not mask.any():
        return np.ones_like(mask)
    qlo, qhi = np.quantile(values[mask], [lo, hi])
    return (values > qlo) & (values < qhi)


def align_depth_to_depth(source_depth: np.ndarray, target_depth: np.ndarray,
                         target_mask: np.ndarray | None = None,
                         return_scale: bool = False):
    """Affine-align a dense depth map to sparse metric depth with 10-90%
    quantile outlier rejection.
    Zeros in the source stay zero."""
    source_invalid = source_depth == 0
    smask = source_depth > 0
    tmask = target_depth > 0
    if target_mask is not None:
        tmask &= target_mask > 0
    smask &= _quantile_band_mask(source_depth, smask)
    tmask &= _quantile_band_mask(target_depth, tmask)
    m = smask & tmask
    if m.sum() < 2:
        return (1.0, 0.0) if return_scale else source_depth
    A = np.stack([source_depth[m], np.ones(m.sum())], axis=1)
    sol, *_ = np.linalg.lstsq(A, target_depth[m][:, None], rcond=None)
    scale, bias = float(sol[0, 0]), float(sol[1, 0])
    if return_scale:
        return scale, bias
    out = source_depth * scale + bias
    out[source_invalid] = 0
    return out


def align_inv_depth_to_depth(source_inv_depth: np.ndarray,
                             target_depth: np.ndarray,
                             target_mask: np.ndarray | None = None
                             ) -> np.ndarray:
    """Align an INVERSE-depth map (Depth-Anything output) to metric depth:
    true_depth = 1 / (scale * inv + bias), fitted in inverse-depth space
    with quantile outlier rejection. Negative depths clamp to 0."""
    with np.errstate(divide="ignore"):
        target_inv = np.where(target_depth > 0, 1.0 / target_depth, 0.0)
    smask = source_inv_depth > 0
    tmask = target_depth > 0
    if target_mask is not None:
        tmask &= target_mask > 0
    smask &= _quantile_band_mask(source_inv_depth, smask)
    tmask &= _quantile_band_mask(target_inv, tmask)
    m = smask & tmask
    if m.sum() < 2:
        return np.zeros_like(source_inv_depth)
    A = np.stack([source_inv_depth[m], np.ones(m.sum())], axis=1)
    sol, *_ = np.linalg.lstsq(A, target_inv[m][:, None], rcond=None)
    aligned_inv = source_inv_depth * float(sol[0, 0]) + float(sol[1, 0])
    with np.errstate(divide="ignore"):
        out = np.where(aligned_inv > 0, 1.0 / aligned_inv, 0.0)
    return np.where(out < 0, 0.0, out)


def align_depth_to_depth_batch(source: np.ndarray, target: np.ndarray,
                               target_mask: np.ndarray | None = None
                               ) -> np.ndarray:
    """Per-frame alignment over a [N, H, W] stack."""
    return np.stack([
        align_depth_to_depth(source[i], target[i],
                             None if target_mask is None else target_mask[i])
        for i in range(len(source))])


def normalize_pointmap(points: np.ndarray, valid: np.ndarray | None = None):
    """Scale a pointmap [H, W, 3] by the mean valid distance. Returns
    (normalized, scale)."""
    v = valid if valid is not None else np.isfinite(points).all(-1)
    d = np.linalg.norm(points[v], axis=-1)
    scale = float(d.mean()) if len(d) else 1.0
    return points / max(scale, 1e-9), scale
