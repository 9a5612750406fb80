"""The kitchen-sink NKSR field losses (UDF, spatial TSDF, GT surface);
counterpart of ``infinicube_tpu/models/vae/nksr_loss.py``.

- ``sdf_from_points``: the IMLS signed distance from an oriented point
  cloud over the k nearest references (``ops/knn.knn_bruteforce``),
  Gaussian-weighted plane distances.
- The samplers draw slots from the capacity-padded grids by inverse CDF
  (one cumsum and one searchsorted). Their uniform and normal draws come
  from a ``torch.Generator``, or are injected (``u_slot``, ``u_off``,
  ``noise``, ``u_surface``) so that the JAX package's ``jax.random``
  draws can be fed through.
- The field is a callable ``field_fn(points f32 [N, 3]) -> f32 [N]``; the
  surface normal is its gradient through ``torch.autograd.grad(...,
  create_graph=True)``, so the normal loss stays differentiable.

Chi is positive inside the surface. Every function takes one sample."""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from infinicube_tpu_torch.grid.grid import Grid
from infinicube_tpu_torch.grid.ops import index_map
from infinicube_tpu_torch.ops.knn import knn_bruteforce

FieldFn = Callable[[torch.Tensor], torch.Tensor]   # f32 [N, 3] -> f32 [N]


def grid_iou(gt: Grid, pd: Grid) -> torch.Tensor:
    """f32 [B] IoU of two same-frame grids' active voxel sets."""
    idx = index_map(gt, pd)                       # [B, C_gt] into pd
    inter = torch.sum((idx >= 0) & gt.mask, dim=-1).float()
    union = (gt.mask.sum(-1) + pd.mask.sum(-1)).float() - inter
    return inter / (union + 1e-6)


def sdf_from_points(query: torch.Tensor, ref_xyz: torch.Tensor,
                    ref_normal: torch.Tensor,
                    ref_mask: torch.Tensor | None = None, k: int = 8,
                    stdv: float = 0.2) -> torch.Tensor:
    """IMLS SDF, positive outside (along the normals):
    sdf(q) = sum_i w_i <q - x_i, n_i> / sum_i w_i over the k nearest
    references, w_i = exp(-|q - x_i|^2 / (2 stdv^2)); uniform weights
    where every weight underflows."""
    d2, idx = knn_bruteforce(query, ref_xyz, ref_mask, k=k)
    idx = idx.long()
    nn_xyz = ref_xyz[idx]                         # [N, k, 3]
    nn_nrm = ref_normal[idx]
    plane_d = torch.sum((query[:, None, :] - nn_xyz) * nn_nrm, dim=-1)
    w = torch.exp(-d2 / (2.0 * stdv * stdv))
    wsum = torch.sum(w, dim=-1, keepdim=True)
    w = torch.where(wsum > 1e-12, w, torch.ones_like(w))
    return torch.sum(w * plane_d, -1) / torch.sum(w, -1).clamp_min(1e-12)


def transform_field(x: torch.Tensor, truncation: float,
                    soft: bool = True) -> torch.Tensor:
    """tanh-soft or hard-clamp truncation of a distance field."""
    if soft:
        return torch.tanh(x / truncation) * truncation
    return torch.clamp(x, -truncation, truncation)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """One sampler of the UDF and spatial losses."""
    type: str = "uniform"          # "uniform" | "band"
    n_samples: int = 4096
    expand: int = 0                # uniform: voxel-cube expansion
    expand_top: int = 0            # uniform: expansion of the coarsest level
    eps: float = 0.5               # band: normal-noise scale, * voxel_size


def _uniform(shape, generator, device, u=None):
    """Uniform [0, 1) draws of ``shape``, or ``u`` where it is given."""
    if u is not None:
        return torch.as_tensor(u, dtype=torch.float32, device=device)
    return torch.rand(shape, generator=generator, device=device)


def _masked_choice(valid: torch.Tensor, n: int, generator=None,
                   u=None) -> torch.Tensor:
    """int64 [n] slot indices drawn uniformly from the valid slots (inverse
    CDF); ``u`` f32 [n] in [0, 1) replaces the draw."""
    cum = torch.cumsum(valid.to(torch.int32), 0)
    total = cum[-1].clamp_min(1)
    u = _uniform((n,), generator, valid.device, u) * total.float()
    return torch.searchsorted(cum.float(), u, right=True)


def hierarchy_samples(grids: Sequence[Grid], n_samples: int,
                      expand: int = 0, expand_top: int = 0,
                      batch_index: int = 0, generator=None, u_slot=None,
                      u_off=None) -> torch.Tensor:
    """f32 [n_samples, 3] uniform samples across the decoder levels: each
    active voxel's sample cube widened to (1 + 2 (expand // 2)) voxels where
    expand >= 3 (``expand_top`` for the coarsest level). ``u_slot`` [n] and
    ``u_off`` [n, 3] replace the draws."""
    centers, scales, valid = [], [], []
    for d, g in enumerate(grids):
        e = expand if d != len(grids) - 1 else expand_top
        width = float(1 + 2 * (e // 2)) if e >= 3 else 1.0
        centers.append(g.voxel_centers()[batch_index])
        scales.append((g.voxel_size[None, :] * width).expand(g.capacity, 3))
        valid.append(g.mask[batch_index])
    centers = torch.cat(centers, 0)
    scales = torch.cat(scales, 0)
    valid = torch.cat(valid, 0)
    slots = _masked_choice(valid, n_samples, generator, u_slot)
    off = _uniform((n_samples, 3), generator, centers.device, u_off) - 0.5
    return centers[slots] + off * scales[slots]


def band_samples(ref_xyz: torch.Tensor, ref_normal: torch.Tensor,
                 ref_mask: torch.Tensor | None, n_samples: int, eps: float,
                 voxel_size: float, generator=None, u_slot=None,
                 noise=None) -> torch.Tensor:
    """f32 [n_samples, 3] near-surface samples: references moved along
    their normals by N(0, (eps voxel_size)^2). ``u_slot`` [n] and ``noise``
    [n, 1] (standard normal) replace the draws."""
    if ref_mask is None:
        ref_mask = torch.ones(ref_xyz.shape[:1], dtype=torch.bool,
                              device=ref_xyz.device)
    inds = _masked_choice(ref_mask, n_samples, generator, u_slot)
    if noise is None:
        noise = torch.randn((n_samples, 1), generator=generator,
                            device=ref_xyz.device)
    noise = torch.as_tensor(noise, dtype=torch.float32,
                            device=ref_xyz.device) * (eps * voxel_size)
    return ref_xyz[inds] + ref_normal[inds] * noise


def draw_samples(samplers: Sequence[SamplerConfig], grids: Sequence[Grid],
                 ref_xyz: torch.Tensor, ref_normal: torch.Tensor,
                 ref_mask: torch.Tensor | None, voxel_size: float,
                 generator=None, draws: Sequence[dict] | None = None
                 ) -> torch.Tensor:
    """The concatenation over the samplers; ``draws[i]`` holds sampler i's
    injected draws (the keyword arguments of its sampler)."""
    out = []
    for i, s in enumerate(samplers):
        kw = dict(draws[i]) if draws is not None else {}
        if s.type == "uniform":
            out.append(hierarchy_samples(grids, s.n_samples, s.expand,
                                         s.expand_top, generator=generator,
                                         **kw))
        elif s.type == "band":
            out.append(band_samples(ref_xyz, ref_normal, ref_mask,
                                    s.n_samples, s.eps, voxel_size,
                                    generator=generator, **kw))
        else:
            raise ValueError(f"unknown sampler type {s.type!r}")
    return torch.cat(out, 0)


@dataclasses.dataclass(frozen=True)
class NKSRLossConfig:
    """The supervision settings the kitchen-sink losses read."""
    voxel_size: float = 0.1
    gt_band: float = 3.0               # truncation = gt_band * voxel_size
    gt_soft: bool = True
    udf_weight: float = 1.0
    spatial_weight: float = 1.0
    reg_sdf_weight: float = 0.0
    surface_value_weight: float = 1.0
    surface_normal_weight: float = 1.0
    surface_subsample: int = 4096
    sdf_knn: int = 8
    sdf_stdv: float = 0.2

    @property
    def truncation(self) -> float:
        return self.gt_band * self.voxel_size


def compute_gt_chi(cfg: NKSRLossConfig, query: torch.Tensor,
                   ref_xyz: torch.Tensor, ref_normal: torch.Tensor,
                   ref_mask: torch.Tensor | None = None,
                   transform: bool = True) -> torch.Tensor:
    """chi = -IMLS sdf, truncated unless ``transform`` is False."""
    chi = -sdf_from_points(query, ref_xyz, ref_normal, ref_mask,
                           k=cfg.sdf_knn, stdv=cfg.sdf_stdv)
    return transform_field(chi, cfg.truncation, cfg.gt_soft) if transform \
        else chi


def udf_loss(cfg: NKSRLossConfig, field_fn: FieldFn, query: torch.Tensor,
             ref_xyz: torch.Tensor, ref_normal: torch.Tensor,
             ref_mask: torch.Tensor | None = None) -> torch.Tensor:
    """L1 between the truncated predicted field and |truncated gt chi|,
    over voxel_size."""
    gt_tudf = torch.abs(compute_gt_chi(cfg, query, ref_xyz, ref_normal,
                                       ref_mask))
    pd_tudf = transform_field(field_fn(query), cfg.truncation, cfg.gt_soft)
    return torch.mean(torch.abs(pd_tudf - gt_tudf) / cfg.voxel_size)


def spatial_loss(cfg: NKSRLossConfig, field_fn: FieldFn, query: torch.Tensor,
                 ref_xyz: torch.Tensor, ref_normal: torch.Tensor,
                 ref_mask: torch.Tensor | None = None,
                 near_surface_mask: torch.Tensor | None = None):
    """Near the surface the L1 of the truncated fields over voxel_size; in
    empty space 0.1 exp(chi / (2 voxel_size)). With point-cloud ground truth
    every sample is near the surface. Returns (mixed_loss, reg_sdf_loss)."""
    pd_chi = field_fn(query)
    gt_tsdf = compute_gt_chi(cfg, query, ref_xyz, ref_normal, ref_mask)
    pd_tsdf = transform_field(pd_chi, cfg.truncation, cfg.gt_soft)
    if near_surface_mask is None:
        near_surface_mask = torch.ones(query.shape[:1], dtype=torch.bool,
                                       device=query.device)
    near = torch.abs(pd_tsdf - gt_tsdf) / cfg.voxel_size
    empty = 0.1 * torch.exp(pd_chi / (2.0 * cfg.voxel_size))
    zero = torch.zeros_like(near)
    mixed = (torch.sum(torch.where(near_surface_mask, near, zero))
             + torch.sum(torch.where(near_surface_mask, zero, empty))
             ) / query.shape[0]
    reg_sdf_eps = 0.5
    reg = torch.mean(reg_sdf_eps / (pd_chi * pd_chi + reg_sdf_eps ** 2))
    return mixed, reg


def gt_surface_loss(cfg: NKSRLossConfig, field_fn: FieldFn,
                    ref_xyz: torch.Tensor, ref_normal: torch.Tensor,
                    ref_mask: torch.Tensor | None = None, generator=None,
                    u_slot=None):
    """The field's L1 on the surface, and 1 - <normalized -grad field, gt
    normal> on a subsample of the references (``u_slot`` replaces its
    draw). The gradient is the field's own, kept in the graph. Returns
    (value_loss, normal_loss)."""
    if ref_mask is None:
        ref_mask = torch.ones(ref_xyz.shape[:1], dtype=torch.bool,
                              device=ref_xyz.device)
    n = min(cfg.surface_subsample, ref_xyz.shape[0]) \
        if cfg.surface_subsample > 0 else ref_xyz.shape[0]
    inds = _masked_choice(ref_mask, n, generator, u_slot)
    pts, nrm = ref_xyz[inds], ref_normal[inds]
    if cfg.surface_normal_weight <= 0.0:
        return torch.mean(torch.abs(field_fn(pts))), \
            torch.zeros((), device=pts.device)
    with torch.enable_grad():
        if not pts.requires_grad:
            pts = pts.detach().requires_grad_(True)
        val = field_fn(pts)
        grad, = torch.autograd.grad(val, pts, torch.ones_like(val),
                                    create_graph=True)
    value_loss = torch.mean(torch.abs(val))
    pd_grad = -grad / (torch.linalg.vector_norm(grad, dim=-1, keepdim=True)
                       + 1e-6)
    normal_loss = 1.0 - torch.mean(torch.sum(pd_grad * nrm, dim=-1))
    return value_loss, normal_loss


def kitchen_sink_losses(cfg: NKSRLossConfig, field_fn: FieldFn,
                        grids: Sequence[Grid], ref_xyz: torch.Tensor,
                        ref_normal: torch.Tensor,
                        ref_mask: torch.Tensor | None = None,
                        samplers: Sequence[SamplerConfig] = (
                            SamplerConfig("uniform", 4096, expand_top=4),
                            SamplerConfig("band", 4096),
                        ), generator=None,
                        draws: Sequence[dict] | None = None,
                        u_surface=None):
    """The weighted sum of every enabled loss and the per-term metrics.
    ``draws`` and ``u_surface`` replace the samplers' and the surface
    subsample's draws."""
    metrics = {}
    total = torch.zeros((), device=ref_xyz.device)
    if cfg.udf_weight > 0.0 or cfg.spatial_weight > 0.0:
        query = draw_samples(samplers, grids, ref_xyz, ref_normal, ref_mask,
                             cfg.voxel_size, generator, draws)
        if cfg.udf_weight > 0.0:
            l = udf_loss(cfg, field_fn, query, ref_xyz, ref_normal, ref_mask)
            total = total + cfg.udf_weight * l
            metrics["udf"] = l
        if cfg.spatial_weight > 0.0:
            mixed, reg = spatial_loss(cfg, field_fn, query, ref_xyz,
                                      ref_normal, ref_mask)
            total = total + cfg.spatial_weight * mixed
            metrics["spatial"] = mixed
            if cfg.reg_sdf_weight > 0.0:
                total = total + cfg.reg_sdf_weight * reg
                metrics["msa"] = reg
    if cfg.surface_value_weight > 0.0 or cfg.surface_normal_weight > 0.0:
        v, nl = gt_surface_loss(cfg, field_fn, ref_xyz, ref_normal, ref_mask,
                                generator, u_surface)
        total = total + cfg.surface_value_weight * v \
            + cfg.surface_normal_weight * nl
        metrics["gt-surface-value"] = v
        metrics["gt-surface-normal"] = nl
    metrics["total"] = total
    return total, metrics
