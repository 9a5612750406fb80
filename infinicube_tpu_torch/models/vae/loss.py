"""VAE losses and metrics; counterpart of
``infinicube_tpu/models/vae/loss.py``: per-level structure cross-entropy with
adaptive positive weighting, struct accuracy and IoU, semantic
cross-entropy, and the normalized KL with linear annealing. Everything in
f32."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from infinicube_tpu_torch.grid.grid import Grid
from infinicube_tpu_torch.grid.ops import index_map


@dataclasses.dataclass(frozen=True)
class VAELossConfig:
    struct_weight: float = 10.0
    semantic_weight: float = 1.0
    normal_weight: float = 0.0
    kl_weight: float = 2e-3
    kl_anneal_steps: int = 0          # 0 = no anneal
    adaptive_pos_weight: bool = True


def _masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * m) / torch.sum(m).clamp_min(1.0)


def _ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    lp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(lp, -1, target.long()[..., None])[..., 0]


def struct_ce(logits: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
              adaptive_pos_weight: bool = True):
    """2-class CE over candidate voxels. logits [B, C, 2]; target bool
    [B, C]; mask bool [B, C]. Adaptive weighting balances the (sparse)
    positives. Returns (loss, {"acc", "iou"})."""
    ce = _ce(logits, target)
    m = mask.float()
    tgt = target.float()
    if adaptive_pos_weight:
        pos = torch.sum(tgt * m) + 1.0
        neg = torch.sum((1 - tgt) * m) + 1.0
        w_pos = (pos + neg) / (2.0 * pos)
        w_neg = (pos + neg) / (2.0 * neg)
        ce = ce * torch.where(target, w_pos, w_neg)
    loss = _masked_mean(ce, m)
    pred = logits.argmax(dim=-1) > 0
    acc = _masked_mean((pred == target).float(), m)
    inter = torch.sum((pred & target) * m)
    union = torch.sum((pred | target) * m)
    return loss, {"acc": acc, "iou": inter / union.clamp_min(1.0)}


def semantic_ce(logits: torch.Tensor, target: torch.Tensor,
                mask: torch.Tensor):
    m = mask.float()
    loss = _masked_mean(_ce(logits, target), m)
    acc = _masked_mean((logits.argmax(dim=-1) == target).float(), m)
    return loss, {"sem_acc": acc}


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Mean KL(q || N(0, 1)) per latent element."""
    return 0.5 * torch.mean(mu.square() + torch.exp(logvar) - 1.0 - logvar)


def vae_loss(cfg: VAELossConfig, outputs: dict, gt_grid_finest: Grid,
             gt_semantics: torch.Tensor, step: int = 0):
    """Total loss from ``SparseStructureVAE.forward``'s teacher-forced
    outputs.
    gt_semantics int [B, C0], aligned to gt_grid_finest's slots. Returns
    (total, metrics)."""
    metrics = {}
    total = 0.0
    for i, (logits, target, mask) in enumerate(outputs["struct"]):
        l, m = struct_ce(logits, target, mask.bool(),
                         cfg.adaptive_pos_weight)
        total = total + cfg.struct_weight * l
        metrics[f"struct{i}_ce"] = l
        metrics[f"struct{i}_iou"] = m["iou"]

    # semantics: the decoded finest grid is a subset of the ground truth
    # (teacher-forced); fetch the labels at the matching voxels
    dec_grid: Grid = outputs["grid"]
    gt_idx = index_map(dec_grid, gt_grid_finest).long()
    have = (gt_idx >= 0) & dec_grid.mask
    labels = torch.gather(gt_semantics.to(gt_idx.device).long(), 1,
                          gt_idx.clamp_min(0))
    sem_l, sem_m = semantic_ce(outputs["semantic_logits"], labels, have)
    total = total + cfg.semantic_weight * sem_l
    metrics["semantic_ce"] = sem_l
    metrics.update(sem_m)

    kl = kl_divergence(outputs["mu"], outputs["logvar"])
    w_kl = cfg.kl_weight
    if cfg.kl_anneal_steps > 0:
        w_kl = w_kl * min(1.0, float(step) / cfg.kl_anneal_steps)
    total = total + w_kl * kl
    metrics["kl"] = kl
    metrics["total"] = total
    return total, metrics
