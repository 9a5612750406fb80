"""VAE reconstruction eval; counterpart of
``infinicube_tpu/inference/voxel_vae.py``: encode a point cloud's hash tree,
decode the latent mean without guidance, and compare the reconstructed grid
with the input's (voxel-set IoU, semantic accuracy on the shared voxels).
Checkpoints are the port's own (``training/checkpoint.py``). Runs on the
card unless ``main(argv, device="cpu")``.

Usage:
  python -m infinicube_tpu_torch.inference.voxel_vae --points scene.npz \\
      --checkpoint checkpoints/myvae --output out/
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from infinicube_tpu_torch.grid.ops import index_map, majority_label
from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                   SparseVAEConfig,
                                                   build_hash_tree)
from infinicube_tpu_torch.utils.fileio import save_grid_semantic
from infinicube_tpu_torch.utils.precision import set_float32_precision


@torch.no_grad()
def evaluate_reconstruction(model: SparseStructureVAE, points: torch.Tensor,
                            semantics_pts: torch.Tensor) -> dict:
    """One VAE roundtrip: points f32 [B, N, 3] with labels int [B, N] ->
    ``grid_iou``, ``semantic_acc`` and the predicted and input grids with
    their per-voxel labels."""
    cfg = model.cfg
    points = points.to(model.device)
    semantics_pts = semantics_pts.to(model.device)
    mask = torch.ones(points.shape[:2], dtype=torch.bool, device=model.device)
    grids = build_hash_tree(cfg, points, mask)
    sem = majority_label(grids[0], points, semantics_pts, mask,
                         cfg.num_semantic)
    mu, _ = model.encode(grids, sem)
    dec = model.decode(mu)
    pred, gt = dec["grid"], grids[0]
    gi = index_map(pred, gt).long()
    have = (gi >= 0) & pred.mask
    inter = int(have.sum())
    union = int(pred.mask.sum()) + int(gt.mask.sum()) - inter
    labels = torch.gather(sem.long(), 1, gi.clamp_min(0))
    pred_sem = dec["semantic_logits"].argmax(-1)
    acc = float(((pred_sem == labels) & have).sum() /
                have.sum().clamp_min(1))
    return {"grid_iou": inter / max(union, 1), "semantic_acc": acc,
            "pred_grid": pred, "gt_grid": gt, "pred_sem": pred_sem,
            "gt_sem": sem}


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", required=True, help="npz with xyz/semantic")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint directory of the VAE trainer")
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)
    set_float32_precision()
    model = SparseStructureVAE(SparseVAEConfig(), device=device)
    d = np.load(args.points)
    if args.checkpoint:
        from infinicube_tpu_torch.training.checkpoint import CheckpointManager
        model.load_state_dict(CheckpointManager(args.checkpoint).restore()[
            "params"])
    else:
        model.init_params(torch.Generator(device=model.device).manual_seed(0))
    model.eval().requires_grad_(False)
    pts = torch.from_numpy(d["xyz"].astype(np.float32))[None]
    sem = torch.from_numpy(d["semantic"].astype(np.int32))[None]
    res = evaluate_reconstruction(model, pts, sem)
    g = res["pred_grid"]
    m = g.mask[0].cpu().numpy()
    save_grid_semantic(Path(args.output) / "pred.npz",
                       g.ijk[0].cpu().numpy()[m],
                       res["pred_sem"][0].cpu().numpy()[m],
                       g.voxel_size.cpu().numpy(), g.origin.cpu().numpy())
    scores = {k: v for k, v in res.items() if isinstance(v, float)}
    print(scores)
    return scores


if __name__ == "__main__":
    main()
