"""K-nearest-neighbour queries on tensors; counterpart of
``infinicube_tpu/ops/knn.py``, on the caller's device.

- ``knn_bruteforce``: the distance block as one rank-3 product,
  ``|q|^2 - 2 q.r + |r|^2``, and ``torch.topk`` over it, ``chunk`` queries
  at a time to bound memory (4,096 queries against 200,000 references are a
  3.3 GB block). The product cancels in f32, so TF32 must stay off
  (``utils/precision.py``), or distances at 0.2 m voxels lose their last
  bits.
- ``knn_grid_hash``: references binned into cells of ``cell_size`` (the
  packed-key core), each query scanning the 27 cells around its own.

Both return squared distances and indices, nearest first. ``torch.topk``
and ``lax.top_k`` order ties differently, so two references at one
distance may come in the other order."""

from __future__ import annotations

import torch

from infinicube_tpu_torch.grid import keys as GK

_FAR = 1e30


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """f32 [..., 3] -> |x|^2 f32 [...], summed as the reference's compiled
    reduction sums it: fma(x2, x2, fma(x1, x1, x0 * x0)), each step rounded
    once to f32 (the f32 products are exact in f64), so every device gives
    the same bits."""
    x = x.double()
    acc = (x[..., 0] * x[..., 0]).float()
    for i in (1, 2):
        acc = (acc.double() + x[..., i] * x[..., i]).float()
    return acc


def knn_bruteforce(query: torch.Tensor, ref: torch.Tensor,
                   ref_mask: torch.Tensor | None = None, k: int = 1,
                   chunk: int = 4096):
    """query f32 [N, 3], ref f32 [M, 3] -> (sq_dist f32 [N, k], idx int32
    [N, k]); masked references are at distance 1e30."""
    ref_sq = _sq_norm(ref)
    dists, idxs = [], []
    for q in torch.split(query, chunk):
        d = _sq_norm(q)[:, None] - 2.0 * (q @ ref.T) + ref_sq[None]
        if ref_mask is not None:
            d.masked_fill_(~ref_mask[None], _FAR)
        neg_d, idx = torch.topk(-d, k, dim=-1)
        dists.append(-neg_d)
        idxs.append(idx.to(torch.int32))
    if not dists:
        return (torch.zeros((0, k), dtype=query.dtype, device=query.device),
                torch.zeros((0, k), dtype=torch.int32, device=query.device))
    return torch.cat(dists), torch.cat(idxs)


def knn_grid_hash(query: torch.Tensor, ref: torch.Tensor, cell_size: float,
                  ref_mask: torch.Tensor | None = None, k: int = 1,
                  cell_capacity: int = 32):
    """Exact within the 3x3x3 cells of ``cell_size`` around each query (a
    reference farther than one cell may be missed: pick cell_size >= the
    expected nearest distance). Returns (sq_dist [N, k], idx [N, k]); a
    missing neighbour gets 1e30 and -1."""
    M, N = ref.shape[0], query.shape[0]
    dev = ref.device
    if ref_mask is None:
        ref_mask = torch.ones((M,), dtype=torch.bool, device=dev)
    cell = torch.floor(ref / cell_size).to(torch.int32)
    keys = GK.pack(cell, ref_mask)
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]

    qcell = torch.floor(query / cell_size).to(torch.int32)
    r = torch.arange(-1, 2, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       -1).reshape(27, 3).to(torch.int32)
    nkeys = GK.pack(qcell[:, None, :] + offs[None])             # [N, 27]
    starts = torch.searchsorted(skeys, nkeys.contiguous())
    slot = torch.arange(cell_capacity, device=dev)
    cand_pos = (starts[:, :, None] + slot[None, None]).clamp(0, M - 1)
    cand_key = skeys[cand_pos]
    cand_ok = (cand_key == nkeys[:, :, None]) & (cand_key != GK.INVALID_KEY)
    cand_idx = order[cand_pos].reshape(N, -1)                   # [N, 27 C]
    d = torch.sum((ref[cand_idx] - query[:, None, :]) ** 2, -1)
    d = torch.where(cand_ok.reshape(N, -1), d, torch.full_like(d, _FAR))
    neg_d, pos = torch.topk(-d, k, dim=-1)
    idx = torch.take_along_dim(cand_idx, pos, 1)
    idx = torch.where(-neg_d < 1e29, idx, torch.full_like(idx, -1))
    return -neg_d, idx.to(torch.int32)


def semantic_from_points(query: torch.Tensor, ref: torch.Tensor,
                         ref_semantics: torch.Tensor,
                         ref_mask: torch.Tensor | None = None,
                         k: int = 1) -> torch.Tensor:
    """Nearest-neighbour label transfer: k = 1 copies the nearest label, k >
    1 takes the majority of the k (the lowest label on a tie)."""
    _, idx = knn_bruteforce(query, ref, ref_mask, k=k)
    labels = ref_semantics[idx.clamp_min(0).long()]
    if k == 1:
        return labels[:, 0]
    votes = torch.nn.functional.one_hot(labels.long(), 32).sum(dim=1)
    return torch.argmax(votes, -1).to(ref_semantics.dtype)


def latent_semantic_from_grid(fine_grid, fine_semantics: torch.Tensor,
                              coarse_grid, k: int = 1) -> torch.Tensor:
    """Per-voxel labels of a coarse (latent) grid by transfer from the
    finest grid's labelled voxel centers. Batch-1 grids; fine_semantics
    int [C_fine] -> [C_coarse]."""
    q = coarse_grid.voxel_centers()[0]
    r = fine_grid.voxel_centers()[0]
    return semantic_from_points(q, r, fine_semantics,
                                ref_mask=fine_grid.mask[0], k=k)


def color_from_points(query: torch.Tensor, ref: torch.Tensor,
                      ref_colors: torch.Tensor,
                      ref_mask: torch.Tensor | None = None,
                      k: int = 3) -> torch.Tensor:
    """Inverse-distance-weighted color transfer from the k nearest."""
    d, idx = knn_bruteforce(query, ref, ref_mask, k=k)
    w = 1.0 / d.clamp_min(1e-8)
    w = w / torch.sum(w, -1, keepdim=True)
    cols = ref_colors[idx.clamp_min(0).long()]
    return torch.sum(w[..., None] * cols, dim=1)
