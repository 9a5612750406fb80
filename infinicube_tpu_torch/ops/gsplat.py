"""Tile-based 3D Gaussian Splatting rasterizer; counterpart of
``infinicube_tpu/ops/gsplat.py`` (the reference is XLA there, so the port is
plain PyTorch on every device).

1. **project**: EWA splatting, component-wise on [N] tensors: camera
   transform (behind-camera z sanitized before 1/z), perspective Jacobian,
   2D covariance with a 0.3 px low-pass, a relative determinant floor, the
   3-sigma radius, near and image culling.
2. **bin**: each gaussian emits up to S x S tile instances (a radius beyond
   the span is clamped to ``S * tile / 2 - 1``); instances carry the packed
   int32 key ``tile_id << depth_bits | zq`` (log-quantized depth) and are
   sorted stably in the reference's span-major [S, S, N] order; each tile
   keeps its first ``tile_capacity`` instances, front to back.
3. **composite**: per tile, alpha of every kept gaussian at the 16 x 16
   pixels, the exclusive transmittance as a strictly-lower-triangular
   product in log space, tiles in chunks of ``chunk`` to bound memory.

Instances of culled gaussians carry the sentinel key in the reference and
sort behind every tile, so the port drops them before the sort: the kept
instances come out in the same order, and the sort holds only what
renders."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from infinicube_tpu_torch.utils.casts import saturating_int32

_ZNEAR, _ZFAR = 1e-2, 4e4     # the depth key's log range


def _unit_quats(quats: torch.Tensor) -> torch.Tensor:
    """quats / max(|quats|, 1e-8), the norm summed in a fixed order."""
    w, x, y, z = quats.unbind(-1)
    n = torch.sqrt(w * w + x * x + y * y + z * z).clamp_min(1e-8)
    return quats / n[..., None]


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """quats (..., 4) wxyz (need not be normalized) -> (..., 3, 3)."""
    w, x, y, z = _unit_quats(quats).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


class Projected(NamedTuple):
    mean2d: torch.Tensor   # f32 [N, 2] pixel coords
    conic: torch.Tensor    # f32 [N, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor    # f32 [N] camera z
    radius: torch.Tensor   # f32 [N] pixel radius (3 sigma)
    valid: torch.Tensor    # bool [N]


def project_gaussians(means: torch.Tensor, quats: torch.Tensor,
                      scales: torch.Tensor, viewmat: torch.Tensor,
                      K: torch.Tensor, image_hw: tuple[int, int],
                      near: float = 0.01, radius_clip: float = 0.0,
                      eps2d: float = 0.3) -> Projected:
    """viewmat f32 [4, 4] world-to-camera (OpenCV). EWA projection.

    Elementwise throughout, each sum in a fixed order: the card and the
    CPU round alike, so a gaussian's depth key and tiles come out the same
    on both (a matrix product's summation order is the library's)."""
    h, w = image_hw
    R = viewmat[:3, :3]
    mx, my, mz = means.unbind(-1)
    tcam = torch.stack([mx * R[i, 0] + my * R[i, 1] + mz * R[i, 2] +
                        viewmat[i, 3] for i in range(3)], -1)
    z = tcam[:, 2]
    # behind- and near-plane gaussians are culled below, but an unguarded
    # 1/z would send huge Jacobian terms into the backward (inf * 0 = NaN)
    front = z > near
    z_safe = torch.where(front, z.clamp_min(near), torch.ones_like(z))
    inv_z = 1.0 / z_safe
    fx, fy = K[0, 0], K[1, 1]
    u = tcam[:, 0] * inv_z * fx + K[0, 2]
    v = tcam[:, 1] * inv_z * fy + K[1, 2]

    qw, qx, qy, qz = _unit_quats(quats).unbind(-1)
    r = [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy),
         2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx),
         2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)]
    s0, s1, s2 = scales.unbind(-1)

    def c3(a, b):  # world-frame cov3d[a, b] = sum_j R[a,j] s_j^2 R[b,j]
        return (r[3 * a] * r[3 * b] * s0 * s0 +
                r[3 * a + 1] * r[3 * b + 1] * s1 * s1 +
                r[3 * a + 2] * r[3 * b + 2] * s2 * s2)

    cw = {(a, b): c3(a, b) for a in range(3) for b in range(a, 3)}

    def cwi(a, b):
        return cw[(a, b)] if b >= a else cw[(b, a)]

    def cc(a, b):  # camera-frame cov[a, b] = R_view cov3d R_view^T
        return sum(R[a, i] * cwi(i, j) * R[b, j]
                   for i in range(3) for j in range(3))

    cxx, cxy, cxz = cc(0, 0), cc(0, 1), cc(0, 2)
    cyy, cyz, czz = cc(1, 1), cc(1, 2), cc(2, 2)

    # perspective Jacobian rows J0 = (j00, 0, j02), J1 = (0, j11, j12)
    j00 = fx * inv_z
    j02 = -fx * tcam[:, 0] * inv_z ** 2
    j11 = fy * inv_z
    j12 = -fy * tcam[:, 1] * inv_z ** 2
    a2 = j00 * j00 * cxx + 2 * j00 * j02 * cxz + j02 * j02 * czz + eps2d
    b2 = j00 * j11 * cxy + j00 * j12 * cxz + j02 * j11 * cyz + \
        j02 * j12 * czz
    c2 = j11 * j11 * cyy + 2 * j11 * j12 * cyz + j12 * j12 * czz + eps2d

    # relative determinant floor: bounds |conic| <= 1e6 / min(a2, c2) and
    # every backward term for needle gaussians, and leaves well-conditioned
    # ones untouched
    det = torch.maximum(a2 * c2 - b2 ** 2, 1e-6 * a2 * c2)
    conic = torch.stack([c2 / det, -b2 / det, a2 / det], -1)
    mid = 0.5 * (a2 + c2)
    lam = mid + torch.sqrt((mid ** 2 - det).clamp_min(0.01))
    radius = 3.0 * torch.sqrt(lam)

    inside = (u + radius > 0) & (u - radius < w) & \
        (v + radius > 0) & (v - radius < h)
    valid = front & inside & (radius > radius_clip)
    return Projected(mean2d=torch.stack([u, v], -1), conic=conic, depth=z,
                     radius=radius, valid=valid)


def depth_bits_for(num_tiles: int) -> int:
    """Bits of the packed key's depth field, so that the key fits int32."""
    return max(8, min(20, 30 - int(math.ceil(math.log2(num_tiles + 2)))))


def tile_instances(proj: Projected, image_hw: tuple[int, int],
                   tile: int = 16, max_span: int = 4,
                   tile_capacity: int = 256):
    """The binning: (gaussian id int64 [T, K] of each tile's first K
    instances after the sort, valid bool [T, K]). Instances are ordered by
    the packed key, ties in the reference's span-major [S, S, N] order."""
    h, w = image_hw
    ty_n, tx_n = -(-h // tile), -(-w // tile)
    T = ty_n * tx_n
    S = max_span
    dev = proj.mean2d.device
    gid = torch.nonzero(proj.valid).flatten()                 # [Nv]
    mean2d, depth = proj.mean2d[gid], proj.depth[gid]
    radius = proj.radius[gid].clamp_max((S * tile) / 2.0 - 1.0)

    def tiles(x):
        return saturating_int32(torch.floor(x / tile)).long()

    t_min_x = tiles(mean2d[:, 0] - radius)
    t_min_y = tiles(mean2d[:, 1] - radius)
    t_max_x = tiles(mean2d[:, 0] + radius)
    t_max_y = tiles(mean2d[:, 1] + radius)
    offs = torch.arange(S, device=dev)[:, None]
    gx = t_min_x[None, :] + offs                              # [S, Nv]
    gy = t_min_y[None, :] + offs
    okx = (gx <= t_max_x[None, :]) & (gx >= 0) & (gx < tx_n)
    oky = (gy <= t_max_y[None, :]) & (gy >= 0) & (gy < ty_n)
    ok = (oky[:, None, :] & okx[None, :, :]).reshape(-1)      # [S*S*Nv]
    sel = torch.nonzero(ok).flatten()
    nv = gid.shape[0]
    g_of = sel % max(nv, 1)
    sy, sx = sel // max(nv * S, 1), (sel // max(nv, 1)) % S
    tile_id = gy[sy, g_of] * tx_n + gx[sx, g_of]

    db = depth_bits_for(T)
    top = (1 << db) - 1
    # the same key on every device: the log in f64 rounded to f32 (the
    # CPU's and the card's f32 logs differ in the last bit), and products
    # with constants (the card divides a tensor by a scalar as a product
    # with its rounded reciprocal, the CPU does not): a last bit moves a
    # depth across a quantum
    zq = (torch.log((depth.clamp_min(_ZNEAR) * (1.0 / _ZNEAR)).double())
          .float() * (top / math.log(_ZFAR / _ZNEAR))).clamp(0, top)
    key = (tile_id << db) + saturating_int32(zq).long()[g_of]
    order = torch.sort(key.to(torch.int32), stable=True).indices
    tile_sorted = (key[order] >> db).contiguous()
    gauss_sorted = torch.cat([gid[g_of[order]],
                              torch.full((1,), -1, dtype=torch.int64,
                                         device=dev)])
    t = torch.arange(T, device=dev)
    starts = torch.searchsorted(tile_sorted, t)
    ends = torch.searchsorted(tile_sorted, t + 1)
    idx = starts[:, None] + torch.arange(tile_capacity, device=dev)[None]
    k_ok = idx < ends[:, None]
    idx = idx.clamp(0, gauss_sorted.shape[0] - 1)
    return gauss_sorted[idx], k_ok


def _composite(params: torch.Tensor, kk: torch.Tensor, pix: torch.Tensor):
    """One chunk of tiles: params [c, K, 7 + C] (mean2d, conic, depth,
    opacity, color), kk bool [c, K], pix [c, P, 2] pixel centers ->
    (color [c, P, C], alpha [c, P], depth-weighted sum [c, P])."""
    mu, con = params[..., 0:2], params[..., 2:5]
    dep, op, col = params[..., 5], params[..., 6], params[..., 7:]
    d = pix[:, None, :, :] - mu[:, :, None, :]               # [c, K, P, 2]
    dx, dy = d[..., 0], d[..., 1]
    sigma = 0.5 * (con[..., 0, None] * dx ** 2 +
                   con[..., 2, None] * dy ** 2) + \
        con[..., 1, None] * dx * dy
    # clamp sigma before exp: masked negative-sigma rows would overflow to
    # inf and send 0 * inf = NaN through the masking's backward
    alpha = (op[..., None] * torch.exp(-sigma.clamp_min(-30.0))).clamp_max(
        0.999)
    alpha = torch.where((sigma > 0) & kk[..., None] & (alpha > 1.0 / 255.0),
                        alpha, torch.zeros_like(alpha))       # [c, K, P]
    Kn = alpha.shape[1]
    ltri = torch.tril(torch.ones((Kn, Kn), device=alpha.device), diagonal=-1)
    log_t_excl = torch.matmul(ltri, torch.log1p(-alpha))
    wgt = alpha * torch.exp(log_t_excl)
    out_c = torch.einsum("nkp,nkc->npc", wgt, col)
    out_a = wgt.sum(1)
    out_d = torch.einsum("nkp,nk->np", wgt, dep)
    return out_c, out_a, out_d


def rasterize(proj: Projected, opacities: torch.Tensor, colors: torch.Tensor,
              image_hw: tuple[int, int], tile: int = 16, max_span: int = 4,
              tile_capacity: int = 256, chunk: int = 130):
    """Composite projected gaussians. colors f32 [N, C]. Returns (color
    [H, W, C], alpha [H, W], expected depth [H, W], 0 where nothing
    renders)."""
    h, w = image_hw
    ty_n, tx_n = -(-h // tile), -(-w // tile)
    T = ty_n * tx_n
    dev = proj.mean2d.device
    C = colors.shape[-1]
    gidx, k_ok = tile_instances(proj, image_hw, tile, max_span,
                                tile_capacity)
    packed = torch.cat([proj.mean2d, proj.conic, proj.depth[:, None],
                        opacities[:, None], colors.float()], -1)
    packed = torch.cat([packed, packed.new_zeros((1, packed.shape[1]))])
    tile_params = packed[gidx]                                # [T, K, 7+C]

    ty, tx = torch.meshgrid(torch.arange(ty_n, device=dev),
                            torch.arange(tx_n, device=dev), indexing="ij")
    origin = torch.stack([tx.reshape(-1), ty.reshape(-1)], -1) * tile
    ly, lx = torch.meshgrid(torch.arange(tile, device=dev),
                            torch.arange(tile, device=dev), indexing="ij")
    local = torch.stack([lx.reshape(-1), ly.reshape(-1)], -1)  # [P, (x, y)]
    pix = (origin[:, None, :] + local[None]).float() + 0.5    # [T, P, 2]

    # with a gradient to record, each chunk is recomputed in the backward
    # (the reference's jax.checkpoint of its tile block): the chunks'
    # [c, K, P] intermediates are what would fill the memory
    recompute = torch.is_grad_enabled() and tile_params.requires_grad
    outs = [checkpoint(_composite, *a, use_reentrant=False) if recompute
            else _composite(*a)
            for a in ((tile_params[i:i + chunk], k_ok[i:i + chunk],
                       pix[i:i + chunk]) for i in range(0, T, chunk))]
    out_c, out_a, out_d = (torch.cat(o) for o in zip(*outs))

    def untile(x):
        x = x.reshape(ty_n, tx_n, tile, tile, -1).permute(0, 2, 1, 3, 4)
        return x.reshape(ty_n * tile, tx_n * tile, -1)[:h, :w]

    color = untile(out_c)
    alpha = untile(out_a)[..., 0]
    depth = untile(out_d)[..., 0]
    # exact math keeps alpha = 1 - prod(1 - a_i) <= 1; the rounded product
    # can overshoot by a few ulps, so clamp to a valid transmittance
    alpha = alpha.clamp(0.0, 1.0)
    depth = torch.where(alpha > 1e-6, depth / alpha.clamp_min(1e-6),
                        torch.zeros_like(depth))
    return color, alpha, depth


def render_gaussians(means, quats, scales, opacities, colors, viewmat, K,
                     image_hw, near: float = 0.01, radius_clip: float = 0.0,
                     tile: int = 16, max_span: int = 4,
                     tile_capacity: int = 256,
                     background: torch.Tensor | None = None):
    """gsplat ``rasterization`` for one camera, RGB+ED. Returns (color
    [H, W, C], alpha [H, W], depth [H, W])."""
    proj = project_gaussians(means, quats, scales, viewmat, K, image_hw,
                             near=near, radius_clip=radius_clip)
    color, alpha, depth = rasterize(proj, opacities, colors, image_hw,
                                    tile=tile, max_span=max_span,
                                    tile_capacity=tile_capacity)
    if background is not None:
        color = color + (1.0 - alpha)[..., None] * background
    return color, alpha, depth
