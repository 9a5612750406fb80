"""Guidance-buffer generation: semantic, depth, instance and coordinate
buffers rendered from the semantic voxel world (pipeline stage 2);
counterpart of ``infinicube_tpu/utils/buffers.py``.

Two routes share one scene preparation:

- **splat** (the default, the main path): voxel centers and each frame's
  posed canonical-car points render by z-buffered point splatting. One
  packed scatter-min per frame ((quantized depth << 32) | point slot)
  resolves the z-buffer and the winner together; a near-field footprint
  pass and an interior hole fill follow.
- **dda**: exact first-hit ray marching (``ops.raycast.dda_first_hit``)
  with Manhattan-distance empty-space skipping, the cars ray-traced in
  their canonical frames.

Everything runs in plain PyTorch on the tensors' device (the reference has
no Pallas here: its scatter-min, while loop and sort are XLA).

Known difference from the reference: it packs ``(zq << 20) | slot`` into
int32, so a slot of 2^20 or more spills into the depth bits and aliases
another point. The port packs into int64 (``zq << 32 | slot``) with the same
depth quantization, clip and tie rule (the lower slot wins), so it picks
the reference's winners wherever the points number at most 2^20 and the
right ones beyond.

Buffer encodings:
- depth: z-depth in meters, 0 = no hit (sky);
- semantic: Waymo class id at the first hit, 0 = background / sky;
- instance: instance id at the first hit, 0 = none (dynamic ids >= 10000);
- coordinate: frame-0-camera xyz normalized to [0, 1] by global
  percentiles, no-hit pixels 1.0 (white).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from infinicube_tpu_torch.camera import projection as proj
from infinicube_tpu_torch.camera.conventions import invert_pose
from infinicube_tpu_torch.camera.pinhole import PinholeCamera
from infinicube_tpu_torch.grid.grid import Grid
from infinicube_tpu_torch.grid.ops import to_dense
from infinicube_tpu_torch.ops.raycast import (dda_first_hit,
                                              manhattan_distance_transform)
from infinicube_tpu_torch.utils.cad_car import (canonical_car_occupancy,
                                                canonical_car_points)
from infinicube_tpu_torch.utils.casts import saturating_int32


@dataclasses.dataclass(frozen=True)
class StaticSceneBlocks:
    """Densified static world, built once per scene."""
    occ: torch.Tensor         # bool  [D, H, W]
    semantic: torch.Tensor    # int32 [D, H, W]
    instance: torch.Tensor    # int32 [D, H, W]
    skip: torch.Tensor        # uint8 [D, H, W] L1 distance field
    voxel_size: torch.Tensor  # f32 [3]
    origin: torch.Tensor      # f32 [3]
    ijk_min: torch.Tensor     # int32 [3]


def build_static_blocks(grid: Grid, semantics: torch.Tensor,
                        instance: torch.Tensor, ijk_min, dense_dims
                        ) -> StaticSceneBlocks:
    """grid: batch-1 Grid; semantics int32 [C]; instance int32 [C]."""
    occ = to_dense(grid, grid.mask[..., None].to(torch.int32), ijk_min,
                   dense_dims)[0, ..., 0] > 0
    sem = to_dense(grid, semantics[None, :, None].to(torch.int32), ijk_min,
                   dense_dims)[0, ..., 0]
    ins = to_dense(grid, instance[None, :, None].to(torch.int32), ijk_min,
                   dense_dims)[0, ..., 0]
    return StaticSceneBlocks(
        occ=occ, semantic=sem, instance=ins,
        skip=manhattan_distance_transform(occ),
        voxel_size=grid.voxel_size, origin=grid.origin,
        ijk_min=torch.as_tensor(ijk_min, dtype=torch.int32,
                                device=occ.device))


@dataclasses.dataclass(frozen=True)
class DynamicObjects:
    """Per-sequence dynamic (and optionally static CAD) car set.

    poses  f32 [T, M, 4, 4] object-to-world per frame
    lwh    f32 [M, 3]
    ids    int32 [M]  (>= 10000 for dynamic objects by convention)
    sem    int32 [M]  semantic class (CAR etc.)
    valid  bool [T, M]
    """
    poses: torch.Tensor
    lwh: torch.Tensor
    ids: torch.Tensor
    sem: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def empty(num_frames: int, device=None) -> "DynamicObjects":
        return DynamicObjects(
            poses=torch.eye(4, device=device).expand(num_frames, 1, 4, 4),
            lwh=torch.ones((1, 3), device=device),
            ids=torch.zeros((1,), dtype=torch.int32, device=device),
            sem=torch.zeros((1,), dtype=torch.int32, device=device),
            valid=torch.zeros((num_frames, 1), dtype=torch.bool,
                              device=device))

    def to(self, device) -> "DynamicObjects":
        return DynamicObjects(*(getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class FrameBuffers:
    depth: torch.Tensor      # f32 [..., H, W] z-depth, 0 = sky
    semantic: torch.Tensor   # int32 [..., H, W]
    instance: torch.Tensor   # int32 [..., H, W]


def _stack_frames(frames: list[FrameBuffers]) -> FrameBuffers:
    return FrameBuffers(*(torch.stack([getattr(f, n) for f in frames])
                          for n in ("depth", "semantic", "instance")))


# ---------------------------------------------------------------------------
# DDA route
# ---------------------------------------------------------------------------

def _static_hit(blocks: StaticSceneBlocks, ray_o, ray_d, max_steps):
    hit = dda_first_hit(blocks.occ, ray_o, ray_d, blocks.voxel_size,
                        blocks.origin, blocks.ijk_min, max_steps=max_steps,
                        skip_dist=blocks.skip)
    D, H, W = blocks.occ.shape
    rel = torch.minimum((hit.ijk - blocks.ijk_min).clamp_min(0),
                        torch.tensor([D - 1, H - 1, W - 1],
                                     device=ray_o.device)).long()
    sem = blocks.semantic[rel[:, 0], rel[:, 1], rel[:, 2]]
    ins = blocks.instance[rel[:, 0], rel[:, 1], rel[:, 2]]
    t = torch.where(hit.hit, hit.t_entry, float("inf"))
    zero = torch.zeros_like(sem)
    return t, torch.where(hit.hit, sem, zero), torch.where(hit.hit, ins, zero)


def _object_hits(car_occ, poses_t, lwh, ray_o, ray_d, valid_t, max_steps):
    """First-hit t of every object, f32 [M, N] (inf = miss): each object's
    rays in its canonical frame, all objects in one march (per-ray voxel
    sizes). Nothing is marched in a frame without a valid object."""
    M, N = poses_t.shape[0], ray_o.shape[0]
    if not bool(valid_t.any()):
        return torch.full((M, N), float("inf"), device=ray_o.device)
    dims = torch.tensor(car_occ.shape, dtype=torch.float32,
                        device=ray_o.device)
    ijk_min = tuple(-(d // 2) for d in car_occ.shape)
    R, t = poses_t[:, :3, :3], poses_t[:, :3, 3]
    o_loc = (ray_o[None] - t[:, None]) @ R                 # R^T from the right
    d_loc = ray_d[None].expand(M, -1, -1) @ R
    vs = (lwh / dims)[:, None].expand(M, N, 3).reshape(-1, 3)
    hit = dda_first_hit(car_occ, o_loc.reshape(-1, 3), d_loc.reshape(-1, 3),
                        vs, vs / 2.0, ijk_min, max_steps=max_steps)
    ok = hit.hit.reshape(M, N) & valid_t[:, None]
    return torch.where(ok, hit.t_entry.reshape(M, N), float("inf"))


def _compose(t_s, sem_s, ins_s, t_o, objects, ray_d, fwd, h, w):
    """The nearer of the static and the object hit per ray -> buffers."""
    t_best_obj, best_obj = t_o.min(dim=0)
    obj_wins = t_best_obj < t_s
    t = torch.where(obj_wins, t_best_obj, t_s)
    sem = torch.where(obj_wins, objects.sem[best_obj], sem_s)
    ins = torch.where(obj_wins, objects.ids[best_obj], ins_s)
    hit = torch.isfinite(t)
    # distance -> z-depth: rays are normalized; cos = d . optical_axis
    depth = torch.where(hit, t * (ray_d @ fwd), 0.0)
    zero = torch.zeros_like(sem)
    return FrameBuffers(
        depth=depth.reshape(h, w),
        semantic=torch.where(hit, sem, zero).reshape(h, w).to(torch.int32),
        instance=torch.where(hit, ins, zero).reshape(h, w).to(torch.int32))


def _car_occ(device) -> torch.Tensor:
    return torch.from_numpy(canonical_car_occupancy()).to(device)


def render_frame(blocks: StaticSceneBlocks, objects: DynamicObjects,
                 frame_idx: int, K: torch.Tensor, cam_to_world: torch.Tensor,
                 image_hw: tuple[int, int], max_steps_static: int = 768,
                 max_steps_obj: int = 64) -> FrameBuffers:
    """Render one frame's depth / semantic / instance buffers."""
    h, w = image_hw
    ray_o, ray_d = proj.posed_rays_from_intrinsics(K, cam_to_world, image_hw)
    ray_o, ray_d = ray_o.reshape(-1, 3), ray_d.reshape(-1, 3)
    t_s, sem_s, ins_s = _static_hit(blocks, ray_o, ray_d, max_steps_static)
    t_o = _object_hits(_car_occ(ray_o.device), objects.poses[frame_idx],
                       objects.lwh, ray_o, ray_d, objects.valid[frame_idx],
                       max_steps_obj)
    return _compose(t_s, sem_s, ins_s, t_o, objects, ray_d,
                    cam_to_world[:3, 2], h, w)


def render_sequence(blocks: StaticSceneBlocks, objects: DynamicObjects,
                    K: torch.Tensor, cam_to_worlds: torch.Tensor,
                    image_hw: tuple[int, int], max_steps_static: int = 768,
                    max_steps_obj: int = 64,
                    frame_chunk: int = 8) -> FrameBuffers:
    """Render all frames. cam_to_worlds f32 [T, 4, 4].

    The static world is marched ``frame_chunk`` frames of rays at a time
    (the chunk bounds the ray state: 3.2M rays at 480p), the cheap object
    passes (<= max_steps_obj steps) frame by frame."""
    T = cam_to_worlds.shape[0]
    h, w = image_hw
    rays = [proj.posed_rays_from_intrinsics(K, pose, image_hw)
            for pose in cam_to_worlds]
    car_occ = _car_occ(K.device)
    out = []
    for c0 in range(0, T, frame_chunk):
        c1 = min(c0 + frame_chunk, T)
        ro = torch.stack([rays[t][0] for t in range(c0, c1)]).reshape(-1, 3)
        rd = torch.stack([rays[t][1] for t in range(c0, c1)]).reshape(-1, 3)
        t_s, sem_s, ins_s = (x.reshape(c1 - c0, -1) for x in _static_hit(
            blocks, ro, rd, max_steps_static))
        for i, fi in enumerate(range(c0, c1)):
            ro_f, rd_f = rays[fi][0].reshape(-1, 3), rays[fi][1].reshape(-1, 3)
            t_o = _object_hits(car_occ, objects.poses[fi], objects.lwh,
                               ro_f, rd_f, objects.valid[fi], max_steps_obj)
            out.append(_compose(t_s[i], sem_s[i], ins_s[i], t_o, objects,
                                rd_f, cam_to_worlds[fi, :3, 2], h, w))
    return _stack_frames(out)


# ---------------------------------------------------------------------------
# splat route (the default): voxels as z-buffered point splats
# ---------------------------------------------------------------------------
#
# Every voxel projects once and scatter-mins its packed depth into the
# frame, the nearest voxels with a footprint scaled to their projected size;
# attributes are read at the winning slot, and small interior holes closed.

_STENCIL = 2          # (2R+1)^2 near-field footprint taps
_NEAR_CAP = 32768     # budget of near voxels that get the footprint
_DEPTH_QUANTA = 0.2   # packed-depth resolution (m); 2046 quanta -> 409 m
_ZQ_MAX = (1 << 11) - 2
_SLOT_BITS = 32
_SLOT_MASK = (1 << _SLOT_BITS) - 1
_MISS = torch.iinfo(torch.int64).max


def _packed_splat(flat_px: torch.Tensor, z: torch.Tensor, slot: torch.Tensor,
                  ok: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """One scatter-min of (quantized depth << 32 | slot) over h*w pixels:
    int64 [h*w], ``_MISS`` where nothing landed. The depth quantization and
    clip are the reference's (trunc(z / 0.2) clipped to [0, 2046], clamped
    in float first so that a far or NaN depth saturates as XLA's cast
    does); the slot no longer shares 32 bits with it."""
    zq = torch.nan_to_num(z / _DEPTH_QUANTA, nan=0.0).clamp(
        0, _ZQ_MAX).to(torch.int64)
    packed = (zq << _SLOT_BITS) | slot.to(torch.int64)
    flat_safe = torch.where(ok, flat_px.to(torch.int64), h * w)
    buf = torch.full((h * w + 1,), _MISS, dtype=torch.int64,
                     device=z.device)
    buf.scatter_reduce_(0, flat_safe, torch.where(ok, packed, _MISS), "amin")
    return buf[:-1]


def _splat_zbuffer(points, valid, radius_world, K, cam_to_world, image_hw):
    """The z-buffer core of the splat route: (packed buffer int64 [h*w],
    z f32 [C]). Points project to their rounded pixel; the ``_NEAR_CAP``
    points of largest projected radius (a stable sort, as the reference's
    ``argsort``) with a radius above 0.75 px also splat a square footprint
    of up to (2R+1)^2 taps."""
    h, w = image_hw
    C = points.shape[0]
    dev = points.device
    uv, z, vis = proj.project_points(points, cam_to_world, K, image_hw)
    vis = vis & valid & (z > 0.05)
    px = saturating_int32(torch.round(uv[:, 0]))
    py = saturating_int32(torch.round(uv[:, 1]))
    inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    ok = vis & inside
    slot = torch.arange(C, dtype=torch.int64, device=dev)
    buf = _packed_splat(py.long() * w + px.long(), z, slot, ok, h, w)

    # near pass: points whose footprint exceeds one pixel
    r_px = torch.where(ok, K[0, 0] * radius_world / z.clamp_min(1e-3), 0.0)
    near = torch.argsort(-r_px, stable=True)[:_NEAR_CAP]
    r_near = r_px[near]
    n_ok = ok[near] & (r_near > 0.75)
    taps = torch.arange(-_STENCIL, _STENCIL + 1, device=dev)
    du, dv = torch.meshgrid(taps, taps, indexing="ij")
    du, dv = du.reshape(-1), dv.reshape(-1)
    S = du.shape[0]
    ix = px[near].long()[:, None] + du[None]
    iy = py[near].long()[:, None] + dv[None]
    infoot = (du[None].abs() <= r_near[:, None] + 0.5) & \
        (dv[None].abs() <= r_near[:, None] + 0.5)
    n_ok2 = n_ok[:, None] & infoot & (ix >= 0) & (ix < w) & (iy >= 0) & \
        (iy < h)
    buf_near = _packed_splat(
        (iy * w + ix).reshape(-1), z[near][:, None].expand(-1, S).reshape(-1),
        near[:, None].expand(-1, S).reshape(-1), n_ok2.reshape(-1), h, w)
    return torch.minimum(buf, buf_near), z


def _winners(buf: torch.Tensor, C: int):
    """(hit bool, winning slot int64 clipped to [0, C-1]) of a buffer."""
    hit = buf != _MISS
    return hit, (buf & _SLOT_MASK).clamp(0, C - 1)


def splat_winner_slots(points: torch.Tensor, valid: torch.Tensor,
                       radius_world: torch.Tensor, K: torch.Tensor,
                       cam_to_world: torch.Tensor,
                       image_hw: tuple[int, int]):
    """Project points and resolve the front-most point per pixel by the
    packed scatter-min (the z-buffer of ``splat_frame``). Returns (win_slot
    int64 [h, w] with -1 at misses, zdepth f32 [h, w])."""
    h, w = image_hw
    buf, z = _splat_zbuffer(points, valid, radius_world, K, cam_to_world,
                            image_hw)
    hit, slot = _winners(buf, points.shape[0])
    win = torch.where(hit, slot, -1)
    zd = torch.where(hit, z[slot], 0.0)
    return win.reshape(h, w), zd.reshape(h, w)


def _fill_holes(depth, sem, ins, iters: int):
    """Interior pinholes (empty pixels with >= 6 of 8 neighbours hit) adopt
    the nearest-depth neighbour; open sky stays 0."""
    for _ in range(iters):
        best = torch.full_like(depth, float("inf"))
        bs, bi = sem, ins
        n_hit = torch.zeros_like(depth)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                dn = torch.roll(depth, (dy, dx), (0, 1))
                sn = torch.roll(sem, (dy, dx), (0, 1))
                inn = torch.roll(ins, (dy, dx), (0, 1))
                n_hit = n_hit + (dn > 0)
                better = (dn > 0) & ((dn < best) | (best == float("inf")))
                best = torch.where(better, dn, best)
                bs = torch.where(better, sn, bs)
                bi = torch.where(better, inn, bi)
        empty = (depth == 0) & (n_hit >= 6) & torch.isfinite(best)
        depth = torch.where(empty, best, depth)
        sem = torch.where(empty, bs, sem)
        ins = torch.where(empty, bi, ins)
    return depth, sem, ins


def splat_frame(points: torch.Tensor, attrs: torch.Tensor,
                valid: torch.Tensor, radius_world: torch.Tensor,
                K: torch.Tensor, cam_to_world: torch.Tensor,
                image_hw: tuple[int, int], fill_iters: int = 2
                ) -> FrameBuffers:
    """points f32 [C, 3] world; attrs int32 [C, 2] (semantic, instance);
    radius_world f32 [C] splat half-extent in meters.

    Far points (sub-pixel footprint) splat one tap; the nearest
    ``_NEAR_CAP`` also splat a (2R+1)^2 footprint."""
    h, w = image_hw
    buf, z = _splat_zbuffer(points, valid, radius_world, K, cam_to_world,
                            image_hw)
    hit, slot = _winners(buf, points.shape[0])
    zero = torch.zeros((), dtype=attrs.dtype, device=attrs.device)
    depth = torch.where(hit, z[slot], 0.0).reshape(h, w)
    sem = torch.where(hit, attrs[slot, 0], zero).reshape(h, w)
    ins = torch.where(hit, attrs[slot, 1], zero).reshape(h, w)
    depth, sem, ins = _fill_holes(depth, sem, ins, fill_iters)
    return FrameBuffers(depth=depth, semantic=sem.to(torch.int32),
                        instance=ins.to(torch.int32))


def splat_points(grid: Grid, semantics: torch.Tensor, instance: torch.Tensor,
                 objects: DynamicObjects):
    """The splat route's point sets: a function of the frame index ->
    (points f32 [C + M*P, 3], attrs int32 [C + M*P, 2], valid bool,
    radius f32): the static voxel centers (radius half the largest voxel
    edge) followed by the M objects' posed canonical-car points (radius a
    twelfth of the object's smallest extent), as ``splat_frame`` takes
    them."""
    dev = grid.ijk.device
    centers = grid.voxel_centers()[0]
    svalid = grid.mask[0]
    sattr = torch.stack([semantics, instance], dim=-1).to(torch.int32)
    srad = torch.full((centers.shape[0],), 0.5, device=dev) * \
        grid.voxel_size.amax()
    car_pts = torch.from_numpy(canonical_car_points()).to(dev)   # [P, 3]
    P = car_pts.shape[0]
    M = objects.lwh.shape[0]
    cattr = torch.stack([objects.sem[:, None].expand(M, P),
                         objects.ids[:, None].expand(M, P)], -1).reshape(
                             -1, 2).to(torch.int32)
    crad = (objects.lwh.amin(dim=-1) / 12.0)[:, None].expand(
        M, P).reshape(-1)
    att = torch.cat([sattr, cattr])
    rad = torch.cat([srad, crad])

    def frame(t: int):
        obj_poses = objects.poses[t]
        cpts = (car_pts[None] * objects.lwh[:, None]) @ \
            obj_poses[:, :3, :3].transpose(1, 2) + obj_poses[:, None, :3, 3]
        cvalid = objects.valid[t][:, None].expand(M, P).reshape(-1)
        return (torch.cat([centers, cpts.reshape(-1, 3)]), att,
                torch.cat([svalid, cvalid]), rad)
    return frame


def render_sequence_splat(grid: Grid, semantics: torch.Tensor,
                          instance: torch.Tensor, objects: DynamicObjects,
                          K: torch.Tensor, cam_to_worlds: torch.Tensor,
                          image_hw: tuple[int, int],
                          fill_iters: int = 2) -> FrameBuffers:
    """Splat-rasterized buffer sequence: the static voxel centers and each
    frame's posed canonical-car points (``splat_points``), z-buffered frame
    by frame."""
    frame_points = splat_points(grid, semantics, instance, objects)
    frames = []
    for t, pose in enumerate(cam_to_worlds):
        pts, att, val, rad = frame_points(t)
        frames.append(splat_frame(pts, att, val, rad, K, pose, image_hw,
                                  fill_iters))
    return _stack_frames(frames)


def generate_coordinate_buffer(depth: torch.Tensor, K: torch.Tensor,
                               cam_to_worlds: torch.Tensor,
                               percentile: float = 0.05) -> torch.Tensor:
    """Point-map buffer: z-depths unprojected into frame-0 camera
    coordinates and normalized to [0, 1] by global per-axis percentiles;
    no-hit pixels 1.0.

    depth f32 [T, H, W]; cam_to_worlds f32 [T, 4, 4]. Returns f32
    [T, H, W, 3]. The percentile ranks are f32 products, as the
    reference's (``percentile * n`` with n an int32 count)."""
    to_cam0 = torch.einsum("ij,tjk->tik", invert_pose(cam_to_worlds[0]),
                           cam_to_worlds)
    pts = proj.unproject_depth(depth, K, to_cam0)          # [T, H, W, 3]
    invalid = depth == 0.0
    flat = pts.reshape(-1, 3)
    vmask = ~invalid.reshape(-1)
    n = vmask.sum().clamp_min(1).to(torch.int32).float()
    last = flat.shape[0] - 1

    def rank(p):
        r = torch.tensor(p, dtype=torch.float32, device=depth.device) * n
        return saturating_int32(r).clamp(0, last).long()

    i_lo, i_hi = rank(percentile), rank(1 - percentile)
    lo, hi = [], []
    for axis in range(3):
        xs = torch.sort(torch.where(vmask, flat[:, axis],
                                    float("inf"))).values
        lo.append(xs[i_lo])
        hi.append(xs[i_hi])
        del xs
    lo, hi = torch.stack(lo), torch.stack(hi)
    rng = (hi - lo).clamp_min(1e-7)
    norm = ((pts - lo) / rng).clamp(0.0, 1.0)
    return torch.where(invalid[..., None], 1.0, norm)


def generate_guidance_buffers(grid: Grid, semantics: torch.Tensor,
                              instance: torch.Tensor, camera: PinholeCamera,
                              cam_to_worlds: torch.Tensor,
                              objects: DynamicObjects | None = None,
                              ijk_min=None, dense_dims=None,
                              method: str = "splat") -> dict:
    """The stage-2 pipeline in one call. Returns a dict of tensors on the
    grid's device: depth / semantic / instance [T, H, W] and coordinate
    [T, H, W, 3].

    method "splat" (default): z-buffered voxel splatting; "dda": exact
    first-hit ray marching."""
    T = cam_to_worlds.shape[0]
    dev = cam_to_worlds.device
    if objects is None:
        objects = DynamicObjects.empty(T, dev)
    K = camera.intrinsics_matrix(dev)
    if method == "splat":
        fb = render_sequence_splat(grid, semantics, instance, objects, K,
                                   cam_to_worlds, (camera.h, camera.w))
    elif method == "dda":
        if ijk_min is None or dense_dims is None:
            mn, mx = (np.asarray(b[0].cpu()) for b in grid.bbox_ijk())
            ijk_min = tuple(int(v) for v in mn)
            dense_dims = tuple(int(v) for v in (mx - mn + 1))
        blocks = build_static_blocks(grid, semantics, instance, ijk_min,
                                     dense_dims)
        fb = render_sequence(blocks, objects, K, cam_to_worlds,
                             (camera.h, camera.w))
    else:
        raise ValueError(f"unknown method {method!r}")
    coord = generate_coordinate_buffer(fb.depth, K, cam_to_worlds)
    return {"depth": fb.depth, "semantic": fb.semantic,
            "instance": fb.instance, "coordinate": coord}
