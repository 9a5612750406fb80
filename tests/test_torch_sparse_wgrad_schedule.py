"""The walk of ``sparse_conv_bf16_wgrad`` (csrc/sparse_conv_bwd.cu) on the CPU.

Each tap's present (row, tap) pairs, in row order, are cut into stages of
128; a unit is (F tile, N tile, tap) and holds
its tap's stages; the stages of all units are cut into at most 132 ranges of
equal length, which the persistent blocks walk; a piece (the stages of one
unit within one range) sums into partial slots of its own (one a consumer
warpgroup where they split the k16 steps), and a last pass adds a unit's
slots in range order. ``kernels.sparse_wgrad_plan`` is that plan in
PyTorch. Here it is held against a numpy reference written from the same
rules (a level of padding slots only, active rows at the front at the bench
levels' fill, scattered rows, two batch elements of unequal fills, taps no
row has); its ranges are held equal in stages and their present pairs
within a stated bound, and its cuts a function of nbr and the shape alone;
and a model of the kernel's summation order (k16 steps of 16 pairs whose
tensor-core sums truncate, flushed into f32 sums every 32 k16 steps and at
each piece's end, the slots added in range order) is held within one bf16
ulp of the f64 sum. Nothing here imports JAX or needs a card; a few
seconds."""

import numpy as np
import pytest
import torch

from infinicube_tpu_torch import kernels
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

from test_torch_tf32x3_f32_kernels import rz

SHAPES = [(64, 64), (64, 128), (128, 256), (384, 128), (192, 64), (32, 24)]


def plan_numpy(nbr, F, Fo, ranges=132):
    """The plan from the kernel's rules, unit by unit and range by range."""
    tiles = [(F * -(-Fo // bn) + Fo * -(-F // (64 * mt)), mt * bn, mt, bn)
             for mt in (1, 2) for bn in (64, 128)]
    _, _, mt, bn = sorted(tiles)[0]
    P = 128
    combos = -(-F // (64 * mt)) * -(-Fo // bn)
    counts = [int((nbr[..., t] >= 0).sum()) for t in range(27)]
    stg = [-(-n // P) for n in counts]
    S = sum(stg) * combos
    if S == 0:
        return mt, bn, P, counts, 0, 1, 0, []
    R = min(ranges, S)
    L = -(-S // R)
    R = -(-S // L)
    units, s = [], 0
    for c in range(combos):
        for t in range(27):
            units.append((c, t, s, s + stg[t]))
            s += stg[t]
    pieces = []
    for r in range(R):
        lo, hi = r * L, min(S, r * L + L)
        for c, t, a, b in units:
            s0, s1 = max(a, lo), min(b, hi)
            if s0 < s1:
                pieces.append((r, c, t, s0, s1, (s0 - a) * P,
                               min((s1 - a) * P, counts[t]), c * 27 + t + r))
    return mt, bn, P, counts, S, L, R, pieces


def _front(rng, C, active, keep=0.7):
    nbr = np.full((1, C, 27), -1, np.int32)
    pick = rng.integers(0, active, (active, 27))
    nbr[0, :active] = np.where(rng.random((active, 27)) < keep, pick, -1)
    return nbr


def _table(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "padding":
        return np.full((1, 1 << 16, 27), -1, np.int32)
    if kind == "front":          # the bench grid's level 2: 3,712 voxels
        return _front(rng, 1 << 16, 3712)
    if kind == "scattered":      # 4 active 128-row tiles among 512
        nbr = np.full((1, 1 << 16, 27), -1, np.int32)
        rows = np.concatenate([np.arange(t * 128, t * 128 + 128)
                               for t in (3, 200, 201, 511)])
        pick = rows[rng.integers(0, rows.size, (rows.size, 27))]
        nbr[0, rows] = np.where(rng.random((rows.size, 27)) < 0.4, pick, -1)
        return nbr
    if kind == "two elements":   # B = 2, unequal fills
        return np.concatenate([_front(rng, 20_000, 15_000),
                               _front(rng, 20_000, 2_000)])
    nbr = _front(rng, 1 << 16, 3712)   # "taps absent"
    nbr[..., [5, 12, 13, 14, 26]] = -1
    return nbr


@pytest.mark.parametrize("F,Fo", SHAPES)
@pytest.mark.parametrize("kind", ["padding", "front", "scattered",
                                  "two elements", "taps absent"])
def test_plan_matches_numpy(kind, F, Fo):
    nbr = _table(kind)
    plan = kernels.sparse_wgrad_plan(torch.from_numpy(nbr), F, Fo)
    mt, bn, P, counts, S, L, R, pieces = plan_numpy(nbr, F, Fo)
    assert (plan.mt, plan.bn) == (mt, bn) == kernels.wgrad_bf16_tile(F, Fo)
    assert P == kernels.WGRAD_PAIRS
    assert plan.counts.tolist() == counts
    assert (plan.stages, plan.length, plan.ranges) == (S, L, R)
    assert plan.pieces.tolist() == [list(p) for p in pieces]
    if kind == "padding":
        assert R == 0 and not pieces
    if kind == "taps absent":
        assert not {5, 12, 13, 14, 26} & {p[2] for p in pieces}


@pytest.mark.parametrize("F,Fo", SHAPES)
def test_ranges_are_equal_and_balanced(F, Fo):
    """Every range but the last holds exactly L stages and its pieces tile
    it; a full range's present pairs lie between L * P - (P - 1) * k and
    L * P (k its pieces: only a unit's last stage is part full), and at the
    bench levels' fill their mean is within 10 % of L * P."""
    plan = kernels.sparse_wgrad_plan(torch.from_numpy(_table("front")), F, Fo)
    P, L = kernels.WGRAD_PAIRS, plan.length
    assert 0 < plan.ranges <= kernels.WGRAD_RANGES
    stages = torch.zeros(plan.ranges, dtype=torch.int64)
    pairs = torch.zeros(plan.ranges, dtype=torch.int64)
    pieces = torch.zeros(plan.ranges, dtype=torch.int64)
    for r, c, t, s0, s1, p0, p1, slot in plan.pieces.tolist():
        assert (s1 - s0 - 1) * P < p1 - p0 <= (s1 - s0) * P
        stages[r] += s1 - s0
        pairs[r] += p1 - p0
        pieces[r] += 1
    assert (stages[:-1] == L).all()
    assert 0 < stages[-1] <= L
    assert stages.sum() == plan.stages
    full, k = pairs[:-1], pieces[:-1]
    assert ((full <= L * P) & (full >= L * P - (P - 1) * k)).all()
    assert full.double().mean() >= 0.9 * L * P


def test_cuts_depend_on_nbr_and_the_shape_alone():
    """The same table gives the same plan; pointing present taps at other
    rows moves no cut (only how many pairs each tap has counts); another
    shape cuts anew."""
    nbr = _table("front")
    plan = kernels.sparse_wgrad_plan(torch.from_numpy(nbr), 128, 256)
    again = kernels.sparse_wgrad_plan(torch.from_numpy(nbr.copy()), 128, 256)
    assert torch.equal(plan.pieces, again.pieces)
    moved = np.where(nbr >= 0, (nbr + 17) % 3712, -1).astype(np.int32)
    assert torch.equal(plan.pieces, kernels.sparse_wgrad_plan(
        torch.from_numpy(moved), 128, 256).pieces)
    other = kernels.sparse_wgrad_plan(torch.from_numpy(nbr), 256, 256)
    assert other.stages == 2 * plan.stages


def _model(nbr, feats, g, taps, ranges, flush=32):
    """What the kernel computes for ``taps``: per piece, its pairs in stages
    of P, each stage k16 steps of 16 pairs (feats of the neighbour by g,
    zero past the pairs) whose sums truncate on the tensor cores; one chain
    of sums where a warpgroup takes every step of its outputs, two (the
    first and the second half of each stage's steps) where the warpgroups
    split the steps; each flushed into an f32 sum every ``flush`` of its
    steps and at the piece's end; the slots added in range order."""
    B, C, F = feats.shape
    Fo = g.shape[-1]
    plan = kernels.sparse_wgrad_plan(nbr, F, Fo, ranges)
    P = kernels.WGRAD_PAIRS
    steps = P // 16
    halves = [range(0, steps // 2), range(steps // 2, steps)] \
        if (plan.mt, plan.bn) == (1, 64) else [range(steps)]
    n_tiles = -(-Fo // plan.bn)
    fz = torch.cat([feats.reshape(-1, F).double(), torch.zeros((1, F))])
    gz = torch.cat([g.reshape(-1, Fo).double(), torch.zeros((1, Fo))])
    flat = nbr.reshape(-1, 27).long()
    base = (torch.arange(B * C) // C * C)[:, None]
    out = {t: torch.zeros((F, Fo), dtype=torch.float32) for t in taps}
    for r, c, t, s0, s1, p0, p1, slot in plan.pieces.tolist():
        if t not in taps:
            continue
        rows = torch.nonzero(flat[:, t] >= 0)[:, 0][p0:p1]
        src = (flat[rows, t] + base[rows, 0])
        pad = (s1 - s0) * P - rows.numel()
        rows = torch.cat([rows, torch.full((pad,), -1)])
        src = torch.cat([src, torch.full((pad,), -1)])
        f0, n0 = c // n_tiles * 64 * plan.mt, c % n_tiles * plan.bn
        a = fz[src][:, f0:f0 + 64 * plan.mt]
        b = gz[rows][:, n0:n0 + plan.bn]
        for half in halves:
            part = torch.zeros((a.shape[1], b.shape[1]), dtype=torch.float32)
            acc, n = None, 0
            for st in range(s1 - s0):
                for k in half:
                    ks = slice(st * P + 16 * k, st * P + 16 * k + 16)
                    prod = a[ks].t() @ b[ks]
                    acc = rz(prod if acc is None else acc.double() + prod)
                    n += 1
                    if n == flush:
                        part, acc, n = part + acc, None, 0
            if acc is not None:
                part = part + acc
            # the unit's slots in range order (the pieces come so), each a
            # rounded f32 add; the first onto +0.0 is the slot itself
            out[t][f0:f0 + a.shape[1], n0:n0 + b.shape[1]] += part
    return out


@pytest.mark.parametrize("F,Fo", [(16, 24), (64, 128), (136, 136)])
def test_summation_order_within_one_bf16_ulp(F, Fo):
    """On about 3,700 voxels (five ranges, so that pieces span several
    flushes), at a tile whose warpgroups split the k16 steps and at two
    whose warpgroups split the outputs (by panel and by features), the
    model of the kernel's order is within one bf16 ulp of the f64 sum,
    with a floor of 2^-16 of max|ref|."""
    rng = np.random.default_rng(F + Fo)
    nbr = torch.from_numpy(np.concatenate([_front(rng, 2_200, 2_000),
                                           _front(rng, 2_200, 1_700)]))
    feats = torch.from_numpy(rng.standard_normal((2, 2_200, F))).to(
        torch.bfloat16).float()
    g = torch.from_numpy(rng.standard_normal((2, 2_200, Fo))).to(
        torch.bfloat16).float()
    taps = (0, 13, 26)
    got = _model(nbr, feats, g, taps, ranges=5)
    plan = kernels.sparse_wgrad_plan(nbr, F, Fo, 5)
    # pieces of more pairs than a chain flushes after (32 k16 steps of 16
    # pairs, or of half the steps where the warpgroups split them)
    chains = 2 if (plan.mt, plan.bn) == (1, 64) else 1
    assert plan.ranges == 5
    assert (plan.pieces[:, 6] - plan.pieces[:, 5]).max() > 2 * 32 * 16 * chains
    gf = g.reshape(-1, Fo).double()
    for t in taps:
        src = nbr[..., t].long()
        tap = torch.where((src >= 0)[..., None], torch.gather(
            feats, 1, src.clamp_min(0)[..., None].expand(-1, -1, F)), 0.0)
        ref = tap.reshape(-1, F).double().t() @ gf
        d = (got[t].double() - ref).abs()
        a = torch.maximum(got[t].double().abs(), ref.abs()).clamp_min(
            2.0 ** -126)
        tol = torch.exp2(torch.floor(torch.log2(a)) - 7) + \
            2.0 ** -16 * ref.abs().max()
        assert (d <= tol).all()
