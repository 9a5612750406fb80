"""The arithmetic of K6 (the sparse conv's weight gradient on the card) on
the CPU. Its products run on the tensor cores by the 3xTF32 split: A is the
gathered feats rows, split into tf32 hi and lo in registers; B is g^T from
the pack the kernel's prologue writes (``pack_wgrad_grad``); a k8 step adds
lo_A hi_B, hi_A lo_B and hi_A hi_B to a tensor-core sum that truncates
(emulated with ``rz`` and ``k8_steps`` of test_torch_tf32x3_f32_kernels.py),
and every 32 k8 steps that sum is added into an f32 sum with a rounded add.
The rows are cut into the fixed ranges of ``wgrad_rows_per_split``, each
walked in 32-row chunks (only those where some row has the tap), and the
ranges' partial sums are added in order. That emulation holds K6's gate,
max-abs <= 5e-4 * max|ref|, against an f64 reference at the VAE's widths on
thousands of rows (the sums flushed a dozen times); one TF32 product alone
misses it. Nothing here imports JAX."""

import pytest
import torch

from infinicube_tpu_torch.grid.build import grid_from_ijk
from infinicube_tpu_torch.kernels import wgrad_rows_per_split
from infinicube_tpu_torch.nn.sparse import conv_plan
from infinicube_tpu_torch.ops.window_conv import (gather_neighbor_features,
                                                  pack_wgrad_grad,
                                                  tf32_split, tf32_truncate)

from test_torch_tf32x3_f32_kernels import k8_steps

GATE = 5e-4
CHUNK, FLUSH = 32, 32   # rows a chunk; k8 steps between flushes
TAPS = (4, 13, 22)      # an in-plane tap, the centre, an off-plane tap


def _sheet(n, cap, seed):
    """A ground plane with bumps in batch 1: most rows have 8 to 12 of the
    27 neighbours, as on the VAE's grids."""
    g = torch.Generator().manual_seed(seed)
    ij = torch.randint(-45, 45, (1, n, 2), generator=g)
    k = (torch.sin(ij[..., :1] * 0.3) * 3).round().int() + torch.randint(
        -1, 2, (1, n, 1), generator=g)
    grid = grid_from_ijk(torch.cat([ij, k], -1).int(),
                         torch.ones((1, n), dtype=torch.bool), 0.2, 0.1, cap)
    return grid, conv_plan(grid, dense_bounds=((-64, -64, -64),
                                               (128, 128, 128)))


def k6_emulation(nbr, feats, pack, t, per, passes=3, flush=True):
    """What K6 computes for tap t from feats [B, C, F] and the pack
    [2, n, ld] (a subset of g^T's rows is enough): the ranges of ``per``
    rows, the chunks with a present tap, the k8 steps split between the
    consumer warpgroups as the kernel splits them (an F tile of 128: every
    step; of 64, F <= 64: steps 0-1 and 2-3 of each chunk in two sums added
    at the end), flushed every 32 k8 steps of a warpgroup (``flush`` False:
    one truncating sum a range), the ranges' partials summed in order."""
    F = feats.shape[-1]
    rows = nbr.shape[0] * nbr.shape[1]
    a_hi, a_lo = tf32_split(gather_neighbor_features(feats, nbr, t)
                            .reshape(rows, F).t().contiguous())
    b_hi, b_lo = pack[0, :, :rows].t(), pack[1, :, :rows].t()
    parts = ((a_lo, a_hi, a_hi), (b_hi, b_lo, b_hi))
    if passes == 1:
        parts = ((a_hi,), (b_hi,))
    present = (nbr[..., t] >= 0).reshape(-1)
    streams = ((0, 1, 2, 3),) if F > 64 else ((0, 1), (2, 3))
    out = None
    for r0 in range(0, rows, per):
        chunks = [c for c in range(r0, min(rows, r0 + per), CHUNK)
                  if present[c:c + CHUNK].any()]
        total = None
        for steps in streams:
            s_sum = torch.zeros((F, b_hi.shape[1]))
            acc, n = None, 0
            for c in chunks:
                for step in steps:
                    k0 = c + 8 * step
                    if k0 >= rows:   # rows past the end are zero rows
                        continue
                    acc = k8_steps(acc, *parts, k0, acc is None)
                    n += 1
                if flush and n >= FLUSH:
                    s_sum, acc, n = s_sum + acc, None, 0
            if acc is not None:
                s_sum = s_sum + acc
            total = s_sum if total is None else total + s_sum
        out = total if out is None else out + total
    return out


def _case(F, Fo, seed, n_cols=16):
    """A sheet of about 3,000 voxels in 3,328 rows, features and an output
    gradient, the pack of its columns ``cols`` and the f64 dW of TAPS."""
    grid, plan = _sheet(5000, 3328, seed)
    g = torch.Generator().manual_seed(seed + 1)
    m = grid.mask[..., None]
    feats = torch.where(m, torch.randn((1, 3328, F), generator=g), 0.0)
    gout = torch.where(m, torch.randn((1, 3328, Fo), generator=g), 0.0)
    cols = torch.randperm(Fo, generator=g)[:n_cols]
    pack = pack_wgrad_grad(gout)[:, cols]
    ref = torch.stack([
        gather_neighbor_features(feats, plan.nbr, t).reshape(-1, F).double()
        .t() @ gout.reshape(-1, Fo)[:, cols].double() for t in TAPS])
    return plan, feats, pack, ref


def _err(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


# the trainer's (F, Fo); the sheet's 3,328 rows lie in one range of the
# length K6 takes on a decoded grid (6,912 rows at 131,072 x 64 -> 64,
# 6,560 at 32,768 x 256 -> 256)
@pytest.mark.parametrize("F,Fo", [(32, 64), (64, 64), (128, 128),
                                  (256, 128), (256, 256)])
def test_three_tf32_products_hold_the_gate(F, Fo):
    plan, feats, pack, ref = _case(F, Fo, seed=F + Fo)
    per = 6912 if F <= 64 else 6560
    got = torch.stack([k6_emulation(plan.nbr, feats, pack, t, per)
                       for t in TAPS])
    assert _err(got, ref) <= GATE


@pytest.mark.parametrize("F,Fo", [(64, 64), (256, 256)])
def test_one_tf32_product_misses_the_gate(F, Fo):
    plan, feats, pack, ref = _case(F, Fo, seed=3)
    got = torch.stack([k6_emulation(plan.nbr, feats, pack, t, 6912,
                                    passes=1) for t in TAPS])
    assert _err(got, ref) > GATE


def test_ranges_and_flushes_keep_the_truncation_small():
    """On a range of 3,328 rows the flushed sums stay far inside the gate;
    one truncating sum a range drifts further (by how much is the card's
    rounding, so only the order is held)."""
    plan, feats, pack, ref = _case(256, 256, seed=11)
    flushed = torch.stack([k6_emulation(plan.nbr, feats, pack, t, 6560)
                           for t in TAPS])
    one_sum = torch.stack([k6_emulation(plan.nbr, feats, pack, t, 6560,
                                        flush=False) for t in TAPS])
    assert _err(flushed, ref) <= GATE / 10
    assert _err(flushed, ref) < _err(one_sum, ref)


def test_the_g_pack_layout():
    """[2, Fo, B*C rounded up to 4]: hi and lo of g^T, tf32 values (the low
    13 mantissa bits zero), hi + lo within 2^-21 of g, zero padding."""
    g = torch.randn((2, 777, 12), generator=torch.Generator().manual_seed(0))
    pack = pack_wgrad_grad(g)
    assert pack.shape == (2, 12, 1556) and pack.dtype == torch.float32
    gt = g.reshape(-1, 12).t()
    for part in pack:
        assert torch.equal(part, tf32_truncate(part))
    assert torch.equal(pack[0, :, :1554], tf32_truncate(gt))
    assert torch.equal(pack[1, :, :1554],
                       tf32_truncate(gt - pack[0, :, :1554]))
    assert ((pack[0, :, :1554] + pack[1, :, :1554] - gt).abs() <=
            gt.abs() * 2.0 ** -21).all()
    assert (pack[:, :, 1554:] == 0).all()


@pytest.mark.parametrize("rows,F,Fo", [(131072, 64, 64), (131072, 32, 64),
                                       (32768, 256, 256), (65536, 256, 128),
                                       (4099, 8, 12), (700, 64, 128),
                                       (40_000_000, 64, 64)])
def test_row_ranges_are_a_function_of_the_shape(rows, F, Fo):
    """Multiples of 32 rows, at most 16,384, covering the rows; the same for
    the same shape; about 512 blocks of (tap, F tile, N tile, range) or
    ranges of at least 1,024 rows, whichever is fewer."""
    per = wgrad_rows_per_split(rows, F, Fo)
    assert per == wgrad_rows_per_split(rows, F, Fo)
    assert per % 32 == 0 and 0 < per <= 16384
    splits = -(-rows // per)
    assert (splits - 1) * per < rows <= splits * per
    tiles = 27 * -(-F // (64 if F <= 64 else 128)) * \
        -(-Fo // (64 if Fo <= 64 else 128))
    if rows <= 16384 * 16:
        assert splits == min(-(-512 // tiles), -(-rows // 1024))
    assert {(131072, 64, 64): 6912, (32768, 256, 256): 6560}.get(
        (rows, F, Fo), per) == per
