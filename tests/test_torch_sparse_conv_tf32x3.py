"""The arithmetic of K4 (the sparse conv on the card) on the CPU: its
products run on the tensor cores by the 3xTF32 split, hi = tf32(a), lo =
tf32(a - hi) for both operands, summing lo_A hi_B + hi_A lo_B + hi_A hi_B
(TF32 emulated as f32 with the low 13 mantissa bits cleared, as the card
reads it). That emulation holds K4's gate, max-abs <= 1e-4 * max|ref|,
against ``sparse_conv_plain`` at the VAE's widths, forward and as the input
gradient through ``pack_sparse_weight``'s packs; a single TF32 product does
not, which is why the kernel takes three. Nothing here imports JAX."""

import numpy as np
import pytest
import torch

from infinicube_tpu_torch.grid.build import grid_from_ijk
from infinicube_tpu_torch.nn.sparse import conv_plan
from infinicube_tpu_torch.ops.window_conv import (gather_neighbor_features,
                                                  pack_sparse_weight, rev_w,
                                                  sparse_conv_bwd_plain,
                                                  sparse_conv_plain,
                                                  tf32_truncate)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch thread for the module: the suite runs files in parallel
    workers, and a thread per core in each of them oversubscribes the
    machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BOUNDS = ((-16, -16, -16), (32, 32, 32))
GATE = 1e-4


def _scene(n, cap, seed):
    """A sheet-like voxel set (a ground plane with bumps) in batch 1."""
    rng = np.random.default_rng(seed)
    ij = rng.integers(-10, 10, (n, 2))
    k = (np.sin(ij[:, :1] * 0.5) * 2).round() + rng.integers(-1, 2, (n, 1))
    ijk = np.concatenate([ij, k], -1).astype(np.int32)[None]
    grid = grid_from_ijk(torch.from_numpy(ijk),
                         torch.ones((1, n), dtype=torch.bool), 0.2, 0.1, cap)
    return grid, conv_plan(grid, dense_bounds=BOUNDS)


def k4_emulation(plan, feats, pack, passes=3):
    """What K4 computes from feats [B, C, K] and a pack [2, 27, N, K]: per
    present tap the gathered rows split into tf32 hi and lo, the products
    of the tf32 parts (exact in f32) summed in f32; ``passes`` 1 keeps only
    hi_A hi_B."""
    out = torch.zeros(feats.shape[:2] + (pack.shape[2],))
    for t in range(pack.shape[1]):
        a = gather_neighbor_features(feats, plan.nbr, t)
        a_hi = tf32_truncate(a)
        a_lo = tf32_truncate(a - a_hi)
        b_hi, b_lo = pack[0, t].t(), pack[1, t].t()
        if passes == 3:
            out = out + a_lo @ b_hi + a_hi @ b_lo
        out = out + a_hi @ b_hi
    return out


def _err(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("F,Fo,n", [(32, 64, 500), (64, 64, 500),
                                    (128, 128, 300), (256, 128, 200),
                                    (256, 256, 200)])
def test_three_tf32_products_hold_the_gate(F, Fo, n):
    grid, plan = _scene(n, 512, seed=F + Fo)
    g = torch.Generator().manual_seed(F * Fo)
    feats = torch.where(grid.mask[..., None],
                        torch.randn((1, 512, F), generator=g), 0.0)
    w = (torch.rand((27, F, Fo), generator=g) * 2 - 1) / (27 * F) ** 0.5
    ref = sparse_conv_plain(plan, feats, w)
    assert _err(k4_emulation(plan, feats, pack_sparse_weight(w)),
                ref) <= GATE
    # the input gradient: the output gradient through the dgrad pack
    gout = torch.where(grid.mask[..., None],
                       torch.randn((1, 512, Fo), generator=g), 0.0)
    ref_dx = sparse_conv_bwd_plain(plan, feats, w, gout)[0]
    dx = k4_emulation(plan, gout, pack_sparse_weight(w, dgrad=True))
    assert _err(dx, ref_dx) <= GATE


@pytest.mark.parametrize("F,Fo", [(64, 64), (256, 256)])
def test_one_tf32_product_misses_the_gate(F, Fo):
    grid, plan = _scene(300, 512, seed=7)
    g = torch.Generator().manual_seed(3)
    feats = torch.where(grid.mask[..., None],
                        torch.randn((1, 512, F), generator=g), 0.0)
    w = (torch.rand((27, F, Fo), generator=g) * 2 - 1) / (27 * F) ** 0.5
    ref = sparse_conv_plain(plan, feats, w)
    one = k4_emulation(plan, feats, pack_sparse_weight(w), passes=1)
    assert _err(one, ref) > 2 * GATE


def test_pack_layout_and_split():
    """pack[0] + pack[1] is w^T per tap to within 2^-21 relative, both
    parts are tf32 values, and the dgrad pack is rev_w(w) transposed."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn((27, 8, 12), generator=g)
    pack = pack_sparse_weight(w)
    assert pack.shape == (2, 27, 12, 8)
    for part in pack:
        assert torch.equal(tf32_truncate(part), part)
    wt = w.transpose(1, 2)
    assert ((pack[0] + pack[1] - wt).abs() <= 2 ** -21 * wt.abs()).all()
    dpack = pack_sparse_weight(w, dgrad=True)
    assert dpack.shape == (2, 27, 8, 12)
    assert torch.equal(dpack[0], tf32_truncate(
        rev_w(w).transpose(1, 2).contiguous()))
