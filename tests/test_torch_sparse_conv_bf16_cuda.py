"""The sparse conv on bf16 features on the card: ``sparse_conv_bf16``
(forward, and as the input gradient) and ``sparse_conv_bf16_wgrad``
against their plain versions at the GSM voxel branch's widths on the three
levels of a 65,536-slot scene grid (0.4 m, bench_gsm_train.py's kind of
scene), through a padded width (30 -> 62) and a poisoned batch element,
two runs bit-identical; a table whose few active tiles lie scattered
among tiles of padding slots, and a call with no active tile (the
kernel's persistent blocks walk every tile and gather only where a tap is
present, ``kernels.sparse_conv_schedule``); the weight gradient alone on
tables that exercise its walk over the present (row, tap) pairs
(``kernels.sparse_wgrad_plan``): 3,712 active rows at the front of 65,536
slots, two batch elements of unequal fills, taps no row has (their dW
exactly 0) and a table with no active row (dW all 0). Gate: one bf16 ulp
per element of the larger of the two values, with a floor of 2^-16 of the
largest reference value (the two sum in f32 in different orders; where an
element's terms cancel the order alone moves it by more than its own ulp).
Needs an NVIDIA GPU and skips without one; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_sparse_conv_bf16_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.grid.build import coarsened_grid, grid_from_points
from infinicube_tpu_torch.nn.sparse import conv_plan
from infinicube_tpu_torch.ops import window_conv as wc

pytestmark = pytest.mark.cuda

# the voxel branch's convs in gsm_bf16_config: (F, Fo, level)
SHAPES = [(64, 64, 0), (64, 128, 1), (128, 128, 1), (128, 256, 2),
          (256, 256, 2), (384, 128, 1), (192, 64, 0), (30, 62, 0)]
BOUNDS = ((-8, -64, -8), (224, 128, 48))


@pytest.fixture(scope="module")
def plans():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    n = 200_000
    road = np.stack([rng.uniform(0, 80, n // 2), rng.uniform(-20, 20, n // 2),
                     rng.normal(0, 0.1, n // 2)], -1)
    walls = np.stack([rng.uniform(0, 80, n // 2),
                      np.sign(rng.normal(size=n // 2)) *
                      rng.normal(16, 0.3, n // 2),
                      rng.uniform(0, 10, n // 2)], -1)
    pts = torch.tensor(np.concatenate([road, walls])[None],
                       dtype=torch.float32, device="cuda")
    grids = [grid_from_points(pts, torch.ones((1, n), dtype=torch.bool,
                                              device="cuda"),
                              0.4, 0.2, capacity=1 << 16)]
    for _ in range(2):
        grids.append(coarsened_grid(grids[-1], (2, 2, 2),
                                    capacity=grids[-1].capacity))
    out = []
    for level, g in enumerate(grids):
        mn, dm = np.asarray(BOUNDS[0]), np.asarray(BOUNDS[1])
        mx = mn + dm - 1
        for _ in range(level):
            mn, mx = mn // 2, mx // 2
        bounds = (tuple(int(v) for v in mn), tuple(int(v) for v in mx - mn + 1))
        out.append((g, conv_plan(g, dense_bounds=bounds)))
    return out


def hold_ulp(got, ref):
    """got within one bf16 ulp of ref element by element; returns the
    bit-equal share."""
    got, ref = got.float(), ref.float()
    a = torch.maximum(got.abs(), ref.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    tol = ulp + 2.0 ** -16 * ref.abs().max()
    assert ((got - ref).abs() <= tol).all()
    return (got == ref).float().mean().item()


@pytest.mark.parametrize("F,Fo,level", SHAPES)
def test_bf16_kernels_match_plain(plans, F, Fo, level):
    grid, plan = plans[level]
    assert not plan.overflowed.any()
    g = torch.Generator(device="cuda").manual_seed(F * 1000 + Fo)
    m = grid.mask[..., None]
    C = grid.mask.shape[1]
    x = torch.where(m, torch.randn((1, C, F), generator=g, device="cuda"),
                    0.0).bfloat16()
    w = (torch.randn((27, F, Fo), generator=g, device="cuda") /
         (27 * F) ** 0.5).bfloat16()
    cot = torch.where(m, torch.randn((1, C, Fo), generator=g,
                                     device="cuda"), 0.0).bfloat16()
    runs = []
    for _ in range(2):
        kernels.reset_launches()
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = wc.window_sparse_conv(plan, xr, wr)
        out.backward(cot)
        torch.cuda.synchronize()
        assert {k for k, v in kernels.launches.items() if v} == {
            "sparse_conv_bf16", "sparse_conv_bf16_dgrad",
            "sparse_conv_bf16_wgrad"}
        runs.append((out, xr.grad, wr.grad))
    ref = wc.sparse_conv_plain(plan, x, w)
    ref_dx, ref_dw = wc.sparse_conv_bwd_plain(plan, x, w, cot)
    for got, want in zip(runs[0], (ref, ref_dx, ref_dw)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert hold_ulp(got, want) >= 0.99
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_bf16_poisoned_batch_element_is_nan(plans):
    grid, plan = plans[0]
    C = grid.mask.shape[1]
    x = torch.randn((2, C, 64), device="cuda").bfloat16()
    nbr = plan.nbr.expand(2, -1, -1).contiguous()
    w = (torch.randn((27, 64, 64), device="cuda") / 40).bfloat16()
    poison = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    out = kernels.sparse_conv_bf16(x, nbr, wc.pack_sparse_weight(w), poison)
    assert torch.isnan(out[1]).all() and torch.isfinite(out[0]).all()
    ref = wc.sparse_conv_plain(wc.ConvPlan(nbr, poison), x, w)
    assert torch.isnan(ref[1]).all()
    hold_ulp(out[0], ref[0])


def test_bf16_kernels_refuse_what_they_do_not_take(plans):
    _, plan = plans[0]
    C = plan.nbr.shape[1]
    x = torch.zeros((1, C, 12), dtype=torch.bfloat16, device="cuda")
    pack = torch.zeros((27, 16, 12), dtype=torch.bfloat16, device="cuda")
    poison = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        kernels.sparse_conv_bf16(x, plan.nbr, pack, poison)
    with pytest.raises(ValueError):
        kernels.sparse_conv_bf16_wgrad(x, plan.nbr, x)
    with pytest.raises(ValueError):
        kernels.sparse_conv_bf16(x.float(), plan.nbr, pack, poison)


def _scattered(C, tiles, seed):
    """nbr int32 [1, C, 27]: -1 but in the given 128-row tiles, whose rows
    have random taps among the rows of other active tiles."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    nbr = torch.full((1, C, 27), -1, dtype=torch.int32, device="cuda")
    rows = torch.cat([torch.arange(t * 128, t * 128 + 128, device="cuda")
                      for t in tiles])
    pick = torch.randint(0, rows.numel(), (rows.numel(), 27), generator=g,
                         device="cuda")
    keep = torch.rand((rows.numel(), 27), generator=g, device="cuda") < 0.4
    nbr[0, rows] = torch.where(keep, rows[pick], -1).int()
    return nbr


@pytest.mark.parametrize("F,Fo", [(64, 64), (128, 256), (384, 128)])
def test_bf16_few_scattered_active_tiles(plans, F, Fo):
    """Four active tiles among 512 (the rest padding slots): forward and
    dx within one bf16 ulp of the plain version, zeros in the padding
    tiles, two runs bit-identical."""
    C, tiles = 1 << 16, (3, 200, 201, 511)
    nbr = _scattered(C, tiles, F + Fo)
    poison = torch.zeros(1, dtype=torch.int32, device="cuda")
    stages, _ = kernels.sparse_conv_schedule(nbr, poison, F, Fo,
                                             torch.bfloat16)
    assert (stages > 0).sum().item() == len(tiles) * -(-Fo // 128)
    g = torch.Generator(device="cuda").manual_seed(F)
    x = torch.randn((1, C, F), generator=g, device="cuda").bfloat16()
    w = (torch.randn((27, F, Fo), generator=g, device="cuda") /
         (27 * F) ** 0.5).bfloat16()
    cot = torch.randn((1, C, Fo), generator=g, device="cuda").bfloat16()
    plan = wc.ConvPlan(nbr, poison)
    runs = [(kernels.sparse_conv_bf16(x, nbr, wc.pack_sparse_weight(w),
                                      poison),
             kernels.sparse_conv_bf16(cot, nbr,
                                      wc.pack_sparse_weight(w, True), poison,
                                      dgrad=True)) for _ in range(2)]
    torch.cuda.synchronize()
    ref = wc.sparse_conv_plain(plan, x, w)
    ref_dx = wc.sparse_conv_plain(plan, cot, wc.rev_w(w))
    for got, want in zip(runs[0], (ref, ref_dx)):
        hold_ulp(got, want)
        assert (got[0, :128 * 3] == 0).all()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_bf16_call_with_no_active_tile(plans):
    """A table of padding slots only: zeros, or NaN for a poisoned element,
    and no stage walked."""
    nbr = torch.full((2, 5000, 27), -1, dtype=torch.int32, device="cuda")
    poison = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    stages, _ = kernels.sparse_conv_schedule(nbr, poison, 64, 64,
                                             torch.bfloat16)
    assert (stages <= 0).all()
    x = torch.randn((2, 5000, 64), device="cuda").bfloat16()
    w = (torch.randn((27, 64, 64), device="cuda") / 40).bfloat16()
    out = kernels.sparse_conv_bf16(x, nbr, wc.pack_sparse_weight(w), poison)
    torch.cuda.synchronize()
    assert (out[0] == 0).all() and torch.isnan(out[1]).all()


def _front(C, active, seed, keep=0.7, device="cuda"):
    """nbr int32 [1, C, 27]: rows 0 .. active-1 are voxels whose taps are
    present with probability ``keep``, each pointing at a random voxel;
    the rest padding slots (the grid's active rows come first)."""
    g = torch.Generator(device=device).manual_seed(seed)
    nbr = torch.full((1, C, 27), -1, dtype=torch.int32, device=device)
    pick = torch.randint(0, active, (active, 27), generator=g, device=device)
    on = torch.rand((active, 27), generator=g, device=device) < keep
    nbr[0, :active] = torch.where(on, pick, -1).int()
    return nbr


def _hold_wgrad(nbr, F, Fo, seed):
    """``sparse_conv_bf16_wgrad`` on random bf16 feats and g over ``nbr``:
    two runs bit-identical, within one bf16 ulp of
    ``sparse_conv_bwd_plain``'s dW once rounded as the backward rounds it.
    Returns the kernel's f32 dW."""
    B, C, _ = nbr.shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, C, F), generator=g, device="cuda").bfloat16()
    cot = torch.randn((B, C, Fo), generator=g, device="cuda").bfloat16()
    runs = []
    for _ in range(2):
        before = kernels.launches["sparse_conv_bf16_wgrad"]
        runs.append(kernels.sparse_conv_bf16_wgrad(x, nbr, cot))
        assert kernels.launches["sparse_conv_bf16_wgrad"] == before + 1
    torch.cuda.synchronize()
    assert runs[0].dtype == torch.float32 and runs[0].shape == (27, F, Fo)
    assert torch.equal(runs[0], runs[1])
    w = torch.zeros((27, F, Fo), dtype=torch.bfloat16, device="cuda")
    poison = torch.zeros(B, dtype=torch.int32, device="cuda")
    ref = wc.sparse_conv_bwd_plain(wc.ConvPlan(nbr, poison), x, w, cot)[1]
    hold_ulp(runs[0].bfloat16(), ref)
    return runs[0]


@pytest.mark.parametrize("F,Fo", [(64, 64), (64, 128), (128, 256),
                                  (256, 256), (192, 64), (384, 128)])
def test_bf16_wgrad_few_rows_at_the_front(plans, F, Fo):
    """3,712 voxels at the front of 65,536 slots (the bench grid's level 2):
    every tile and split of the walk."""
    nbr = _front(1 << 16, 3712, F + Fo)
    plan = kernels.sparse_wgrad_plan(nbr, F, Fo)
    assert 0 < plan.ranges <= kernels.WGRAD_RANGES
    assert (plan.ranges - 1) * plan.length < plan.stages
    _hold_wgrad(nbr, F, Fo, F * Fo)


def test_bf16_wgrad_two_elements_of_unequal_fills(plans):
    """B = 2: 15,000 and 2,000 voxels of 20,000 slots, each pointing within
    its own element."""
    nbr = torch.cat([_front(20_000, 15_000, 1), _front(20_000, 2_000, 2)])
    assert (nbr[1, 2_000:] == -1).all()
    _hold_wgrad(nbr, 64, 128, 3)


def test_bf16_wgrad_taps_no_row_has(plans):
    """dW of a tap no row has is exactly 0, beside taps that every range
    cut passes through; scattered rows too."""
    nbr = _front(1 << 16, 3712, 4)
    nbr[..., 5] = -1
    nbr[..., 26] = -1
    dw = _hold_wgrad(nbr, 128, 128, 5)
    assert (dw[5] == 0).all() and (dw[26] == 0).all()
    assert (dw[13] != 0).any()
    nbr = _scattered(1 << 16, (3, 200, 201, 511), 6)
    nbr[..., 0] = -1
    assert (_hold_wgrad(nbr, 64, 64, 7)[0] == 0).all()


def test_bf16_wgrad_call_with_no_active_row(plans):
    """A table of padding slots only: no stage, dW all 0."""
    nbr = torch.full((2, 5000, 27), -1, dtype=torch.int32, device="cuda")
    assert kernels.sparse_wgrad_plan(nbr, 64, 64).ranges == 0
    x = torch.randn((2, 5000, 64), device="cuda").bfloat16()
    dw = kernels.sparse_conv_bf16_wgrad(x, nbr, x)
    torch.cuda.synchronize()
    assert (dw == 0).all()
