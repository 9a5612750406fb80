"""The work the sparse conv kernels walk, on the CPU.

``sparse_conv_f32`` and ``sparse_conv_bf16`` (csrc/sparse_conv.cu) run in
persistent blocks that take work items (batch element, 128-row tile, N
tile; the N tile fastest) from a queue; for each item the kernel finds on
the card the taps some row of the tile has and walks taps x K chunks
stages of gathers,
stores zeros where the tile has none (padding slots) and NaN where the
element is poisoned, without a stage. ``kernels.sparse_conv_schedule`` is
that plan in PyTorch; here it is held against a numpy reference written
from the same rules: a level whose slots are all padding, scattered active
tiles, a poisoned batch element, both element types' K chunks, every N
tile. Nothing here imports JAX or needs a card; about 1 s."""

import numpy as np
import pytest
import torch

from infinicube_tpu_torch import kernels
from tests.test_torch_gsm import one_torch_thread  # noqa: F401


def schedule_numpy(nbr, poison, K, N, elt):
    B, C, _ = nbr.shape
    bn = 32 if N <= 32 else 64 if N <= 64 else 128
    kc = -(-K * elt // 128)
    stages, masks = [], []
    for b in range(B):
        for m0 in range(0, C, 128):
            taps = [t for t in range(27)
                    if (nbr[b, m0:m0 + 128, t] >= 0).any()]
            for _ in range(0, N, bn):
                if poison[b]:
                    stages.append(-1)
                    masks.append(0)
                else:
                    stages.append(len(taps) * kc)
                    masks.append(sum(1 << t for t in taps))
    return np.array(stages), np.array(masks)


def _table(rng, B, C, active_tiles):
    """nbr [B, C, 27]: -1 everywhere but in the given 128-row tiles, where
    a few rows have a few taps."""
    nbr = np.full((B, C, 27), -1, np.int32)
    for b, tile in active_tiles:
        rows = rng.choice(np.arange(tile * 128, min(C, tile * 128 + 128)),
                          size=3, replace=False)
        for r in rows:
            taps = rng.choice(27, size=rng.integers(1, 5), replace=False)
            nbr[b, r, taps] = rng.integers(0, C, size=len(taps))
    return nbr


@pytest.mark.parametrize("dtype,K,N", [(torch.bfloat16, 64, 64),
                                       (torch.bfloat16, 384, 128),
                                       (torch.bfloat16, 128, 256),
                                       (torch.float32, 64, 128),
                                       (torch.float32, 12, 8)])
def test_schedule_matches_numpy(dtype, K, N):
    rng = np.random.default_rng(K + N)
    B, C = 3, 1000  # 8 row tiles, the last one ragged
    nbr = _table(rng, B, C, [(0, 0), (0, 5), (1, 7), (2, 3), (2, 7)])
    nbr[1] = -1                      # batch element 1: all padding
    nbr[1, 900:905, 13] = 900        # ... but for one ragged tile
    poison = np.array([0, 0, 1], np.int32)
    elt = torch.empty((), dtype=dtype).element_size()
    stages, masks = kernels.sparse_conv_schedule(
        torch.from_numpy(nbr), torch.from_numpy(poison), K, N, dtype)
    want_s, want_m = schedule_numpy(nbr, poison, K, N, elt)
    np.testing.assert_array_equal(stages.numpy(), want_s)
    np.testing.assert_array_equal(masks.numpy(), want_m)
    n_tiles = -(-N // (32 if N <= 32 else 64 if N <= 64 else 128))
    assert stages.numel() == B * 8 * n_tiles
    assert (stages[2 * 8 * n_tiles:] == -1).all()


def test_all_padding_level_has_no_stage():
    nbr = torch.full((1, 65536, 27), -1, dtype=torch.int32)
    stages, masks = kernels.sparse_conv_schedule(
        nbr, torch.zeros(1, dtype=torch.int32), 64, 64, torch.bfloat16)
    assert stages.numel() == 512 and (stages == 0).all()
    assert (masks == 0).all()
