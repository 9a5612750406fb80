"""Head dims and widths that the card's kernels do not take, on the card:
``multi_head_attention`` at d = 16, 32 and 48 (bf16 forward and gradients
through K2 and K5, f32 forward through ``flash_attn_f32``), ``mha_quantized``
at d = 16 and 96 (K1, K8), and ``window_sparse_conv`` at 30 -> 30 and
30 -> 62 (K4 forward and dx, K6 dW), each against its plain version at its
gate. Needs an NVIDIA GPU and skips without one; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_padding_cuda.py -m cuda -q
"""

import pytest
import torch

from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.grid.build import grid_from_ijk
from infinicube_tpu_torch.nn.sparse import conv_plan
from infinicube_tpu_torch.ops.attention import (attention_plain,
                                                multi_head_attention)
from infinicube_tpu_torch.ops.flash_attention import mha_quantized
from infinicube_tpu_torch.ops.window_conv import (sparse_conv_bwd_plain,
                                                  sparse_conv_plain,
                                                  window_sparse_conv)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _cos(a, b):
    a, b = a.detach().double().flatten(), b.detach().double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def _rel(got, ref):
    got, ref = got.detach().double(), ref.detach().double()
    return (got - ref).abs().max().item() / ref.abs().max().item()


@pytest.mark.parametrize("d", [16, 32, 48])
def test_attention_at_small_head_dims(gen, d):
    """bf16: K2 and K5 once each, output and dq, dk, dv within K2's and
    K5's gate (cosine >= 0.9999, max-abs <= 2e-2 * max|ref|) of the plain
    f32 attention at the true head dim; f32: ``flash_attn_f32`` once,
    max-abs <= 1e-4 * max|ref|."""
    B, nq, nk, h = 2, 1000, 777, 4
    q, k, v = (torch.randn((B, n, h, d), generator=gen, device="cuda")
               for n in (nq, nk, nk))
    do = torch.randn((B, nq, h, d), generator=gen, device="cuda")
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
    before = dict(kernels.launches)
    out = multi_head_attention(*leaves)
    out.backward(do.to(torch.bfloat16))
    assert kernels.launches["flash_attn_bf16"] == \
        before["flash_attn_bf16"] + 1
    assert kernels.launches["flash_attn_bf16_bwd"] == \
        before["flash_attn_bf16_bwd"] + 1
    ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
    ref = attention_plain(*ref_leaves, d ** -0.5)
    ref.backward(do.to(torch.bfloat16).float())
    assert out.shape == (B, nq, h, d)
    for got, want in [(out, ref)] + [(a.grad, b.grad) for a, b in
                                     zip(leaves, ref_leaves)]:
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert _cos(got, want) >= 0.9999
        assert _rel(got, want) <= 2e-2
    with torch.no_grad():
        f32 = multi_head_attention(q, k, v)
    assert kernels.launches["flash_attn_f32"] == before["flash_attn_f32"] + 1
    assert f32.shape == (B, nq, h, d) and f32.dtype == torch.float32
    assert _rel(f32, attention_plain(q, k, v, d ** -0.5)) <= 1e-4


def test_attention_refuses_head_dims_above_128(gen):
    q = torch.zeros((1, 64, 1, 160), device="cuda", dtype=torch.bfloat16)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="128"):
        multi_head_attention(q, q, q)
    assert kernels.launches == before


@pytest.mark.parametrize("quant,name", [("qk", "flash_attn_int8qk"),
                                        ("qkv", "flash_attn_int8qkv")])
@pytest.mark.parametrize("d", [16, 96])
def test_int8_attention_at_other_head_dims(gen, quant, name, d):
    """K1 and K8 (64 and 128 only) at d = 16 and 96 through the padding:
    one launch, cosine >= 0.999 against the unpadded plain int8 attention
    on the CPU."""
    q, k, v = (torch.randn((2, 1000, 3, d), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    before = kernels.launches[name]
    out = mha_quantized(q, k, v, quant=quant)
    assert kernels.launches[name] == before + 1
    ref = mha_quantized(q.cpu(), k.cpu(), v.cpu(), quant=quant)
    assert out.shape == ref.shape == (2, 1000, 3, d)
    assert torch.isfinite(out).all()
    assert _cos(out.cpu(), ref) >= 0.999


@pytest.mark.parametrize("F,Fo", [(30, 30), (30, 62)])
def test_sparse_conv_at_widths_2_mod_4(gen, F, Fo):
    """K4 forward and dx (max-abs <= 1e-4 * max|ref|) and K6 dW (<= 5e-4 *
    max|ref|) through the width padding, on a voxel sheet, against
    ``sparse_conv_plain`` and ``sparse_conv_bwd_plain``."""
    n, cap = 20000, 32768
    ij = torch.randint(-60, 60, (1, n, 2), generator=gen, device="cuda")
    kk = (torch.sin(ij[..., :1] * 0.3) * 3).round().int()
    grid = grid_from_ijk(torch.cat([ij, kk], -1).int(),
                         torch.ones((1, n), dtype=torch.bool, device="cuda"),
                         0.2, 0.1, cap)
    plan = conv_plan(grid, dense_bounds=((-64, -64, -64), (128, 128, 128)))
    m = grid.mask[..., None]
    x = torch.where(m, torch.randn((1, cap, F), generator=gen,
                                   device="cuda"), 0.0)
    w = torch.randn((27, F, Fo), generator=gen, device="cuda") / \
        (27 * F) ** 0.5
    gout = torch.where(m, torch.randn((1, cap, Fo), generator=gen,
                                      device="cuda"), 0.0)
    feats, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = dict(kernels.launches)
    out = window_sparse_conv(plan, feats, wl)
    out.backward(gout)
    for name in ("sparse_conv_f32", "sparse_conv_f32_dgrad",
                 "sparse_conv_f32_wgrad"):
        assert kernels.launches[name] == before[name] + 1
    ref = sparse_conv_plain(plan, x, w)
    ref_dx, ref_dw = sparse_conv_bwd_plain(plan, x, w, gout)
    assert out.shape == (1, cap, Fo) and feats.grad.shape == x.shape
    assert wl.grad.shape == w.shape
    assert _rel(out, ref) <= 1e-4
    assert _rel(feats.grad, ref_dx) <= 1e-4
    assert _rel(wl.grad, ref_dw) <= 5e-4
