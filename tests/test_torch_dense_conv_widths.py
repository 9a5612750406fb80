"""The card's dense conv at every width and in f32, checked on the CPU.

K3 and the f32 conv take channel counts that are multiples of 8 and K7
multiples of 32, so ``ops/dense_conv.py`` zero-pads other widths on the way
in and slices the output back; f32 models go to ``conv3x3x3_f32``, whose
pack holds the weights' tf32 hi and lo parts. The kernels run only on
the card, so here the card's branch is taken with CPU tensors and each
kernel replaced by a plain emulation that reads the same packed operands:
what is checked is the padding, the packs, the slicing and the dispatch.
Also the float32 precision that every entry point states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.diffusion.unet3d import UNet3D as JaxUNet
from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.inference import voxel_generation_single_chunk
from infinicube_tpu_torch.inference import voxel_vae
from infinicube_tpu_torch.models.diffusion.unet3d import UNet3D
from infinicube_tpu_torch.ops import dense_conv as dc
from infinicube_tpu_torch.ops.window_conv import tf32_truncate
from infinicube_tpu_torch.utils import precision
from infinicube_tpu_torch import train
from infinicube_tpu_torch.weights.from_jax import unet_from_jax
from tests.test_torch_unet3d import filled_params


def _unpack(wp, C):
    """A K3 / f32 pack [O, 27*C] back to [O, C, 3, 3, 3]."""
    return wp.reshape(wp.shape[0], 3, 3, 3, C).permute(0, 4, 1, 2, 3)


def _fake_k3(calls):
    """Plain stand-ins for K3 and the f32 conv with their wrappers' checks
    on widths and packs (the f32 conv reads its pack's hi + lo)."""
    def run(x, wp, bias):
        C = x.shape[-1]
        if x.dtype == torch.float32:
            assert wp.dim() == 3 and wp.shape[0] == 2
            wp = wp[0] + wp[1]
        O = wp.shape[0]
        assert wp.shape == (O, 27 * C) and wp.dtype == x.dtype
        assert C % 8 == 0 and O % 8 == 0
        calls.append((x.dtype, C, O, bias is None))
        b = torch.zeros(O) if bias is None else bias
        return dc.conv3x3x3_plain(x, _unpack(wp, C), b)
    return run


def _fake_k7(calls):
    def run(x8, w8p, sw, bias):
        C, O = x8.shape[-1], w8p.shape[0]
        assert C % 32 == 0 and O % 32 == 0 and sw.shape == (3, O)
        calls.append((C, O))
        w8 = w8p.reshape(O, 3, 3, 3, C).permute(0, 4, 2, 3, 1)
        return dc.conv3x3x3_int8_plain(x8, w8, sw, bias, torch.bfloat16)
    return run


@pytest.fixture
def card(monkeypatch):
    """CPU tensors take the card's branch, with plain kernels."""
    calls = []
    monkeypatch.setattr(dc, "_on_card", lambda x: True)
    monkeypatch.setattr(kernels, "conv3x3x3_bf16", _fake_k3(calls))
    monkeypatch.setattr(kernels, "conv3x3x3_f32", _fake_k3(calls))
    monkeypatch.setattr(kernels, "conv3x3x3_int8", _fake_k7(calls))
    # K7's quantize prologue: its kernels' plain versions
    for name in ("int8_conv_amax", "int8_conv_quantize_x",
                 "int8_conv_quantize_w"):
        monkeypatch.setattr(kernels, name, getattr(dc, f"{name}_plain"))
    return calls


def _case(B, n, C, O, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, n, n, n, C), generator=g)
    w = torch.randn((O, C, 3, 3, 3), generator=g) / (27 * C) ** 0.5
    b = torch.randn(O, generator=g)
    return x, w, b


@pytest.mark.parametrize("C,O", [(64, 72), (72, 104)])
def test_padded_int8_conv_is_bit_equal(C, O):
    """K7's padding: the plain int8 conv on operands padded to multiples of
    32, sliced back, equals the unpadded conv bit for bit (the padded
    channels add exact zeros to exact integer sums)."""
    x, w, b = _case(1, 16, C, O)
    x = x * torch.logspace(-1, 1, C)
    x8, w8, sw = dc.quantize_for_conv(x, w)
    ref = dc.conv3x3x3_int8_plain(x8, w8, sw, b, torch.bfloat16)
    m = dc.K7_MULTIPLE
    x8p, w8p = dc.pad_channels(x8, m, -1), dc.pad_channels(w8, m, 0, 1)
    bp, swp = dc.pad_channels(b, m, 0), dc.pad_channels(sw, m, 1)
    Cp, Op = -(-C // 32) * 32, -(-O // 32) * 32
    assert x8p.shape[-1] == Cp and w8p.shape[:2] == (Op, Cp)
    assert bp.shape == (Op,) and swp.shape == (3, Op)
    assert x8p.dtype == torch.int8 and w8p.dtype == torch.int8
    assert (x8p[..., C:] == 0).all() and (w8p[O:] == 0).all() and \
        (w8p[:, C:] == 0).all()
    got = dc.conv3x3x3_int8_plain(x8p, w8p, swp, bp, torch.bfloat16)
    assert torch.equal(got[..., :O], ref)


def test_int8_card_route_pads_to_32(card):
    """conv3x3x3(quant=True) on the card's branch at 64 -> 72: K7 sees 64 ->
    96, and the sliced output equals the unpadded plain int8 conv."""
    x, w, b = _case(2, 8, 64, 72, seed=1)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    with torch.no_grad():
        got = dc.conv3x3x3(x, w, b, quant=True)
    x8, w8, sw = dc.quantize_for_conv(x, w)
    assert card == [(64, 96)]
    assert got.shape == (2, 8, 8, 8, 72) and got.is_contiguous()
    assert torch.equal(got, dc.conv3x3x3_int8_plain(x8, w8, sw, b,
                                                    torch.bfloat16))


def test_pack_pads_bf16_to_eight():
    w = torch.randn(20, 12, 3, 3, 3)
    wp = dc.pack_conv_weight(w)
    assert wp.shape == (24, 27 * 16) and wp.dtype == torch.bfloat16
    full = _unpack(wp, 16)
    assert torch.equal(full[:20, :12], w.to(torch.bfloat16))
    assert (full[20:] == 0).all() and (full[:, 12:] == 0).all()
    # the f32 pack: padded alike, as tf32 hi and lo with hi + lo = w to
    # within 2^-21 of |w|
    wf = dc.pack_conv_weight(w, torch.float32)
    assert wf.shape == (2, 24, 27 * 16) and wf.dtype == torch.float32
    hi, lo = (_unpack(part, 16) for part in wf)
    assert torch.equal(hi[:20, :12], tf32_truncate(w))
    assert ((hi + lo)[:20, :12] - w).abs().le(2 ** -21 * w.abs()).all()
    assert (hi[20:] == 0).all() and (hi[:, 12:] == 0).all()
    assert (lo[20:] == 0).all() and (lo[:, 12:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_route_serves_any_width(card, dtype):
    """12 -> 20 channels through the module on the card's branch, forward
    and backward: K3 (bf16) and the f32 conv see 16 -> 24 and 24 -> 16;
    outputs and gradients as the plain conv's. (The bf16 weight gradient is
    a bf16 product with an f32 result, which only the card computes: in
    bf16 only x takes a gradient here.)"""
    bf16 = dtype == torch.bfloat16
    m = dc.Conv3x3x3(12, 20, dtype=dtype)
    m.reset_parameters(torch.Generator().manual_seed(2))
    with torch.no_grad():
        m.bias.normal_(generator=torch.Generator().manual_seed(3))
    m.requires_grad_(not bf16)
    x = torch.randn((2, 5, 6, 7, 12), generator=torch.Generator()
                    .manual_seed(4)).to(dtype).requires_grad_()
    out = m(x)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    out.backward(g.to(dtype))
    assert card == [(dtype, 16, 24, False), (dtype, 24, 16, True)]
    assert out.shape == (2, 5, 6, 7, 20) and out.dtype == dtype
    xr = x.detach().float().requires_grad_()
    wr = m.weight.detach().to(dtype).float().requires_grad_()
    br = m.bias.detach().to(dtype).float().requires_grad_()
    ref = dc.conv3x3x3_plain(xr, wr, br)
    ref.backward(g.to(dtype).float())
    tol = dict(atol=2e-2, rtol=2e-2) if bf16 else dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out.float(), ref, **tol)
    torch.testing.assert_close(x.grad.float(), xr.grad, **tol)
    if not bf16:
        torch.testing.assert_close(m.weight.grad, wr.grad, **tol)
        torch.testing.assert_close(m.bias.grad, br.grad, **tol)


def test_f32_unet_through_the_card_route_matches_jax(card):
    """A tiny f32 UNet (no SelfAttention3D: K2 takes bf16 only) whose convs
    all take the card's branch, i.e. ``conv3x3x3_f32``, against the JAX
    UNet on the same weights."""
    small = dict(out_channels=8, model_channels=16, channel_mult=(1, 2),
                 num_res_blocks=1, attention_ds=(), num_heads=2,
                 transformer_depth=1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 8, 8, 8, 16)).astype(np.float32)
    t = np.array([250], np.int32)
    jnet = JaxUNet(**small, dtype=jnp.float32)
    params = filled_params(jnet, jnp.asarray(x), jnp.asarray(t), seed=6)
    ref = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(t)))
    net = UNet3D(in_channels=16, **small, dtype=torch.float32)
    net.load_state_dict(unet_from_jax(params))
    with torch.no_grad():
        out = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    n_convs = sum(isinstance(mod, dc.Conv3x3x3) for mod in net.modules())
    assert len(card) == n_convs > 0
    assert all(c[0] == torch.float32 for c in card)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=2e-3)


def test_precision_helper_sets_both_switches():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        precision.set_float32_precision()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


class _Called(Exception):
    pass


@pytest.mark.parametrize("module,argv", [
    (train, ["none"]),
    (voxel_vae, ["--points", "p.npz", "--output", "o"]),
    (voxel_generation_single_chunk, ["--output", "o"])])
def test_every_entry_point_states_its_precision(monkeypatch, module, argv):
    """Each CLI sets the precision (TF32 off) before it builds anything."""
    def stop():
        raise _Called

    monkeypatch.setattr(module, "set_float32_precision", stop)
    with pytest.raises(_Called):
        module.main(argv, device="cpu")
