"""The arithmetic of the card's f32 conv and f32 attention on the CPU.

Both kernels (``conv3x3x3_f32`` in csrc/dense_conv.cu, ``flash_attn_f32`` in
csrc/flash_attention_f32.cu) take their f32 products on the tensor cores by
the 3xTF32 split: each operand a becomes hi = tf32(a) (the low 13 mantissa
bits cleared, as ``window_conv.tf32_truncate`` does) and lo = tf32(a - hi),
and a product is lo_A hi_B + hi_A lo_B + hi_A hi_B. Here that arithmetic is
emulated in plain PyTorch as the tensor cores run it: every k8 step of a
``wgmma`` adds its eight exact tf32 products to the running sum and
truncates the result to f32 (round toward zero), and the kernels move their
sums into f32 sums of their own with rounded adds (the conv every 32 k8
steps, the attention every key tile at d <= 96), because that truncation
drifts over a long K. The emulation is held against an f64 reference at the
gate ``chip_smoke.py`` applies, max-abs <= 1e-4 * max|ref|: the conv at the
release UNet's widths up to K = 27 * 1,536, also summed in K slices as the
split-K shapes are; the attention's logits, its online softmax over key
tiles and PV, also with the keys split into ranges and merged. One TF32
product alone misses the gate, which is why the kernels take three. The f32
conv's zero-padded route (C and O to multiples of 8, the pack of hi and lo)
gives the unpadded conv. Nothing here imports JAX."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.ops import dense_conv as dc
from infinicube_tpu_torch.ops.window_conv import tf32_split

GATE = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch thread for the module: the suite runs files in parallel
    workers, and a thread per core in each of them oversubscribes the
    machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def _im2col(x):
    """x [B, D, H, W, C] -> [B*D*H*W, 27*C] with k = (dz*9 + dy*3 + dx)*C + c,
    the order of ``pack_conv_weight``'s rows; zeros outside the volume."""
    B, D, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    cols = [xp[:, dz:dz + D, dy:dy + H, dx:dx + W].reshape(-1, C)
            for dz in range(3) for dy in range(3) for dx in range(3)]
    return torch.cat(cols, dim=1)


def rz(x64):
    """f64 values rounded to f32 toward zero, as the tensor cores round the
    sums they accumulate."""
    r = x64.float()
    return torch.where(r.double().abs() > x64.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def k8_steps(acc, a_parts, b_parts, k0, fresh):
    """One wgmma k8 step of the 3xTF32 products from K index k0: for each
    of the products in order, acc = rz(acc + the eight exact products),
    the first overwriting acc where ``fresh``."""
    ks = slice(k0, k0 + 8)
    for i, (a, b) in enumerate(zip(a_parts, b_parts)):
        prod = a[:, ks].double() @ b[ks].double()
        acc = rz(prod if fresh and i == 0 else acc.double() + prod)
    return acc


def conv_emulation(x, pack, bias, slices=1, passes=3, flush=32):
    """What ``conv3x3x3_f32`` computes from x [B, D, H, W, C] and its pack
    [2, O, 27*C] (C a multiple of 8): K walked as the kernel walks it, a tap
    at a time in iterations of 32 channels (8 or 16 where C is that narrow;
    the channels a box row reads past C are zeros), each A row split into
    tf32 hi and lo, each k8 step a tensor-core sum, the sums flushed into
    rounded f32 sums at every multiple of ``flush`` k8 steps (None: one sum
    over K), over ``slices`` K slices (cut at iterations, as the kernel's
    plan cuts them) summed in order, plus the bias; ``passes`` 1 keeps only
    hi_A hi_B."""
    C, O = x.shape[-1], pack.shape[1]
    bkc = 8 if C <= 8 else 16 if C <= 16 else 32
    x = dc.pad_channels(x, bkc, -1)
    pack = dc.pad_channels(pack.reshape(2, O, 27, C), bkc, -1).reshape(
        2, O, -1)
    a_hi, a_lo = tf32_split(_im2col(x))
    b_hi, b_lo = pack[0].t(), pack[1].t()
    a_parts, b_parts = (a_lo, a_hi, a_hi), (b_hi, b_lo, b_hi)
    if passes == 1:
        a_parts, b_parts = (a_hi,), (b_hi,)
    steps = a_hi.shape[1] // 8
    per = -(-(steps * 8 // bkc) // slices) * (bkc // 8)  # k8 steps a slice
    out = None
    for s0 in range(0, steps, per):
        total = torch.zeros((a_hi.shape[0], b_hi.shape[1]))
        acc = None
        for j in range(s0, min(steps, s0 + per)):
            fresh = acc is None
            acc = k8_steps(acc, a_parts, b_parts, 8 * j, fresh)
            if flush and (j + 1) % flush == 0:
                total, acc = total + acc, None
        if acc is not None:
            total = total + acc
        out = total if out is None else out + total
    out = out + (0.0 if bias is None else bias)
    return out.reshape(x.shape[:4] + (pack.shape[1],))


def conv_f64(x, w, bias):
    out = F.conv3d(x.double().permute(0, 4, 1, 2, 3), w.double(), padding=1)
    return out.permute(0, 2, 3, 4, 1) + bias.double()


def _conv_case(n, C, O, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((1, n, n, n, C), generator=g)
    w = torch.randn((O, C, 3, 3, 3), generator=g) / math.sqrt(27 * C)
    b = 0.1 * torch.randn(O, generator=g)
    return x, w, b


# the release UNet's conv widths on small cubes (64 of their output
# channels: each is summed on its own); the widest reaches K = 27 * 1,536 =
# 41,472, the 8^3 and 16^3 convs' reduction
@pytest.mark.parametrize("n,C,O", [(4, 16, 64), (4, 192, 64), (3, 384, 64),
                                   (2, 1152, 64), (2, 1536, 64)])
def test_three_tf32_products_hold_the_conv_gate(n, C, O):
    x, w, b = _conv_case(n, C, O, seed=C + O)
    ref = conv_f64(x, w, b)
    got = conv_emulation(x, dc.pack_conv_weight(w, torch.float32), b)
    assert _err(got, ref) <= GATE
    # the input gradient: the output gradient through the flipped, swapped
    # pack, no bias
    go = torch.randn((1, n, n, n, O), generator=torch.Generator()
                     .manual_seed(n))
    ref_dx = conv_f64(go, dc.dgrad_weight(w), torch.zeros(C))
    dx = conv_emulation(
        go, dc.pack_conv_weight(dc.dgrad_weight(w), torch.float32), None)
    assert _err(dx, ref_dx) <= GATE


@pytest.mark.parametrize("slices", [2, 8])
def test_split_k_slices_hold_the_conv_gate(slices):
    """The small-M shapes (8^3, 16^3 at 1,536 channels) sum K in slices of
    f32 partials, added in slice order."""
    x, w, b = _conv_case(2, 1536, 64, seed=slices)
    pack = dc.pack_conv_weight(w, torch.float32)
    got = conv_emulation(x, pack, b, slices=slices)
    assert _err(got, conv_f64(x, w, b)) <= GATE
    assert torch.equal(got, conv_emulation(x, pack, b, slices=slices))


def test_flushing_bounds_the_truncation_drift():
    """Without its flushes the conv's one tensor-core sum over K = 27 *
    1,152 drifts (every step truncates toward zero) to several times the
    flushed sums' error; the kernel flushes every 32 k8 steps."""
    x, w, b = _conv_case(2, 1152, 64, seed=9)
    pack = dc.pack_conv_weight(w, torch.float32)
    ref = conv_f64(x, w, b)
    flushed = _err(conv_emulation(x, pack, b), ref)
    assert flushed <= GATE / 10
    assert _err(conv_emulation(x, pack, b, flush=None), ref) > 3 * flushed


def test_one_tf32_product_misses_the_conv_gate():
    x, w, b = _conv_case(2, 1536, 64, seed=5)
    one = conv_emulation(x, dc.pack_conv_weight(w, torch.float32), b,
                         passes=1)
    assert _err(one, conv_f64(x, w, b)) > 2 * GATE


def test_padded_f32_route_equals_the_unpadded_conv(monkeypatch):
    """20 -> 36 channels through ``Conv3x3x3`` on the card's branch (CPU
    tensors, the kernel replaced by its emulation): the kernel sees 24 -> 40
    and a [2, 40, 27*24] pack, the route's output is the kernel's sliced
    back, and it is the unpadded conv's within the gate (the padded
    channels add exact zeros); the input gradient likewise."""
    seen = []

    def f32_conv(x, pack, bias):
        C, O = x.shape[-1], pack.shape[1]
        assert C % 8 == 0 and O % 8 == 0 and pack.shape == (2, O, 27 * C)
        seen.append((C, O, bias is None))
        return conv_emulation(x, pack, bias)

    monkeypatch.setattr(dc, "_on_card", lambda x: True)
    monkeypatch.setattr(kernels, "conv3x3x3_f32", f32_conv)
    x, w, b = _conv_case(5, 20, 36, seed=11)
    m = dc.Conv3x3x3(20, 36, dtype=torch.float32)
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
    m.requires_grad_(False)
    xg = x.clone().requires_grad_()
    out = m(xg)
    go = torch.randn(out.shape, generator=torch.Generator().manual_seed(12))
    out.backward(go)
    assert seen == [(24, 40, False), (40, 24, True)]
    assert out.shape == (1, 5, 5, 5, 36) and out.is_contiguous()
    kernel_out = f32_conv(dc.pad_channels(x, 8, -1),
                          dc.pack_conv_weight(w, torch.float32),
                          dc.pad_channels(b, 8, 0))
    assert torch.equal(out, kernel_out[..., :36])
    assert _err(out, conv_f64(x, w, b)) <= GATE
    assert _err(out, dc.conv3x3x3_plain(x, w, b).double()) <= GATE
    ref_dx = conv_f64(go, dc.dgrad_weight(w), torch.zeros(20))
    assert _err(xg.grad, ref_dx) <= GATE


def attention_emulation(q, k, v, scale, kt=32, ranges=1, passes=3):
    """What ``flash_attn_f32`` computes for one (batch, head): q [Nq, d],
    k, v [Nk, d]. Per tile of ``kt`` keys the logits are 3xTF32 products
    in tensor-core sums (a fresh sum a tile), scaled to base 2 and run
    through the online softmax (f32 running max and sum); P is split into
    tf32 hi and lo and P V taken by three products: at d <= 96 into a fresh
    sum a tile, added into O with a rounded FMA, at d = 128 into O's own
    tensor-core sum after O is rescaled. With ``ranges`` > 1 the key tiles
    are cut into ranges, each with its own max, sum and unnormalized
    output, merged in order."""
    d = q.shape[1]
    fresh_pv = d <= 96
    qh, ql = tf32_split(q)
    q_parts = (ql, qh, qh) if passes == 3 else (qh,)
    nk = k.shape[0]
    n_tiles = -(-nk // kt)
    per = -(-n_tiles // ranges)
    parts = []
    for t0 in range(0, n_tiles, per):
        m = torch.full((q.shape[0], 1), -math.inf)
        l = torch.zeros((q.shape[0], 1))
        o = torch.zeros((q.shape[0], d))
        for t in range(t0, min(n_tiles, t0 + per)):
            kk = F.pad(k[t * kt:(t + 1) * kt], (0, 0, 0, kt))[:kt]
            vv = F.pad(v[t * kt:(t + 1) * kt], (0, 0, 0, kt))[:kt]
            kh, kl = tf32_split(kk.t().contiguous())
            k_parts = (kh, kl, kh) if passes == 3 else (kh,)
            s = None
            for c0 in range(0, d, 8):
                s = k8_steps(s, q_parts, k_parts, c0, s is None)
            s = s * (scale * math.log2(math.e))
            s[:, nk - t * kt:] = -math.inf        # keys past Nk
            mx = torch.maximum(m, s.amax(dim=1, keepdim=True))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx)
            l = l * alpha + p.sum(dim=1, keepdim=True)
            m = mx
            ph, pl = tf32_split(p)
            vh, vl = tf32_split(vv)
            p_parts = (pl, ph, ph) if passes == 3 else (ph,)
            v_parts = (vh, vl, vh) if passes == 3 else (vh,)
            if fresh_pv:
                pv = None
                for c0 in range(0, kt, 8):
                    pv = k8_steps(pv, p_parts, v_parts, c0, pv is None)
                o = (o.double() * alpha.double() + pv.double()).float()
            else:
                o = o * alpha
                for c0 in range(0, kt, 8):
                    o = k8_steps(o, p_parts, v_parts, c0, False)
        parts.append((m, l, o))
    if len(parts) == 1:
        m, l, o = parts[0]
        return o * (1.0 / l)
    mx = torch.stack([p[0] for p in parts]).amax(dim=0)
    den = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        f = torch.exp2(m - mx)
        den = den + l * f
        acc = acc + o * f
    return acc * (1.0 / den)


def attention_f64(q, k, v, scale):
    s = (q.double() @ k.double().t()) * scale
    return torch.softmax(s, dim=1) @ v.double()


def _qkv(nq, nk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((n, d))
                                  .astype(np.float32))
                 for n in (nq, nk, nk))


# the kernel's key tile at each head dim: 64 at d = 64, 32 at 96, 16 at 128;
# N = 512 and 1,000 x 777 take 4 key ranges, as the kernel splits them
@pytest.mark.parametrize("nq,nk,d,kt,ranges", [
    (512, 512, 96, 32, 1), (512, 512, 96, 32, 4), (300, 77, 64, 64, 1),
    (1000, 777, 64, 64, 4), (200, 1003, 128, 16, 7), (96, 2048, 96, 32, 1)])
def test_three_tf32_products_hold_the_attention_gate(nq, nk, d, kt, ranges):
    q, k, v = _qkv(nq, nk, d, seed=nq + nk + d)
    scale = d ** -0.5
    ref = attention_f64(q, k, v, scale)
    got = attention_emulation(q, k, v, scale, kt, ranges)
    assert _err(got, ref) <= GATE


def test_one_tf32_product_misses_the_attention_gate():
    q, k, v = _qkv(256, 1024, 96, seed=3)
    # logits of a few units, as a trained model's are: rounding q and k to
    # tf32 moves them by about 1e-3, which the softmax passes on
    q = q * 3
    ref = attention_f64(q, k, v, 96 ** -0.5)
    one = attention_emulation(q, k, v, 96 ** -0.5, passes=1)
    assert _err(one, ref) > 2 * GATE
