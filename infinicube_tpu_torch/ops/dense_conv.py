"""3x3x3 stride-1 SAME convolution on NDHWC tensors, forward and backward:
kernel K3 on the card, the plain versions on the CPU; and its int8 serving
variant, kernel K7 on the card.

Counterpart of ``infinicube_tpu/ops/dense_conv.py``. There the Pallas
implicit-GEMM kernel serves the UNet's convs on the TPU where its plan fits
and XLA's conv the rest, and its ``custom_vjp`` sends the output gradient
through the same kernel with flipped, in/out-swapped weights while the weight
gradient (27 tap contractions) and the bias gradient stay XLA. Here every
CUDA tensor goes to the hand-written ``conv3x3x3_bf16`` (csrc/dense_conv.cu),
whatever its width; when a gradient is asked for, a
``torch.autograd.Function`` launches K3 forward and K3 again for the input
gradient, and computes the weight gradient as 27 tap matrix products in plain
PyTorch (bf16 operands, f32 accumulation, one f32 result per tap; TF32 is
never used) and the bias gradient as a sum. A CPU tensor goes to the plain
version and autograd. A CUDA call the kernel does not take raises.

Weights keep torch's conv layout [O, C, 3, 3, 3] (``weights/from_jax.py``
turns flax's DHWIO into it). The kernel reads them as [O, 27*C] bf16 for the
forward and as [C, 27*O] bf16 (flipped, swapped) for the input gradient;
``Conv3x3x3`` packs each once per weight version and caches it. K3 takes C
and O that are multiples of 8: other widths are zero-padded on the way in
(``pad_channels``; the packs are padded when they are made) and the
output sliced back, which leaves the result exact. An f32 model's convs run
on ``conv3x3x3_f32``, forward and input gradient alike: K3's kernel in f32,
f32-accurate on the tensor cores by the 3xTF32 split (its own arithmetic:
PyTorch's library calls keep TF32 off), with the same channel multiple of 8
and an f32 pack of the weights' tf32 hi and lo parts.

The int8 variant (``quant=True``, the reference's ``quant=True`` path,
selected by ``DiffusionConfig.serve_quant``) quantizes x per input channel
over the whole batch and folds those scales into the weights (rounded to x's
dtype first, the reference's promote_dtype), which are then quantized per
(dx, output channel) (``quantize_for_conv``, the reference's
``_quantize_for_conv``). K7 (``conv3x3x3_int8``, csrc/dense_conv.cu) sums the
int8 products in int32 per dx group, dequantizes each group with its scales
and adds the three in the reference's order, bit for bit as
``conv3x3x3_int8_plain``. It applies only where ``int8_conv_applies`` holds,
as the reference quantizes only where its plan fits; elsewhere the conv
stays bf16 (K3). K7 takes C and O that are multiples of 32, so its operands
are zero-padded to them. On the card the quantization itself runs in three
kernels of the same source (``int8_conv_operands``): the per-channel max of
|x|, x8 written at the padded width, and the weights (read from the f32
parameter) folded, quantized and packed; each equals its plain version here
(``int8_conv_amax_plain``, ``int8_conv_quantize_x_plain``,
``int8_conv_quantize_w_plain``), and together they equal
``quantize_for_conv`` followed by ``pad_channels`` and
``pack_int8_weight``. The weights are quantized anew on every call: their
scales depend on that call's activations."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.nn.quant import amax_scale
from infinicube_tpu_torch.ops.window_conv import tf32_split


# the reference kernel's VMEM budget, which decides where it quantizes
_VMEM_BUDGET = 12 * 1024 * 1024


def int8_conv_applies(shape, C: int, O: int) -> bool:
    """Whether the reference quantizes the conv of x [B, D, H, W, C] -> O:
    the ``quant=True`` branch of its ``conv_plan_feasible`` (dense_conv.py
    :74-126), which looks for a row tile and channel chunks of its Pallas
    kernel that fit the TPU's 12 MiB VMEM budget with 32-row int8 tiles.
    The budget means nothing on this card; the rule is kept because it
    decides which convs of the UNet are int8, and with it the outputs."""
    _, D, H, W = shape
    if C < 64 or O < 64 or min(D, H, W) < 3:
        return False
    if C % 8 or O % 8 or W % 8:
        return False

    def divisors_desc(n):
        return [d for d in range(n, 0, -1) if n % d == 0]

    oblks = [O] + [o for o in divisors_desc(O) if o % 128 == 0 and o < O]
    cblks = [C] + [c for c in divisors_desc(C) if c % 128 == 0 and c < C]
    for oblk in oblks:
        for cblk in cblks:
            chunks = (O // oblk) * (C // cblk)
            wbuf = 1 if chunks == 1 else 2
            for by in divisors_desc(H):
                R = by * W
                if R < 128 or R > 4096 or R % 32:
                    continue
                if chunks > 1 and R < 512:
                    continue
                vmem = (2 * 9 * R * cblk + R * 9 * cblk
                        + wbuf * 9 * cblk * 3 * oblk + R * 3 * oblk * 4
                        + R * 3 * oblk * 4 + 2 * R * oblk * 2)
                if vmem <= _VMEM_BUDGET:
                    return True
    return False


def _quantize_weight(w: torch.Tensor, sc: torch.Tensor):
    """w [O, C, 3, 3, 3] folded with the per-input-channel scales sc and
    quantized per (dx, output channel): (w8, sw [3, O])."""
    wf = w.float() * sc[None, :, None, None, None]
    sw = amax_scale(wf.abs().amax(dim=(1, 2, 3))).t()           # [3, O]
    w8 = torch.round(wf / sw.t()[:, None, None, None, :]).to(torch.int8)
    return w8, sw.contiguous()


def quantize_for_conv(x: torch.Tensor, w: torch.Tensor):
    """The reference's ``_quantize_for_conv``: x [B, D, H, W, C] gets one
    scale per input channel over the whole batch (a CFG pair's two halves
    share them), folded exactly into w [O, C, 3, 3, 3], which gets one scale
    per (dx, output channel). Returns x8 int8 like x, w8 int8 like w and
    sw f32 [3, O]."""
    xf = x.float()
    sc = amax_scale(xf.abs().amax(dim=(0, 1, 2, 3)))
    x8 = torch.round(xf / sc).to(torch.int8)
    w8, sw = _quantize_weight(w, sc)
    return x8, w8, sw


# the channel multiples the card's kernels take: K3 8, K7 32, the f32 conv 8
# (its k8 step; TMA wants 16-byte strides)
K3_MULTIPLE, K7_MULTIPLE = 8, 32
_MULTIPLE = {torch.bfloat16: K3_MULTIPLE, torch.float32: K3_MULTIPLE}


def pad_channels(t: torch.Tensor, multiple: int, *dims: int) -> torch.Tensor:
    """t with each of ``dims`` zero-padded at its end up to a multiple of
    ``multiple``. The card's convs take x [..., C] padded along -1, w
    [O, C, 3, 3, 3] along 0 and 1, the bias [O] along 0 and the int8 scales
    sw [3, O] along 1: the padded input channels meet zero weights and the
    caller drops the padded outputs (``out[..., :O]``), so the conv's result
    is unchanged."""
    pad = [0] * (2 * t.dim())
    for d in dims:
        pad[2 * (t.dim() - 1 - d % t.dim()) + 1] = -t.shape[d] % multiple
    return F.pad(t, pad) if any(pad) else t


def pack_int8_weight(w8: torch.Tensor) -> torch.Tensor:
    """int8 [O, C, 3, 3, 3] -> [O, 27*C] with k = (dx*9 + dz*3 + dy)*C + c:
    each dx group is one contiguous third of a row, so K7 sums it in int32
    and dequantizes it with its own scales."""
    O, C = w8.shape[:2]
    return w8.permute(0, 4, 2, 3, 1).reshape(O, 27 * C).contiguous()


def int8_conv_amax_plain(x: torch.Tensor) -> torch.Tensor:
    """What ``kernels.int8_conv_amax`` computes: max |x| per channel over
    all voxels of the batch, f32 [C]."""
    return x.float().abs().amax(dim=(0, 1, 2, 3))


def int8_conv_quantize_x_plain(x: torch.Tensor,
                               amax: torch.Tensor) -> torch.Tensor:
    """What ``kernels.int8_conv_quantize_x`` computes: x8 =
    round(x / sc) with sc from amax, zero-padded to a multiple of 32
    channels."""
    x8 = torch.round(x.float() / amax_scale(amax)).to(torch.int8)
    return pad_channels(x8, K7_MULTIPLE, -1).contiguous()


def int8_conv_quantize_w_plain(w: torch.Tensor, amax: torch.Tensor):
    """What ``kernels.int8_conv_quantize_w`` computes: w rounded to bf16,
    folded with the scales of amax and quantized (``quantize_for_conv``'s
    weight half), then padded and packed for K7: (the dx-major pack
    [Op, 27*Cp], sw [3, Op])."""
    w8, sw = _quantize_weight(w.to(torch.bfloat16), amax_scale(amax))
    return (pack_int8_weight(pad_channels(w8, K7_MULTIPLE, 0, 1)),
            pad_channels(sw, K7_MULTIPLE, 1).contiguous())


def int8_conv_operands(x: torch.Tensor, w: torch.Tensor):
    """K7's operands for bf16 x [B, D, H, W, C] and w [O, C, 3, 3, 3] (f32
    or bf16; rounded to bf16): x8 [B, D, H, W, Cp], the dx-major pack
    [Op, 27*Cp] and sw [3, Op], zero-padded to multiples of 32, as
    ``quantize_for_conv`` followed by ``pad_channels`` and
    ``pack_int8_weight`` gives them: the three prologue kernels on the
    card, their plain versions on the CPU."""
    if _on_card(x):
        amax = kernels.int8_conv_amax(x)
        w8p, sw = kernels.int8_conv_quantize_w(w, amax)
        return kernels.int8_conv_quantize_x(x, amax), w8p, sw
    amax = int8_conv_amax_plain(x)
    return (int8_conv_quantize_x_plain(x, amax),
            *int8_conv_quantize_w_plain(w, amax))


# keeps every f32 partial sum of int8 products below 2^24 (exact)
_EXACT_CHUNK = 1024


def conv3x3x3_int8_plain(x8: torch.Tensor, w8: torch.Tensor,
                         sw: torch.Tensor, bias: torch.Tensor,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """What K7 computes, as the reference's int8 kernel does: for each dx the
    exact integer sum over (dz, dy, c) of x8 * w8, rounded to f32 and times
    sw[dx]; then t1 + t0, + t2, + the f32 bias, cast to ``out_dtype``. A dx
    group sums up to 9*C products of up to 127^2, above 2^24 at the UNet's
    widths, so the sums are taken as f32 products over at most 1,024
    channels (exact) added in f64 (exact)."""
    B, D, H, W, C = x8.shape
    O = w8.shape[0]
    xp = torch.nn.functional.pad(x8.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    t = []
    for dx in range(3):
        acc = torch.zeros((B * D * H * W, O), dtype=torch.float64,
                          device=x8.device)
        for dz in range(3):
            for dy in range(3):
                xs = xp[:, dz:dz + D, dy:dy + H, dx:dx + W].reshape(-1, C)
                wt = w8[:, :, dz, dy, dx].float().t()          # [C, O]
                for c0 in range(0, C, _EXACT_CHUNK):
                    acc += (xs[:, c0:c0 + _EXACT_CHUNK] @
                            wt[c0:c0 + _EXACT_CHUNK]).double()
        t.append(acc.float() * sw[dx])
    out = (t[1] + t[0]) + t[2]
    return (out + bias.float()).reshape(B, D, H, W, O).to(out_dtype)


def pack_conv_weight(w: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[O, C, 3, 3, 3] -> [O, 27*C] with k = (dz*9 + dy*3 + dx)*C + c, O
    and C zero-padded to multiples of 8, the layout the card's kernels
    read: bf16 for K3; for ``conv3x3x3_f32`` f32 [2, O, 27*C], its tf32 hi
    and lo parts (``window_conv.tf32_split``)."""
    w = pad_channels(w, _MULTIPLE[dtype], 0, 1)
    O, C = w.shape[:2]
    wp = w.permute(0, 2, 3, 4, 1).reshape(O, 27 * C)
    if dtype == torch.float32:
        return tf32_split(wp.float())
    return wp.to(dtype).contiguous()


def dgrad_weight(w: torch.Tensor) -> torch.Tensor:
    """[O, C, 3, 3, 3] -> [C, O, 3, 3, 3], flipped along dz, dy and dx: the
    weights whose conv over the output gradient is the input gradient (the
    reference's ``w[::-1, ::-1, ::-1]`` with in/out swapped)."""
    return w.flip(2, 3, 4).transpose(0, 1)


def conv3x3x3_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The reference's ``_xla_conv``: f32 accumulation of x's values against
    w, plus the f32 bias, cast back to x's dtype. x [B, D, H, W, C],
    w [O, C, 3, 3, 3], bias [O]."""
    out = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), w.float(), padding=1)
    out = out.permute(0, 2, 3, 4, 1) + bias.float()
    return out.to(x.dtype)


def conv_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW of the conv, f32 [O, C, 3, 3, 3]: for each of the 27 taps the
    contraction over all voxels of the tap-shifted input [V, C] with the
    output gradient [V, O] (the reference's 27 einsums). Operands keep their
    dtype (bf16 on the card), sums and results are f32."""
    B, D, H, W, C = x.shape
    O = g.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    gt = g.reshape(-1, O).t()
    taps = []
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                xs = xp[:, dz:dz + D, dy:dy + H, dx:dx + W].reshape(-1, C)
                taps.append(_mm_f32(gt, xs))
    return torch.stack(taps, dim=-1).reshape(O, C, 3, 3, 3)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation and an f32 result, whatever the operands'
    dtype (cuBLAS takes bf16 operands with an f32 output directly)."""
    if a.dtype == torch.float32:
        return a @ b
    return torch.mm(a, b, out_dtype=torch.float32)


def conv3x3x3_bwd_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """(dx, dw, db) of ``conv3x3x3_plain`` written as the reference's
    ``_conv_bwd``: dx is the conv of g with the flipped, in/out-swapped
    weights and no bias, in x's dtype; dw the 27 tap contractions and db the
    sum of g over all voxels, both in f32 arithmetic (dw in w's dtype)."""
    C = w.shape[1]
    dx = conv3x3x3_plain(g, dgrad_weight(w), torch.zeros(C, device=g.device))
    dw = conv_weight_grad(x.float(), g.float()).to(w.dtype)
    return dx.to(x.dtype), dw, g.float().sum(dim=(0, 1, 2, 3))


def _on_card(x: torch.Tensor) -> bool:
    """Whether x goes to the card's kernels (the tests route CPU tensors
    through this branch with the kernels' plain versions in their place)."""
    return x.is_cuda


def _card_conv(x: torch.Tensor, w_packed: torch.Tensor,
               bias: torch.Tensor | None, O: int) -> torch.Tensor:
    """x [..., C] through the card's kernel for x's dtype (K3 for bf16,
    ``conv3x3x3_f32`` for f32) against a pack from ``pack_conv_weight``:
    x and the bias zero-padded to the pack's widths, the output sliced back
    to O channels."""
    if x.dtype not in _MULTIPLE:
        raise ValueError(f"the card's conv3x3x3 takes bf16 or f32, got "
                         f"{x.dtype}")
    m = _MULTIPLE[x.dtype]
    x = pad_channels(x, m, -1).contiguous()
    if bias is not None:
        bias = pad_channels(bias, m, 0)
    run = kernels.conv3x3x3_bf16 if x.dtype == torch.bfloat16 else \
        kernels.conv3x3x3_f32
    out = run(x, w_packed, bias)
    return out if out.shape[-1] == O else out[..., :O].contiguous()


class _Conv3x3x3(torch.autograd.Function):
    """The card's conv forward; backward the same kernel on the output
    gradient for dx, the tap products for dW, a sum for db."""

    @staticmethod
    def forward(ctx, x, weight, bias, w_packed, w_packed_dgrad):
        ctx.save_for_backward(x, w_packed_dgrad)
        ctx.w_dtype = weight.dtype
        return _card_conv(x, w_packed, bias, weight.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w_packed_dgrad = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            if w_packed_dgrad is None:
                raise ValueError("the input gradient needs w_packed_dgrad "
                                 "(pack_conv_weight(dgrad_weight(w)))")
            dx = _card_conv(g, w_packed_dgrad, None, x.shape[-1])
        if ctx.needs_input_grad[1]:
            dw = conv_weight_grad(x, g).to(ctx.w_dtype)
        if ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 1, 2, 3))
        return dx, dw, db, None, None


def conv3x3x3(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              w_packed: torch.Tensor | None = None,
              w_packed_dgrad: torch.Tensor | None = None,
              quant: bool = False) -> torch.Tensor:
    """x [B, D, H, W, C] @ w [O, C, 3, 3, 3] + bias [O], SAME padding,
    differentiable in x, w and bias. On the card x is bf16 (K3) or f32
    (``conv3x3x3_f32``, 3xTF32), of any width, and the kernel reads
    ``w_packed`` (``pack_conv_weight(w, x.dtype)``) and, for x's gradient,
    ``w_packed_dgrad`` (``pack_conv_weight(dgrad_weight(w), x.dtype)``),
    both packed once by the caller; on the CPU the plain version runs.
    ``quant=True`` serves the int8 variant instead (K7 and its prologue
    kernels on the card, no gradient, packs made here from this call's
    quantization; w is rounded to x's dtype first, so the f32 parameter may
    be passed as it is)."""
    if quant:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            raise ValueError("the int8 conv serves only: no gradient")
        if _on_card(x):
            if x.dtype != torch.bfloat16:
                raise ValueError("the card's int8 conv writes bf16; got "
                                 f"{x.dtype} input")
            x8, w8p, sw = int8_conv_operands(x.contiguous(), w.contiguous())
            O = w.shape[0]
            out = kernels.conv3x3x3_int8(
                x8, w8p, sw,
                pad_channels(bias.float(), K7_MULTIPLE, 0).contiguous())
            return out if out.shape[-1] == O else out[..., :O].contiguous()
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return conv3x3x3_int8_plain(*quantize_for_conv(x, w.to(x.dtype)),
                                    bias, x.dtype)
    if _on_card(x):
        if w_packed is None:
            raise ValueError("the card's conv3x3x3 needs w_packed "
                             "(pack_conv_weight(w), packed once)")
        x, bias = x.contiguous(), bias.float().contiguous()
        if torch.is_grad_enabled() and \
                (x.requires_grad or w.requires_grad or bias.requires_grad):
            return _Conv3x3x3.apply(x, w, bias, w_packed, w_packed_dgrad)
        return _card_conv(x, w_packed, bias, w.shape[0])
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return conv3x3x3_plain(x, w, bias)


class Conv3x3x3(nn.Module):
    """flax ``nn.Conv(features, (3, 3, 3))`` with promote-dtype semantics
    (input, kernel and bias cast to ``dtype``; the bias then enters in f32),
    the counterpart of the JAX ``Conv3x3x3`` module. Parameters ``weight``
    [O, C, 3, 3, 3] and ``bias`` [O] stay f32. With ``quant`` the conv is
    int8 wherever ``int8_conv_applies`` holds for its input (the weights are
    quantized from their ``dtype`` cast, as the reference's promote_dtype
    runs first)."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 quant: bool = False):
        super().__init__()
        self.dtype, self.quant = dtype, quant
        self.weight = nn.Parameter(torch.empty((out_ch, in_ch, 3, 3, 3),
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))
        self._packed: tuple | None = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun_normal over the full receptive field, as the JAX module."""
        fan_in = 27 * self.weight.shape[1]
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                generator=generator)
            self.bias.zero_()

    def _packed_weight(self, dgrad: bool = False,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The forward pack or the input-gradient pack of the current
        weight in ``dtype``, cached against its address and version (every
        in-place update of the parameter, an optimizer step or
        ``load_state_dict``, raises the version)."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.device)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, {})
        packs = self._packed[1]
        if (dgrad, dtype) not in packs:
            src = w.detach()
            packs[dgrad, dtype] = pack_conv_weight(
                dgrad_weight(src) if dgrad else src, dtype)
        return packs[dgrad, dtype]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = self.bias.to(dt).float()
        if self.quant and int8_conv_applies(x.shape[:4], x.shape[-1],
                                            self.weight.shape[0]):
            # the parameter as it is: the int8 path rounds it to dt itself
            # (on the card inside the weight pass, with no copy made here)
            return conv3x3x3(x.to(dt), self.weight, bias, quant=True)
        if _on_card(x):
            if dt not in _MULTIPLE:
                raise ValueError("the card's conv3x3x3 kernels take bf16 or "
                                 f"f32; this module computes in {dt}")
            need_dx = torch.is_grad_enabled() and x.requires_grad
            return conv3x3x3(x.to(dt), self.weight, bias,
                             self._packed_weight(dtype=dt),
                             self._packed_weight(dgrad=True, dtype=dt)
                             if need_dx else None)
        return conv3x3x3(x.to(dt), self.weight.to(dt), bias)
