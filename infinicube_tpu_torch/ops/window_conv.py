"""Sparse submanifold 3x3x3 convolution on voxel rows, forward and backward:
kernels K4 and K6 on the card, the plain gather versions on the CPU.

Counterpart of ``window_sparse_conv`` in ``infinicube_tpu/ops/window_conv.py``
and its ``custom_vjp``. There a window plan (directional windows, one-hot
selection matmuls and a miss list replayed by an exact fallback) works around
the TPU's slow gathers. Here the plan is the neighbour table itself:
``ConvPlan`` holds ``int32 [B, C, 27]`` slot indices from
``grid.ops.neighbor_indexes`` (built on the card over the declared dense
bounds) and the per-batch count of active voxels outside those bounds. K4
(``sparse_conv_f32``, csrc/sparse_conv.cu) gathers the neighbour rows itself,
so nothing is missed and there is no fallback. It computes its f32 products
on the tensor cores by the 3xTF32 split: the weights go to it as
``pack_sparse_weight``'s tf32 hi and lo parts, made once per weight version
by the caller (``SparseConv3d``) or here per call.

When a gradient is asked for, a ``torch.autograd.Function`` runs the forward
and, as the JAX ``_wc_bwd`` does, the input gradient as the same stencil on
the output gradient with the reversed, transposed weights (the neighbour
relation is symmetric: ``nbr(m, t) = n`` iff ``nbr(n, 26 - t) = m``), K4 again
on the card, and the weight gradient ``dw[t] = sum feats[nbr(., t)]^T g``,
K6 (``sparse_conv_f32_wgrad``, csrc/sparse_conv_bwd.cu) on the card, 3xTF32
too, its B operand the tf32 parts of g^T (``pack_wgrad_grad``, written by
its prologue once a call). On the CPU both come from
``sparse_conv_bwd_plain``. A CUDA tensor never takes a plain version.

On bf16 features the same three products go to their bf16 twins,
``sparse_conv_bf16`` (the forward, and as ``sparse_conv_bf16_dgrad`` the
input gradient; csrc/sparse_conv.cu) and ``sparse_conv_bf16_wgrad``
(csrc/sparse_conv_bwd.cu), one bf16 product per tensor-core step. In every
dtype the conv computes what the TPU kernels compute (``_conv_kernel``,
``_dw_kernel`` and ``_wc_bwd``): each tap's product is added into f32
sums, the forward and dx are rounded to the features' dtype once, and dW
is an f32 sum rounded to the weight's dtype once. The plain versions do
the same, so they are the kernels' oracle in bf16 too.

The f32 kernels take widths that are multiples of 4, the bf16 ones of 8
(``width_multiple``). On the card other widths are zero-padded on the way
in (feats, the output gradient and the weight packs, ``pad_width``) and
the output, dx and dW sliced back: the zero columns and rows add nothing
to any product, so this is exact.

The loud policy stays: a batch element whose active voxels fall outside the
declared dense bounds (its lookup would be wrong) gets NaN in every row of
the forward output, as an overflowed window plan does in JAX; as there, the
backward itself poisons nothing (the NaN output has made the loss NaN
already)."""

from __future__ import annotations

import dataclasses

import torch

from infinicube_tpu_torch import kernels


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Per-grid sparse-conv plan (build once per grid, reuse per conv)."""
    nbr: torch.Tensor         # int32 [B, C, 27] slot of each tap, -1 absent
    violations: torch.Tensor  # int32 [B] active voxels outside dense bounds

    @property
    def overflowed(self) -> torch.Tensor:
        """bool [B]: True where the lookup is inexact (NaN-poisoned conv)."""
        return self.violations > 0


def gather_neighbor_features(feats: torch.Tensor, nbr: torch.Tensor,
                             tap: int) -> torch.Tensor:
    """feats [B, C, F], nbr int32 [B, C, K] -> tap features [B, C, F]
    (zeros where the neighbour is absent)."""
    idx = nbr[:, :, tap].long()
    got = torch.gather(feats, 1, idx.clamp_min(0)[..., None].expand(
        -1, -1, feats.shape[-1]))
    return torch.where((idx >= 0)[..., None], got, torch.zeros_like(got))


def _stencil(feats: torch.Tensor, nbr: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """sum_t feats[nbr(., t)] @ w[t], every tap's product added into an
    f32 sum and rounded to feats' dtype once (the TPU kernel's ``acc``)."""
    acc = torch.zeros(feats.shape[:2] + (w.shape[-1],), dtype=torch.float32,
                      device=feats.device)
    for t in range(w.shape[0]):
        acc = acc + gather_neighbor_features(feats, nbr, t).float() @ \
            w[t].float()
    return acc.to(feats.dtype)


def sparse_conv_plain(plan: ConvPlan, feats: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """The reference's gather-GEMM: 27 row gathers and matmuls, summed in
    f32 and rounded to feats' dtype once."""
    out = _stencil(feats, plan.nbr, w)
    return torch.where(plan.overflowed[:, None, None],
                       torch.full_like(out, float("nan")), out)


def rev_w(w: torch.Tensor) -> torch.Tensor:
    """The transposed stencil: ``w_rev[t] = w[26 - t].T`` ([27, F, Fo] ->
    [27, Fo, F]; offsets negate under reversal of the row-major 3^3 tap
    list)."""
    return w.flip(0).transpose(1, 2)


def tf32_truncate(t: torch.Tensor) -> torch.Tensor:
    """f32 t with the low 13 mantissa bits cleared: the tf32 value the
    tensor cores read."""
    return (t.contiguous().view(torch.int32) & -8192).view(torch.float32)


def tf32_split(t: torch.Tensor) -> torch.Tensor:
    """f32 t as its two tf32 parts, f32 [2, *t.shape]: hi = tf32(t) and
    lo = tf32(t - hi) (t - hi is exact), the operand packs of the 3xTF32
    kernels."""
    hi = tf32_truncate(t)
    return torch.stack([hi, tf32_truncate(t - hi)])


def width_multiple(dtype: torch.dtype) -> int:
    """The widths the sparse-conv kernels of ``dtype`` take are multiples
    of this: a row is gathered in 16-byte pieces."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def pad_width(t: torch.Tensor, *dims: int) -> torch.Tensor:
    """t zero-padded at the end of each of ``dims`` to a multiple of
    ``width_multiple(t.dtype)`` (t itself where nothing is padded)."""
    mult = width_multiple(t.dtype)
    pad = [0] * (2 * t.dim())
    for dim in dims:
        pad[2 * (t.dim() - 1 - dim % t.dim()) + 1] = (-t.shape[dim]) % mult
    return torch.nn.functional.pad(t, pad) if any(pad) else t


def pack_sparse_weight(w: torch.Tensor, dgrad: bool = False) -> torch.Tensor:
    """K4's weight operand for w [27, F, Fo], each tap's matrix w' laid out
    [N, K] (the reduction dim contiguous), F and Fo zero-padded first
    (``pad_width``). The forward's w' is w[t]^T (N = Fo, K = F); the input
    gradient's (``dgrad``) is ``rev_w(w)[t]^T = w[26 - t]`` (N = F,
    K = Fo). f32 w: f32 [2, 27, N, K], the tf32 hi = tf32(w') and lo =
    tf32(w' - hi) (the 3xTF32 operands); bf16 w: bf16 [27, N, K], w' as it
    is."""
    w = pad_width(w, 1, 2)
    w = w.flip(0) if dgrad else w.transpose(1, 2)
    if w.dtype == torch.bfloat16:
        return w.contiguous()
    return tf32_split(w.float())


def pack_wgrad_grad(g: torch.Tensor) -> torch.Tensor:
    """K6's B operand for the output gradient g [B, C, Fo]: f32 [2, Fo, ld],
    the tf32 hi and lo parts of g^T with the rows of every batch element
    along the reduction dim, zero-padded to ld = B * C rounded up to 4. It
    serves all 27 taps; the kernel's prologue writes it once a call."""
    gt = g.reshape(-1, g.shape[-1]).t()
    return tf32_split(torch.nn.functional.pad(gt.float(),
                                              (0, (-gt.shape[1]) % 4)))


def sparse_conv_bwd_plain(plan: ConvPlan, feats: torch.Tensor,
                          w: torch.Tensor, g: torch.Tensor):
    """(dx, dw) of the conv for the output gradient g [B, C, Fo], written as
    the reference's ``_wc_bwd``: dx[m] = sum_t g[nbr(m, t)] @ w_rev[t]
    (nothing poisoned) summed in f32 and rounded to feats' dtype once,
    dw[t] = sum over batch and rows of feats[nbr(., t)]^T g in f32, rounded
    to w's dtype once."""
    dx = _stencil(g, plan.nbr, rev_w(w)).to(feats.dtype)
    gf = g.reshape(-1, g.shape[-1]).float()
    dw = []
    for t in range(w.shape[0]):
        tap = gather_neighbor_features(feats, plan.nbr, t)
        dw.append(tap.reshape(-1, tap.shape[-1]).float().t() @ gf)
    return dx, torch.stack(dw).to(w.dtype)


# the card's forward / input-gradient and weight-gradient kernels by dtype
_CARD_CONV = {torch.float32: ("sparse_conv_f32", "sparse_conv_f32_wgrad"),
              torch.bfloat16: ("sparse_conv_bf16", "sparse_conv_bf16_wgrad")}


def _card_kernels(dtype: torch.dtype):
    if dtype not in _CARD_CONV:
        raise ValueError(f"the card's sparse conv takes f32 or bf16, got "
                         f"{dtype}")
    return tuple(getattr(kernels, name) for name in _CARD_CONV[dtype])


def _forward(plan: ConvPlan, feats: torch.Tensor, w: torch.Tensor,
             w_pack: torch.Tensor | None = None) -> torch.Tensor:
    if feats.is_cuda:
        conv, _ = _card_kernels(feats.dtype)
        out = conv(pad_width(feats, -1).contiguous(), plan.nbr.contiguous(),
                   pack_sparse_weight(w.to(feats.dtype)) if w_pack is None
                   else w_pack,
                   plan.violations.to(torch.int32).contiguous())
        return out[..., :w.shape[-1]]
    if feats.device.type != "cpu":
        raise ValueError(f"unsupported device {feats.device}")
    return sparse_conv_plain(plan, feats, w)


class _WindowSparseConv(torch.autograd.Function):
    """K4 forward; backward K4 on the output gradient with ``rev_w(w)``'s
    pack and no poison for dx, K6 for dw rounded to w's dtype (the bf16
    twins on bf16 features; the plain versions on the CPU), each only when
    asked for."""

    @staticmethod
    def forward(ctx, feats, w, plan, w_pack, w_pack_dgrad):
        ctx.plan, ctx.on_card = plan, feats.is_cuda
        ctx.w_pack_dgrad = w_pack_dgrad
        ctx.save_for_backward(feats, w)
        return _forward(plan, feats, w, w_pack)

    @staticmethod
    def backward(ctx, g):
        feats, w = ctx.saved_tensors
        plan = ctx.plan
        need_dx, need_dw = ctx.needs_input_grad[:2]
        g = g.to(feats.dtype).contiguous()
        if not ctx.on_card:
            dx, dw = sparse_conv_bwd_plain(plan, feats, w, g)
            return (dx if need_dx else None, dw if need_dw else None, None,
                    None, None)
        dx = dw = None
        nbr = plan.nbr.contiguous()
        F, Fo = w.shape[1:]
        conv, wgrad = _card_kernels(feats.dtype)
        g = pad_width(g, -1)
        if need_dx:
            # the caller's pack, else made here from the weight as it is now
            pack = ctx.w_pack_dgrad
            if pack is None:
                pack = pack_sparse_weight(w.to(feats.dtype), dgrad=True)
            dx = conv(g, nbr, pack,
                      torch.zeros_like(plan.violations, dtype=torch.int32),
                      dgrad=True)[..., :F]
        if need_dw:
            dw = wgrad(pad_width(feats, -1).contiguous(), nbr,
                       g)[:, :F, :Fo].to(w.dtype)
        return dx, dw, None, None, None


def window_sparse_conv(plan: ConvPlan, feats: torch.Tensor, w: torch.Tensor,
                       w_pack: torch.Tensor | None = None,
                       w_pack_dgrad: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Sparse submanifold 3^3 conv: feats [B, C, F], w [27, F, Fo]
    (``neighbor_offsets`` tap order, SparseConv3d's kernel layout) ->
    [B, C, Fo] in feats' dtype, differentiable in feats and w. Rows of a
    batch element with dense-bounds violations are NaN. On the card feats
    must be f32 or bf16, w of the same dtype (any widths: they are padded to
    ``width_multiple`` and the results sliced); ``w_pack`` and
    ``w_pack_dgrad`` are ``pack_sparse_weight(w)`` and
    ``pack_sparse_weight(w, dgrad=True)`` where the caller keeps them per
    weight version (made here when not given)."""
    if torch.is_grad_enabled() and (feats.requires_grad or w.requires_grad):
        return _WindowSparseConv.apply(feats, w, plan, w_pack, w_pack_dgrad)
    return _forward(plan, feats, w, w_pack)
