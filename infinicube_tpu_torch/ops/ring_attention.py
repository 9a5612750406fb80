"""Ring attention: exact softmax attention over a sequence split between
the ranks of a process group; counterpart of
``infinicube_tpu/ops/ring_attention.py``.

Each rank holds a contiguous slice of the tokens (rank order) as q, k, v
[B, N_local, h, d]. The K/V blocks go round the ring, each rank sending its
current block to rank + 1 (``torch.distributed.batch_isend_irecv``), while
every rank attends its own queries to each visiting block and folds the
result into its rows by log-sum-exp: never the [h, Nq, Nk] logits of more
than one block, and on the card not even those, since a block's attention
is one launch of the flash kernels with their lse output (K2
``flash_attn_bf16`` for bf16, ``flash_attn_f32`` for f32). The JAX ring
computes its blocks in plain ``jnp``; here they run through the same
hand-written kernels as the single-device attention, so the ring needs no
kernel of its own.

The gradient is a ``torch.autograd.Function``: the backward sends (k, v,
dk, dv) round the ring and computes each visiting block's dq, dk and dv
with the global log-sum-exp of the forward and ``attention_delta`` (K5
``flash_attn_bf16_bwd`` / ``flash_attn_f32_bwd`` on the card,
``attention_bwd_plain`` on the CPU); dq and the travelling dk, dv are summed
in f32. After P steps dk and dv are back at their owners.

The merge takes the rows in f32 (``merge``); the JAX ring rescales its
running output in the inputs' dtype. A group of one rank (or none) is one
block and no collective: the output is then the single-device attention's,
bit for bit. ``block_attend``, ``merge`` and ``block_grad`` are what a rank
calls, and ``ring_forward`` / ``ring_backward`` the ring's one order of
steps, for the ranks a process runs with the exchange it is given: one
rank and the collective shift in ``ring_attention``, P virtual ranks on
one device and a rotation of their blocks in ``ring_attention_virtual``
(the tests and the card's smoke run use it)."""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.ops.attention import (_on_card, attention_bwd_plain,
                                                attention_delta,
                                                attention_plain, pad_head_dim)


def block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float):
    """One block: q [B, Nq, h, d] against k/v [B, Nk, h, d] -> (o [B, Nq,
    h, d] in q's dtype, normalised within the block; lse f32 [B, h, Nq],
    the natural log-sum-exp of each row's scaled logits)."""
    if _on_card(q):
        d = q.shape[-1]
        qp, kp, vp = (pad_head_dim(t) for t in (q, k, v))
        fn = kernels.flash_attn_f32 if q.dtype == torch.float32 else \
            kernels.flash_attn_bf16
        o, lse = fn(qp, kp, vp, scale, return_lse=True)
        return (o if qp is q else o[..., :d]), lse
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return attention_plain(q, k, v, scale, return_lse=True)


def merge(o: torch.Tensor | None, lse: torch.Tensor | None,
          o_b: torch.Tensor, lse_b: torch.Tensor):
    """Fold a block's (o_b, lse_b) into the rows' running (o f32, lse f32):
    lse' = logaddexp(lse, lse_b), o' = o e^(lse - lse') + o_b e^(lse_b -
    lse'). The first block (o None) is taken as it is, in f32."""
    if o is None:
        return o_b.float(), lse_b
    new = torch.logaddexp(lse, lse_b)
    a = torch.exp(lse - new).transpose(1, 2)[..., None]
    b = torch.exp(lse_b - new).transpose(1, 2)[..., None]
    return o * a + o_b.float() * b, new


def block_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
               scale: float):
    """One block's share of the gradient, (dq, dk, dv) in the inputs'
    dtypes: the rows' output o and its gradient do, lse the rows' global
    log-sum-exp (over every block), so that the block's softmax terms are
    the full attention's."""
    if _on_card(q):
        d = q.shape[-1]
        qp, kp, vp, dop = (pad_head_dim(t) for t in (q, k, v, do.contiguous()))
        fn = kernels.flash_attn_f32_bwd if q.dtype == torch.float32 else \
            kernels.flash_attn_bf16_bwd
        grads = fn(qp, kp, vp, dop, lse, attention_delta(o, do), scale)
        return grads if qp is q else tuple(g[..., :d] for g in grads)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return attention_bwd_plain(q, k, v, o, do, lse, scale)


def _acc(total: torch.Tensor | None, part: torch.Tensor) -> torch.Tensor:
    """An f32 running sum of gradient parts."""
    return part.float() if total is None else total + part.float()


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _shift(group, *tensors):
    """Send ``tensors`` to the next rank of ``group`` and return the
    previous rank's (the ring's one exchange)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def collective_exchange(group):
    """The exchange of a rank in ``group``: its one-element lists of blocks
    sent to the next rank, the previous rank's received."""
    def exchange(*lists):
        return [[t] for t in _shift(group, *(b[0] for b in lists))]
    return exchange


def virtual_exchange(*lists):
    """The exchange of P virtual ranks on one device: each list of the
    ranks' blocks rotated by one, rank r taking rank r - 1's."""
    return [b[-1:] + b[:-1] for b in lists]


def ring_forward(qs, ks, vs, scale, world, exchange):
    """The ring's forward for the ranks this process runs: qs, ks, vs their
    blocks (one per rank), ``world`` steps, the K/V blocks passed on by
    ``exchange`` between them. Returns each rank's (o in q's dtype, lse
    f32)."""
    acc = [merge(None, None, *block_attend(q, k, v, scale))
           for q, k, v in zip(qs, ks, vs)]
    for _ in range(world - 1):
        ks, vs = exchange(ks, vs)
        acc = [merge(o, lse, *block_attend(q, k, v, scale))
               for (o, lse), q, k, v in zip(acc, qs, ks, vs)]
    return [(o.to(q.dtype), lse) for (o, lse), q in zip(acc, qs)]


def ring_backward(qs, ks, vs, outs, dos, lses, scale, world, exchange):
    """The ring's backward for the ranks this process runs (as
    ``ring_forward``): each step every rank's dq gathers its part of the
    visiting block and the block's dk, dv theirs, then (k, v, dk, dv) move
    on; after ``world`` steps one more exchange takes dk and dv home.
    Returns each rank's (dq, dk, dv) in the inputs' dtypes."""
    n = len(qs)
    dqs, dks, dvs = [None] * n, [None] * n, [None] * n
    for step in range(world):
        for i in range(n):
            gq, gk, gv = block_grad(qs[i], ks[i], vs[i], outs[i], dos[i],
                                    lses[i], scale)
            dqs[i], dks[i], dvs[i] = (_acc(dqs[i], gq), _acc(dks[i], gk),
                                      _acc(dvs[i], gv))
        if step < world - 1:
            ks, vs, dks, dvs = exchange(ks, vs, dks, dvs)
    if world > 1:
        # the block held now is rank + 1's: its sums go home
        dks, dvs = exchange(dks, dvs)
    return [(dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype))
            for dq, dk, dv, q in zip(dqs, dks, dvs, qs)]


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group):
        scale = 1.0 / math.sqrt(q.shape[-1])
        (o, lse), = ring_forward([q], [k], [v], scale, _world(group),
                                 collective_exchange(group))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.group = scale, group
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        (dq, dk, dv), = ring_backward([q], [k], [v], [o], [do], [lse],
                                      ctx.scale, _world(ctx.group),
                                      collective_exchange(ctx.group))
        return dq, dk, dv, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Exact softmax attention (scale 1/sqrt(d)) of this rank's rows: q, k,
    v [B, N_local, h, d], the rank's contiguous slice of the tokens in rank
    order within ``group`` (None: one rank). Returns [B, N_local, h, d] in
    q's dtype, differentiable in q, k and v."""
    return _RingAttention.apply(q, k, v, group)


def ring_attention_virtual(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           world: int, do: torch.Tensor | None = None):
    """The ring of ``world`` ranks run on one device: q, k, v [B, N, h, d]
    whole, split into ``world`` contiguous slices, ``ring_forward`` and
    ``ring_backward`` run for all of them with the exchange a rotation of
    the slices (``virtual_exchange``). Returns the output [B, N, h, d] and,
    given its gradient ``do``, also (dq, dk, dv)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs, ks, vs = (list(t.chunk(world, dim=1)) for t in (q, k, v))
    fwd = ring_forward(qs, ks, vs, scale, world, virtual_exchange)
    out = torch.cat([o for o, _ in fwd], dim=1)
    if do is None:
        return out
    grads = ring_backward(qs, ks, vs, [o for o, _ in fwd],
                          list(do.chunk(world, dim=1)),
                          [lse for _, lse in fwd], scale, world,
                          virtual_exchange)
    return out, tuple(torch.cat(parts, dim=1) for parts in zip(*grads))
