"""UMT5-style text encoder (umt5-xxl shape by default); counterpart of
``infinicube_tpu/models/wan/t5.py``: per-layer relative position bias,
RMSNorm pre-norm, gated-GELU FFN, masked outputs zeroed. The projections'
weights and the token embedding are held in ``cfg.dtype``, the precision they
compute in (the JAX tower casts its f32 ones at each call, to the same
values): the released umt5-xxl is bf16, 11.4 GB so, not 22.7 in f32. The
norm scales and the position biases stay f32."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.nn.layers import Dense, RMSNorm


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 256384          # umt5 vocab
    d_model: int = 4096
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    head_dim: int = 64
    rel_pos_buckets: int = 32
    rel_pos_max_dist: int = 128
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny(**kw) -> "T5Config":
        base = dict(vocab_size=512, d_model=64, d_ff=128, num_layers=2,
                    num_heads=4, head_dim=16)
        base.update(kw)
        return T5Config(**base)


def relative_position_bucket(rel: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """Bidirectional T5 bucket scheme (f32 log math, truncation to int, as
    the reference)."""
    nb = num_buckets // 2
    out = torch.where(rel > 0, nb, 0)
    rel = rel.abs()
    max_exact = nb // 2
    denom = torch.log(torch.tensor(max_distance / max_exact,
                                   dtype=torch.float32, device=rel.device))
    large = max_exact + (
        torch.log(rel.clamp_min(1).float() / max_exact) / denom *
        (nb - max_exact)).to(torch.int32)
    large = large.clamp_max(nb - 1)
    return out + torch.where(rel < max_exact, rel, large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.head_dim
        for name in ("q", "k", "v"):
            setattr(self, name, Dense(cfg.d_model, inner, bias=False,
                                      compute_dtype=cfg.dtype, device=device,
                                      dtype=cfg.dtype))
        self.o = Dense(inner, cfg.d_model, bias=False,
                       compute_dtype=cfg.dtype, device=device, dtype=cfg.dtype)
        self.rel_bias = nn.Parameter(
            torch.zeros(cfg.rel_pos_buckets, cfg.num_heads, device=device))

    def forward(self, x, mask):
        cfg = self.cfg
        B, L, _ = x.shape
        shape = (B, L, cfg.num_heads, cfg.head_dim)
        q, k, v = (m(x).reshape(shape) for m in (self.q, self.k, self.v))
        pos = torch.arange(L, device=x.device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           cfg.rel_pos_buckets,
                                           cfg.rel_pos_max_dist)
        bias = self.rel_bias.float()[buckets].permute(2, 0, 1)   # [h, L, L]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() + bias[None]
        logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
        attn = torch.softmax(logits, dim=-1).to(cfg.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, L, -1)
        return self.o(out)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
        self.ln1 = RMSNorm(d, device=device)
        self.attn = T5Attention(cfg, device=device)
        self.ln2 = RMSNorm(d, device=device)
        self.wi0 = Dense(d, f, bias=False, compute_dtype=dt, device=device,
                         dtype=dt)
        self.wi1 = Dense(d, f, bias=False, compute_dtype=dt, device=device,
                         dtype=dt)
        self.wo = Dense(f, d, bias=False, compute_dtype=dt, device=device,
                        dtype=dt)

    def forward(self, x, mask):
        dt = self.cfg.dtype
        x = x + self.attn(self.ln1(x).to(dt), mask)
        h = self.ln2(x).to(dt)
        h = F.gelu(self.wi0(h), approximate="tanh") * self.wi1(h)
        return x + self.wo(h)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config = T5Config(), device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, device=dev,
                                  dtype=cfg.dtype)
        self.layers = nn.ModuleList(T5Block(cfg, device=dev)
                                    for _ in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.d_model, device=dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """The reference's random fill: norm scales 1, everything else
        N(0, 0.02), drawn in f32 and rounded to the dtype held."""
        for mod in self.modules():
            if isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
        for name, p in self.named_parameters():
            if not name.endswith(("ln1.weight", "ln2.weight",
                                  "final_ln.weight")):
                p.copy_(torch.empty(p.shape, device=p.device).normal_(
                    0.0, 0.02, generator=generator))

    def forward(self, tokens: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """tokens int[B, L], mask bool[B, L] -> f32[B, L, d_model]."""
        x = self.embed(tokens).to(self.cfg.dtype)
        for layer in self.layers:
            x = layer(x, mask)
        x = self.final_ln(x)
        return torch.where(mask[..., None], x, 0.0)
