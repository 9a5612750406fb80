"""Wan2.1-style video diffusion transformer with buffer conditioning;
counterpart of ``infinicube_tpu/models/wan/dit.py``.

Parameters mirror the JAX module: fused ``qkv`` (self) and ``kv`` (cross)
projections, q/k RMSNorm over the full dim before the head split, the
half-split RoPE, a per-block ``mod_bias``, the zero-initialized
``buffer_embed`` and ``head``. Blocks are ``blocks.{i}``;
``weights/from_jax.py`` reads either JAX layout (``scan_layers`` stacked
``blocks`` or ``block{i}``) into it.

Dtypes follow the reference: projections in ``cfg.dtype``; norms, adaLN
modulation, the time MLP and the head in f32; the carried residual in
``cfg.residual_dtype``. Self-attention goes, in the JAX module's order,
through ``ring_attention`` when ``sp_axis`` is set, through
``mha_quantized`` when ``attn_quant`` is (K1 for ``"qk"``, K8 for
``"qkv"``), else, like cross-attention, through ``multi_head_attention``
(K2, and K5 for its gradient). With ``attn_quant`` or ``quant_linear`` set
the DiT serves only: under a gradient it raises.

Sequence parallelism (``sp_axis`` with ``WanDiT(..., sp_group=group)``, the
counterpart of the JAX module's ``sp_mesh``): every rank of ``group`` holds
the whole inputs and runs its contiguous N/P of the tokens through the
token-wise layers (patch embed, norms, FFN, the cross-attention's queries,
RoPE at its own tokens' positions and the head), self-attention as the
ring over the group; the ranks then gather the head's output, so each
returns the whole velocity, as the JAX module's global array is. The split
and the gather are differentiable: the inputs' gradients come back whole
on every rank, and each rank's parameter gradients are its tokens' share
(their sum over the group is the model's). With ``sp_axis`` set and no
group, the ring is one block."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.models.diffusion.unet3d import timestep_embedding
from infinicube_tpu_torch.nn.layers import Dense, RMSNorm, layer_norm, \
    lecun_normal_
from infinicube_tpu_torch.nn.quant import QuantLinear
from infinicube_tpu_torch.ops.attention import multi_head_attention
from infinicube_tpu_torch.ops.flash_attention import mha_quantized
from infinicube_tpu_torch.ops.ring_attention import ring_attention
from infinicube_tpu_torch.parallel.mesh import gather_tokens, split_tokens


@dataclasses.dataclass(frozen=True)
class WanDiTConfig:
    dim: int = 1536                 # 1.3B; 14B: 5120
    ffn_dim: int = 8960             # 14B: 13824
    num_layers: int = 30            # 14B: 40
    num_heads: int = 12             # 14B: 40
    in_channels: int = 16           # video VAE latent channels
    out_channels: int = 16
    text_dim: int = 4096            # umt5-xxl hidden
    freq_dim: int = 256
    sp_axis: str | None = None      # ring self-attention over sp_group
    attn_quant: str | None = None   # "qk" (K1) / "qkv" (K8): int8 self-attn
    quant_linear: bool = False      # int8 block projections / FFN
    residual_dtype: torch.dtype = torch.float32
    patch_size: tuple = (1, 2, 2)
    buffer_channels: int = 32       # 2 x VAE-encoded buffer videos
    use_buffer_embedder: bool = True
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def wan_1_3b(**kw) -> "WanDiTConfig":
        return WanDiTConfig(**kw)

    @staticmethod
    def wan_14b(**kw) -> "WanDiTConfig":
        base = dict(dim=5120, ffn_dim=13824, num_layers=40, num_heads=40)
        base.update(kw)
        return WanDiTConfig(**base)


def rope_3d(thw: tuple[int, int, int], head_dim: int,
            device=None) -> torch.Tensor:
    """3D RoPE angles f32[T*H*W, head_dim//2], frequency channels split
    between the t/h/w axes."""
    T, H, W = thw
    half = head_dim // 2
    d_t = half - 2 * (half // 3)
    d_h = d_w = half // 3

    def axis_angles(n, d):
        inv = 1.0 / (10000.0 ** (torch.arange(d, dtype=torch.float32,
                                              device=device) / d))
        return torch.arange(n, dtype=torch.float32,
                            device=device)[:, None] * inv[None]

    ang = torch.cat([
        axis_angles(T, d_t)[:, None, None, :].expand(T, H, W, d_t),
        axis_angles(H, d_h)[None, :, None, :].expand(T, H, W, d_h),
        axis_angles(W, d_w)[None, None, :, :].expand(T, H, W, d_w),
    ], dim=-1)
    return ang.reshape(T * H * W, half)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [B, N, h, d]; angles [N, d//2]. Rotates the half-split pairs
    (x[j], x[j + d/2]) by angles[j]."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _dense(cin, cout, cfg, quant=False, device=None):
    cls = QuantLinear if quant else Dense
    return cls(cin, cout, compute_dtype=cfg.dtype, device=device)


class WanAttention(nn.Module):
    def __init__(self, cfg: WanDiTConfig, cross: bool = False, device=None,
                 sp_group=None):
        super().__init__()
        self.cfg, self.cross, self.sp_group = cfg, cross, sp_group
        C, qt = cfg.dim, cfg.quant_linear
        if cross:
            self.q = _dense(C, C, cfg, qt, device)
            self.kv = _dense(C, 2 * C, cfg, False, device)
        else:
            self.qkv = _dense(C, 3 * C, cfg, qt, device)
        self.q_norm = RMSNorm(C, device=device)
        self.k_norm = RMSNorm(C, device=device)
        self.o = _dense(C, C, cfg, qt, device)

    def forward(self, x, context=None, rope_angles=None):
        cfg = self.cfg
        B, N, C = x.shape
        h = cfg.num_heads
        hd = C // h
        if self.cross:
            q = self.q(x)
            k, v = self.kv(context).chunk(2, dim=-1)
        else:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        # RMSNorm over the FULL dim before the head split (upstream Wan)
        q = self.q_norm(q).reshape(B, -1, h, hd)
        k = self.k_norm(k).reshape(B, -1, h, hd)
        v = v.reshape(B, -1, h, hd)
        if not self.cross and rope_angles is not None:
            q = apply_rope(q, rope_angles)
            k = apply_rope(k, rope_angles)
        q, k = q.to(cfg.dtype), k.to(cfg.dtype)
        if cfg.sp_axis and not self.cross:
            out = ring_attention(q, k, v, self.sp_group)
        elif cfg.attn_quant and not self.cross:
            out = mha_quantized(q, k, v, quant=cfg.attn_quant)
        else:
            out = multi_head_attention(q, k, v)
        return self.o(out.reshape(B, N, C))


class WanBlock(nn.Module):
    def __init__(self, cfg: WanDiTConfig, device=None, sp_group=None):
        super().__init__()
        self.cfg = cfg
        C = cfg.dim
        self.mod_bias = nn.Parameter(torch.zeros(6, C, device=device))
        self.self_attn = WanAttention(cfg, device=device, sp_group=sp_group)
        self.cross_norm = nn.LayerNorm(C, device=device)
        self.cross_attn = WanAttention(cfg, cross=True, device=device)
        self.ffn_in = _dense(C, cfg.ffn_dim, cfg, cfg.quant_linear, device)
        self.ffn_out = _dense(cfg.ffn_dim, C, cfg, cfg.quant_linear, device)

    def forward(self, x, t_mod, context, rope_angles):
        """t_mod f32[B, 6, C] adaLN params (shift/scale/gate x2)."""
        cfg = self.cfg
        m = t_mod + self.mod_bias.float()[None]
        sh1, sc1, g1, sh2, sc2, g2 = [m[:, i, None, :] for i in range(6)]
        h = layer_norm(x) * (1 + sc1) + sh1
        x = x + g1 * self.self_attn(h.to(cfg.dtype), rope_angles=rope_angles)
        h = layer_norm(x, self.cross_norm.weight, self.cross_norm.bias)
        x = x + self.cross_attn(h.to(cfg.dtype), context=context)
        h = layer_norm(x) * (1 + sc2) + sh2
        h = F.gelu(self.ffn_in(h.to(cfg.dtype)), approximate="tanh")
        h = self.ffn_out(h)
        return (x + g2 * h).to(cfg.residual_dtype)


class WanDiT(nn.Module):
    """Video DiT over VAE latents.

    forward(latents [B, T, H, W, C_in], t [B], text_emb [B, L, text_dim],
            buffer_latents [B, T, H, W, buffer_channels] | None)
    -> velocity f32[B, T, H, W, C_out]

    ``sp_group``: the process group the tokens are split over when
    ``cfg.sp_axis`` is set (None: one rank).
    """

    def __init__(self, cfg: WanDiTConfig, device="cuda", sp_group=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.sp_group = sp_group if cfg.sp_axis else None
        C = cfg.dim
        patch = cfg.patch_size[0] * cfg.patch_size[1] * cfg.patch_size[2]
        f32 = torch.float32
        self.patch_embed = Dense(patch * cfg.in_channels, C,
                                 compute_dtype=cfg.dtype, device=dev)
        self.buffer_embed = Dense(patch * cfg.buffer_channels, C,
                                  compute_dtype=cfg.dtype, device=dev)
        self.t_proj1 = Dense(cfg.freq_dim, C, compute_dtype=f32, device=dev)
        self.t_proj2 = Dense(C, C, compute_dtype=f32, device=dev)
        self.t_mod = Dense(C, 6 * C, compute_dtype=f32, device=dev)
        self.text_proj_in = Dense(cfg.text_dim, C, compute_dtype=cfg.dtype,
                                  device=dev)
        self.text_proj = Dense(C, C, compute_dtype=cfg.dtype, device=dev)
        self.blocks = nn.ModuleList(WanBlock(cfg, device=dev,
                                             sp_group=self.sp_group)
                                    for _ in range(cfg.num_layers))
        self.head_mod = nn.Parameter(torch.zeros(2, C, device=dev))
        self.head = Dense(C, patch * cfg.out_channels, compute_dtype=f32,
                          device=dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random weights at the reference's init scales: lecun-normal
        kernels, zero biases and modulation, unit norm scales, and a zero
        ``buffer_embed`` and ``head`` (so a fresh DiT returns exactly 0)."""
        for name, mod in self.named_modules():
            if isinstance(mod, nn.Linear):
                if name in ("buffer_embed", "head"):
                    mod.weight.zero_()
                else:
                    lecun_normal_(mod.weight, mod.in_features, generator)
                mod.bias.zero_()
            elif isinstance(mod, (RMSNorm, nn.LayerNorm)):
                mod.weight.fill_(1.0)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
        for blk in self.blocks:
            blk.mod_bias.zero_()
        self.head_mod.zero_()

    def forward(self, latents, t, text_emb, buffer_latents=None):
        cfg = self.cfg
        if (cfg.attn_quant or cfg.quant_linear) and torch.is_grad_enabled() \
                and (latents.requires_grad or
                     any(p.requires_grad for p in self.parameters())):
            raise ValueError("a DiT with attn_quant or quant_linear serves "
                             "only: no gradient")
        B, T, H, W, _ = latents.shape
        pt, ph, pw = cfg.patch_size
        gt, gh, gw = T // pt, H // ph, W // pw
        N = gt * gh * gw

        def patchify(x):
            x = x.reshape(B, gt, pt, gh, ph, gw, pw, x.shape[-1])
            return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, N, -1)

        group = self.sp_group
        x = self.patch_embed(split_tokens(patchify(latents), group))
        if cfg.use_buffer_embedder and buffer_latents is not None:
            x = x + self.buffer_embed(split_tokens(patchify(buffer_latents),
                                                   group))

        te = timestep_embedding(t, cfg.freq_dim)
        te = self.t_proj1(te)
        te = self.t_proj2(F.silu(te))
        t_mod = self.t_mod(F.silu(te)).reshape(B, 6, cfg.dim)

        ctx = self.text_proj(F.gelu(self.text_proj_in(text_emb.to(cfg.dtype)),
                                    approximate="tanh"))
        angles = split_tokens(rope_3d((gt, gh, gw), cfg.dim // cfg.num_heads,
                                      device=latents.device), group, dim=0)
        x = x.to(cfg.residual_dtype)
        for blk in self.blocks:
            x = blk(x, t_mod, ctx, angles)

        # final adaLN with the RAW time embedding (Wan's Head), zero-init head
        fin = self.head_mod.float()[None] + te[:, None, :].float()
        sh, sc = fin[:, 0][:, None, :], fin[:, 1][:, None, :]
        x = layer_norm(x) * (1 + sc) + sh
        # the head is token-wise: its output (out_channels x patch wide, not
        # dim) is what the ranks gather
        x = gather_tokens(self.head(x.float()), group)
        x = x.reshape(B, gt, gh, gw, pt, ph, pw, cfg.out_channels)
        return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(
            B, T, H, W, cfg.out_channels)
