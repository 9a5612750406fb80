"""Time one checkout of the PyTorch port on one NVIDIA GPU: the kernels a
redesign changes and their guards, at the shapes of ``chip_smoke.py``'s
paths (CUDA events after warm-up), and the steps those kernels carry (host
clock around work that ends in a synchronize).

    python3 chip_time_kernels.py <checkout> [--json FILE]
        [--sparse] [--f32-bwd] [--int8-prologue] | [--vae]

- guards, timed first: K2 at d = 96 (N = 4,096 and 512, 8 heads) and
  d = 128 (37,440 x 512, 12 heads), K3 forward at [1,64^3,192]->192, K8
  and K1 (N = 37,440 and 7,800), K5 (d = 96 at 4,096 and 512), K6 (the
  sparse conv's weight gradient) at the three levels of a 200,000-point
  training batch and on a decode's two grids, K7 at its six shapes (CFG
  batch 2) and K4 forward through ``window_conv.window_sparse_conv`` on
  the decode's grids; K8 and K1 also with their quantize prologues
  (``mha_quantized``);
- one train step of the release sparse VAE on a 200,000-point sample, and
  the part of its device time in K6;
- K2 and K5 also as device time alone (``torch.profiler``), which the
  small calls need: at N = 512 launching from Python takes about as long
  as the kernel; and the host's time to issue one K2 call at N = 512 (the
  row ending in "issue"), queued behind a kernel that keeps the card busy,
  so that no launch waits for the card;
- the f32 kernels: ``conv3x3x3_f32`` at the release UNet's six conv shapes,
  forward and as the input gradient (the flipped, swapped pack, no bias),
  each beside cuDNN's f32 conv3d forward and backward-data on the same
  inputs; ``flash_attn_f32`` at the UNet's two SelfAttention3D shapes
  (N = 4,096 and 512, h = 8, d = 96), at 1,000 x 777 keys (d = 64) and at
  the GSM pixel branch's SelfAttn2D shape (N = 5,280, h = 4, d = 64), each
  host-timed and as device time alone beside ``scaled_dot_product_attention``
  on f32 inputs, and at N = 512 the host's time to issue one call of each;
- steps: one DDIM step (batch 1, 64^3) of the release UNet computing in
  f32 (``DiffusionConfig(dtype=torch.float32)``, its SelfAttention3D blocks
  included), and the share of one such UNet call's device time (profiler)
  in the f32 conv kernels and in the f32 attention kernels. Random weights,
  null conditions (the dense work does not depend on them).

With ``--sparse`` only the sparse conv's kernels run (``sparse_rows``:
host-timed, and the weight gradients also as device time alone, summed over
a bf16 GSM train step's ten launches by their shapes'
``chip_smoke.BF16_CONV_STEP_COUNTS``, the bf16 one split into its pairs,
products and reduce kernels); with
``--f32-bwd`` only ``flash_attn_f32_bwd`` at the three timed shapes of
``chip_smoke.F32_BWD_SHAPES`` (the GSM's train shape [3, 5,280, 4, 64],
N = 4,096 with 8 heads of 96, 1,000 x 777 with 4 heads of 128), called
through its Python signature on the forward's lse and ``attention_delta``,
each host-timed and as device time alone beside the backward of
``scaled_dot_product_attention`` on f32 inputs with the memory-efficient
backend pinned (``f32_bwd_rows``). With ``--int8-prologue`` only K7's
quantize prologue: ``int8_conv_amax``, ``int8_conv_quantize_x`` and
``int8_conv_quantize_w`` at the six ``chip_smoke.K7_SHAPES`` (CFG batch 2,
the f32 weight parameter), each host-timed as ``chip_smoke.py``'s phase 18
times them (CUDA events around 5 back-to-back calls) and as device time
alone (``device_ms``), beside ``torch.linalg.vector_norm(x, inf, dim=(0,
1, 2, 3))`` timed both ways, and K7 with its prologue as the UNet calls it
(``conv3x3x3(quant=True)``); then one CFG DDIM step (batch 2, 64^3) of the
release UNet with ``serve_quant``, host-timed, and its device time with
the parts in the three prologue kernels and in K7 (``int8_prologue_rows``).
The three options combine. With ``--vae``
only K3 at the Wan VAE's routed conv shapes of ``chip_smoke.py``'s phase 36,
each beside cuDNN's bf16 conv3d on the same padded input (``vae_rows``).

TF32 is off for PyTorch's own calls, so cuDNN and SDPA compute in f32.
Prints one line of milliseconds and, with ``--json``, writes them there. To
compare two checkouts, run it on each in turns inside one job on one card
(a, b, b, a): each run builds the kernels of the checkout it is given and
imports ``infinicube_tpu_torch`` from there; it uses only what both sides
of such a comparison have."""

import argparse
import json
import math
import subprocess
import sys
import time

import torch

from chip_smoke import (D, D96, F32_ATTN_SHAPES, H, H96, K3_SHAPES,
                        K7_SHAPES, N_RELEASE, N_SERVE, TEXT_LEN, VAE_POINTS,
                        cuda_ms, k7_prologue_inputs, rand, vae_points)

# the VAE's conv widths at the training batch's levels: (level, F, Fo)
TRAIN_CONVS = ((0, 32, 64), (0, 64, 64), (1, 128, 128), (1, 256, 128),
               (2, 256, 256))


def device_ms(fn, iters=20):
    """The device time of ``fn``'s kernels alone per call (the profiler's
    CUDA events), for calls short enough that launching them from Python
    takes about as long as running them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / iters / 1e3


def issue_ms(fn, calls=100):
    """The host's time to issue one call of ``fn`` (Python, the wrapper, the
    launches), or NaN where that could not be told apart from waiting: the
    calls queue behind ``torch.cuda._sleep``, which keeps the card busy for
    longer than they take to issue unless one of them waits for the card
    (a UNet step does, so steps have no such row)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1_000_000_000)
    end.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return host / calls if host < 0.9 * start.elapsed_time(end) else math.nan


def training_grids():
    """The three levels of a 200,000-point training batch (the VAE
    trainer's kind of sample) and the release VAE config."""
    from infinicube_tpu_torch.models.vae.sunet import (SparseVAEConfig,
                                                       build_hash_tree)
    vcfg = SparseVAEConfig()
    pts, _ = vae_points(15)
    return vcfg, build_hash_tree(vcfg, pts.cuda(), torch.ones(
        (1, VAE_POINTS), dtype=torch.bool, device="cuda"))


def guard_rows(kernels, dc, fa, wc, g):
    """The kernels this redesign leaves as they are, timed first, so that
    none is timed right after a run of the redesigned kernels at full
    power."""
    from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                       SparseVAEConfig)
    from infinicube_tpu_torch.nn.sparse import conv_plan
    out = {}
    for nq, nk, h, d in ((N_RELEASE, TEXT_LEN, H, D), (4096, 4096, H96, D96),
                         (512, 512, H96, D96)):
        q, k, v = (rand((1, n, h, d), g) for n in (nq, nk, nk))

        def k2():
            return kernels.flash_attn_bf16(q, k, v, d ** -0.5)
        # at N = 512 the host's time to issue the call bounds it: more calls
        # average out the host's spread
        calls = 500 if nq == 512 else 20
        out[f"k2 {nq}x{nk} h{h} d{d}"] = cuda_ms(k2, 3, calls)
        out[f"k2 {nq}x{nk} h{h} d{d} device"] = device_ms(k2)
        if nq == 512:
            out[f"k2 {nq}x{nk} h{h} d{d} issue"] = issue_ms(k2, calls)
    x = rand((1, 64, 64, 64, 192), g)
    w = rand((192, 192, 3, 3, 3), g) / math.sqrt(27 * 192)
    wp, b = dc.pack_conv_weight(w), torch.zeros(192, device="cuda")
    out["k3 64^3 192->192"] = cuda_ms(
        lambda: kernels.conv3x3x3_bf16(x, wp, b), 2, 10)
    del x, w, wp
    for n in (N_RELEASE, N_SERVE):
        block, npad = fa.quant_blocks(n)
        q8, sq = fa.block_quantize(fa.fold_heads(rand((1, n, H, D), g),
                                                 npad), block)
        k8, sk = fa.block_quantize(fa.fold_heads(rand((1, n, H, D), g),
                                                 npad), block)
        v = rand((1, n, H, D), g)
        v8, sv = fa.channel_quantize(fa.fold_heads(v, npad))
        # K8's V operand: keys permuted within each 16 where the checkout
        # has ``pack_v8``, else plainly transposed (the kernel of PR 5)
        pack_v8 = getattr(fa, "pack_v8", None)
        v8t = pack_v8(v8) if pack_v8 else v8.transpose(1, 2).contiguous()
        out[f"k8 N={n}"] = cuda_ms(lambda: kernels.flash_attn_int8qkv(
            q8, k8, sq, sk, v8t, sv, 1, n, block, D ** -0.5), 2, 5)
        out[f"k1 N={n}"] = cuda_ms(lambda: kernels.flash_attn_int8qk(
            q8, k8, sq, sk, v, block, D ** -0.5), 2, 5)
        del q8, k8, v8, v8t
        # with their quantize prologues, as the DiT calls them
        q, k = (rand((1, n, H, D), g) for _ in range(2))
        out[f"k8 N={n} with prologue"] = cuda_ms(
            lambda: fa.mha_quantized(q, k, v, quant="qkv"), 1, 5)
        out[f"k1 N={n} with prologue"] = cuda_ms(
            lambda: fa.mha_quantized(q, k, v), 1, 5)
        del q, k, v
    for n in (4096, 512):
        q, k, v, do = (rand((1, n, H96, D96), g) for _ in range(4))
        o, lse = kernels.flash_attn_bf16(q, k, v, D96 ** -0.5,
                                         return_lse=True)
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()

        def k5():
            return kernels.flash_attn_bf16_bwd(q, k, v, do, lse, delta,
                                               D96 ** -0.5)
        shape = f"{n}x{n} h{H96} d{D96}"
        out[f"k5 {shape}"] = cuda_ms(k5, 3, 20)
        out[f"k5 {shape} device"] = device_ms(k5)
    vcfg, tree = training_grids()
    for level, F, Fo in TRAIN_CONVS:
        grid = tree[level]
        plan = conv_plan(grid, dense_bounds=vcfg.level_dense_bounds(level))
        m = grid.mask[..., None]
        feats = torch.where(m, torch.randn((1, grid.capacity, F),
                                           generator=g, device="cuda"), 0.0)
        gout = torch.where(m, torch.randn((1, grid.capacity, Fo),
                                          generator=g, device="cuda"), 0.0)
        out[f"k6 train L{level} {F}->{Fo}"] = cuda_ms(
            lambda: kernels.sparse_conv_f32_wgrad(feats, plan.nbr, gout),
            2, 5)
    del tree
    for n, C, O in K7_SHAPES:
        x = (torch.randn((2, n, n, n, C), generator=g, device="cuda") *
             torch.logspace(-1, 1, C, device="cuda")).to(torch.bfloat16)
        w = torch.randn((O, C, 3, 3, 3), generator=g, device="cuda") / \
            math.sqrt(27 * C)
        b = torch.zeros(O, device="cuda")
        x8, w8, sw = dc.quantize_for_conv(x, w.to(torch.bfloat16))
        w8p = dc.pack_int8_weight(w8)
        out[f"k7 [2,{n}^3] {C}->{O}"] = cuda_ms(
            lambda: kernels.conv3x3x3_int8(x8, w8p, sw, b), 2, 10)
        del x, w, x8, w8, w8p
    torch.cuda.empty_cache()
    vae = SparseStructureVAE(vcfg, device="cuda")
    vae.init_params(g)
    latents = torch.randn((1, 64, 64, 64, vcfg.latent_channels),
                          generator=g, device="cuda")
    grids = vae.decode(latents)["grids"]
    for grid, level, F in ((grids[-1], 0, 64), (grids[0], 2, 256)):
        plan = conv_plan(grid, dense_bounds=vcfg.level_dense_bounds(level))
        feats = torch.where(grid.mask[..., None], torch.randn(
            (1, grid.capacity, F), generator=g, device="cuda"), 0.0)
        w = torch.randn((27, F, F), generator=g, device="cuda") / \
            math.sqrt(27 * F)
        gout = torch.where(grid.mask[..., None], torch.randn(
            (1, grid.capacity, F), generator=g, device="cuda"), 0.0)
        with torch.no_grad():
            out[f"k4 decode {grid.capacity} {F}->{F}"] = cuda_ms(
                lambda: wc.window_sparse_conv(plan, feats, w), 2, 10)
        out[f"k6 decode {grid.capacity} {F}->{F}"] = cuda_ms(
            lambda: kernels.sparse_conv_f32_wgrad(feats, plan.nbr, gout),
            2, 5)
    del vae, grids, latents
    torch.cuda.empty_cache()
    return out


def sparse_rows(kernels, wc, g):
    """K4 (forward and input gradient) and K6 in f32 and in bf16 at the
    GSM voxel branch's seven conv shapes on ``bench_gsm_train.py``'s scene
    grid and its two coarser levels (``chip_smoke.BF16_CONV_SHAPES``): the
    two instantiations of K4's kernel template, K6 and
    ``sparse_conv_bf16_wgrad``; the weight gradients also as device time
    alone, and summed over a train step's launches (``... gsm step``)."""
    from chip_smoke import (BF16_CONV_SHAPES, BF16_CONV_STEP_COUNTS,
                            gsm_bf16_levels)
    levels = gsm_bf16_levels()
    out = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        conv = getattr(kernels, f"sparse_conv_{name}")
        wgrad = getattr(kernels, f"sparse_conv_{name}_wgrad")
        step = step_device = 0.0
        for (F, Fo, level), count in zip(BF16_CONV_SHAPES,
                                         BF16_CONV_STEP_COUNTS):
            grid, plan = levels[level]
            m = grid.mask[..., None]
            x, cot = (torch.where(m, torch.randn(
                (1, grid.capacity, n), generator=g, device="cuda"),
                0.0).to(dtype) for n in (F, Fo))
            w = (torch.randn((27, F, Fo), generator=g, device="cuda") /
                 math.sqrt(27 * F)).to(dtype)
            pack, dpack = (wc.pack_sparse_weight(w, d) for d in (False, True))
            zero = torch.zeros_like(plan.violations)
            shape = f"{name} L{level} {F}->{Fo}"
            out[f"k4 {shape}"] = cuda_ms(
                lambda: conv(x, plan.nbr, pack, plan.violations), 3, 20)
            out[f"k4 dgrad {shape}"] = cuda_ms(
                lambda: conv(cot, plan.nbr, dpack, zero, dgrad=True), 3, 20)
            out[f"k6 {shape}"] = cuda_ms(
                lambda: wgrad(x, plan.nbr, cot), 3, 20)
            out[f"k6 {shape} device"] = device_ms(
                lambda: wgrad(x, plan.nbr, cot))
            if name == "bf16":
                # the call's three kernels (a checkout whose weight
                # gradient is one kernel gives its time under "products")
                def ten():
                    for _ in range(10):
                        wgrad(x, plan.nbr, cot)
                wgrad(x, plan.nbr, cot)
                parts = {"pairs": 0.0, "products": 0.0, "reduce": 0.0}
                for k, us in _device_by_name(ten).items():
                    part = "pairs" if "pairs" in k else \
                        "reduce" if "reduce" in k else "products"
                    parts[part] += us / 10 / 1e3
                for part, ms in parts.items():
                    out[f"k6 {shape} {part}"] = ms
            step += count * out[f"k6 {shape}"]
            step_device += count * out[f"k6 {shape} device"]
        out[f"k6 {name} gsm step"] = step
        out[f"k6 {name} gsm step device"] = step_device
    return out


def f32_bwd_rows(kernels, att, g):
    """``flash_attn_f32_bwd`` beside SDPA's f32 backward (efficient backend
    pinned, TF32 off), host-timed and as device time alone."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from chip_smoke import F32_BWD_SHAPES
    out = {}
    for B, nq, nk, h, d in F32_BWD_SHAPES[:3]:
        q, k, v, do = (rand((B, n, h, d), g, torch.float32)
                       for n in (nq, nk, nk, nq))
        scale = d ** -0.5
        o, lse = kernels.flash_attn_f32(q, k, v, scale, return_lse=True)
        delta = att.attention_delta(o, do)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            ref = torch.nn.functional.scaled_dot_product_attention(qt, kt,
                                                                   vt)

        def ours():
            return kernels.flash_attn_f32_bwd(q, k, v, do, lse, delta, scale)

        def sdpa():
            return torch.autograd.grad(ref, (qt, kt, vt), dot,
                                       retain_graph=True)
        key = f"B{B} {nq}x{nk} h{h} d{d}"
        out[f"f32 attn bwd {key}"] = cuda_ms(ours, 2, 10)
        out[f"f32 attn bwd {key} device"] = device_ms(ours, 10)
        out[f"sdpa f32 bwd {key}"] = cuda_ms(sdpa, 2, 10)
        out[f"sdpa f32 bwd {key} device"] = device_ms(sdpa, 10)
        del q, k, v, do, o, lse, delta, qt, kt, vt, dot, ref
    torch.cuda.empty_cache()
    return out


def int8_prologue_rows(kernels, dc, g):
    """K7's quantize prologue at ``K7_SHAPES`` beside ``vector_norm``, and
    K7 with it (``conv3x3x3(quant=True)``, the f32 parameter); then one
    int8 CFG DDIM step of the release UNet with its device time split
    (kernel names: the three prologue kernels; K7's int8 instantiation of
    the conv template and its split-K reduce)."""
    from infinicube_tpu_torch.models.diffusion.model import (CondCubes,
                                                             DiffusionConfig,
                                                             VoxelDiffusion)
    out = {}
    for n, C, O in K7_SHAPES:
        x, wf = k7_prologue_inputs(g, n, C, O)
        amax = kernels.int8_conv_amax(x)
        fns = {"amax": lambda: kernels.int8_conv_amax(x),
               "quantize_x": lambda: kernels.int8_conv_quantize_x(x, amax),
               "quantize_w": lambda: kernels.int8_conv_quantize_w(wf, amax),
               "vector_norm": lambda: torch.linalg.vector_norm(
                   x, float("inf"), dim=(0, 1, 2, 3))}
        b = torch.zeros(O, device="cuda")

        def k7_with_prologue():
            with torch.no_grad():
                return dc.conv3x3x3(x, wf, b, quant=True)
        fns["k7 with prologue"] = k7_with_prologue
        shape = f"[2,{n}^3] {C}->{O}"
        for name, fn in fns.items():
            out[f"{name} {shape}"] = cuda_ms(fn, 2, 5)
            out[f"{name} {shape} device"] = device_ms(fn)
        del x, wf, amax, b
    torch.cuda.empty_cache()
    diffusion = VoxelDiffusion(DiffusionConfig(serve_quant=True),
                               device="cuda")
    diffusion.init_params(g, zero_init_layers=False)
    x = torch.randn((2, 64, 64, 64, 8), generator=g, device="cuda")
    cond = CondCubes.null(2, diffusion.cfg, "cuda")
    t = torch.tensor([500, 500], device="cuda")

    def step():
        with torch.no_grad():
            return diffusion.denoise(x, t, cond, serve=True)
    out["int8 cfg step"] = _host_ms(step)
    by_name = _device_by_name(step)
    out["int8 cfg step device"] = sum(by_name.values()) / 1e3
    out["int8 cfg step prologue"] = sum(
        v for k, v in by_name.items()
        if "int8_conv_amax" in k or "int8_conv_quantize" in k) / 1e3
    out["int8 cfg step k7"] = sum(
        v for k, v in by_name.items()
        if "conv3x3x3_wgmma_kernel<1," in k or "int8_splitk" in k) / 1e3
    del diffusion, x, cond
    torch.cuda.empty_cache()
    return out


def vae_rows(kernels, dc, g):
    """K3 at the Wan VAE's routed conv shapes (``chip_smoke.py`` phase 36:
    a release decode tile's five, the whole frame's latent level, one of
    each encode level), each beside cuDNN's bf16 conv3d on the same padded
    input (channels_last_3d, the layout K3 reads)."""
    from chip_smoke import (VAE_DECODE_SHAPES, VAE_ENCODE_SHAPES,
                            VAE_FRAME_SHAPE)
    out = {}
    for D_, H_, W_, C, O in VAE_DECODE_SHAPES + (VAE_FRAME_SHAPE,) + \
            VAE_ENCODE_SHAPES:
        x = rand((1, D_, H_, W_, C), g)
        w = (torch.randn((O, C, 3, 3, 3), generator=g, device="cuda") /
             math.sqrt(27 * C)).to(torch.bfloat16)
        b = 0.1 * torch.randn(O, generator=g, device="cuda")
        wp = dc.pack_conv_weight(w)
        xl = x.permute(0, 4, 1, 2, 3)
        wl = w.contiguous(memory_format=torch.channels_last_3d)
        bb = b.to(torch.bfloat16)
        shape = f"[1,{D_},{H_},{W_},{C}]->{O}"
        out[f"k3 vae {shape}"] = cuda_ms(
            lambda: kernels.conv3x3x3_bf16(x, wp, b), 3, 10)
        out[f"cudnn vae {shape}"] = cuda_ms(
            lambda: torch.nn.functional.conv3d(xl, wl, bb, padding=1), 3, 10)
        del x, w, wp, xl, wl
    torch.cuda.empty_cache()
    return out


def f32_rows(kernels, dc, g):
    """``conv3x3x3_f32`` forward and dgrad beside cuDNN's f32 conv3d
    forward and backward-data; ``flash_attn_f32`` beside f32 SDPA."""
    out = {}
    for n, C, O in K3_SHAPES:
        x = torch.randn((1, n, n, n, C), generator=g, device="cuda")
        w = torch.randn((O, C, 3, 3, 3), generator=g, device="cuda") / \
            math.sqrt(27 * C)
        b = torch.zeros(O, device="cuda")
        go = torch.randn((1, n, n, n, O), generator=g, device="cuda")
        wp = dc.pack_conv_weight(w, torch.float32)
        wd = dc.pack_conv_weight(dc.dgrad_weight(w), torch.float32)
        key = f"[1,{n}^3] {C}->{O}"
        iters = 3 if n == 64 else 10
        out[f"f32 conv {key}"] = cuda_ms(
            lambda: kernels.conv3x3x3_f32(x, wp, b), 1, iters)
        out[f"f32 conv dgrad {key}"] = cuda_ms(
            lambda: kernels.conv3x3x3_f32(go, wd, None), 1, iters)
        xl, gl = x.permute(0, 4, 1, 2, 3), go.permute(0, 4, 1, 2, 3)
        wl = w.contiguous(memory_format=torch.channels_last_3d)
        out[f"cudnn f32 conv {key}"] = cuda_ms(
            lambda: torch.nn.functional.conv3d(xl, wl, b, padding=1), 1,
            iters)
        out[f"cudnn f32 dgrad {key}"] = cuda_ms(
            lambda: torch.nn.grad.conv3d_input(xl.shape, wl, gl, padding=1),
            1, iters)
        del x, w, go, wp, wd, xl, gl, wl
        torch.cuda.empty_cache()
    for nq, nk, h, d in F32_ATTN_SHAPES:
        q, k, v = (rand((1, n, h, d), g, torch.float32) for n in (nq, nk, nk))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def ours():
            return kernels.flash_attn_f32(q, k, v, d ** -0.5)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt)
        key = f"{nq}x{nk} h{h} d{d}"
        calls = 500 if nq == 512 else 10
        out[f"f32 attn {key}"] = cuda_ms(ours, 2, calls)
        out[f"f32 attn {key} device"] = device_ms(ours)
        out[f"sdpa f32 {key}"] = cuda_ms(sdpa, 2, calls)
        out[f"sdpa f32 {key} device"] = device_ms(sdpa)
        if nq == 512:
            # 200 calls: a call may launch three kernels, and the queue of
            # launches the host may run ahead of the card is about 1,000
            out[f"f32 attn {key} issue"] = issue_ms(ours, 200)
            out[f"sdpa f32 {key} issue"] = issue_ms(sdpa, 200)
        del q, k, v, qt, kt, vt
    return out


def _host_ms(fn, runs=3):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sum(times) / runs


def _device_by_name(fn):
    """``fn()`` under the profiler: device time by kernel name (us)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.end - e.time_range.start
    return by_name


def vae_step_rows(g):
    """One train step of the release sparse VAE on a 200,000-point sample,
    as ``chip_smoke.py``'s phase 16 takes it (batch making, forward,
    backward, clip + AdamW + EMA), host-timed, and one step's device time
    with the part of it in K6's kernels (names holding "sparse_wgrad")."""
    from torch.func import functional_call

    from infinicube_tpu_torch.grid.ops import majority_label
    from infinicube_tpu_torch.models.vae.loss import VAELossConfig, vae_loss
    from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                       SparseVAEConfig,
                                                       build_hash_tree)
    from infinicube_tpu_torch.training.state import (TrainConfig, TrainState,
                                                     make_train_step)
    cfg, vcfg = TrainConfig(), SparseVAEConfig()
    model = SparseStructureVAE(vcfg, device="cuda")
    model.init_params(g)
    state = TrainState.create(cfg, dict(model.named_parameters()))
    pts, labels = (a.cuda() for a in vae_points(18))
    mask = torch.ones((1, VAE_POINTS), dtype=torch.bool, device="cuda")

    def make_batch():
        grids = build_hash_tree(vcfg, pts, mask)
        return grids, majority_label(grids[0], pts, labels, mask,
                                     vcfg.num_semantic)

    def loss_fn(p, gen, b):
        out = functional_call(model, p, b, {"generator": gen})
        return vae_loss(VAELossConfig(), out, b[0][0], b[1])

    step_fn = make_train_step(cfg, loss_fn)
    out = {"vae train step": _host_ms(
        lambda: step_fn(state, g, make_batch()))}
    by_name = _device_by_name(lambda: step_fn(state, g, make_batch()))
    out["vae train step device"] = sum(by_name.values()) / 1e3
    out["vae train step k6"] = sum(
        v for k, v in by_name.items() if "sparse_wgrad" in k) / 1e3
    del model, state
    torch.cuda.empty_cache()
    return out


def step_rows(g):
    """One f32 DDIM step of the release UNet and its device-time split."""
    from infinicube_tpu_torch.models.diffusion.model import (CondCubes,
                                                             DiffusionConfig,
                                                             VoxelDiffusion)
    out = {}
    diffusion = VoxelDiffusion(DiffusionConfig(dtype=torch.float32),
                               device="cuda")
    diffusion.init_params(g, zero_init_layers=False)
    x = torch.randn((1, 64, 64, 64, 8), generator=g, device="cuda")
    cond = CondCubes.null(1, diffusion.cfg, "cuda")
    t = torch.tensor([500], device="cuda")
    with torch.no_grad():
        out["f32 ddim step"] = _host_ms(lambda: diffusion.denoise(x, t, cond))
        by_name = _device_by_name(lambda: diffusion.denoise(x, t, cond))
    total = sum(by_name.values())
    conv = sum(v for k, v in by_name.items() if "conv3x3x3" in k)
    attn = sum(v for k, v in by_name.items() if "flash" in k)
    out["f32 unet call device"] = total / 1e3
    out["f32 unet call conv3x3x3_f32"] = conv / 1e3
    out["f32 unet call flash_attn_f32"] = attn / 1e3
    print("f32 UNet call, device time by kernel (ms): " + "; ".join(
        f"{k[:60]} {v / 1e3:.3f}" for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:8]), flush=True)
    del diffusion, x, cond
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout")
    ap.add_argument("--json", default=None)
    ap.add_argument("--sparse", action="store_true",
                    help="time only the sparse conv's kernels, f32 and "
                    "bf16, at the GSM's shapes (``sparse_rows``)")
    ap.add_argument("--f32-bwd", action="store_true",
                    help="time only flash_attn_f32_bwd beside SDPA's f32 "
                    "backward (``f32_bwd_rows``); combines with --sparse")
    ap.add_argument("--int8-prologue", action="store_true",
                    help="time only K7's quantize prologue beside "
                    "vector_norm and one int8 CFG UNet step "
                    "(``int8_prologue_rows``); combines with --sparse and "
                    "--f32-bwd")
    ap.add_argument("--vae", action="store_true",
                    help="time only K3 at the Wan VAE's routed conv shapes "
                    "beside cuDNN (``vae_rows``)")
    args = ap.parse_args()
    sys.path.insert(0, args.checkout)
    from infinicube_tpu_torch import kernels
    from infinicube_tpu_torch.ops import attention as att
    from infinicube_tpu_torch.ops import dense_conv
    from infinicube_tpu_torch.ops import flash_attention as fa
    from infinicube_tpu_torch.ops import window_conv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build()
    built = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(0)
    if args.sparse or args.f32_bwd or args.int8_prologue:
        rows = sparse_rows(kernels, window_conv, g) if args.sparse else {}
        if args.f32_bwd:
            rows.update(f32_bwd_rows(kernels, att, g))
        if args.int8_prologue:
            rows.update(int8_prologue_rows(kernels, dense_conv, g))
    elif args.vae:
        rows = vae_rows(kernels, dense_conv, g)
    else:
        rows = guard_rows(kernels, dense_conv, fa, window_conv, g)
        rows.update(vae_step_rows(g))
        rows.update(f32_rows(kernels, dense_conv, g))
        rows.update(step_rows(g))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{args.checkout} ({smi}; build {built:.1f} s) | " +
          " | ".join(f"{k}: {v:.4f}" for k, v in rows.items()), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"checkout": args.checkout, "build_s": built,
                       "device": smi, "ms": rows},
                      f, indent=1)


if __name__ == "__main__":
    main()
