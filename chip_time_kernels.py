"""Time one checkout of the PyTorch port on one NVIDIA GPU: the kernels a
redesign changes and their guards, at the shapes of ``chip_smoke.py``'s
paths (CUDA events after warm-up), and the steps those kernels carry (host
clock around work that ends in a synchronize).

    python3 chip_time_kernels.py <checkout> [--json FILE]

- guards, timed first: K2 at d = 96 (N = 4,096 and 512, 8 heads) and
  d = 128 (37,440 x 512, 12 heads), K3 forward at [1,64^3,192]->192, K8
  (N = 37,440 and 7,800), ``flash_attn_f32`` at the UNet's two
  SelfAttention3D shapes, K1 (N = 37,440 and 7,800), K5 (d = 96 at 4,096
  and 512, also plus ``attention_delta``) and K6 (the sparse conv's weight
  gradient) at the three levels of a 200,000-point training batch;
- K2 and K5 also as device time alone (``torch.profiler``), which the
  small calls need: at N = 512 launching from Python takes about as long
  as the kernel; and the host's time to issue one K2 call at N = 512 (the
  row ending in "issue"), queued behind a kernel that keeps the card busy,
  so that no launch waits for the card;
- the redesigned kernels through the calls both sides of a comparison
  have: K7 alone (``kernels.conv3x3x3_int8`` on one quantization) and with
  its quantize prologue (``dense_conv.Conv3x3x3(quant=True)``, which calls
  ``conv3x3x3(..., quant=True)``) at its six shapes, CFG batch 2; K4 through
  ``window_conv.window_sparse_conv`` on the grids of a decode (capacity
  131,072 at 64 -> 64 and 32,768 at 256 -> 256) and of the training batch
  at the VAE's widths, forward, and forward plus its input gradient
  (autograd, weights held fixed);
- steps: one CFG DDIM step (batch 2, 64^3) of the release UNet in its int8
  serving configuration and in bf16, one VAE decode of a random latent
  cube, and one VAE train step on a 200,000-point sample (forward,
  backward, clip, AdamW, EMA). Random weights, null conditions (the dense
  work does not depend on them).

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

from chip_smoke import (D, D96, H, H96, K7_SHAPES, N_RELEASE, N_SERVE,
                        TEXT_LEN, VAE_POINTS, cuda_ms, rand,
                        sdpa_backward_ms, vae_points)

# the VAE's conv widths at the training batch's levels: (level, F, Fo)
TRAIN_CONVS = ((0, 32, 64), (0, 64, 64), (1, 128, 128), (1, 256, 128),
               (2, 256, 256))


def device_ms(fn, iters=20):
    """The device time of ``fn``'s kernels alone per call (the profiler's
    CUDA events), for kernels short enough that launching them from Python
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


def guard_rows(kernels, att, dc, fa, g):
    """The kernels this redesign leaves as they are, timed first, so that
    none is timed right after a run of the redesigned kernels at full
    power."""
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
        v8t = v8.transpose(1, 2).contiguous()
        out[f"k8 N={n}"] = cuda_ms(lambda: kernels.flash_attn_int8qkv(
            q8, k8, sq, sk, v8t, sv, 1, n, block, D ** -0.5), 2, 5)
        out[f"k1 N={n}"] = cuda_ms(lambda: kernels.flash_attn_int8qk(
            q8, k8, sq, sk, v, block, D ** -0.5), 2, 5)
        del q8, k8, v, v8, v8t
    for n in (4096, 512):
        q, k, v = (rand((1, n, H96, D96), g, torch.float32)
                   for _ in range(3))
        out[f"f32 attn {n}x{n} h{H96} d{D96}"] = cuda_ms(
            lambda: kernels.flash_attn_f32(q, k, v, D96 ** -0.5), 1, 5)
    for n in (4096, 512):
        q, k, v, do = (rand((1, n, H96, D96), g) for _ in range(4))
        o, lse = kernels.flash_attn_bf16(q, k, v, D96 ** -0.5,
                                         return_lse=True)
        delta = att.attention_delta(o, do)

        def k5():
            return kernels.flash_attn_bf16_bwd(q, k, v, do, lse, delta,
                                               D96 ** -0.5)

        def k5_delta():
            return kernels.flash_attn_bf16_bwd(
                q, k, v, do, lse, att.attention_delta(o, do), D96 ** -0.5)
        shape = f"{n}x{n} h{H96} d{D96}"
        out[f"k5 {shape}"] = cuda_ms(k5, 3, 20)
        out[f"k5 {shape} device"] = device_ms(k5)
        out[f"k5+delta {shape}"] = cuda_ms(k5_delta, 3, 20)
        lib, backend = sdpa_backward_ms(q, k, v, do)
        out[f"sdpa bwd ({backend}) {shape}"] = lib
    from infinicube_tpu_torch.nn.sparse import conv_plan
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
    torch.cuda.empty_cache()
    return out


def redesign_rows(kernels, dc, wc, g):
    """K7 alone and with its quantize prologue; K4 forward and forward +
    input gradient on decode and training grids."""
    from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                       SparseVAEConfig)
    from infinicube_tpu_torch.nn.sparse import conv_plan
    out = {}
    for n, C, O in K7_SHAPES:
        x = (torch.randn((2, n, n, n, C), generator=g, device="cuda") *
             torch.logspace(-1, 1, C, device="cuda")).to(torch.bfloat16)
        w = torch.randn((O, C, 3, 3, 3), generator=g, device="cuda") / \
            math.sqrt(27 * C)
        b = torch.zeros(O, device="cuda")
        x8, w8, sw = dc.quantize_for_conv(x, w.to(torch.bfloat16))
        w8p = dc.pack_int8_weight(w8)
        key = f"[2,{n}^3] {C}->{O}"
        out[f"k7 {key}"] = cuda_ms(
            lambda: kernels.conv3x3x3_int8(x8, w8p, sw, b), 2, 10)
        # the main path's call: the module (f32 parameters, bf16 compute)
        conv = dc.Conv3x3x3(C, O, dtype=torch.bfloat16, device="cuda",
                            quant=True)
        conv.reset_parameters(g)
        with torch.no_grad():
            out[f"k7+prologue {key}"] = cuda_ms(lambda: conv(x), 2, 10)
        del x, w, x8, w8, w8p, conv
    torch.cuda.empty_cache()

    def k4_rows(tag, grid, level, F, Fo, vcfg):
        plan = conv_plan(grid, dense_bounds=vcfg.level_dense_bounds(level))
        m = grid.mask[..., None]
        feats = torch.where(m, torch.randn((1, grid.capacity, F),
                                           generator=g, device="cuda"), 0.0)
        w = torch.randn((27, F, Fo), generator=g, device="cuda") / \
            math.sqrt(27 * F)
        gout = torch.where(m, torch.randn((1, grid.capacity, Fo),
                                          generator=g, device="cuda"), 0.0)
        with torch.no_grad():
            out[f"k4 {tag}"] = cuda_ms(
                lambda: wc.window_sparse_conv(plan, feats, w), 2, 10)
        fg = feats.clone().requires_grad_()

        def fwd_dgrad():
            wc.window_sparse_conv(plan, fg, w).backward(gout)
            fg.grad = None
        out[f"k4+dgrad {tag}"] = cuda_ms(fwd_dgrad, 2, 10)

    vcfg = SparseVAEConfig()
    vae = SparseStructureVAE(vcfg, device="cuda")
    vae.init_params(g)
    latents = torch.randn((1, 64, 64, 64, vcfg.latent_channels),
                          generator=g, device="cuda")
    dec = vae.decode(latents)
    out["vae decode"] = _host_ms(lambda: vae.decode(latents))
    grids = dec["grids"]
    print(f"decode voxels per level "
          f"{[int(gr.mask.sum()) for gr in grids]}", flush=True)
    k4_rows(f"decode {grids[-1].capacity} 64->64", grids[-1], 0, 64, 64,
            vcfg)
    k4_rows(f"decode {grids[0].capacity} 256->256", grids[0], 2, 256, 256,
            vcfg)
    del vae, dec, grids, latents
    vcfg, tree = training_grids()
    for level, F, Fo in TRAIN_CONVS:
        k4_rows(f"train L{level} {F}->{Fo}", tree[level], level, F, Fo, vcfg)
    torch.cuda.empty_cache()
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


def step_rows(g):
    from torch.func import functional_call

    from infinicube_tpu_torch.grid.ops import majority_label
    from infinicube_tpu_torch.models.diffusion.model import (CondCubes,
                                                             DiffusionConfig,
                                                             VoxelDiffusion)
    from infinicube_tpu_torch.models.vae.loss import VAELossConfig, vae_loss
    from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                       SparseVAEConfig,
                                                       build_hash_tree)
    from infinicube_tpu_torch.training.state import (TrainConfig, TrainState,
                                                     make_train_step)
    out = {}
    diffusion = VoxelDiffusion(DiffusionConfig(serve_quant=True),
                               device="cuda")
    diffusion.init_params(g, zero_init_layers=False)
    x = torch.randn((2, 64, 64, 64, 8), generator=g, device="cuda")
    cond = CondCubes.null(2, diffusion.cfg, "cuda")
    t = torch.tensor([500, 500], device="cuda")
    for label, serve in (("int8", True), ("bf16", False)):
        with torch.no_grad():
            out[f"cfg ddim step {label}"] = _host_ms(
                lambda: diffusion.denoise(x, t, cond, serve=serve))
    del diffusion, x, cond
    torch.cuda.empty_cache()

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
        res = functional_call(model, p, b, {"generator": gen})
        return vae_loss(VAELossConfig(), res, b[0][0], b[1])

    step = make_train_step(cfg, loss_fn)
    out["vae train step"] = _host_ms(lambda: step(state, g, make_batch()))
    del model, state
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout")
    ap.add_argument("--json", default=None)
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
    rows = guard_rows(kernels, att, dense_conv, fa, g)
    rows.update(redesign_rows(kernels, dense_conv, window_conv, g))
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
