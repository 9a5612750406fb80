"""Time one checkout of the PyTorch port on one NVIDIA GPU: the kernels a
redesign changes and their guards, at the shapes of ``chip_smoke.py``'s
paths (CUDA events after warm-up), and the steps those kernels carry (host
clock around work that ends in a synchronize).

    python3 chip_time_kernels.py <checkout> [--json FILE]

- K3 forward at the six release conv shapes and as dgrad at their six;
- K2 at d = 96 (N = 4,096 and 512, 8 heads) and d = 128 (37,440 x 512, 12
  heads);
- guards, timed first: K1 (N = 37,440 and 7,800), K7 at its six shapes,
  K5 (d = 96 at 4,096 and 512);
- K2 and K5 also as device time alone (``torch.profiler``), which the
  small calls need: at N = 512 launching from Python takes about as long
  as the kernel;
- the host's time to issue one call (rows ending in "issue"): K3 at the six
  forward shapes and K2 at N = 512, queued behind a kernel that keeps the
  card busy, so that no launch waits for the card;
- steps: one DDIM step of the release UNet (bf16, guidance 1), one CFG DDIM
  step at batch 2 through its int8 twin and through the bf16 UNet, one
  sequential-CFG step of the 1.3B DiT at 93f@480p, one diffusion train step
  (batch 1, no remat: forward, backward, clip, AdamW, EMA). Random weights,
  null conditions (the dense work does not depend on them).

Prints one line of milliseconds and, with ``--json``, writes them there. To
compare two checkouts, run it on each in turns inside one job on one card
(a, b, b, a): each run builds the kernels of the checkout it is given and
imports ``infinicube_tpu_torch`` from there; it uses only what both sides
of such a comparison have."""

import argparse
import json
import math
import sys
import time

import torch

from chip_smoke import (D, D96, H, H96, K3_SHAPES, K7_SHAPES, N_RELEASE,
                        N_SERVE, TEXT_LEN, cuda_ms, rand)


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


def kernel_rows(kernels, dc, fa, g):
    """The guards first (K1, K7, K5), then K2 and K3, so that no guard is
    timed right after a run of the redesigned kernels at full power."""
    out = {}
    for n in (N_RELEASE, N_SERVE):
        block, npad = fa.quant_blocks(n)
        q8, sq = fa.block_quantize(fa.fold_heads(rand((1, n, H, D), g),
                                                 npad), block)
        k8, sk = fa.block_quantize(fa.fold_heads(rand((1, n, H, D), g),
                                                 npad), block)
        v = rand((1, n, H, D), g)
        out[f"k1 N={n}"] = cuda_ms(lambda: kernels.flash_attn_int8qk(
            q8, k8, sq, sk, v, block, D ** -0.5), 2, 5)
        del q8, k8, v
    for n, C, O in K7_SHAPES:
        x = rand((2, n, n, n, C), g)
        w = rand((O, C, 3, 3, 3), g) / math.sqrt(27 * C)
        x8, w8, sw = dc.quantize_for_conv(x, w)
        w8p = dc.pack_int8_weight(w8)
        b = torch.zeros(O, device="cuda")
        out[f"k7 [2,{n}^3] {C}->{O}"] = cuda_ms(
            lambda: kernels.conv3x3x3_int8(x8, w8p, sw, b), 2, 10)
        del x, w, x8, w8, w8p
    for n in (4096, 512):
        q, k, v, do = (rand((1, n, H96, D96), g) for _ in range(4))
        o, lse = kernels.flash_attn_bf16(q, k, v, D96 ** -0.5,
                                         return_lse=True)
        delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()

        def k5():
            return kernels.flash_attn_bf16_bwd(q, k, v, do, lse, delta,
                                               D96 ** -0.5)
        out[f"k5 {n}x{n} h{H96} d{D96}"] = cuda_ms(k5, 3, 20)
        out[f"k5 {n}x{n} h{H96} d{D96} device"] = device_ms(k5)
    for nq, nk, h, d in ((N_RELEASE, TEXT_LEN, H, D), (4096, 4096, H96, D96),
                         (512, 512, H96, D96)):
        q, k, v = (rand((1, n, h, d), g) for n in (nq, nk, nk))

        def k2():
            return kernels.flash_attn_bf16(q, k, v, d ** -0.5)
        out[f"k2 {nq}x{nk} h{h} d{d}"] = cuda_ms(k2, 3, 20)
        out[f"k2 {nq}x{nk} h{h} d{d} device"] = device_ms(k2)
        if nq == 512:
            out[f"k2 {nq}x{nk} h{h} d{d} issue"] = issue_ms(k2)
    out.update(k3_rows(kernels, dc, g))
    return out


def k3_rows(kernels, dc, g):
    """K3 forward and as dgrad at the six release conv shapes."""
    out = {}
    for n, C, O in K3_SHAPES:
        x = rand((1, n, n, n, C), g)
        w = rand((O, C, 3, 3, 3), g) / math.sqrt(27 * C)
        wp = dc.pack_conv_weight(w)
        b = torch.zeros(O, device="cuda")

        def k3():
            return kernels.conv3x3x3_bf16(x, wp, b)
        out[f"k3 {n}^3 {C}->{O}"] = cuda_ms(k3, 2, 10)
        out[f"k3 {n}^3 {C}->{O} issue"] = issue_ms(k3)
        go = rand((1, n, n, n, O), g)
        wd = dc.pack_conv_weight(dc.dgrad_weight(w))
        out[f"k3 dgrad {n}^3 {O}->{C}"] = cuda_ms(
            lambda: kernels.conv3x3x3_bf16(go, wd, None), 2, 10)
        del x, w, wp, go, wd
    torch.cuda.empty_cache()
    return out


def host_ms(fn, runs=3):
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
    from infinicube_tpu_torch.models.diffusion.model import (CondCubes,
                                                             DiffusionConfig,
                                                             VoxelDiffusion)
    from infinicube_tpu_torch.models.wan.dit import WanDiT
    from infinicube_tpu_torch.models.wan.pipeline import WanPipelineConfig
    from infinicube_tpu_torch.training.state import (TrainConfig, TrainState,
                                                     make_train_step)
    out = {}
    diffusion = VoxelDiffusion(DiffusionConfig(serve_quant=True),
                               device="cuda")
    diffusion.init_params(g, zero_init_layers=False)
    x1 = torch.randn((1, 64, 64, 64, 8), generator=g, device="cuda")
    x2 = torch.randn((2, 64, 64, 64, 8), generator=g, device="cuda")
    c1 = CondCubes.null(1, diffusion.cfg, "cuda")
    c2 = CondCubes.null(2, diffusion.cfg, "cuda")
    t1 = torch.tensor([500], device="cuda")
    t2 = torch.tensor([500, 500], device="cuda")
    with torch.no_grad():
        out["ddim step bf16"] = host_ms(lambda: diffusion.denoise(x1, t1, c1))
        out["cfg step int8"] = host_ms(
            lambda: diffusion.denoise(x2, t2, c2, serve=True))
        out["cfg step bf16"] = host_ms(
            lambda: diffusion.denoise(x2, t2, c2, serve=False))
    del diffusion, x1, x2, c1, c2
    torch.cuda.empty_cache()

    cfg = WanPipelineConfig.serving()
    dit = WanDiT(cfg.dit, device="cuda").eval().requires_grad_(False)
    dit.init_params(g)
    dit.to(torch.bfloat16)
    T, Hl, Wl = WanPipelineConfig(num_frames=93).latent_thw
    lat = torch.randn((1, T, Hl, Wl, 16), generator=g, device="cuda")
    buf = torch.randn((1, T, Hl, Wl, 32), generator=g, device="cuda")
    txt = [torch.randn((1, TEXT_LEN, 4096), generator=g, device="cuda")
           for _ in range(2)]
    tt = torch.tensor([600.0], device="cuda")
    with torch.no_grad():
        out["dit 93f cfg step"] = host_ms(
            lambda: [dit(lat, tt, c, buf) for c in txt], runs=2)
    del dit, lat, buf, txt
    torch.cuda.empty_cache()

    tcfg = TrainConfig()
    model = VoxelDiffusion(DiffusionConfig(), device="cuda", trainable=True)
    model.init_params(g, zero_init_layers=False)
    state = TrainState.create(tcfg, model.named_parameters())
    batch = (torch.randn((1, 64, 64, 64, 8), generator=g, device="cuda"),
             CondCubes.null(1, model.cfg, "cuda"))
    step = make_train_step(
        tcfg, lambda p, gen, b: model.train_loss(*b, generator=gen, params=p))
    step(state, g, batch)
    out["train step"] = host_ms(lambda: step(state, g, batch))
    del model, state, batch
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    sys.path.insert(0, args.checkout)
    from infinicube_tpu_torch import kernels
    from infinicube_tpu_torch.ops import dense_conv
    from infinicube_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build()
    built = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = kernel_rows(kernels, dense_conv, fa, g)
    rows.update(step_rows(g))
    print(f"{args.checkout} (build {built:.1f} s) | " +
          " | ".join(f"{k}: {v:.4f}" for k, v in rows.items()), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"checkout": args.checkout, "build_s": built,
                       "device": torch.cuda.get_device_name(0), "ms": rows},
                      f, indent=1)


if __name__ == "__main__":
    main()
