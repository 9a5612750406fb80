"""Time one checkout of the PyTorch port on one NVIDIA GPU: the kernels a
redesign changes and their guards, at the shapes of ``chip_smoke.py``'s
paths (CUDA events after warm-up), and the steps those kernels carry (host
clock around work that ends in a synchronize).

    python3 chip_time_kernels.py <checkout> [--json FILE]

- guards, timed first: K2 at d = 96 (N = 4,096 and 512, 8 heads) and
  d = 128 (37,440 x 512, 12 heads), K3 forward at [1,64^3,192]->192, K7 at
  its six shapes, K8 (N = 37,440 and 7,800) and, where the checkout has it,
  ``flash_attn_f32`` at the UNet's two SelfAttention3D shapes;
- the redesigned kernels: K1 (N = 37,440 and 7,800) and K5 (d = 96 at
  4,096 and 512), K5 also plus ``attention_delta`` (the function SDPA's
  backward computes), beside the backward of
  ``scaled_dot_product_attention`` with its backend pinned (flash where it
  takes the shape; the row names the backend that ran);
- K2 and K5 also as device time alone (``torch.profiler``), which the
  small calls need: at N = 512 launching from Python takes about as long
  as the kernel; and the host's time to issue one K2 call at N = 512 (the
  row ending in "issue"), queued behind a kernel that keeps the card busy,
  so that no launch waits for the card;
- steps: one sequential-CFG step of the 1.3B DiT at 93f@480p, one diffusion
  train step (batch 1, no remat: forward, backward, clip, AdamW, EMA) and,
  where the checkout serves f32 attention, one DDIM step of the release
  UNet in f32 with its SelfAttention3D blocks (guidance 1). Random
  weights, null conditions (the dense work does not depend on them).

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
                        TEXT_LEN, cuda_ms, rand, sdpa_backward_ms)


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


def guard_rows(kernels, dc, fa, g):
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
    for n, C, O in K7_SHAPES:
        x = rand((2, n, n, n, C), g)
        w = rand((O, C, 3, 3, 3), g) / math.sqrt(27 * C)
        x8, w8, sw = dc.quantize_for_conv(x, w)
        w8p = dc.pack_int8_weight(w8)
        b = torch.zeros(O, device="cuda")
        out[f"k7 [2,{n}^3] {C}->{O}"] = cuda_ms(
            lambda: kernels.conv3x3x3_int8(x8, w8p, sw, b), 2, 10)
        del x, w, x8, w8, w8p
    for n in (N_RELEASE, N_SERVE):
        block, npad = fa.quant_blocks(n)
        q8, sq = fa.block_quantize(fa.fold_heads(rand((1, n, H, D), g),
                                                 npad), block)
        k8, sk = fa.block_quantize(fa.fold_heads(rand((1, n, H, D), g),
                                                 npad), block)
        v8, sv = fa.channel_quantize(fa.fold_heads(rand((1, n, H, D), g),
                                                   npad))
        v8t = v8.transpose(1, 2).contiguous()
        out[f"k8 N={n}"] = cuda_ms(lambda: kernels.flash_attn_int8qkv(
            q8, k8, sq, sk, v8t, sv, 1, n, block, D ** -0.5), 2, 5)
        del q8, k8, v8, v8t
    if hasattr(kernels, "flash_attn_f32"):
        for n in (4096, 512):
            q, k, v = (rand((1, n, H96, D96), g, torch.float32)
                       for _ in range(3))
            out[f"f32 attn {n}x{n} h{H96} d{D96}"] = cuda_ms(
                lambda: kernels.flash_attn_f32(q, k, v, D96 ** -0.5), 1, 5)
    torch.cuda.empty_cache()
    return out


def redesign_rows(kernels, att, fa, g):
    """K1 and K5, with K5's yardstick: K5 plus ``attention_delta`` against
    the pinned backward of ``scaled_dot_product_attention``."""
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
        out[f"k5+delta {shape} device"] = device_ms(k5_delta)
        lib, backend = sdpa_backward_ms(q, k, v, do)
        out[f"sdpa bwd ({backend}) {shape}"] = lib
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


def step_rows(kernels, g):
    from infinicube_tpu_torch.models.diffusion.model import (CondCubes,
                                                             DiffusionConfig,
                                                             VoxelDiffusion)
    from infinicube_tpu_torch.models.wan.dit import WanDiT
    from infinicube_tpu_torch.models.wan.pipeline import WanPipelineConfig
    from infinicube_tpu_torch.training.state import (TrainConfig, TrainState,
                                                     make_train_step)
    out = {}
    if hasattr(kernels, "flash_attn_f32"):
        diffusion = VoxelDiffusion(DiffusionConfig(dtype=torch.float32),
                                   device="cuda")
        diffusion.init_params(g, zero_init_layers=False)
        x1 = torch.randn((1, 64, 64, 64, 8), generator=g, device="cuda")
        c1 = CondCubes.null(1, diffusion.cfg, "cuda")
        t1 = torch.tensor([500], device="cuda")
        with torch.no_grad():
            out["ddim step f32"] = host_ms(
                lambda: diffusion.denoise(x1, t1, c1))
        del diffusion, x1, c1
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
    from infinicube_tpu_torch.ops import attention as att
    from infinicube_tpu_torch.ops import dense_conv
    from infinicube_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build()
    built = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = guard_rows(kernels, dense_conv, fa, g)
    rows.update(redesign_rows(kernels, att, fa, g))
    rows.update(step_rows(kernels, g))
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
