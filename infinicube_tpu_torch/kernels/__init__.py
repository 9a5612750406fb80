"""The port's hand-written CUDA kernels: build, load, launch, count.

Every ``infinicube_tpu_torch/csrc/*.cu`` source is compiled at first use with
``nvcc`` for ``sm_90a`` into a shared library of its own with a plain C
interface under ``infinicube_tpu_torch/_build`` (named by a hash of source,
the ``*.cuh`` headers and flags, so an edited source is rebuilt), and loaded
with ``ctypes``. ``build``
starts one ``nvcc`` per source, all at once. Every entry point returns
``cudaGetLastError()``; the wrappers raise when it is not 0.

The wrappers take CUDA tensors only. Each adds one to its entry in
``launches`` where it launches its kernel and nowhere else, so a run can show
that it went through the kernel. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# source stem -> {entry point: ctypes argtypes}
SIGNATURES = {
    "flash_attention": {
        "flash_attn_bf16": [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _P],
        "flash_attn_int8qk": [_P] * 6 + [_I] * 6 + [_L] * 12 + [_F, _P],
        "flash_attn_int8qkv": [_P] * 7 + [_I] * 6 + [_L] * 12 + [_F, _P],
    },
    "flash_attention_bwd": {
        "flash_attn_bf16_bwd": [_P] * 9 + [_I] * 5 + [_L] * 21 + [_F, _P],
    },
    "flash_attention_f32": {
        "flash_attn_f32": [_P] * 9 + [_I] * 7 + [_L] * 12 + [_F, _P],
        "flash_attn_f32_splits": [_I] * 6,
    },
    "flash_attention_f32_bwd": {
        "flash_attn_f32_bwd": [_P] * 11 + [_I] * 6 + [_L] * 21 + [_F, _P],
        "flash_attn_f32_bwd_splits": [_I] * 7,
    },
    "dense_conv": {"conv3x3x3_bf16": [_P] * 5 + [_I] * 8 + [_P],
                   "conv3x3x3_bf16_splits": [_I] * 7,
                   "conv3x3x3_f32": [_P] * 5 + [_I] * 8 + [_P],
                   "conv3x3x3_f32_splits": [_I] * 7,
                   "conv3x3x3_int8": [_P] * 6 + [_I] * 8 + [_P],
                   "conv3x3x3_int8_splits": [_I] * 7,
                   "int8_conv_amax": [_P] * 3 + [_L] + [_I] * 5 + [_L, _P],
                   "int8_conv_quantize_x": [_P] * 3 + [_L] + [_I] * 2 + [_P],
                   "int8_conv_quantize_w": [_P, _I] + [_P] * 3 + [_I] * 4
                   + [_P]},
    "sparse_conv": {"sparse_conv_f32": [_P] * 5 + [_I] * 4 + [_P],
                    "sparse_conv_bf16": [_P] * 5 + [_I] * 4 + [_P]},
    "sparse_conv_bwd": {"sparse_conv_f32_wgrad": [_P] * 6 + [_I] * 5 + [_P],
                        "sparse_conv_bf16_wgrad": [_P] * 6 + [_I] * 8
                        + [_P]},
}

# K3 and K4 each serve two rows of the kernel table, so their launches are
# counted apart: the forward under its own name, the input gradient under
# these
K3_DGRAD = "conv3x3x3_bf16_dgrad"
K4_DGRAD = "sparse_conv_f32_dgrad"
K4_BF16_DGRAD = "sparse_conv_bf16_dgrad"
# the split plan queries launch nothing
_NOT_COUNTED = ("conv3x3x3_bf16_splits", "conv3x3x3_f32_splits",
                "conv3x3x3_int8_splits", "flash_attn_f32_splits",
                "flash_attn_f32_bwd_splits")
launches: dict[str, int] = {name: 0 for fns in SIGNATURES.values()
                            for name in fns if name not in _NOT_COUNTED} | \
    {K3_DGRAD: 0, K4_DGRAD: 0, K4_BF16_DGRAD: 0}
_sms: dict[int, int] = {}
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(stem: str) -> Path:
    src = CSRC / f"{stem}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    return BUILD_DIR / f"lib{stem}-{key.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every source that is not built already, one ``nvcc`` each,
    all started together. Returns the seconds the builds took (0.0 when
    nothing was built)."""
    todo = [s for s in SIGNATURES if not _target(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    jobs = []
    for stem in todo:
        tmp = _target(stem).with_suffix(f".{os.getpid()}.tmp")
        jobs.append((stem, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for stem, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {stem}.cu:\n{log}")
        else:
            os.replace(tmp, _target(stem))
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def _fn(stem: str, name: str):
    lib = _libs.get(stem)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(_target(stem)))
        for fn_name, argtypes in SIGNATURES[stem].items():
            getattr(lib, fn_name).argtypes = argtypes
            getattr(lib, fn_name).restype = _I
        _libs[stem] = lib
    return getattr(lib, name)


def _check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError("kernel inputs must be CUDA tensors on one device")


def _check_bnhd(x: torch.Tensor, name: str, elem_align: int) -> None:
    """[B, N, h, d] view with unit last stride whose other strides and base
    address allow 16-byte vector loads."""
    if x.dim() != 4 or x.stride(3) != 1:
        raise ValueError(f"{name}: need a [B, N, h, d] view with stride(-1)"
                         f" == 1, got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    if any(s % elem_align for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(f"{name}: strides {x.stride()} / address not "
                         "16-byte aligned")


def _check_dense(x: torch.Tensor, name: str, shape: tuple,
                 dtype: torch.dtype) -> None:
    if tuple(x.shape) != shape or x.dtype != dtype or \
            not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: need a contiguous, 16-byte aligned {dtype}"
                         f" tensor of shape {shape}, got {x.dtype} "
                         f"{tuple(x.shape)}")


def _run(stem: str, name: str, device: torch.device, *args,
         count_as: str | None = None) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(stem, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[count_as or name] += 1


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16,
               name: str = "flash_attn_bf16") -> None:
    """What K2 and K5 (bf16) and ``flash_attn_f32`` take: [B, N, h, d] views
    of ``dtype`` on one card, d in {64, 96, 128}, 16-byte aligned."""
    _check_cuda(q, k, v)
    B, nq, h, d = q.shape
    nk = k.shape[1]
    if k.shape != (B, nk, h, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)}"
                         f" v{tuple(v.shape)}")
    if d not in (64, 96, 128):
        raise ValueError(f"head dim {d} not supported (64, 96 or 128)")
    if any(t.dtype != dtype for t in (q, k, v)):
        raise ValueError(f"{name} takes {dtype} q, k, v, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if nq == 0 or nk == 0:
        raise ValueError("empty sequence")
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        _check_bnhd(t, n, 16 // q.element_size())


def flash_attn_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float, return_lse: bool = False):
    """K2: softmax(q k^T * sm_scale) v, non-causal. q [B, Nq, h, d], k/v
    [B, Nk, h, d], bf16, d in {64, 96, 128}. Returns [B, Nq, h, d] bf16 and,
    with ``return_lse``, also the natural log-sum-exp of each row's scaled
    logits, f32 [B, h, Nq] (what K5 needs; the kernel stores it only then)."""
    _check_qkv(q, k, v)
    B, nq, h, d = q.shape
    o = torch.empty((B, nq, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((B, h, nq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    _run("flash_attention", "flash_attn_bf16", q.device, q.data_ptr(),
         k.data_ptr(), v.data_ptr(), o.data_ptr(),
         lse.data_ptr() if return_lse else None, B, h, nq, k.shape[1], d,
         *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
         *o.stride()[:3], float(sm_scale))
    return (o, lse) if return_lse else o


def flash_attn_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sm_scale: float, return_lse: bool = False):
    """softmax(q k^T * sm_scale) v to f32 accuracy, non-causal, on the
    tensor cores by the 3xTF32 split: q [B, Nq, h, d], k/v [B, Nk, h, d],
    f32 views with 16-byte aligned strides, d in {64, 96, 128}. Returns f32
    [B, Nq, h, d] and, with ``return_lse``, also the natural log-sum-exp of
    each row's scaled logits, f32 [B, h, Nq] (what ``flash_attn_f32_bwd``
    needs; the kernel stores it only then). One call launches the kernel's
    prologue (K's tf32 parts and V's transposed ones, into scratch this
    wrapper allocates), the kernel and, where the keys are split into
    ranges (``f32_attn_splits``), the pass that combines them; it counts
    once."""
    _check_qkv(q, k, v, torch.float32, "flash_attn_f32")
    B, nq, h, d = q.shape
    nk = k.shape[1]
    dev = q.device
    sms = _sm_count(dev)
    splits = f32_attn_splits(B, h, nq, nk, d, sms)
    o = torch.empty((B, nq, h, d), dtype=torch.float32, device=dev)
    lse = torch.empty((B, h, nq), dtype=torch.float32, device=dev) \
        if return_lse else None
    # one scratch buffer (each allocation costs the host time): K's parts
    # [2, B*h, nk, d], V's transposed [2, B*h, d, nk rounded up to 8] and,
    # with key ranges, their outputs [S, B*h, nq, d] and row statistics
    # [S, B*h, nq, 2] (every part a multiple of 8 floats: 16-byte aligned)
    sizes = (2 * B * h * nk * d, 2 * B * h * d * (-(-nk // 8) * 8),
             splits * B * h * nq * d, splits * B * h * nq * 2)
    if splits == 1:
        sizes = sizes[:2]
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    ptrs, at = [], scratch.data_ptr()
    for n in sizes:
        ptrs.append(at)
        at += 4 * n
    ptrs += [None] * (4 - len(ptrs))
    _run("flash_attention_f32", "flash_attn_f32", dev, q.data_ptr(),
         k.data_ptr(), v.data_ptr(), o.data_ptr(), *ptrs,
         lse.data_ptr() if return_lse else None, B, h, nq, nk, d, splits,
         sms, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
         *o.stride()[:3], float(sm_scale))
    return (o, lse) if return_lse else o


@functools.lru_cache(maxsize=None)
def f32_attn_splits(B: int, h: int, nq: int, nk: int, d: int,
                    sms: int) -> int:
    """The number of key ranges ``flash_attn_f32`` takes at this shape on a
    card with ``sms`` SMs (1: none), from the kernel's own plan."""
    return _fn("flash_attention_f32", "flash_attn_f32_splits")(
        B, h, nq, nk, d, sms)


def flash_attn_bf16_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, sm_scale: float):
    """K5: the gradients of K2's function. q, k, v as K2 took them; dout bf16
    [B, Nq, h, d] (the output's gradient); lse f32 [B, h, Nq] as K2 stored
    it; delta f32 [B, h, Nq] = sum_d o * dout. Returns (dq, dk, dv), bf16,
    shaped like q, k, v. One call launches the dK/dV kernel and the dQ
    kernel and counts once."""
    _check_qkv(q, k, v)
    _check_cuda(q, dout, lse, delta)
    B, nq, h, d = q.shape
    if dout.shape != q.shape or dout.dtype != torch.bfloat16:
        raise ValueError(f"dout must be bf16 {tuple(q.shape)}, got "
                         f"{dout.dtype} {tuple(dout.shape)}")
    _check_bnhd(dout, "dout", 8)
    _check_dense(lse, "lse", (B, h, nq), torch.float32)
    _check_dense(delta, "delta", (B, h, nq), torch.float32)
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.bfloat16, device=q.device)
                  for t in (q, k, v))
    _run("flash_attention_bwd", "flash_attn_bf16_bwd", q.device, q.data_ptr(),
         k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
         delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, h,
         nq, k.shape[1], d, *q.stride()[:3], *k.stride()[:3],
         *v.stride()[:3], *dout.stride()[:3], *dq.stride()[:3],
         *dk.stride()[:3], *dv.stride()[:3], float(sm_scale))
    return dq, dk, dv


def flash_attn_f32_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, sm_scale: float):
    """The gradients of ``flash_attn_f32``'s function to f32 accuracy (3xTF32
    on the tensor cores). q, k, v as the forward took them; dout f32
    [B, Nq, h, d] (the output's gradient), 16-byte aligned strides; lse f32
    [B, h, Nq] as the forward stored it; delta f32 [B, h, Nq] = sum_d o *
    dout. Returns (dq, dk, dv), f32, shaped like q, k, v, bit-identical
    from run to run. One call launches the prologue (the tf32 parts of q,
    k, v and dout as they lie and of q, dout and k token-major,
    ``f32_bwd_prologue_plain``'s layout, into scratch allocated here), the
    dK/dV kernel and the dQ kernel and, for a pass whose streamed axis is
    split into ranges (``f32_bwd_splits``), the pass that adds the ranges;
    it counts once."""
    _check_qkv(q, k, v, torch.float32, "flash_attn_f32_bwd")
    _check_cuda(q, dout, lse, delta)
    B, nq, h, d = q.shape
    nk = k.shape[1]
    if dout.shape != q.shape or dout.dtype != torch.float32:
        raise ValueError(f"dout must be f32 {tuple(q.shape)}, got "
                         f"{dout.dtype} {tuple(dout.shape)}")
    _check_bnhd(dout, "dout", 4)
    _check_dense(lse, "lse", (B, h, nq), torch.float32)
    _check_dense(delta, "delta", (B, h, nq), torch.float32)
    if B * h > 65535:
        raise ValueError(f"too many (batch, head) pairs for one launch: "
                         f"{B * h}")
    dev = q.device
    sms = _sm_count(dev)
    s_kv, s_q = (f32_bwd_splits(B, h, nq, nk, d, sms, dkv)
                 for dkv in (True, False))
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=dev)
                  for t in (q, k, v))
    # the prologue's copies: [2, B*h, N, d] of q, k, v, dout, then
    # [2, B*h, d, N rounded up to 8] of q, dout, k; the ranges' partial sums
    # (dK and dV, then dQ) where a pass takes more than one
    bh, nqp, nkp = B * h, -(-nq // 8) * 8, -(-nk // 8) * 8
    scratch = torch.empty(2 * bh * d * (2 * nq + 2 * nk + 2 * nqp + nkp),
                          dtype=torch.float32, device=dev)
    n_part = (2 * s_kv * bh * nk * d if s_kv > 1 else 0) + \
        (s_q * bh * nq * d if s_q > 1 else 0)
    part = torch.empty(n_part, dtype=torch.float32, device=dev) \
        if n_part else None
    _run("flash_attention_f32_bwd", "flash_attn_f32_bwd", dev,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
         lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
         dv.data_ptr(), scratch.data_ptr(),
         part.data_ptr() if part is not None else None, B, h, nq, nk, d,
         sms, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
         *dout.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
         *dv.stride()[:3], float(sm_scale))
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def f32_bwd_splits(B: int, h: int, nq: int, nk: int, d: int, sms: int,
                   dkv: bool) -> int:
    """The number of ranges ``flash_attn_f32_bwd`` splits the streamed axis
    of its dK/dV pass (``dkv``: the queries) or its dQ pass (the keys) into
    on a card with ``sms`` SMs (1: none), from the kernel's own plan."""
    return _fn("flash_attention_f32_bwd", "flash_attn_f32_bwd_splits")(
        B, h, nq, nk, d, sms, int(dkv))


def f32_bwd_prologue_plain(x: torch.Tensor):
    """What ``flash_attn_f32_bwd``'s prologue writes for one of its inputs
    x [B, N, h, d] (f32): its tf32 hi and lo as it lies, [2, B*h, N, d],
    and token-major, [2, B*h, d, Np] (Np = N rounded up to 8, zeros past N),
    the tokens of each 8 in the order 0, 2, 4, 6, 1, 3, 5, 7, so that a
    row of P or dS taken from the accumulators is an A fragment."""
    from ..ops.window_conv import tf32_split
    B, n, h, d = x.shape
    rows = x.float().permute(0, 2, 1, 3).reshape(B * h, n, d)
    dm = tf32_split(rows)
    n_p = -(-n // 8) * 8
    tok = torch.nn.functional.pad(rows, (0, 0, 0, n_p - n))
    order = torch.tensor((0, 2, 4, 6, 1, 3, 5, 7))
    idx = (torch.arange(n_p) // 8 * 8).reshape(-1, 8) + order
    tm = tf32_split(tok[:, idx.reshape(-1)].transpose(1, 2).contiguous())
    return dm, tm


def flash_attn_int8qk(q8: torch.Tensor, k8: torch.Tensor, qscale: torch.Tensor,
                      kscale: torch.Tensor, v: torch.Tensor, block: int,
                      sm_scale: float) -> torch.Tensor:
    """K1: int8-QK attention. q8/k8 int8 [B*h, Npad, d] with f32 scales
    [B*h, Npad/block] (one per block of rows, ``block_quantize``; the block
    a multiple of 128, as ``quant_blocks`` makes it); v bf16 [B, N, h, d]
    with N <= Npad real tokens; keys >= N are masked. Returns
    [B, N, h, d] bf16."""
    _check_cuda(q8, k8, qscale, kscale, v)
    B, n, h, d = v.shape
    BH, npad = q8.shape[:2]
    if q8.shape != (B * h, npad, d) or k8.shape != q8.shape or npad < n:
        raise ValueError(f"shape mismatch q8{tuple(q8.shape)} "
                         f"k8{tuple(k8.shape)} v{tuple(v.shape)}")
    if d not in (64, 128):
        raise ValueError(f"head dim {d} not supported (64 or 128)")
    if q8.dtype != torch.int8 or k8.dtype != torch.int8 or \
            v.dtype != torch.bfloat16:
        raise ValueError("flash_attn_int8qk takes int8 q8/k8 and bf16 v")
    if block % 128 or npad % block:
        raise ValueError(f"block {block} must be a multiple of 128 that "
                         f"divides Npad={npad}")
    nb = npad // block
    for s, nm in ((qscale, "qscale"), (kscale, "kscale")):
        if s.shape != (BH, nb) or s.dtype != torch.float32 or \
                not s.is_contiguous():
            raise ValueError(f"{nm} must be contiguous f32 [{BH}, {nb}]")
    if not (q8.is_contiguous() and k8.is_contiguous()):
        raise ValueError("q8/k8 must be contiguous")
    _check_bnhd(v, "v", 8)
    o = torch.empty((B, n, h, d), dtype=torch.bfloat16, device=v.device)
    fold = (h * npad * d, d, npad * d)  # batch, token, head strides of q8/k8
    _run("flash_attention", "flash_attn_int8qk", v.device, q8.data_ptr(),
         k8.data_ptr(), v.data_ptr(), o.data_ptr(), qscale.data_ptr(),
         kscale.data_ptr(), B, h, n, d, block, nb, *fold, *fold,
         *v.stride()[:3], *o.stride()[:3], float(sm_scale))
    return o


def flash_attn_int8qkv(q8: torch.Tensor, k8: torch.Tensor,
                       qscale: torch.Tensor, kscale: torch.Tensor,
                       v8t: torch.Tensor, vscale: torch.Tensor, B: int,
                       n: int, block: int, sm_scale: float) -> torch.Tensor:
    """K8: attention with int8 QK^T and int8 PV. q8/k8 int8 [B*h, Npad, d]
    with f32 scales [B*h, Npad/block] as for K1 (the block a multiple of
    128); v8t int8 [B*h, d, Npad], V quantized per channel
    (``channel_quantize``), transposed and its keys permuted within each 16
    (``flash_attention.pack_v8``), with f32 scales vscale [B*h, d]; the
    first n of Npad tokens are real, keys >= n are masked. Returns
    [B, n, h, d] bf16."""
    _check_cuda(q8, k8, qscale, kscale, v8t, vscale)
    BH, npad, d = q8.shape
    h = BH // B
    if BH != B * h or k8.shape != q8.shape or \
            v8t.shape != (BH, d, npad) or not 0 < n <= npad:
        raise ValueError(f"shape mismatch q8{tuple(q8.shape)} "
                         f"k8{tuple(k8.shape)} v8t{tuple(v8t.shape)} B={B} "
                         f"n={n}")
    if d not in (64, 128):
        raise ValueError(f"head dim {d} not supported (64 or 128)")
    if block % 128 or npad % block:
        raise ValueError(f"block {block} must be a multiple of 128 that "
                         f"divides Npad={npad}")
    nb = npad // block
    for t, nm in ((q8, "q8"), (k8, "k8")):
        _check_dense(t, nm, (BH, npad, d), torch.int8)
    _check_dense(v8t, "v8t", (BH, d, npad), torch.int8)
    _check_dense(qscale, "qscale", (BH, nb), torch.float32)
    _check_dense(kscale, "kscale", (BH, nb), torch.float32)
    _check_dense(vscale, "vscale", (BH, d), torch.float32)
    o = torch.empty((B, n, h, d), dtype=torch.bfloat16, device=q8.device)
    fold = (h * npad * d, d, npad * d)  # batch, token, head strides of q8/k8
    _run("flash_attention", "flash_attn_int8qkv", q8.device, q8.data_ptr(),
         k8.data_ptr(), v8t.data_ptr(), o.data_ptr(), qscale.data_ptr(),
         kscale.data_ptr(), vscale.data_ptr(), B, h, n, d, block, nb, *fold,
         *fold, h * d * npad, npad, d * npad, *o.stride()[:3],
         float(sm_scale))
    return o


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _check_conv(x: torch.Tensor, w_packed: torch.Tensor,
                bias: torch.Tensor | None, dtype: torch.dtype, name: str):
    """What K3 and the f32 conv take: x [B, D, H, W, C] of ``dtype``, the
    pack [O, 27*C] (K3, bf16) or [2, O, 27*C] (f32: its tf32 hi and lo),
    bias f32 [O] or None; C and O multiples of 8."""
    _check_cuda(x, w_packed, *(() if bias is None else (bias,)))
    if x.dim() != 5 or w_packed.dim() < 2:
        raise ValueError(f"{name}: x must be [B, D, H, W, C], got "
                         f"{tuple(x.shape)}")
    B, D, H, W, C = x.shape
    O = w_packed.shape[-2]
    if min(B, D, H, W, C, O) < 1 or B * D * H * W >= 2 ** 31 or \
            C % 8 or O % 8:
        raise ValueError(f"{name} takes C, O multiples of 8, got "
                         f"x{tuple(x.shape)} -> {O}")
    parts = (2,) if dtype == torch.float32 else ()
    _check_dense(x, "x", (B, D, H, W, C), dtype)
    _check_dense(w_packed, "w_packed", parts + (O, 27 * C), dtype)
    if bias is not None:
        _check_dense(bias, "bias", (O,), torch.float32)
    return B, D, H, W, C, O


def conv3x3x3_bf16(x: torch.Tensor, w_packed: torch.Tensor,
                   bias: torch.Tensor | None) -> torch.Tensor:
    """K3: 3x3x3 stride-1 SAME conv. x bf16 [B, D, H, W, C] contiguous;
    w_packed bf16 [O, 27*C] (``pack_conv_weight``); bias f32 [O] or None
    (the input-gradient call has none, and is counted under ``K3_DGRAD``).
    C and O multiples of 8. Returns bf16 [B, D, H, W, O]. Where the output
    tiles fall short of the card's SMs the kernel splits its K range
    (``k3_splits``): this wrapper then allocates the f32 partials
    [S, B*D*H*W, O], and the call launches the kernel and the fixed-order
    sum of the slices (counted once)."""
    B, D, H, W, C, O = _check_conv(x, w_packed, bias, torch.bfloat16,
                                   "conv3x3x3_bf16")
    out = torch.empty((B, D, H, W, O), dtype=torch.bfloat16, device=x.device)
    sms = _sm_count(x.device)
    splits = k3_splits(B, D, H, W, C, O, sms)
    partial = None if splits == 1 else torch.empty(
        (splits, B * D * H * W, O), dtype=torch.float32, device=x.device)
    _run("dense_conv", "conv3x3x3_bf16", x.device, x.data_ptr(),
         w_packed.data_ptr(), None if bias is None else bias.data_ptr(),
         out.data_ptr(), None if partial is None else partial.data_ptr(),
         splits, B, D, H, W, C, O, sms,
         count_as=K3_DGRAD if bias is None else None)
    return out


@functools.lru_cache(maxsize=None)
def k3_splits(B: int, D: int, H: int, W: int, C: int, O: int,
              sms: int) -> int:
    """The number of K slices K3 takes at this shape on a card with ``sms``
    SMs (1: no split), from the kernel's own plan, asked once a shape."""
    return _fn("dense_conv", "conv3x3x3_bf16_splits")(B, D, H, W, C, O, sms)


def conv3x3x3_f32(x: torch.Tensor, w_packed: torch.Tensor,
                  bias: torch.Tensor | None) -> torch.Tensor:
    """The f32 3x3x3 stride-1 SAME conv, f32-accurate on the tensor cores
    by the 3xTF32 split (K3's kernel in f32). x f32 [B, D, H, W, C]
    contiguous; w_packed f32 [2, O, 27*C], the tf32 hi and lo of the packed
    weights (``pack_conv_weight(w, torch.float32)``); bias f32 [O] or None
    (the input-gradient call). C and O multiples of 8. Returns f32
    [B, D, H, W, O]; every call counts under ``conv3x3x3_f32``. Where the
    output tiles fall short of the card's SMs the kernel splits its K range
    (``f32_conv_splits``) into f32 partials this wrapper allocates, summed
    in slice order by a second kernel of the same call."""
    B, D, H, W, C, O = _check_conv(x, w_packed, bias, torch.float32,
                                   "conv3x3x3_f32")
    out = torch.empty((B, D, H, W, O), dtype=torch.float32, device=x.device)
    sms = _sm_count(x.device)
    splits = f32_conv_splits(B, D, H, W, C, O, sms)
    partial = None if splits == 1 else torch.empty(
        (splits, B * D * H * W, O), dtype=torch.float32, device=x.device)
    _run("dense_conv", "conv3x3x3_f32", x.device, x.data_ptr(),
         w_packed.data_ptr(), None if bias is None else bias.data_ptr(),
         out.data_ptr(), None if partial is None else partial.data_ptr(),
         splits, B, D, H, W, C, O, sms)
    return out


@functools.lru_cache(maxsize=None)
def f32_conv_splits(B: int, D: int, H: int, W: int, C: int, O: int,
                    sms: int) -> int:
    """The number of K slices the f32 conv takes at this shape on a card
    with ``sms`` SMs (1: no split), from the kernel's own plan."""
    return _fn("dense_conv", "conv3x3x3_f32_splits")(B, D, H, W, C, O, sms)


def conv3x3x3_int8(x8: torch.Tensor, w8_packed: torch.Tensor,
                   sw: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K7: the int8 3x3x3 stride-1 SAME conv. x8 int8 [B, D, H, W, C]
    contiguous; w8_packed int8 [O, 27*C] (``pack_int8_weight``, dx-major);
    sw f32 [3, O], the per-(dx, output channel) scales; bias f32 [O]. C and
    O multiples of 32. Returns bf16 [B, D, H, W, O], equal bit for bit to
    ``conv3x3x3_int8_plain``. Where the output tiles fall short of the
    card's SMs the kernel splits each dx group's K range (``k7_splits``):
    this wrapper then allocates the int32 partials [S, B*D*H*W, O], and the
    call launches the kernel and the exact sum of the slices (counted
    once)."""
    _check_cuda(x8, w8_packed, sw, bias)
    if x8.dim() != 5:
        raise ValueError(f"x8 must be [B, D, H, W, C], got {tuple(x8.shape)}")
    B, D, H, W, C = x8.shape
    O = w8_packed.shape[0]
    if C % 32 or O % 32 or min(B, D, H, W, C, O) < 1:
        raise ValueError(f"conv3x3x3_int8 takes C, O multiples of 32, got "
                         f"x{tuple(x8.shape)} -> {O}")
    M = B * D * H * W
    if M >= 2 ** 31 or -(-M // 128) * -(-O // 32) * 48 >= 2 ** 31:
        raise ValueError(f"too many voxels for one launch: {tuple(x8.shape)}"
                         f" -> {O}")
    _check_dense(x8, "x8", (B, D, H, W, C), torch.int8)
    _check_dense(w8_packed, "w8_packed", (O, 27 * C), torch.int8)
    _check_dense(sw, "sw", (3, O), torch.float32)
    _check_dense(bias, "bias", (O,), torch.float32)
    out = torch.empty((B, D, H, W, O), dtype=torch.bfloat16, device=x8.device)
    sms = _sm_count(x8.device)
    splits = k7_splits(B, D, H, W, C, O, sms)
    partial = None if splits == 1 else torch.empty(
        (splits, M, O), dtype=torch.int32, device=x8.device)
    _run("dense_conv", "conv3x3x3_int8", x8.device, x8.data_ptr(),
         w8_packed.data_ptr(), sw.data_ptr(), bias.data_ptr(),
         out.data_ptr(), None if partial is None else partial.data_ptr(),
         splits, B, D, H, W, C, O, sms)
    return out


@functools.lru_cache(maxsize=None)
def k7_splits(B: int, D: int, H: int, W: int, C: int, O: int,
              sms: int) -> int:
    """The number of K slices K7 takes at this shape on a card with ``sms``
    SMs (1, or a multiple of 3: as many in each dx group), from the
    kernel's own plan, asked once a shape."""
    return _fn("dense_conv", "conv3x3x3_int8_splits")(B, D, H, W, C, O, sms)


# int8_conv_amax's plan (csrc/dense_conv.cu kAmaxThreads, kAmaxGroup,
# kAmaxCounters): threads a block at most (two blocks an SM), the blocks
# whose partial rows one last arrival reduces, the counters of the tree
AMAX_THREADS = 512
AMAX_GROUP = 16
AMAX_COUNTERS = 1024


class AmaxPlan(NamedTuple):
    vs: int        # 16-byte channel vectors of a slab (a block's width)
    rpb: int       # rows a block loads at a time: vs * rpb threads
    slabs: int     # slabs of vs vectors across the row
    blocks: int    # row ranges (grid x)
    rows: int      # rows of a range


@functools.lru_cache(maxsize=None)
def amax_plan(M: int, C: int, sms: int) -> AmaxPlan:
    """How ``int8_conv_amax`` covers x [M, C] (C a multiple of 8) on a card
    with ``sms`` SMs. A block is vs 16-byte channel vectors wide (the whole
    row, or a slab of it past AMAX_THREADS vectors) and rpb rows deep, with
    vs * rpb a multiple of 32 where that fits in AMAX_THREADS threads, so
    that every lane of every warp loads; the blocks (two an SM, one wave)
    split the rows into equal ranges."""
    vpr = C // 8
    slabs = -(-vpr // AMAX_THREADS)
    vs = -(-vpr // slabs)
    q = 32 // math.gcd(vs, 32)
    rpb = AMAX_THREADS // (vs * q) * q or AMAX_THREADS // vs
    blocks = max(1, min(-(-2 * sms // slabs), -(-M // rpb)))
    rows = -(-M // blocks)
    blocks = -(-M // rows)
    if slabs * (-(-blocks // AMAX_GROUP) + 1) > AMAX_COUNTERS:
        raise ValueError(f"int8_conv_amax cannot take C = {C}")
    return AmaxPlan(vs, rpb, slabs, blocks, rows)


def int8_conv_amax(x: torch.Tensor) -> torch.Tensor:
    """K7's prologue, first pass: max |x| per channel over the whole batch
    (a CFG pair shares it), x bf16 [B, D, H, W, C] contiguous with C a
    multiple of 8. Returns f32 [C] (``int8_conv_amax_plain``): the head of
    one buffer whose tail is the kernel's partial rows [blocks, C] (one
    allocation a call)."""
    _check_cuda(x)
    if x.dim() != 5 or x.shape[-1] % 8 or x.numel() == 0:
        raise ValueError(f"int8_conv_amax takes [B, D, H, W, C] with C a "
                         f"multiple of 8, got {tuple(x.shape)}")
    _check_dense(x, "x", tuple(x.shape), torch.bfloat16)
    C = x.shape[-1]
    M = x.numel() // C
    plan = amax_plan(M, C, _sm_count(x.device))
    buf = torch.empty((1 + plan.blocks) * C, dtype=torch.int32,
                      device=x.device)
    _run("dense_conv", "int8_conv_amax", x.device, x.data_ptr(),
         buf.data_ptr(), buf[C:].data_ptr(), M, C, plan.vs, plan.rpb,
         plan.slabs, plan.blocks, plan.rows)
    # the bits of non-negative floats
    return buf[:C].view(torch.float32)


def _padded(n: int) -> int:
    return -(-n // 32) * 32


def int8_conv_quantize_x(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """K7's prologue, second pass: x8 = rint(x / sc), sc = max(amax, 1e-8)
    / 127 per channel, zero-padded to a multiple of 32 channels. x bf16
    [B, D, H, W, C] contiguous (C a multiple of 8); amax f32 [C] from
    ``int8_conv_amax``. Returns int8 [B, D, H, W, Cp]
    (``int8_conv_quantize_x_plain``)."""
    _check_cuda(x, amax)
    if x.dim() != 5 or x.shape[-1] % 8 or x.numel() == 0:
        raise ValueError(f"int8_conv_quantize_x takes [B, D, H, W, C] with C "
                         f"a multiple of 8, got {tuple(x.shape)}")
    C = x.shape[-1]
    if C > 12288:
        raise ValueError(f"int8_conv_quantize_x takes C <= 12288, got {C}")
    _check_dense(x, "x", tuple(x.shape), torch.bfloat16)
    _check_dense(amax, "amax", (C,), torch.float32)
    x8 = torch.empty(x.shape[:-1] + (_padded(C),), dtype=torch.int8,
                     device=x.device)
    _run("dense_conv", "int8_conv_quantize_x", x.device, x.data_ptr(),
         amax.data_ptr(), x8.data_ptr(), x.numel() // C, C, x8.shape[-1])
    return x8


def int8_conv_quantize_w(w: torch.Tensor, amax: torch.Tensor):
    """K7's prologue, the weight pass: w [O, C, 3, 3, 3] (f32, rounded to
    bf16 first, or bf16) folded with the activation scales of ``amax`` (f32
    [C]), quantized per (dx, output channel) and packed. Returns the
    dx-major int8 pack [Op, 27*Cp] and sw f32 [3, Op], zero-padded to
    multiples of 32 (``int8_conv_quantize_w_plain``)."""
    _check_cuda(w, amax)
    if w.dim() != 5 or tuple(w.shape[2:]) != (3, 3, 3) or \
            w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_conv_quantize_w takes f32 or bf16 "
                         f"[O, C, 3, 3, 3], got {w.dtype} {tuple(w.shape)}")
    O, C = w.shape[:2]
    if min(O, C) < 1 or C > 12288:
        raise ValueError(f"int8_conv_quantize_w cannot take {tuple(w.shape)}")
    _check_dense(w, "w", tuple(w.shape), w.dtype)
    _check_dense(amax, "amax", (C,), torch.float32)
    Cp, Op = _padded(C), _padded(O)
    w8 = torch.empty((Op, 27 * Cp), dtype=torch.int8, device=w.device)
    sw = torch.empty((3, Op), dtype=torch.float32, device=w.device)
    _run("dense_conv", "int8_conv_quantize_w", w.device, w.data_ptr(),
         int(w.dtype == torch.bfloat16), amax.data_ptr(), w8.data_ptr(),
         sw.data_ptr(), C, O, Cp, Op)
    return w8, sw


def _sparse_widths(name: str, dtype: torch.dtype, *widths: int) -> None:
    """The sparse-conv kernels gather a row in 16-byte pieces: widths of
    ``dtype`` elements in multiples of 16 bytes, none empty."""
    mult = 16 // torch.empty((), dtype=dtype).element_size()
    if any(w % mult for w in widths) or min(widths) < 1:
        raise ValueError(f"{name} takes widths that are multiples of {mult}, "
                         f"got {widths}")


def _sparse_conv(name: str, dtype: torch.dtype, feats: torch.Tensor,
                 nbr: torch.Tensor, w_pack: torch.Tensor,
                 poison: torch.Tensor, count_as: str | None) -> torch.Tensor:
    """K4 in ``dtype``: the checks, the output and the launch shared by
    ``sparse_conv_f32`` (w_pack [2, 27, N, K]) and ``sparse_conv_bf16``
    (w_pack [27, N, K])."""
    _check_cuda(feats, nbr, w_pack, poison)
    lead = (2,) if dtype == torch.float32 else ()
    if feats.dim() != 3 or w_pack.dim() != 3 + len(lead):
        raise ValueError(f"feats [B, C, K] and w_pack [{'2, ' * len(lead)}"
                         f"27, N, K], got {tuple(feats.shape)}, "
                         f"{tuple(w_pack.shape)}")
    B, C, K = feats.shape
    N = w_pack.shape[-2]
    _sparse_widths(name, dtype, K, N)
    if min(B, C) < 1:
        raise ValueError(f"{name} takes B, C >= 1, got {B}, {C}")
    _check_dense(feats, "feats", (B, C, K), dtype)
    _check_dense(nbr, "nbr", (B, C, 27), torch.int32)
    _check_dense(w_pack, "w_pack", (*lead, 27, N, K), dtype)
    _check_dense(poison, "poison", (B,), torch.int32)
    out = torch.empty((B, C, N), dtype=dtype, device=feats.device)
    _run("sparse_conv", name, feats.device, feats.data_ptr(), nbr.data_ptr(),
         w_pack.data_ptr(), poison.data_ptr(), out.data_ptr(), B, C, K, N,
         count_as=count_as)
    return out


def sparse_conv_f32(feats: torch.Tensor, nbr: torch.Tensor,
                    w_pack: torch.Tensor, poison: torch.Tensor,
                    dgrad: bool = False) -> torch.Tensor:
    """K4: out[b, m] = sum_t feats[b, nbr[b, m, t]] @ w[t] over present
    taps (nbr -1 = absent) with f32-accurate products on the tensor cores
    (3xTF32); every row of batch b is NaN where poison[b] != 0. feats f32
    [B, C, K]; nbr int32 [B, C, 27]; w_pack f32 [2, 27, N, K], the tf32 hi
    and lo parts of each w[t]^T (``window_conv.pack_sparse_weight``); poison
    int32 [B]; K and N multiples of 4. Returns f32 [B, C, N]. With ``dgrad``
    the call is the conv's input gradient (feats the output gradient, the
    pack that of the reversed, transposed weights, poison zeros) and is
    counted under ``K4_DGRAD``."""
    return _sparse_conv("sparse_conv_f32", torch.float32, feats, nbr, w_pack,
                        poison, K4_DGRAD if dgrad else None)


def sparse_conv_bf16(feats: torch.Tensor, nbr: torch.Tensor,
                     w_pack: torch.Tensor, poison: torch.Tensor,
                     dgrad: bool = False) -> torch.Tensor:
    """K4 on bf16 features: out[b, m] = sum_t feats[b, nbr[b, m, t]] @ w[t]
    over present taps, every bf16 product added into f32 sums rounded to
    bf16 once; every row of batch b is NaN where poison[b] != 0. feats bf16
    [B, C, K]; nbr int32 [B, C, 27]; w_pack bf16 [27, N, K], each w[t]^T
    (``window_conv.pack_sparse_weight``); poison int32 [B]; K and N
    multiples of 8. Returns bf16 [B, C, N]. With ``dgrad`` the call is the
    conv's input gradient and is counted under ``K4_BF16_DGRAD``."""
    return _sparse_conv("sparse_conv_bf16", torch.bfloat16, feats, nbr,
                        w_pack, poison, K4_BF16_DGRAD if dgrad else None)


def sparse_conv_schedule(nbr: torch.Tensor, poison: torch.Tensor, K: int,
                         N: int, dtype: torch.dtype):
    """The work items the sparse conv kernels (``sparse_conv_f32``,
    ``sparse_conv_bf16``) walk, in their order: (batch element, 128-row
    tile, N tile of 32, 64 or 128 features), the N tile fastest, handed
    to the persistent blocks one by one. An item's stages are the taps
    some row of its tile has, times K's chunks of 128 bytes; 0 where no row
    has one (a tile of padding slots, whose rows get zeros) and -1 for a
    poisoned element (NaN). Returns (stages, tap masks), int64 [items];
    the kernel finds the same on the card, item by item."""
    B, C, _ = nbr.shape
    bn = 32 if N <= 32 else 64 if N <= 64 else 128
    m_tiles, n_tiles = -(-C // 128), -(-N // bn)
    kc = -(-K * torch.empty((), dtype=dtype).element_size() // 128)
    has = torch.nn.functional.pad((nbr >= 0).to(torch.int64),
                                  (0, 0, 0, m_tiles * 128 - C))
    present = has.reshape(B, m_tiles, 128, 27).amax(2)
    bad = poison.to(torch.int64).ne(0)[:, None]
    masks = torch.where(bad, 0, (present << torch.arange(
        27, device=nbr.device)).sum(-1))
    stages = torch.where(bad, -1, present.sum(-1) * kc)
    return (stages.repeat_interleave(n_tiles, 1).reshape(-1),
            masks.repeat_interleave(n_tiles, 1).reshape(-1))


# K6's voxel rows a stage and at most a range (csrc/sparse_conv_bwd.cu)
_K6_CHUNK, _K6_MAX_ROWS = 32, 32 * 512


def _k6_tiles(F: int, Fo: int) -> int:
    """K6's (F tile, N tile) blocks a tap, as the kernel picks its tiles:
    64 features where F (Fo) <= 64, else 128."""
    return -(-F // (64 if F <= 64 else 128)) * -(-Fo // (64 if Fo <= 64 else
                                                         128))


def wgrad_rows_per_split(rows: int, F: int, Fo: int) -> int:
    """Voxel rows per range of K6 (a multiple of 32, its rows a stage, and
    at most 16,384): as many ranges as take about 512 blocks of (tap, F
    tile, N tile, range) over the card, none under 1,024 rows. A function
    of the shape only, so the summation order is fixed."""
    splits = max(-(-rows // _K6_MAX_ROWS),
                 min(-(-512 // (27 * _k6_tiles(F, Fo))), -(-rows // 1024)))
    per = -(-rows // splits)
    return -(-per // _K6_CHUNK) * _K6_CHUNK


# sparse_conv_bf16_wgrad's plan (csrc/sparse_conv_bwd.cu): present (row,
# tap) pairs a stage; the equal ranges of stages at most (one a block on an
# H100 SXM's 132 SMs, and a constant, so that the cuts depend on nbr and the
# shape alone); the rows of a segment of the pair lists, a multiple of 512,
# and at most 128 segments
WGRAD_PAIRS = 128
WGRAD_RANGES = 132
_WGRAD_SEG_ROWS, _WGRAD_MAX_SEGS = 512, 128


def wgrad_bf16_tile(F: int, Fo: int) -> tuple[int, int]:
    """``sparse_conv_bf16_wgrad``'s tile (MT, BN): 64 * MT features by BN
    outputs, MT in {1, 2} and BN in {64, 128} (the consumers' registers
    hold no larger), the one that gathers the fewest bytes a present pair
    (F for each N tile, Fo for each F tile; zero-filled columns cost none),
    the smaller where two tie."""
    return min((F * -(-Fo // bn) + Fo * -(-F // (64 * mt)), mt * bn, mt, bn)
               for mt in (1, 2) for bn in (64, 128))[2:]


def wgrad_bf16_segments(rows: int) -> tuple[int, int]:
    """(rows a segment, segments) of ``sparse_conv_bf16_wgrad``'s pair
    lists for ``rows`` voxel rows."""
    seg = _WGRAD_SEG_ROWS * -(-rows // (_WGRAD_MAX_SEGS * _WGRAD_SEG_ROWS))
    return seg, -(-rows // seg)


class WgradPlan(NamedTuple):
    mt: int               # the tile: 64 * mt features ...
    bn: int               # ... by bn outputs
    counts: torch.Tensor  # int64 [27]: present pairs a tap
    stages: int           # S: the stages of all units
    length: int           # L: stages a range (the last may hold fewer)
    ranges: int           # R: ranges (0 where no pair is present)
    # int64 [pieces, 8], in the order the blocks walk them: range, combo (F
    # tile * N tiles + N tile), tap, first and end stage (global), first and
    # end pair of the tap's list, partial slot (unit + range)
    pieces: torch.Tensor


def sparse_wgrad_plan(nbr: torch.Tensor, F: int, Fo: int,
                      ranges: int = WGRAD_RANGES) -> WgradPlan:
    """The work of ``sparse_conv_bf16_wgrad`` on nbr [B, C, 27], as the
    kernel finds it on the card. Each tap's present pairs, in row order, are
    cut into stages of ``WGRAD_PAIRS``; a unit is (F tile, N tile,
    tap), units in that order, and holds its tap's stages; the S stages of
    all units are cut into R ranges of L = ceil(S / min(ranges, S)) stages
    (every range but the last exactly L); a piece is the stages of one unit
    within one range, and its sums go to partial slot unit + range, which
    the last pass adds in range order."""
    mt, bn = wgrad_bf16_tile(F, Fo)
    combos = -(-F // (64 * mt)) * -(-Fo // bn)
    counts = (nbr >= 0).reshape(-1, 27).sum(0).to(torch.int64).cpu()
    stg = -(-counts // WGRAD_PAIRS)
    start = torch.cumsum(stg, 0) - stg
    stap = int(stg.sum())
    S = stap * combos
    if S == 0:
        return WgradPlan(mt, bn, counts, 0, 1, 0,
                         torch.zeros((0, 8), dtype=torch.int64))
    R = min(ranges, S)
    L = -(-S // R)
    R = -(-S // L)
    c = torch.arange(combos).repeat_interleave(27)
    t = torch.arange(27).repeat(combos)
    keep = stg[t] > 0
    c, t = c[keep], t[keep]
    first = c * stap + start[t]
    end = first + stg[t]
    n = (end - 1) // L - first // L + 1
    u = torch.repeat_interleave(torch.arange(c.numel()), n)
    r = first[u] // L + torch.arange(int(n.sum())) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    s0 = torch.maximum(first[u], r * L)
    s1 = torch.minimum(end[u], (r + 1) * L)
    p0 = (s0 - first[u]) * WGRAD_PAIRS
    p1 = torch.minimum((s1 - first[u]) * WGRAD_PAIRS, counts[t[u]])
    pieces = torch.stack([r, c[u], t[u], s0, s1, p0, p1, c[u] * 27 + t[u] + r],
                         1)
    return WgradPlan(mt, bn, counts, S, L, R,
                     pieces[torch.argsort(r * S + s0)])


def _wgrad_shapes(name: str, dtype: torch.dtype, feats: torch.Tensor,
                  nbr: torch.Tensor, g: torch.Tensor) -> tuple[int, ...]:
    """K6's checks in ``dtype``, shared by ``sparse_conv_f32_wgrad`` and
    ``sparse_conv_bf16_wgrad``. Returns (B, C, F, Fo)."""
    _check_cuda(feats, nbr, g)
    if feats.dim() != 3 or g.dim() != 3:
        raise ValueError(f"feats [B, C, F] and g [B, C, Fo], got "
                         f"{tuple(feats.shape)}, {tuple(g.shape)}")
    B, C, F = feats.shape
    Fo = g.shape[2]
    _sparse_widths(name, dtype, F, Fo)
    if min(B, C) < 1:
        raise ValueError(f"{name} takes B, C >= 1, got {B}, {C}")
    if B * C >= 2 ** 31:
        raise ValueError(f"too many voxel rows for one launch: {B * C}")
    _check_dense(feats, "feats", (B, C, F), dtype)
    _check_dense(nbr, "nbr", (B, C, 27), torch.int32)
    _check_dense(g, "g", (B, C, Fo), dtype)
    return B, C, F, Fo


def sparse_conv_f32_wgrad(feats: torch.Tensor, nbr: torch.Tensor,
                          g: torch.Tensor) -> torch.Tensor:
    """K6: dw[t] = sum_{b, m} feats[b, nbr[b, m, t]]^T g[b, m] over present
    taps, the weight gradient of K4, with f32-accurate products on the
    tensor cores (3xTF32). feats f32 [B, C, F]; nbr int32 [B, C, 27]; g f32
    [B, C, Fo]; F and Fo multiples of 4. Returns f32 [27, F, Fo],
    bit-identical from run to run. One call launches the prologue that
    writes g^T's tf32 parts, the kernel (partial sums over the fixed row
    ranges of ``wgrad_rows_per_split``) and, where there is more than one
    range, the sum of the partials in range order; it counts once. The
    scratch for the pack and the partials is allocated here."""
    B, C, F, Fo = _wgrad_shapes("sparse_conv_f32_wgrad", torch.float32,
                                feats, nbr, g)
    rows = B * C
    per = wgrad_rows_per_split(rows, F, Fo)
    splits = -(-rows // per)
    # one scratch buffer: the pack [2, Fo, rows rounded up to 4] and, with
    # more than one range, the partials [S, 27, F, Fo]
    n_pack = 2 * Fo * (-(-rows // 4) * 4)
    n_part = splits * 27 * F * Fo if splits > 1 else 0
    scratch = torch.empty(n_pack + n_part, dtype=torch.float32,
                          device=feats.device)
    dw = torch.empty((27, F, Fo), dtype=torch.float32, device=feats.device)
    _run("sparse_conv_bwd", "sparse_conv_f32_wgrad", feats.device,
         feats.data_ptr(), nbr.data_ptr(), g.data_ptr(), scratch.data_ptr(),
         scratch.data_ptr() + 4 * n_pack if n_part else None, dw.data_ptr(),
         B, C, F, Fo, per)
    return dw


def sparse_conv_bf16_wgrad(feats: torch.Tensor, nbr: torch.Tensor,
                           g: torch.Tensor) -> torch.Tensor:
    """K6 on bf16 operands: dw[t] = sum_{b, m} feats[b, nbr[b, m, t]]^T
    g[b, m] over present taps, every bf16 product added into f32 sums.
    feats bf16 [B, C, F]; nbr int32 [B, C, 27]; g bf16 [B, C, Fo]; F and Fo
    multiples of 8. Returns f32 [27, F, Fo] (the caller rounds it to the
    weight's dtype), bit-identical from run to run. One call launches the
    kernel that compacts each tap's present pairs, the persistent kernel
    that walks them (partial sums over the pieces of ``sparse_wgrad_plan``,
    whose cuts it finds on the card) and the sum of each unit's pieces in
    range order; it counts once. The scratch for the pair lists and the
    partials (sized for the most pieces the shape can have) is allocated
    here."""
    B, C, F, Fo = _wgrad_shapes("sparse_conv_bf16_wgrad", torch.bfloat16,
                                feats, nbr, g)
    rows = B * C
    mt, bn = wgrad_bf16_tile(F, Fo)
    seg, nseg = wgrad_bf16_segments(rows)
    combos = -(-F // (64 * mt)) * -(-Fo // bn)
    slots = (27 * combos + WGRAD_RANGES) * (2 if (mt, bn) == (1, 64) else 1)
    # one scratch buffer: the partials [slots, 64 * mt, bn] f32, then the
    # int32 pair lists [27, nseg * seg, 2], segment counts [27, nseg] and
    # per-tap totals [27]
    n_part = slots * 64 * mt * bn
    n_work = 2 * 27 * nseg * seg + 27 * nseg + 27
    scratch = torch.empty(n_part + n_work, dtype=torch.float32,
                          device=feats.device)
    dw = torch.empty((27, F, Fo), dtype=torch.float32, device=feats.device)
    _run("sparse_conv_bwd", "sparse_conv_bf16_wgrad", feats.device,
         feats.data_ptr(), nbr.data_ptr(), g.data_ptr(),
         scratch.data_ptr() + 4 * n_part, scratch.data_ptr(), dw.data_ptr(),
         B, C, F, Fo, mt, bn, seg, WGRAD_RANGES)
    return dw
