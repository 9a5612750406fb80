"""Upstream checkpoint files -> state dicts, and the Wan2.1 DiT's released
layout -> the JAX-layout parameter tree; counterpart of
``infinicube_tpu/weights/convert.py`` and of the loaders of
``infinicube_tpu/convert.py``. The per-model converters of HuggingFace
layouts live beside their modules (``models/gsm/dav2.py``, ``segformer.py``,
``convnext.py``); the video VAE's and umt5's are in ``weights/wan_convert.py``.

The converters here produce the JAX package's parameter tree as numpy arrays
(f32, as the reference's ``t2j`` casts); ``weights.from_jax`` turns that tree
into the port's ``state_dict``s, so one mapping serves both routes:

- torch Conv3d [O, I, kD, kH, kW] -> flax [kD, kH, kW, I, O];
- torch Linear [O, I] -> flax Dense kernel [I, O];
- fvdb SparseConv3d [O, I, k, k, k] -> gather-GEMM kernel [27, I, O], taps
  row-major over (di, dj, dk) (``grid.ops.neighbor_offsets`` order).

``.safetensors`` files are read by ``load_safetensors`` with no package: 8
bytes of little-endian header length, a JSON header, then the raw bytes,
mapped and wrapped by ``torch.frombuffer``. Pickles load with
``weights_only=True`` (and ``mmap`` where the file is a zip archive): a
pickle holding any other object is refused, never retried."""

from __future__ import annotations

import json
import math
import mmap
import pickle
import re
import struct
import zipfile
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

# ---------------------------------------------------------------------------
# file readers
# ---------------------------------------------------------------------------

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}


def load_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """One ``.safetensors`` file -> {name: CPU tensor}. Each tensor views the
    file's copy-on-write map (which it keeps alive), or is copied out where
    its offset is not a multiple of its element size. Raises ``ValueError``
    naming the file (and the key) on a header that does not parse, a dtype
    other than ``SAFETENSORS_DTYPES``' or data past the end of the file."""
    path = Path(path)
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a "
                             "safetensors header")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    (n,) = struct.unpack("<Q", mm[:8])
    if 8 + n > size:
        raise ValueError(f"{path}: header of {n} bytes runs past the end of "
                         f"the file ({size} bytes)")
    try:
        header = json.loads(bytes(mm[8:8 + n]).decode("utf-8"))
        if not isinstance(header, dict):
            raise ValueError("not a JSON object")
    except ValueError as e:     # JSONDecodeError and UnicodeDecodeError too
        raise ValueError(f"{path}: safetensors header does not parse: "
                         f"{e}") from None
    base = 8 + n
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        try:
            name = info["dtype"]
            shape = [int(s) for s in info["shape"]]
            lo, hi = (int(o) for o in info["data_offsets"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: tensor {key!r}: bad header entry "
                             f"{info!r} ({e})") from None
        if name not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {key!r} has dtype {name!r}, "
                             f"not one of {sorted(SAFETENSORS_DTYPES)}")
        dtype = SAFETENSORS_DTYPES[name]
        count = math.prod(shape)
        nbytes = count * dtype.itemsize
        if min(shape, default=0) < 0 or not 0 <= lo <= hi or \
                hi - lo != nbytes:
            raise ValueError(f"{path}: tensor {key!r}: data_offsets "
                             f"[{lo}, {hi}] do not hold {shape} of {name}")
        if base + hi > size:
            raise ValueError(f"{path}: tensor {key!r}: data_offsets "
                             f"[{lo}, {hi}] run past the end of the file "
                             f"({size - base} data bytes)")
        if count == 0:
            out[key] = torch.empty(shape, dtype=dtype)
        elif (base + lo) % dtype.itemsize:
            out[key] = torch.frombuffer(mm, dtype=torch.uint8, count=nbytes,
                                        offset=base + lo).clone().view(
                                            dtype).reshape(shape)
        else:
            out[key] = torch.frombuffer(mm, dtype=dtype, count=count,
                                        offset=base + lo).reshape(shape)
    return out


def load_safetensors_any(path: str | Path) -> dict[str, torch.Tensor]:
    """A single ``.safetensors`` file, a sharded set through its
    ``*.safetensors.index.json``, or a directory holding either (the
    released DiT layouts)."""
    path = Path(path)
    if path.is_dir():
        idx = sorted(path.glob("*.safetensors.index.json"))
        if idx:
            return load_safetensors_any(idx[0])
        files = sorted(path.glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors under {path}")
        sd = {}
        for f in files:
            sd.update(load_safetensors(f))
        return sd
    if path.name.endswith(".index.json"):
        index = json.loads(path.read_text())
        sd = {}
        for shard in sorted(set(index["weight_map"].values())):
            sd.update(load_safetensors(path.parent / shard))
        return sd
    return load_safetensors(path)


_REFUSED = re.compile(r"GLOBAL ([\w.]+)")


def load_torch_state_dict(path: str | Path) -> dict:
    """A ``.pth`` / ``.pt`` / ``.ckpt`` / ``.safetensors`` state dict on the
    CPU (a ``{"state_dict": ...}`` wrapper is unwrapped). Pickles load with
    ``weights_only=True``, memory-mapped where the file is a zip archive (a
    full umt5 ``.pth`` is then not held twice); one that holds another
    object raises ``pickle.UnpicklingError`` naming the file and the type.
    A flax ``.msgpack`` holds JAX parameters, which the port takes through
    ``weights.from_jax``."""
    path = str(path)
    if path.endswith(".msgpack"):
        raise ValueError(
            f"{path}: a flax .msgpack holds JAX parameters; restore it with "
            "flax and convert the tree with infinicube_tpu_torch.weights."
            "from_jax.gsm_from_jax, or pass an HF-layout "
            ".pth")
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True,
                        mmap=zipfile.is_zipfile(path))
    except pickle.UnpicklingError as e:
        m = _REFUSED.search(str(e))
        what = m.group(1) if m else str(e).strip().splitlines()[-1]
        raise pickle.UnpicklingError(
            f"{path}: torch.load(weights_only=True) refuses {what}; the port "
            "loads tensors and plain containers only (re-save the "
            "checkpoint's state_dict with torch.save)") from None
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def load_released_state_dict(path: str | Path) -> dict:
    """Dispatch on the released file type: safetensors (single, sharded or a
    directory) or a torch pickle (.pth / .pt / .ckpt)."""
    p = Path(path)
    if p.is_dir() or p.suffix == ".safetensors" or \
            p.name.endswith(".index.json"):
        return load_safetensors_any(p)
    return load_torch_state_dict(p)


# ---------------------------------------------------------------------------
# torch layouts -> the JAX parameter tree (numpy, f32)
# ---------------------------------------------------------------------------

def t2j(t) -> np.ndarray:
    """A tensor (any dtype, bf16 included) or array -> f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def convert_linear(sd: Mapping, prefix: str) -> dict:
    out = {"kernel": t2j(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = t2j(sd[f"{prefix}.bias"])
    return out


def convert_conv3d(sd: Mapping, prefix: str) -> dict:
    w = t2j(sd[f"{prefix}.weight"])          # [O, I, kD, kH, kW]
    out = {"kernel": np.transpose(w, (2, 3, 4, 1, 0))}
    if f"{prefix}.bias" in sd:
        out["bias"] = t2j(sd[f"{prefix}.bias"])
    return out


def convert_conv2d(sd: Mapping, prefix: str) -> dict:
    w = t2j(sd[f"{prefix}.weight"])          # [O, I, kH, kW]
    out = {"kernel": np.transpose(w, (2, 3, 1, 0))}
    if f"{prefix}.bias" in sd:
        out["bias"] = t2j(sd[f"{prefix}.bias"])
    return out


def convert_sparse_conv3d(sd: Mapping, prefix: str) -> dict:
    """fvdb kernel [O, I, 3, 3, 3] -> gather-GEMM [27, I, O], taps row-major
    over the (di, dj, dk) window; a kernel of another rank passes as it
    is."""
    w = t2j(sd[f"{prefix}.weight"])
    if w.ndim == 5:                          # [O, I, kd, kh, kw]
        O, I = w.shape[:2]
        k = w.shape[2] * w.shape[3] * w.shape[4]
        kern = w.reshape(O, I, k).transpose(2, 1, 0)
    else:                                    # already [K, I, O]-like
        kern = w
    out = {"kernel": kern}
    if f"{prefix}.bias" in sd:
        out["bias"] = t2j(sd[f"{prefix}.bias"])
    return out


def convert_norm(sd: Mapping, prefix: str) -> dict:
    return {"scale": t2j(sd[f"{prefix}.weight"]),
            "bias": t2j(sd[f"{prefix}.bias"])}


def convert_embedding(sd: Mapping, prefix: str) -> dict:
    return {"embedding": t2j(sd[f"{prefix}.weight"])}


# ---------------------------------------------------------------------------
# the Wan DiT (DiffSynth names -> models.wan.dit names)
# ---------------------------------------------------------------------------

def _rope_interleave_to_halfsplit(vec_or_kernel: np.ndarray,
                                  num_heads: int) -> np.ndarray:
    """Permute q / k output channels from Wan's interleaved RoPE pairs
    (c[2j], c[2j+1]) to the port's half-split pairs (c[j], c[j + d/2]):
    each head's channels become [evens..., odds...]. q and k permute alike,
    so their dot products do not change; v and o stay put. Takes Dense
    kernels [I, h*d], biases [h*d] and RMSNorm scales [h*d]."""
    x = np.asarray(vec_or_kernel)
    hd = x.shape[-1] // num_heads
    perm = np.concatenate([np.arange(0, hd, 2), np.arange(1, hd, 2)])
    shaped = x.reshape(x.shape[:-1] + (num_heads, hd))
    return shaped[..., perm].reshape(x.shape)


def convert_wan_block(sd: Mapping, i: int, num_heads: int) -> dict:
    """One DiffSynth WanModel block -> WanBlock params."""
    p = f"blocks.{i}"

    def rope_linear(prefix):
        return {k: _rope_interleave_to_halfsplit(v, num_heads)
                for k, v in convert_linear(sd, prefix).items()}

    def fuse(parts: list[dict]) -> dict:
        """Separate linears as one fused projection (output axis)."""
        out = {"kernel": np.concatenate([q["kernel"] for q in parts], -1)}
        if "bias" in parts[0]:
            out["bias"] = np.concatenate([q["bias"] for q in parts], -1)
        return out

    return {
        "self_attn": {
            "qkv": fuse([rope_linear(f"{p}.self_attn.q"),
                         rope_linear(f"{p}.self_attn.k"),
                         convert_linear(sd, f"{p}.self_attn.v")]),
            "o": convert_linear(sd, f"{p}.self_attn.o"),
            "q_norm": {"scale": _rope_interleave_to_halfsplit(
                t2j(sd[f"{p}.self_attn.norm_q.weight"]), num_heads)},
            "k_norm": {"scale": _rope_interleave_to_halfsplit(
                t2j(sd[f"{p}.self_attn.norm_k.weight"]), num_heads)},
        },
        "cross_attn": {
            "q": convert_linear(sd, f"{p}.cross_attn.q"),
            "kv": fuse([convert_linear(sd, f"{p}.cross_attn.k"),
                        convert_linear(sd, f"{p}.cross_attn.v")]),
            "o": convert_linear(sd, f"{p}.cross_attn.o"),
            "q_norm": {"scale": t2j(sd[f"{p}.cross_attn.norm_q.weight"])},
            "k_norm": {"scale": t2j(sd[f"{p}.cross_attn.norm_k.weight"])},
        },
        "cross_norm": convert_norm(sd, f"{p}.norm3"),
        "ffn_in": convert_linear(sd, f"{p}.ffn.0"),
        "ffn_out": convert_linear(sd, f"{p}.ffn.2"),
        "mod_bias": t2j(sd[f"{p}.modulation"]).reshape(6, -1),
    }


def stack_blocks(blocks: list[dict]) -> dict:
    """Per-block trees stacked along a leading layer axis (the JAX
    ``scan_layers=True`` layout)."""
    def rec(trees):
        if isinstance(trees[0], dict):
            return {k: rec([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)
    return rec(blocks)


def convert_wan_dit_stem(sd: Mapping) -> dict:
    """Everything of the DiT but its blocks."""
    params = {
        "patch_embed": _patchify_conv(sd, "patch_embedding"),
        "t_proj1": convert_linear(sd, "time_embedding.0"),
        "t_proj2": convert_linear(sd, "time_embedding.2"),
        "t_mod": convert_linear(sd, "time_projection.1"),
        "text_proj_in": convert_linear(sd, "text_embedding.0"),
        "text_proj": convert_linear(sd, "text_embedding.2"),
        "head": convert_linear(sd, "head.head"),
        # Wan's Head computes (modulation + t_emb).chunk(2): the [2, dim]
        # parameter verbatim (dit.py adds the raw time embedding)
        "head_mod": t2j(sd["head.modulation"]).reshape(2, -1),
    }
    if "buffer_embedding.weight" in sd:
        params["buffer_embed"] = _patchify_conv(sd, "buffer_embedding")
    return params


def convert_wan_dit(sd: Mapping, num_layers: int, num_heads: int,
                    scan_layers: bool = True) -> dict:
    """A DiffSynth WanModel state dict -> {"params": ...} of the JAX WanDiT,
    its blocks scan-stacked or as ``block{i}``."""
    params = convert_wan_dit_stem(sd)
    blocks = [convert_wan_block(sd, i, num_heads) for i in range(num_layers)]
    if scan_layers:
        params["blocks"] = {"WanBlock_0": stack_blocks(blocks)}
    else:
        for i, b in enumerate(blocks):
            params[f"block{i}"] = b
    return {"params": params}


def _patchify_conv(sd: Mapping, prefix: str) -> dict:
    """Wan's Conv3d patch embedding [O, I, pt, ph, pw] -> a Dense over the
    flattened patch [pt*ph*pw*I, O] (patch dims before channels, as the
    DiT's patchify reshapes)."""
    w = t2j(sd[f"{prefix}.weight"])          # [O, I, pt, ph, pw]
    O = w.shape[0]
    out = {"kernel": np.transpose(w, (2, 3, 4, 1, 0)).reshape(-1, O)}
    if f"{prefix}.bias" in sd:
        out["bias"] = t2j(sd[f"{prefix}.bias"])
    return out


def initialize_buffer_embedder(dit_params: dict, cfg) -> dict:
    """A zero buffer-embedder patchifier added to converted DiT params that
    lack one (a vanilla Wan2.1 T2V checkpoint): the InfiniCube fork's
    ``initialize_buffer_embedder(zero_init=True)``, so the pretrained model's
    output is unchanged until the embedder is trained."""
    p = dict(dit_params["params"])
    if "buffer_embed" not in p:
        pt, ph, pw = cfg.patch_size
        in_dim = pt * ph * pw * cfg.buffer_channels
        p["buffer_embed"] = {
            "kernel": np.zeros((in_dim, cfg.dim), np.float32),
            "bias": np.zeros((cfg.dim,), np.float32),
        }
    return {**dit_params, "params": p}
