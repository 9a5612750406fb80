"""The Wan2.1 stack's released checkpoints -> the port's towers; counterpart
of ``infinicube_tpu/weights/wan_convert.py``.

The reference's stage 2 runs on pretrained weights: the Wan2.1 DiT
safetensors, ``Wan2.1_VAE.pth`` and ``models_t5_umt5-xxl-enc-bf16.pth``.
``convert_wan_vae``, ``convert_umt5_hf``, ``convert_umt5_wan`` and
``convert_wan_pipeline`` give the JAX package's parameter trees (numpy,
f32); the ``*_state_dict`` entries carry them through ``weights.from_jax``
into the ``state_dict``s that ``WanVideoGenerator.load_params`` takes,
optionally cast to the dtypes the port's modules hold. The DiT and umt5 are
converted a block at a time, so a 14B DiT is not held twice."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from infinicube_tpu_torch.weights.convert import (
    convert_wan_block, convert_wan_dit, convert_wan_dit_stem,
    initialize_buffer_embedder, t2j)
from infinicube_tpu_torch.weights.from_jax import (dit_from_jax, t5_from_jax,
                                                   vae_from_jax)

# ---------------------------------------------------------------------------
# video VAE
# ---------------------------------------------------------------------------


def _vae_entry(leaf: str, v: np.ndarray) -> dict:
    """One torch parameter -> flax param(s) under its module."""
    if leaf == "gamma":                       # RMS_norm [C,1,1(,1)] -> [C]
        return {"gamma": v.reshape(v.shape[0])}
    if leaf == "bias":
        return {"bias": v}
    if leaf != "weight":
        raise ValueError(f"VAE parameter {leaf!r}")
    if v.ndim == 5:                           # Conv3d -> [kt,kh,kw,I,O]
        return {"kernel": v.transpose(2, 3, 4, 1, 0)}
    if v.ndim == 4:                           # Conv2d
        if v.shape[2] == 1 and v.shape[3] == 1:   # 1x1 -> Dense [I,O]
            return {"kernel": v[:, :, 0, 0].T}
        return {"kernel": v.transpose(2, 3, 1, 0)[None]}  # k3 -> (1,3,3,I,O)
    return {"kernel": v.T}                    # Linear


def convert_wan_vae(sd: Mapping) -> dict:
    """``Wan2.1_VAE.pth`` state dict -> {"params": ...} of the JAX VideoVAE.
    Dotted integer indices become underscored module names
    (downsamples.3.residual.0 -> downsamples_3/residual_0); kernels are laid
    out per layer kind (``_vae_entry``)."""
    params: dict = {}
    for key, val in sd.items():
        parts = key.split(".")
        path = []
        i = 0
        while i < len(parts) - 1:
            if i + 1 < len(parts) - 1 and parts[i + 1].isdigit():
                path.append(f"{parts[i]}_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node.update(_vae_entry(parts[-1], t2j(val)))
    return {"params": params}


# ---------------------------------------------------------------------------
# umt5 text encoder
# ---------------------------------------------------------------------------

def _lin(sd: Mapping, prefix: str) -> dict:
    return {"kernel": t2j(sd[f"{prefix}.weight"]).T}


def _umt5_stem(sd: Mapping, layout: str) -> dict:
    embed, final = (("token_embedding", "norm") if layout == "wan" else
                    ("shared", "encoder.final_layer_norm"))
    return {"embed": {"embedding": t2j(sd[f"{embed}.weight"])},
            "final_ln": {"scale": t2j(sd[f"{final}.weight"])}}


def _umt5_hf_layer(sd: Mapping, i: int) -> dict:
    b = f"encoder.block.{i}"
    att = f"{b}.layer.0.SelfAttention"
    return {
        "ln1": {"scale": t2j(sd[f"{b}.layer.0.layer_norm.weight"])},
        "attn": {
            "q": _lin(sd, f"{att}.q"), "k": _lin(sd, f"{att}.k"),
            "v": _lin(sd, f"{att}.v"), "o": _lin(sd, f"{att}.o"),
            "rel_bias": t2j(sd[f"{att}.relative_attention_bias.weight"]),
        },
        "ln2": {"scale": t2j(sd[f"{b}.layer.1.layer_norm.weight"])},
        "wi0": _lin(sd, f"{b}.layer.1.DenseReluDense.wi_0"),
        "wi1": _lin(sd, f"{b}.layer.1.DenseReluDense.wi_1"),
        "wo": _lin(sd, f"{b}.layer.1.DenseReluDense.wo"),
    }


def _umt5_wan_layer(sd: Mapping, i: int) -> dict:
    """The FFN computes fc2(fc1(x) * GELU(gate(x))): ``gate.0`` is the
    activated branch (wi0)."""
    b = f"blocks.{i}"
    return {
        "ln1": {"scale": t2j(sd[f"{b}.norm1.weight"])},
        "attn": {
            "q": _lin(sd, f"{b}.attn.q"), "k": _lin(sd, f"{b}.attn.k"),
            "v": _lin(sd, f"{b}.attn.v"), "o": _lin(sd, f"{b}.attn.o"),
            "rel_bias": t2j(sd[f"{b}.pos_embedding.embedding.weight"]),
        },
        "ln2": {"scale": t2j(sd[f"{b}.norm2.weight"])},
        "wi0": _lin(sd, f"{b}.ffn.gate.0"),
        "wi1": _lin(sd, f"{b}.ffn.fc1"),
        "wo": _lin(sd, f"{b}.ffn.fc2"),
    }


_UMT5_LAYER = {"wan": _umt5_wan_layer, "hf": _umt5_hf_layer}


def convert_umt5_hf(sd: Mapping, num_layers: int) -> dict:
    """HuggingFace ``UMT5EncoderModel`` state dict (shared.weight;
    encoder.block.N.layer.0.SelfAttention.{q,k,v,o,relative_attention_bias};
    layer.1.DenseReluDense.{wi_0,wi_1,wo}; the layer norms) -> T5Encoder
    params."""
    params = _umt5_stem(sd, "hf")
    for i in range(num_layers):
        params[f"layer{i}"] = _umt5_hf_layer(sd, i)
    return {"params": params}


def convert_umt5_wan(sd: Mapping, num_layers: int) -> dict:
    """Wan's ``models_t5_umt5-xxl-enc`` layout (token_embedding.weight;
    blocks.N.norm1 / attn.{q,k,v,o} / pos_embedding.embedding.weight /
    norm2 / ffn.{gate.0,fc1,fc2}; norm.weight) -> T5Encoder params."""
    params = _umt5_stem(sd, "wan")
    for i in range(num_layers):
        params[f"layer{i}"] = _umt5_wan_layer(sd, i)
    return {"params": params}


def umt5_num_layers(sd: Mapping, layout: str) -> int:
    """The depth of a umt5 state dict, from its block indices."""
    if layout == "wan":
        idxs = [int(k.split(".")[1]) for k in sd if k.startswith("blocks.")]
    else:
        idxs = [int(k.split(".")[2]) for k in sd
                if k.startswith("encoder.block.")]
    return 1 + max(idxs)


def convert_wan_pipeline(dit_sd: Mapping | None, vae_sd: Mapping | None,
                         t5_sd: Mapping | None, dit_cfg=None,
                         t5_layout: str = "wan") -> dict:
    """The JAX pipeline's params dict from the three checkpoints (any may be
    None: that tower is left out)."""
    params = {}
    if dit_sd is not None:
        p = convert_wan_dit(dit_sd, num_layers=dit_cfg.num_layers,
                            num_heads=dit_cfg.num_heads)
        params["dit"] = initialize_buffer_embedder(p, dit_cfg)
    if vae_sd is not None:
        params["vae"] = convert_wan_vae(vae_sd)
    if t5_sd is not None:
        n = umt5_num_layers(t5_sd, t5_layout)
        params["t5"] = (convert_umt5_wan if t5_layout == "wan"
                        else convert_umt5_hf)(t5_sd, n)
    return params


# ---------------------------------------------------------------------------
# -> the port's state dicts
# ---------------------------------------------------------------------------

def _cast(sd: dict, dtypes: Mapping | None) -> dict:
    if dtypes is None:
        return sd
    return {k: v.to(dtypes.get(k, v.dtype)) for k, v in sd.items()}


def _pop_prefix(sd: dict, prefix: str) -> None:
    for k in [k for k in sd if k.startswith(prefix)]:
        del sd[k]


def wan_dit_state_dict(sd: dict, cfg, dtypes: Mapping | None = None,
                       consume: bool = False) -> dict[str, torch.Tensor]:
    """A DiffSynth WanModel state dict -> the port WanDiT's ``state_dict``,
    with a zero buffer embedder where the checkpoint has none. ``cfg`` gives
    the depth, the heads and the embedder's width; ``dtypes`` ({key: dtype})
    casts each tensor as it is made; ``consume`` drops each block's source
    tensors from ``sd`` once converted."""
    stem = initialize_buffer_embedder(
        {"params": convert_wan_dit_stem(sd)}, cfg)
    out = _cast(dit_from_jax(stem), dtypes)
    for i in range(cfg.num_layers):
        blk = convert_wan_block(sd, i, cfg.num_heads)
        if consume:
            _pop_prefix(sd, f"blocks.{i}.")
        out.update(_cast(dit_from_jax({f"block{i}": blk}), dtypes))
    return out


def wan_vae_state_dict(sd: Mapping, dtypes: Mapping | None = None
                       ) -> dict[str, torch.Tensor]:
    """``Wan2.1_VAE.pth`` -> the port VideoVAE's ``state_dict``."""
    return _cast(vae_from_jax(convert_wan_vae(sd)), dtypes)


def umt5_state_dict(sd: dict, layout: str = "wan",
                    dtypes: Mapping | None = None, consume: bool = False
                    ) -> dict[str, torch.Tensor]:
    """A umt5 state dict in Wan's (``"wan"``) or HuggingFace's (``"hf"``)
    layout -> the port T5Encoder's ``state_dict``, a block at a time
    (``dtypes`` and ``consume`` as ``wan_dit_state_dict``'s)."""
    out = _cast(t5_from_jax(_umt5_stem(sd, layout)), dtypes)
    prefix = "blocks" if layout == "wan" else "encoder.block"
    for i in range(umt5_num_layers(sd, layout)):
        layer = _UMT5_LAYER[layout](sd, i)
        if consume:
            _pop_prefix(sd, f"{prefix}.{i}.")
        out.update(_cast(t5_from_jax({f"layer{i}": layer}), dtypes))
    return out


def wan_pipeline_state_dict(dit_sd: dict | None, vae_sd: Mapping | None,
                            t5_sd: dict | None, dit_cfg=None,
                            t5_layout: str = "wan"
                            ) -> dict[str, dict[str, torch.Tensor]]:
    """``convert_wan_pipeline`` as the port's {"dit", "vae", "t5"}
    ``state_dict``s (f32), for ``WanVideoGenerator.load_params``."""
    out = {}
    if dit_sd is not None:
        out["dit"] = wan_dit_state_dict(dit_sd, dit_cfg)
    if vae_sd is not None:
        out["vae"] = wan_vae_state_dict(vae_sd)
    if t5_sd is not None:
        out["t5"] = umt5_state_dict(t5_sd, t5_layout)
    return out
