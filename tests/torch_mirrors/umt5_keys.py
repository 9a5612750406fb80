"""Random umt5 encoder weights under the released key names, made from the
names and shapes alone (no ``transformers``): Wan's
``models_t5_umt5-xxl-enc-bf16.pth`` layout (``token_embedding``,
``blocks.N.{norm1,attn.*,pos_embedding.embedding,norm2,ffn.*}``, ``norm``)
and HuggingFace ``UMT5EncoderModel``'s (``shared``, ``encoder.block.N.layer.
{0,1}.*``, ``encoder.final_layer_norm``). Both hold a relative-position
table in every block."""

from __future__ import annotations

import torch

# Wan name -> HuggingFace name of each block's tensors
BLOCK_NAMES = {
    "norm1.weight": "layer.0.layer_norm.weight",
    "attn.q.weight": "layer.0.SelfAttention.q.weight",
    "attn.k.weight": "layer.0.SelfAttention.k.weight",
    "attn.v.weight": "layer.0.SelfAttention.v.weight",
    "attn.o.weight": "layer.0.SelfAttention.o.weight",
    "pos_embedding.embedding.weight":
        "layer.0.SelfAttention.relative_attention_bias.weight",
    "norm2.weight": "layer.1.layer_norm.weight",
    "ffn.gate.0.weight": "layer.1.DenseReluDense.wi_0.weight",
    "ffn.fc1.weight": "layer.1.DenseReluDense.wi_1.weight",
    "ffn.fc2.weight": "layer.1.DenseReluDense.wo.weight",
}


def umt5_shapes(vocab_size: int, d_model: int, d_ff: int, num_layers: int,
                num_heads: int, head_dim: int, buckets: int = 32) -> dict:
    """{Wan-layout name: shape}."""
    inner = num_heads * head_dim
    block = {"norm1.weight": (d_model,), "attn.q.weight": (inner, d_model),
             "attn.k.weight": (inner, d_model),
             "attn.v.weight": (inner, d_model),
             "attn.o.weight": (d_model, inner),
             "pos_embedding.embedding.weight": (buckets, num_heads),
             "norm2.weight": (d_model,), "ffn.gate.0.weight": (d_ff, d_model),
             "ffn.fc1.weight": (d_ff, d_model),
             "ffn.fc2.weight": (d_model, d_ff)}
    out = {"token_embedding.weight": (vocab_size, d_model),
           "norm.weight": (d_model,)}
    for i in range(num_layers):
        out.update({f"blocks.{i}.{k}": s for k, s in block.items()})
    return out


def random_umt5(shapes: dict, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> dict:
    """Norm scales about 1, everything else N(0, 0.05), Wan's names."""
    out = {}
    for name, shape in shapes.items():
        t = torch.randn(shape, generator=generator, device=device) * 0.05
        out[name] = (t + 1.0 if "norm" in name else t).to(dtype)
    return out


def to_hf(wan_sd: dict) -> dict:
    """A Wan-layout umt5 state dict under HuggingFace's names."""
    out = {}
    for k, v in wan_sd.items():
        if k == "token_embedding.weight":
            out["shared.weight"] = v
        elif k == "norm.weight":
            out["encoder.final_layer_norm.weight"] = v
        else:
            _, i, rest = k.split(".", 2)
            out[f"encoder.block.{i}.{BLOCK_NAMES[rest]}"] = v
    return out


def to_wan(hf_sd: dict) -> dict:
    """The inverse of ``to_hf``."""
    back = {v: k for k, v in BLOCK_NAMES.items()}
    out = {}
    for k, v in hf_sd.items():
        if k == "shared.weight":
            out["token_embedding.weight"] = v
        elif k == "encoder.final_layer_norm.weight":
            out["norm.weight"] = v
        elif k.startswith("encoder.block."):
            _, _, i, rest = k.split(".", 3)
            out[f"blocks.{i}.{back[rest]}"] = v
    return out
