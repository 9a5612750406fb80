"""JAX package parameters -> the port's ``state_dict``s.

Input: the flax parameter tree of a ``infinicube_tpu`` module as nested dicts
of numpy arrays (unboxed; a top-level ``"params"`` key is optional). Output:
a ``state_dict`` for the port's module of the same name. The mapping is a
plain re-layout:

- flax Dense ``kernel`` [in, out] -> ``weight`` [out, in];
- flax Conv ``kernel`` DHWIO -> ``weight`` OIDHW, and HWIO -> OIHW;
- a rank-3 ``kernel`` (SparseConv3d, [27, F_in, F_out]) keeps its name and
  layout;
- RMSNorm / LayerNorm / GroupNorm ``scale`` and Embed ``embedding`` ->
  ``weight``;
- ``block{i}`` / ``layer{i}`` / ``downsamples_{i}`` / ``upsamples_{i}`` ->
  ``blocks.{i}`` / ``layers.{i}`` / ``downsamples.{i}`` / ``upsamples.{i}``;
- the DiT's scan-stacked ``blocks`` (leading layer axis) -> ``blocks.{i}``,
  and so is the voxel UNet's ``middle_transformer/blocks``.

Imports numpy and torch only."""

from __future__ import annotations

import re

import numpy as np
import torch

_INDEXED = re.compile(r"^(block|layer|downsamples_|upsamples_)(\d+)$")
_LIST_NAME = {"block": "blocks", "layer": "layers",
              "downsamples_": "downsamples", "upsamples_": "upsamples"}


def _params(tree: dict) -> dict:
    return tree["params"] if set(tree) == {"params"} else tree


def _flatten(tree: dict, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _leaf(name: str, a: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if a.ndim == 2:
            return "weight", a.T
        if a.ndim == 5:
            return "weight", a.transpose(4, 3, 0, 1, 2)
        if a.ndim == 4:
            return "weight", a.transpose(3, 2, 0, 1)
        if a.ndim == 3:
            return "kernel", a
        raise ValueError(f"kernel of rank {a.ndim}")
    if name in ("scale", "embedding"):
        return "weight", a
    return name, a


def _convert(tree: dict) -> dict[str, torch.Tensor]:
    out = {}
    for path, a in _flatten(tree):
        parts = []
        for p in path[:-1]:
            m = _INDEXED.match(p)
            parts += [_LIST_NAME[m.group(1)], m.group(2)] if m else [p]
        leaf, a = _leaf(path[-1], a)
        out[".".join(parts + [leaf])] = torch.from_numpy(np.array(a))
    return out


def _unstack_blocks(tree: dict) -> dict:
    """A scan-stacked ``blocks`` entry (one scanned module, leading layer
    axis) becomes ``block{i}`` entries; other layouts pass through."""
    tree = dict(tree)
    stacked = tree.pop("blocks", None)
    if stacked is not None:
        (body,) = stacked.values()       # the scanned block module
        n = len(next(iter(_flatten(body)))[1])
        for i in range(n):
            tree[f"block{i}"] = _index(body, i)
    return tree


def dit_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """WanDiT params, either layout: scan-stacked ``blocks`` or
    ``block{i}``."""
    return _convert(_unstack_blocks(_params(tree)))


def unet_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """UNet3D params (flax auto-names) in either layout of the middle
    transformer: scan-stacked ``blocks`` (no context) unstacked into
    ``blocks.{i}``, or unrolled ``block{i}`` (with a cross-attention
    context) renamed to them."""
    p = dict(_params(tree))
    p["middle_transformer"] = _unstack_blocks(p["middle_transformer"])
    return _convert(p)


def diffusion_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """``VoxelDiffusion`` params, as ``VoxelDiffusion.load_params`` takes
    them: the UNet's alone, or, where the config has condition encoders,
    the ``{"unet": ..., "cond_enc": ...}`` tree as ``unet.*`` and
    ``cond_enc.*``."""
    p = _params(tree)
    if set(p) != {"unet", "cond_enc"}:
        return unet_from_jax(p)
    return {**{f"unet.{k}": v for k, v in unet_from_jax(p["unet"]).items()},
            **{f"cond_enc.{k}": v
               for k, v in _convert(p["cond_enc"]).items()}}


def sparse_unet_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """``SparseUNet`` params (``models/diffusion/unet_sparse.py``)."""
    return _convert(_params(tree))


def _train_state_from_jax(convert, params: dict, mu: dict, nu: dict,
                          count: int, step: int, num_nan_skips: int,
                          ema_params: dict | None, ema_step: int) -> dict:
    if int(count) != int(step) - int(num_nan_skips):
        raise ValueError(f"Adam count {count} != step {step} - skips "
                         f"{num_nan_skips}")
    return {"step": int(step), "num_nan_skips": int(num_nan_skips),
            "params": convert(params), "mu": convert(mu), "nu": convert(nu),
            "ema": None if ema_params is None else
            {"params": convert(ema_params), "step": int(ema_step)},
            "rng_state": None}


def diffusion_train_state_from_jax(params: dict, mu: dict, nu: dict,
                                   count: int, step: int,
                                   num_nan_skips: int,
                                   ema_params: dict | None = None,
                                   ema_step: int = 0) -> dict:
    """A JAX ``TrainState`` of the voxel-diffusion trainer, given as numpy
    trees, as the ``state_dict`` that the port's
    ``training.state.TrainState.load_state_dict`` takes: the parameters
    (``diffusion_from_jax``'s names),
    the optax AdamW moments ``mu`` / ``nu`` (same tree as the parameters)
    with their ``count``, the EMA shadow with its step, ``step`` and
    ``num_nan_skips``. The port derives Adam's count as ``step -
    num_nan_skips``, so ``count`` must equal it."""
    return _train_state_from_jax(diffusion_from_jax, params, mu, nu, count,
                                 step, num_nan_skips, ema_params, ema_step)


def sparse_vae_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """SparseStructureVAE params (with its attention levels' ``attn*`` and
    its normal and color heads where the config has them)."""
    return _convert(_params(tree))


def vae_train_state_from_jax(params: dict, mu: dict, nu: dict, count: int,
                             step: int, num_nan_skips: int,
                             ema_params: dict | None = None,
                             ema_step: int = 0) -> dict:
    """``diffusion_train_state_from_jax`` for the sparse-VAE trainer: every
    tree is re-laid out by ``sparse_vae_from_jax``, so gradients and Adam
    moments given in the flax layout compare name by name with the port's."""
    return _train_state_from_jax(sparse_vae_from_jax, params, mu, nu, count,
                                 step, num_nan_skips, ema_params, ema_step)


def _index(tree: dict, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in tree.items()}


def vae_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """VideoVAE params."""
    return _convert(_params(tree))


def t5_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """T5Encoder params."""
    return _convert(_params(tree))


def pipeline_from_jax(params: dict) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX pipeline's {'dit', 'vae', 't5'} -> state dicts of the port's
    towers (``WanVideoGenerator.load_params``)."""
    return {"dit": dit_from_jax(params["dit"]),
            "vae": vae_from_jax(params["vae"]),
            "t5": t5_from_jax(params["t5"])}


_ATTN = ("query", "key", "value", "out")


def _flatten_attention(tree: dict) -> dict:
    """flax ``MultiHeadDotProductAttention`` subtrees (query / key / value
    kernels [E, heads, d] with biases [heads, d], out kernel [heads, d, E])
    as plain Dense kernels [E, heads * d] and [heads * d, E]; every other
    entry passes through."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            val = _flatten_attention(val)
            if set(_ATTN) <= set(val) and \
                    np.ndim(val["query"]["kernel"]) == 3:
                val = dict(val)
                for name in _ATTN[:3]:
                    k = np.asarray(val[name]["kernel"])
                    val[name] = {"kernel": k.reshape(k.shape[0], -1),
                                 "bias": np.asarray(
                                     val[name]["bias"]).reshape(-1)}
                k = np.asarray(val["out"]["kernel"])
                val["out"] = {"kernel": k.reshape(-1, k.shape[-1]),
                              "bias": np.asarray(val["out"]["bias"])}
        out[key] = val
    return out


def gsm_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """GSM params (or any of its submodules', such as the sky model's or
    the frozen towers' under ``encoder/dav2`` and ``encoder/dino``; also
    the standalone ``ConvNextTower``'s and ``Segformer``'s, whose attention
    layers are plain Dense kernels and whose BatchNorm statistics are flax
    params of the same names): 2-D
    convs HWIO -> OIHW (the DPT neck's transposed convs too: the port's
    ``dav2.ConvTranspose2d`` takes flax's kernel in a conv's layout),
    Dense kernels transposed, the attention modules' per-head kernels
    flattened, the sparse convs' [27, F_in, F_out] kept, norms' ``scale``
    -> ``weight``, ``layer{i}`` -> ``layers.{i}``."""
    return _convert(_flatten_attention(_params(tree)))


def gsm_train_state_from_jax(params: dict, mu: dict, nu: dict, count: int,
                             step: int, num_nan_skips: int,
                             ema_params: dict | None = None,
                             ema_step: int = 0) -> dict:
    """``diffusion_train_state_from_jax`` for the GSM trainer: every tree is
    re-laid out by ``gsm_from_jax``, so gradients and Adam moments given in
    the flax layout compare name by name with the port's."""
    return _train_state_from_jax(gsm_from_jax, params, mu, nu, count, step,
                                 num_nan_skips, ema_params, ema_step)


def lpips_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """LPIPS params (``models/gsm/lpips.py``): the VGG's HWIO kernels ->
    ``net.conv{idx}.weight`` OIHW, the heads ``lin{k}`` as they are."""
    return _convert(_params(tree))


def gsm_to_jax(model: torch.nn.Module) -> dict:
    """The inverse of ``gsm_from_jax``: the flax parameter tree
    ({"params": ...}, numpy) of a port GSM or of one of its submodules.
    With it a random port init drives the JAX model, and a random numpy
    tree can be made in the JAX layout without JAX."""
    from infinicube_tpu_torch.nn.layers import MultiHeadDotProductAttention
    heads = {name: m.heads for name, m in model.named_modules()
             if isinstance(m, MultiHeadDotProductAttention)}
    tree: dict = {}
    for key, p in model.state_dict().items():
        *path, leaf = key.split(".")
        parent = ".".join(path[:-1])
        # ``layers.{i}`` / ``blocks.{i}`` -> flax's ``layer{i}`` / ``block{i}``
        path = [f"{path[i - 1][:-1]}{part}" if part.isdigit()
                and path[i - 1] in ("layers", "blocks") else part
                for i, part in enumerate(path)
                if not (part in ("layers", "blocks") and i + 1 < len(path)
                        and path[i + 1].isdigit())]
        a = p.detach().cpu().numpy()
        if leaf == "weight":
            if a.ndim == 1:
                leaf = "scale"
            elif a.ndim in (2, 4):
                leaf = "kernel"
                a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
            else:
                raise ValueError(f"{key}: weight of rank {a.ndim}")
        if parent in heads:
            h = heads[parent]
            if path[-1] == "out":
                a = a.reshape(h, -1, a.shape[-1]) if leaf == "kernel" else a
            else:
                a = a.reshape(a.shape[0], h, -1) if leaf == "kernel" else \
                    a.reshape(h, -1)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.array(a)
    return {"params": tree}
