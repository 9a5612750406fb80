"""Released Wan2.1 checkpoint files -> one checkpoint of the port, which
``WanVideoGenerator.from_checkpoint`` and stage 2's ``--ckpt`` load;
counterpart of ``infinicube_tpu/convert.py``.

    python -m infinicube_tpu_torch.convert \\
        --wan-dit  <Wan2.1-T2V-1.3B dir or .safetensors> \\
        --wan-vae  Wan2.1_VAE.pth \\
        --umt5     models_t5_umt5-xxl-enc-bf16.pth \\
        --variant  1.3b \\
        --out      ckpts/wan13b_infinicube

Reads the layouts the Wan2.1 release ships:

- DiT: ``diffusion_pytorch_model.safetensors`` (1.3B, one file), or the
  sharded ``diffusion_pytorch_model-0000X-of-0000N.safetensors`` with
  ``diffusion_pytorch_model.safetensors.index.json`` (14B), or a directory
  holding either; a ``.pth`` / ``.pt`` state dict too. ``--finetune-ckpt``
  overlays a finetuned buffer-DiT ``.ckpt`` (``buffer_embedder.*`` and
  ``dit.*`` keys).
- VAE: the ``Wan2.1_VAE.pth`` pickle.
- umt5: ``models_t5_umt5-xxl-enc-bf16.pth`` (Wan's ``blocks.N`` layout) or
  a HuggingFace ``encoder.block.N`` state dict (``--umt5-layout hf``).

Safetensors are read without the ``safetensors`` package and pickles with
``weights_only=True`` (``weights/convert.py``).

Output, the port's own format: one ``torch.save``d ``state_dict`` a tower
(``dit.pt``, ``vae.pt``, ``t5.pt``) in the dtypes its module holds, so that
loading one is bit-equal to ``load_params`` on the in-memory conversion, and
a ``pipeline.json`` with the JAX converter's keys (``variant``, ``towers``,
``dit_overrides``, ``source_files``). The towers are converted and written
one at a time, each tower's source dropped as its blocks convert. The JAX
converter writes Orbax, which the port does not read: both start from the
released files."""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.models.wan.dit import WanDiT, WanDiTConfig
from infinicube_tpu_torch.models.wan.pipeline import WanPipelineConfig
from infinicube_tpu_torch.models.wan.t5 import T5Config, T5Encoder
from infinicube_tpu_torch.models.wan.vae3d import VideoVAE, VideoVAEConfig
from infinicube_tpu_torch.weights.convert import (  # noqa: F401 (re-export)
    load_released_state_dict, load_safetensors_any)
from infinicube_tpu_torch.weights.wan_convert import (umt5_num_layers,
                                                      umt5_state_dict,
                                                      wan_dit_state_dict,
                                                      wan_vae_state_dict)


def overlay_finetune(dit_sd: dict | None,
                     ft_sd: dict) -> tuple[dict, int, int]:
    """Overlay a finetuned buffer-DiT training checkpoint onto the base DiT
    state dict, as the reference's ``_load_checkpoint`` does: keys
    ``buffer_embedder.<tail>`` carry the trained buffer patchifier (they
    become the DiT's ``buffer_embedding.*`` Conv3d weights; the leaf name is
    what counts, so a bare Conv3d and a nested module both load), keys
    ``dit.<tail>`` override base DiT weights, and other keys are ignored
    (the reference loads with ``strict=False``). Returns (merged state dict,
    buffer-embedder keys, DiT keys)."""
    merged = dict(dit_sd) if dit_sd else {}
    n_be = n_dit = 0
    for k, v in ft_sd.items():
        if k.startswith("buffer_embedder."):
            merged[f"buffer_embedding.{k.rsplit('.', 1)[-1]}"] = v
            n_be += 1
        elif k.startswith("dit."):
            merged[k[len("dit."):]] = v
            n_dit += 1
    return merged, n_be, n_dit


def _fields(kw: dict) -> dict:
    """Config fields from JSON values: dtype names become torch dtypes,
    lists tuples."""
    def value(k, v):
        if k.endswith("dtype") and isinstance(v, str):
            return getattr(torch, v)
        return tuple(v) if isinstance(v, list) else v
    return {k: value(k, v) for k, v in kw.items()}


def pipeline_config_from_meta(meta: dict) -> WanPipelineConfig:
    """The ``WanPipelineConfig`` a sidecar describes: the variant's DiT with
    ``dit_overrides``, and ``pipeline_overrides`` (its ``vae`` and ``t5``
    entries given as their configs' fields)."""
    dit = (WanDiTConfig.wan_14b if meta.get("variant", "1.3b") == "14b"
           else WanDiTConfig.wan_1_3b)(**_fields(meta.get("dit_overrides",
                                                          {})))
    pipe_kw = _fields(meta.get("pipeline_overrides", {}))
    for name, cls in (("vae", VideoVAEConfig), ("t5", T5Config)):
        if name in pipe_kw:
            pipe_kw[name] = cls(**_fields(pipe_kw[name]))
    return WanPipelineConfig(dit=dit, **pipe_kw)


def load_pipeline_checkpoint(path: str | Path, device="cuda"
                             ) -> tuple[dict[str, dict], dict]:
    """-> ({tower: state_dict} on ``device``, the sidecar) for the towers the
    sidecar lists. Each file is memory-mapped and loaded with
    ``weights_only=True``."""
    dev = resolve_device(device)
    path = Path(path)
    meta = json.loads((path / "pipeline.json").read_text())
    sds = {name: torch.load(path / f"{name}.pt", map_location=dev,
                            weights_only=True, mmap=True)
           for name in meta["towers"]}
    return sds, meta


def _held_dtypes(name: str, cfg: WanPipelineConfig, sd: dict,
                 t5_layout: str) -> dict:
    """{key: dtype} of the port's tower, built without storage."""
    if name == "dit":
        module = WanDiT(cfg.dit, device="meta")
    elif name == "vae":
        module = VideoVAE(cfg.vae, device="meta")
    else:
        module = T5Encoder(dataclasses.replace(
            cfg.t5, num_layers=umt5_num_layers(sd, t5_layout)), device="meta")
    return {k: v.dtype for k, v in module.state_dict().items()}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert released Wan2.1 weights to a checkpoint of the "
                    "port")
    ap.add_argument("--wan-dit", default=None,
                    help="DiT dir / .safetensors / index.json / .pth")
    ap.add_argument("--wan-vae", default=None, help="Wan2.1_VAE.pth")
    ap.add_argument("--umt5", default=None,
                    help="models_t5_umt5-xxl-enc-bf16.pth or HF state dict")
    ap.add_argument("--umt5-layout", default="wan", choices=["wan", "hf"])
    ap.add_argument("--finetune-ckpt", default=None,
                    help="finetuned buffer-DiT training checkpoint (.ckpt) "
                         "overlaying the base DiT: 'buffer_embedder.*' and "
                         "'dit.*' keys")
    ap.add_argument("--variant", default="1.3b", choices=["1.3b", "14b"])
    ap.add_argument("--no-buffer-embedder", action="store_true",
                    help="serve without the buffer embedder (pure T2V); "
                         "the zero one is still written")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.finetune_ckpt and not args.wan_dit:
        ap.error("--finetune-ckpt overlays a base DiT; pass --wan-dit")

    dit_cfg = WanDiTConfig.wan_14b() if args.variant == "14b" else \
        WanDiTConfig.wan_1_3b()
    if args.no_buffer_embedder:
        dit_cfg = dataclasses.replace(dit_cfg, use_buffer_embedder=False)
    cfg = WanPipelineConfig(dit=dit_cfg)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sources = {"dit": args.wan_dit, "vae": args.wan_vae, "t5": args.umt5}
    towers = [name for name, src in sources.items() if src]
    for name in towers:
        t0 = time.perf_counter()
        sd = load_released_state_dict(sources[name])
        if name == "dit" and args.finetune_ckpt:
            sd, n_be, n_dit = overlay_finetune(
                sd, load_released_state_dict(args.finetune_ckpt))
            print(f"[convert] finetune overlay: {n_be} buffer-embedder + "
                  f"{n_dit} dit tensors from {args.finetune_ckpt}")
        t1 = time.perf_counter()
        n = sum(v.numel() for v in sd.values() if hasattr(v, "numel"))
        print(f"[convert] {name}: {len(sd)} tensors, {n / 1e6:.0f}M params")
        held = _held_dtypes(name, cfg, sd, args.umt5_layout)
        if name == "dit":
            port = wan_dit_state_dict(sd, dit_cfg, held, consume=True)
        elif name == "vae":
            port = wan_vae_state_dict(sd, held)
        else:
            port = umt5_state_dict(sd, args.umt5_layout, held, consume=True)
        del sd
        t2 = time.perf_counter()
        torch.save(port, out / f"{name}.pt")
        t3 = time.perf_counter()
        size = (out / f"{name}.pt").stat().st_size
        del port
        print(f"[convert] {name}: read {t1 - t0:.2f} s, converted "
              f"{t2 - t1:.2f} s, written {t3 - t2:.2f} s "
              f"({size / 2**30:.2f} GiB)")
    meta = {
        "variant": args.variant,
        "towers": sorted(towers),
        "dit_overrides": {"use_buffer_embedder": dit_cfg.use_buffer_embedder},
        "source_files": {k: str(v) for k, v in
                         (("wan_dit", args.wan_dit), ("wan_vae", args.wan_vae),
                          ("umt5", args.umt5),
                          ("finetune_ckpt", args.finetune_ckpt)) if v},
    }
    (out / "pipeline.json").write_text(json.dumps(meta, indent=2))
    print(f"[convert] checkpoint written to {args.out} "
          f"(towers: {', '.join(meta['towers'])})")


if __name__ == "__main__":
    main()
