"""Training command line; counterpart of ``infinicube_tpu/train.py``.

YAML config with includes and interpolation plus ``--k.e.y v`` / ``--exec``
overrides (``ConfigArgumentParser``), model selection by the ``model:`` key,
logger selection, checkpoint auto-resume. Runs on the card unless
``main(argv, device="cpu")``.

Ported so far: the voxel-diffusion trainer on the synthetic latent stream
(what the JAX CLI trains on when no ``data.root`` is configured). Real data
(``data.root``: the Waymo clips, the frozen VAE's ``encode``,
``scale_by_std``) and the VAE and GSM trainers raise
``NotImplementedError``.

Usage:
  python -m infinicube_tpu_torch.train configs/train_diffusion.yaml \\
      --name myrun --exec batch_size=1 max_steps=3
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from infinicube_tpu_torch.config import Config, ConfigArgumentParser
from infinicube_tpu_torch.device import resolve_device
from infinicube_tpu_torch.training.logging import make_logger
from infinicube_tpu_torch.training.loop import LoopConfig, train
from infinicube_tpu_torch.training.state import TrainConfig

_WAITS = ("not ported yet: {what} (ROADMAP section 1, items 8, 17 and 18: "
          "the VAE encode, the training data glue and the Waymo data path)")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def build_diffusion(cfg: Config, device: torch.device):
    """(params, loss_fn, batches) of the voxel-diffusion trainer."""
    from infinicube_tpu_torch.models.diffusion.model import (
        CondCubes, DiffusionConfig, VoxelDiffusion)
    if cfg.get_path("data.root"):
        raise NotImplementedError(_WAITS.format(
            what="diffusion training on real data (data.root)"))
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg.get_path("diffusion", {}).items()}
    if isinstance(kw.get("dtype"), str):
        kw["dtype"] = _DTYPES[kw["dtype"]]
    dc = DiffusionConfig(**kw)
    model = VoxelDiffusion(dc, device=device, trainable=True)
    model.init_params(torch.Generator(device=device).manual_seed(
        cfg.get_path("seed", 0)))

    def loss_fn(params, generator, batch):
        latents, cond = batch
        return model.train_loss(latents, cond, generator=generator,
                                params=params)

    def synthetic_batches():
        # synthetic latents stream for smoke training without data
        rng = np.random.default_rng(0)
        B = cfg.get_path("batch_size", 2)
        D, H, W = dc.cube_dims
        while True:
            lat = torch.from_numpy(rng.normal(
                size=(B, D, H, W, dc.latent_channels)).astype(np.float32))
            yield lat, CondCubes.null(B, dc)

    return model.named_parameters(), loss_fn, synthetic_batches()


def build_vae(cfg: Config, device: torch.device):
    raise NotImplementedError(_WAITS.format(
        what="the VAE trainer (it also needs the sparse conv's gradient "
        "kernels, ROADMAP section 2)"))


def build_gsm(cfg: Config, device: torch.device):
    raise NotImplementedError(_WAITS.format(what="the GSM trainer"))


BUILDERS = {"diffusion": build_diffusion, "vae": build_vae, "gsm": build_gsm}


def main(argv=None, device="cuda"):
    parser = ConfigArgumentParser()
    parser.add_argument("--name", type=str, default="run")
    parser.add_argument("--logger", type=str, default="jsonl")
    parser.add_argument("--logdir", type=str, default="logs")
    cfg = parser.parse_config(argv)
    device = resolve_device(device)
    model_kind = cfg.get_path("model", "diffusion")
    if model_kind not in BUILDERS:
        raise SystemExit(f"unknown model '{model_kind}'")
    params, loss_fn, batches = BUILDERS[model_kind](cfg, device)
    loop_cfg = LoopConfig(
        max_steps=cfg.get_path("max_steps", 1000),
        log_every=cfg.get_path("log_every", 50),
        ckpt_every=cfg.get_path("ckpt_every", 50),
        ckpt_dir=cfg.get_path("ckpt_dir", f"checkpoints/{cfg.get_path('name')}"))
    train_cfg = TrainConfig(
        learning_rate=cfg.get_path("learning_rate.init", 5e-5),
        grad_clip_value=cfg.get_path("grad_clip", 0.5),
        weight_decay=cfg.get_path("weight_decay", 0.0),
        ema_decay=cfg.get_path("ema_decay", 0.9999),
        use_ema=cfg.get_path("ema", True))
    logger = make_logger(cfg.get_path("logger", "jsonl"),
                         cfg.get_path("logdir", "logs"),
                         cfg.get_path("name", "run"))
    generator = torch.Generator(device=device).manual_seed(
        cfg.get_path("seed", 0))
    state = train(loop_cfg, train_cfg, params, loss_fn, batches, generator,
                  logger=logger, device=device)
    print(f"[train] finished at step {int(state.step)} "
          f"({int(state.num_nan_skips)} NaN-skipped steps)")
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
