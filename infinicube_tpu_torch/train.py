"""Training command line; counterpart of ``infinicube_tpu/train.py``.

YAML config with includes and interpolation plus ``--k.e.y v`` / ``--exec``
overrides (``ConfigArgumentParser``), model selection by the ``model:`` key,
logger selection, checkpoint auto-resume. Runs on the card unless
``main(argv, device="cpu")``, with TF32 off (``utils/precision.py``).

Three trainers: the voxel diffusion model, the sparse VAE and the GSM.
Where ``data.root`` names a directory of converted clips
(``data_process/waymo2shards.py``, then
``data_process/generate_additional_attributes.py``), each trains on them
through ``WaymoClipDataset`` (the ``data.*`` keys are its
``WaymoDatasetConfig``) and ``training/data_glue.py``: the diffusion trainer
on the latents of the frozen VAE at ``vae_checkpoint``, scaled by
``scale_by_std`` (written to ``<ckpt_dir>/scale_factor.json``). Where
``data.root`` is unset or names no existing path, each trains on its
synthetic stream, as the JAX CLI does.

Under torchrun each process trains on its card, data-parallel over the
mesh's ``data`` axis (``mesh.model`` and ``mesh.seq`` take their share of
the ranks, as the JAX CLI's mesh does; nothing is sharded over them):
``python -m torch.distributed.run --nproc_per_node=N -m
infinicube_tpu_torch.train ...``. Every rank reads the whole stream and the
loop gives each data rank its rows. The GSM trainer, whose batch is one
scene's views, refuses a data axis of more than one rank. Without torchrun
it runs on one device.

Usage:
  python -m infinicube_tpu_torch.train configs/train_diffusion.yaml \\
      --name myrun --exec batch_size=1 max_steps=3
  python -m infinicube_tpu_torch.train configs/train_vae.yaml \\
      --name myvae --exec max_steps=3 points_per_sample=200000
  python -m infinicube_tpu_torch.train configs/train_gsm.yaml \\
      --name mygsm --exec max_steps=3 lpips_checkpoint=random
  python -m infinicube_tpu_torch.train configs/train_vae.yaml \\
      --name myvae --exec data.root=data/waymo max_steps=3
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from infinicube_tpu_torch.config import Config, ConfigArgumentParser
from infinicube_tpu_torch.parallel.mesh import (MeshConfig,
                                                data_parallel_sharding,
                                                init_distributed, is_lead,
                                                make_mesh, rank_seed)
from infinicube_tpu_torch.training.logging import make_logger
from infinicube_tpu_torch.training.loop import LoopConfig, train
from infinicube_tpu_torch.training.state import TrainConfig
from infinicube_tpu_torch.utils.precision import set_float32_precision

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


def _dataclass_kwargs(section) -> dict:
    """A YAML section as keyword arguments of a frozen config dataclass:
    lists become tuples and a ``dtype`` name the torch type."""
    kw = {k: _tuples(v) for k, v in section.items()}
    if isinstance(kw.get("dtype"), str):
        kw["dtype"] = _DTYPES[kw["dtype"]]
    return kw


class _Looping:
    """The clips of ``dcfg`` pass after pass, all of them on every rank (the
    global stream, as the JAX CLI's one process reads it: the loop's
    ``shard_batch`` gives each data rank its rows, and the ranks of the
    ``model`` and ``seq`` axes see the same batches). A pass that yields no
    sample raises, naming the root, where looping on would never yield
    one."""

    def __init__(self, dcfg):
        self.dcfg = dcfg

    def __iter__(self):
        from infinicube_tpu_torch.data.waymo_dataset import build_dataset
        while True:
            n = 0
            for sample in build_dataset(self.dcfg, host_index=0,
                                        num_hosts=1):
                n += 1
                yield sample
            if n == 0:
                raise RuntimeError(
                    f"data.root {self.dcfg.root}: a whole pass over its "
                    f"shards yielded no sample")


def _real_dataset(cfg: Config):
    """The clips under ``data.root`` as an endless sample stream, or None
    where ``data.root`` is unset or names no existing path."""
    from pathlib import Path

    from infinicube_tpu_torch.data.waymo_dataset import WaymoDatasetConfig
    root = cfg.get_path("data.root")
    if not root or not Path(root).exists():
        return None
    fields = WaymoDatasetConfig.__dataclass_fields__
    return _Looping(WaymoDatasetConfig(root=root, **{
        k: _tuples(v) for k, v in cfg.get_path("data", Config()).items()
        if k != "root" and k in fields}))


def _frozen_vae(cfg: Config, device: torch.device):
    """The sparse VAE of the ``vae.*`` keys with the parameters of the
    newest checkpoint at ``vae_checkpoint`` (a random init where that holds
    none), frozen."""
    from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                       SparseVAEConfig)
    from infinicube_tpu_torch.training.checkpoint import CheckpointManager
    ckpt = cfg.get_path("vae_checkpoint")
    if not ckpt:
        raise SystemExit("diffusion training on real data requires "
                         "vae_checkpoint")
    vcfg = SparseVAEConfig(**_dataclass_kwargs(cfg.get_path("vae", {})))
    vae = SparseStructureVAE(vcfg, device=device)
    vae.init_params(torch.Generator(device=device).manual_seed(0))
    mgr = CheckpointManager(ckpt)
    if mgr.latest_step() is not None:
        vae.load_state_dict(mgr.restore()["params"])
    return vae.eval().requires_grad_(False), vcfg


def build_diffusion(cfg: Config, device: torch.device):
    """(params, loss_fn, batches) of the voxel-diffusion trainer: the
    frozen VAE's latents of the clips under ``data.root`` scaled by
    ``scale_by_std``, or else the synthetic latent stream."""
    from infinicube_tpu_torch.models.diffusion.model import (
        CondCubes, DiffusionConfig, VoxelDiffusion)
    dc = DiffusionConfig(**_dataclass_kwargs(cfg.get_path("diffusion", {})))
    model = VoxelDiffusion(dc, device=device, trainable=True)
    model.init_params(torch.Generator(device=device).manual_seed(
        cfg.get_path("seed", 0)))

    def loss_fn(params, generator, batch):
        latents, cond = batch
        return model.train_loss(latents, cond, generator=generator,
                                params=params)

    ds = _real_dataset(cfg)
    if ds is not None:
        from infinicube_tpu_torch.training.data_glue import (
            diffusion_batches, scale_by_std)
        vae, vcfg = _frozen_vae(cfg, device)
        sf_path = (cfg.get_path("ckpt_dir",
                                f"checkpoints/{cfg.get_path('name', 'run')}")
                   + "/scale_factor.json")
        return model.named_parameters(), loss_fn, scale_by_std(
            diffusion_batches(ds, model, vae, vcfg,
                              batch_size=cfg.get_path("batch_size", 2)),
            save_path=sf_path)

    def synthetic_batches():
        # synthetic latents stream for smoke training without data; its
        # conditions are the null ones of the config (with the extra cube,
        # class one-hot and one context token where it takes them), as the
        # JAX CLI's, so the condition encoders' parameters get no gradient
        # and do not move on this stream
        rng = np.random.default_rng(0)
        B = cfg.get_path("batch_size", 2)
        D, H, W = dc.cube_dims
        while True:
            lat = torch.from_numpy(rng.normal(
                size=(B, D, H, W, dc.latent_channels)).astype(np.float32))
            yield lat, CondCubes.null(B, dc)

    return model.named_parameters(), loss_fn, synthetic_batches()


def build_vae(cfg: Config, device: torch.device):
    """(params, loss_fn, batches) of the sparse-VAE trainer: hash-tree
    batches of the clips under ``data.root`` (``vae_batches``, the first
    ``point_capacity`` points of a sample), or else of uniform points in a
    +-5 m cube with random labels, drawn from
    ``numpy.random.default_rng(0)`` in the JAX CLI's order (its first draw
    shapes the parameters and is not trained on, so it is drawn and dropped
    here too). The metrics carry the active voxels of every level as
    ``voxels{l}``."""
    from torch.func import functional_call

    from infinicube_tpu_torch.grid.ops import majority_label
    from infinicube_tpu_torch.models.vae.loss import VAELossConfig, vae_loss
    from infinicube_tpu_torch.models.vae.sunet import (
        SparseStructureVAE, SparseVAEConfig, build_hash_tree)
    vc = SparseVAEConfig(**_dataclass_kwargs(cfg.get_path("vae", {})))
    lcfg = VAELossConfig(**cfg.get_path("vae_loss", {}))
    model = SparseStructureVAE(vc, device=device)
    model.init_params(torch.Generator(device=device).manual_seed(
        cfg.get_path("seed", 0)))
    rng0 = np.random.default_rng(0)
    B = cfg.get_path("batch_size", 1)
    N = cfg.get_path("points_per_sample", 2048)

    def draw():
        pts = rng0.uniform(-5, 5, (B, N, 3)).astype(np.float32)
        labels = rng0.integers(0, vc.num_semantic, (B, N)).astype(np.int32)
        return pts, labels

    def make_batch():
        pts, labels = (torch.from_numpy(a).to(device) for a in draw())
        mask = torch.ones((B, N), dtype=torch.bool, device=device)
        grids = build_hash_tree(vc, pts, mask)
        sem = majority_label(grids[0], pts, labels, mask, vc.num_semantic)
        return grids, sem

    draw()

    def loss_fn(params, generator, batch):
        grids, sem = batch
        out = functional_call(model, params, (grids, sem),
                              {"generator": generator})
        loss, metrics = vae_loss(lcfg, out, grids[0], sem)
        for l, g in enumerate(grids):
            metrics[f"voxels{l}"] = g.mask.sum() / g.batch_size
        return loss, metrics

    ds = _real_dataset(cfg)
    if ds is not None:
        from infinicube_tpu_torch.training.data_glue import vae_batches
        return dict(model.named_parameters()), loss_fn, vae_batches(
            ds, vc, batch_size=B,
            point_capacity=cfg.get_path("point_capacity", 65536),
            device=device)

    def batches():
        while True:
            yield make_batch()

    return dict(model.named_parameters()), loss_fn, batches()


def build_gsm(cfg: Config, device: torch.device):
    """(params, loss_fn, batches) of the GSM trainer: the release
    ``GSMConfig()`` (f32) with the dense slot-volume lookup bounds of the
    training crops, on the clips under ``data.root`` (``gsm_batches``: their
    input views) or else the JAX CLI's synthetic scene (2,000 uniform points
    in a 20 m cube as a 0.5 m grid of capacity 4,096, 2 views of 64x96 of
    uniform colors), drawn from ``numpy.random.default_rng(0)`` in its
    order (its first draw shapes the parameters and is not trained on, so
    it is drawn and dropped here too). ``lpips_checkpoint``: None (the
    gradient proxy), "random" (checkpoint-shaped random LPIPS weights) or
    an ``.npz`` of the lpips library's state dict; the LPIPS weights are
    frozen and stay out of the trained parameters."""
    import dataclasses

    from torch.func import functional_call

    from infinicube_tpu_torch.grid.build import grid_from_points
    from infinicube_tpu_torch.models.gsm.loss import GSMLossConfig, gsm_loss
    from infinicube_tpu_torch.models.gsm.lpips import load_lpips
    from infinicube_tpu_torch.models.gsm.model import GSM, GSMConfig
    # training runs on per-sample crops (the same recentered +-(25.6, 25.6,
    # 12.8) m cube as the VAE at 0.2 m voxels), so the conv plans can use
    # the dense slot-volume lookup
    gc = GSMConfig()
    gc = dataclasses.replace(gc, voxel=dataclasses.replace(
        gc.voxel, dense_lookup_bounds=((-132, -132, -68), (264, 264, 136))))
    model = GSM(gc, device=device)
    model.init_params(torch.Generator(device=device).manual_seed(
        cfg.get_path("seed", 0)))
    lcfg = GSMLossConfig(**cfg.get_path("gsm_loss", {}))
    rng0 = np.random.default_rng(0)
    V, h, w = 2, 64, 96
    T = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    T[:, :3, 0] = [0, -1, 0]
    T[:, :3, 1] = [0, 0, -1]
    T[:, :3, 2] = [1, 0, 0]
    T[:, :3, 3] = [0, 0, 2]
    K = np.array([[80.0, 0, w / 2], [0, 80, h / 2], [0, 0, 1]], np.float32)

    def make_batch():
        pts = torch.from_numpy(rng0.uniform(0, 20, (1, 2000, 3)).astype(
            np.float32)).to(device)
        images = rng0.uniform(size=(V, h, w, 3)).astype(np.float32)
        grid = grid_from_points(pts, torch.ones((1, 2000), dtype=torch.bool,
                                                device=device), 0.5, 0.25,
                                capacity=4096)
        return {
            "grid": grid,
            "images": torch.from_numpy(images).to(device),
            "masks": torch.ones((V, h, w, 4), device=device),
            "Ks": torch.from_numpy(np.stack([K, K])).to(device),
            "cam_to_worlds": torch.from_numpy(T).to(device),
            "depth_prior": torch.zeros((V, h, w, 1), device=device),
        }

    make_batch()
    lp_ckpt = cfg.get_path("lpips_checkpoint", None)
    lpips = load_lpips(lp_ckpt, device) if lp_ckpt else None

    def loss_fn(params, generator, batch):
        out = functional_call(model, params, (batch,))
        valid = batch["masks"][..., 0] * batch["masks"][..., 2] > 0
        return gsm_loss(lcfg, out["render"], batch["images"], valid,
                        out["sky_mask"], gaussians=out["gaussians"],
                        lpips=lpips, generator=generator)

    ds = _real_dataset(cfg)
    if ds is not None:
        from infinicube_tpu_torch.training.data_glue import gsm_batches
        return dict(model.named_parameters()), loss_fn, gsm_batches(
            ds, gc, voxel_capacity=cfg.get_path("voxel_capacity", 65536),
            device=device)

    def batches():
        while True:
            yield make_batch()

    return dict(model.named_parameters()), loss_fn, batches()


BUILDERS = {"diffusion": build_diffusion, "vae": build_vae, "gsm": build_gsm}


def main(argv=None, device="cuda"):
    parser = ConfigArgumentParser()
    parser.add_argument("--name", type=str, default="run")
    parser.add_argument("--logger", type=str, default="jsonl")
    parser.add_argument("--logdir", type=str, default="logs")
    cfg = parser.parse_config(argv)
    set_float32_precision()
    device = init_distributed(device)
    mesh = make_mesh(MeshConfig(model=cfg.get_path("mesh.model", 1),
                                seq=cfg.get_path("mesh.seq", 1)), device)
    model_kind = cfg.get_path("model", "diffusion")
    if model_kind not in BUILDERS:
        raise SystemExit(f"unknown model '{model_kind}'")
    data = data_parallel_sharding(mesh).size
    if model_kind == "gsm" and data > 1:
        # XLA computes the JAX loop's global batch whatever its placement;
        # here each rank computes on its rows, and the GSM batch's rows
        # are one scene's views, which the lifter fuses
        raise SystemExit(f"the GSM trainer takes one scene's views a step: "
                         f"a data axis of {data} ranks would split them; "
                         f"set mesh.model or mesh.seq to take the ranks")
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
    lead = is_lead()
    logger = make_logger(cfg.get_path("logger", "jsonl"),
                         cfg.get_path("logdir", "logs"),
                         cfg.get_path("name", "run")) if lead else None
    generator = torch.Generator(device=device).manual_seed(
        rank_seed(cfg.get_path("seed", 0), mesh))
    state = train(loop_cfg, train_cfg, params, loss_fn, batches, generator,
                  logger=logger, device=device, mesh=mesh)
    if lead:
        print(f"[train] finished at step {int(state.step)} "
              f"({int(state.num_nan_skips)} NaN-skipped steps)")
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
