"""Multi-process runs of the port for the CPU tests: ``run_ranks`` spawns one
process per rank over gloo and a ``file://`` store in the test's own
directory (so parallel test workers never race for a port), joins them with
a deadline, kills them on expiry and fails naming the ranks that hung. The
children import torch and the port only, one torch thread each; the rank
functions they run are the ones below, so that unpickling them imports no
JAX."""

from __future__ import annotations

import multiprocessing as mp
import os
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

DEADLINE = 60.0


def _child(fn, rank, world, tmp, args):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    out = Path(tmp) / f"rank{rank}"
    try:
        import torch.distributed as dist

        from infinicube_tpu_torch.parallel.mesh import init_distributed
        init_distributed("cpu", init_method=f"file://{tmp}/store")
        res = fn(rank, world, Path(tmp), *args)
        dist.barrier()
        dist.destroy_process_group()
        torch.save(res, out.with_suffix(".pt"))
    except BaseException:
        out.with_suffix(".err").write_text(traceback.format_exc())
        raise


def run_ranks(fn, world: int, tmp: Path, *args, deadline: float = DEADLINE):
    """``fn(rank, world, tmp, *args)`` in ``world`` processes joined in one
    group; returns their results in rank order."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, world, str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    if hung:
        pytest.fail(f"ranks {hung} of {world} still running after "
                    f"{deadline:.0f} s; killed")
    for r, p in enumerate(procs):
        err = tmp / f"rank{r}.err"
        if p.exitcode != 0 or err.exists():
            pytest.fail(f"rank {r} of {world} exited {p.exitcode}:\n" +
                        (err.read_text() if err.exists() else ""))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ---- ring attention ----------------------------------------------------------

def ring_rank(rank, world, tmp, cases):
    """For each case (q, k, v, cot) numpy f32 and a dtype name: this rank's
    slice through ``ring_attention`` over the world, its output and its
    slice's gradients of sum(out * cot)."""
    from infinicube_tpu_torch.ops.ring_attention import ring_attention
    import torch.distributed as dist
    res = []
    for (q, k, v, cot), dtype in cases:
        m = q.shape[1] // world
        sl = slice(rank * m, (rank + 1) * m)
        t = [torch.from_numpy(a[:, sl].copy()).to(getattr(torch, dtype))
             .requires_grad_() for a in (q, k, v)]
        out = ring_attention(*t, dist.group.WORLD)
        (out.float() * torch.from_numpy(cot[:, sl].copy())).sum().backward()
        res.append([x.detach() for x in (out, *(a.grad for a in t))])
    return res


# ---- the sequence-parallel DiT -------------------------------------------------

def sp_dit_rank(rank, world, tmp, cfg_kw, state, inputs, cot, odd):
    """The DiT with ``sp_axis`` over the world: its output, the latents'
    gradient of sum(out * cot), the parameter gradients summed over the
    ranks, and the error a token count the ranks do not divide gives."""
    import torch.distributed as dist

    from infinicube_tpu_torch.models.wan.dit import WanDiT, WanDiTConfig
    dit = WanDiT(WanDiTConfig(**cfg_kw, sp_axis="seq", dtype=torch.float32),
                 device="cpu", sp_group=dist.group.WORLD)
    dit.load_state_dict(state)
    lat, t, txt, buf = (torch.from_numpy(a) for a in inputs)
    lat.requires_grad_()
    out = dit(lat, t, txt, buf)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = {k: p.grad for k, p in dit.named_parameters()}
    for g in grads.values():
        dist.all_reduce(g)
    try:
        dit(*(torch.from_numpy(a) for a in odd))
        err = None
    except ValueError as e:
        err = str(e)
    return out.detach(), lat.grad, grads, err


# ---- data parallelism ---------------------------------------------------------

def toy_loss(params, generator, batch):
    """A two-layer net on (x + noise) -> y; the noise is in the batch (the
    draws are injected). One draw from the generator keeps its state
    moving without touching the loss."""
    pred = torch.tanh((batch["x"] + batch["noise"]) @ params["w1"] +
                      params["b1"]) @ params["w2"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    if generator is not None:
        loss = loss + 0.0 * torch.rand((), generator=generator)
    return loss, {"mse": loss}


def toy_params(init):
    return {k: torch.from_numpy(v.copy()).requires_grad_()
            for k, v in init.items()}


def ddp_rank(rank, world, tmp, init, batches, val, shard_probe, loop_kw,
             train_kw):
    """Mesh shapes, ``shard_batch`` on a probe batch, then the loop on the
    toy net: 3 steps in one run, and 2 + 1 resumed in another; returns what
    the parent compares."""
    import torch.distributed as dist

    from infinicube_tpu_torch.parallel.mesh import (
        MeshConfig, all_reduce_mean, axis_group, make_mesh, shard_batch)
    from infinicube_tpu_torch.training.loop import (LoopConfig, train,
                                                    make_default_val_fn)
    from infinicube_tpu_torch.training.state import TrainConfig
    shapes = {name: tuple(make_mesh(cfg, "cpu").shape) for name, cfg in (
        ("default", MeshConfig()), ("seq", MeshConfig(seq=world)),
        ("model", MeshConfig(model=world)))}
    seq_mesh = make_mesh(MeshConfig(seq=world), "cpu")
    groups = {"seq": axis_group(seq_mesh, "seq") is not None,
              "data": axis_group(seq_mesh, "data") is not None}
    mesh = make_mesh(MeshConfig(), "cpu")
    shard = shard_batch(mesh, shard_probe)
    mean = all_reduce_mean({"r": torch.tensor(float(rank))},
                           axis_group(mesh, "data"), "cpu")

    def tensors(bs):
        return [{k: torch.from_numpy(v) for k, v in b.items()} for b in bs]

    logged, vals = [], []
    base_val = make_default_val_fn(toy_loss, tensors(val), 1, "cpu", mesh)

    def val_fn(state, step):
        m = base_val(state, step)
        vals.append((step, m))
        return m

    def run(bs, ckpt, max_steps, log):
        gen = torch.Generator().manual_seed(7 + (rank << 32))
        state = train(LoopConfig(**loop_kw, max_steps=max_steps,
                                 ckpt_dir=str(tmp / ckpt)),
                      TrainConfig(**train_kw), toy_params(init), toy_loss,
                      tensors(bs), gen, logger=log,
                      val_fn=val_fn if log else None, device="cpu",
                      mesh=mesh)
        return {k: v.detach() for k, v in state.params.items()}, \
            {k: v.clone() for k, v in state.ema.params.items()}, \
            state.step, gen.get_state()

    full = run(batches, "full", 3, lambda s, m: logged.append((s, m)))
    dist.barrier()
    files = sorted(p.name for p in (tmp / "full").iterdir())
    run(batches[:2], "resumed", 2, None)
    resumed = run(batches[2:], "resumed", 3, None)
    saved = torch.load(tmp / "full" / "ckpt_3.pt", weights_only=True)
    return dict(shapes=shapes, groups=groups, shard=shard, mean=mean,
                full=full, resumed=resumed, logged=logged, vals=vals,
                files=files, rng_states=saved.get("rng_states"))


def real_train_rank(rank, world, tmp, argv):
    """``train.main`` on the CPU with ``argv`` (a config and its ``--exec``
    overrides; the checkpoints and the log go to ``tmp``): the rank's
    trained parameters."""
    from infinicube_tpu_torch.train import main
    state = main([argv[0], "--logdir", str(tmp), *argv[1:],
                  f"ckpt_dir={tmp}/ck"], device="cpu")
    return {k: p.detach() for k, p in state.params.items()}


def seeded(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]
