"""Process groups, the device mesh, data and sequence parallelism;
counterpart of ``infinicube_tpu/parallel/mesh.py``.

One process per device. ``init_distributed`` joins the group torchrun
describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``): NCCL for a CUDA device,
gloo for the CPU. ``make_mesh`` lays the ranks out as a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX mesh's axes
("data", "model", "seq"), seq fastest; a process with no group gets the
world-1 ``LocalMesh`` (a ``DeviceMesh`` needs a group).

- ``data``: the batch's leading dim is split over it (``shard_batch``), the
  gradients averaged over it (``all_reduce_grads``) and the metrics too.
- ``model``: kept in the mesh with the JAX package's effect: it annotates
  logical axes but applies no rule that shards a parameter over ``model``,
  so here nothing is sharded over it and its ranks compute alike.
- ``seq``: the Wan DiT's sequence parallelism (``WanDiT(...,
  sp_group=axis_group(mesh, "seq"))``, ``split_tokens``, ``gather_tokens``).

Where the JAX package places arrays with a ``NamedSharding`` and lets XLA
insert the collectives, the port moves the rank's rows and calls the
collectives itself."""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from infinicube_tpu_torch.device import resolve_device

AXES = ("data", "model", "seq")
# the gradients' all-reduce buckets (one collective each), as DDP's
BUCKET_BYTES = 64 << 20


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1     # -1 = all remaining ranks
    model: int = 1
    seq: int = 1


class LocalMesh:
    """The world-1 mesh of a process with no process group: every axis of
    size 1, no group, local rank 0 (the calls of ``DeviceMesh`` this
    module makes)."""

    mesh_dim_names = AXES
    shape = (1, 1, 1)

    def get_local_rank(self, mesh_dim: str) -> int:
        return 0

    def get_group(self, mesh_dim: str):
        return None


def init_distributed(device="cuda", init_method: str = "env://"
                     ) -> torch.device:
    """This process's device, after joining the process group torchrun
    describes. Without ``RANK`` in the environment no group is made (world
    1) and the device is ``device``. A CUDA rank takes ``cuda:LOCAL_RANK``
    and NCCL, a CPU rank gloo; a group that does not come up raises
    (nothing falls back to another backend or device)."""
    dev = resolve_device(device)
    if "RANK" not in os.environ:
        return dev
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = "gloo"
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        backend = "nccl"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    if dist.get_backend() != backend:
        raise RuntimeError(f"a {dist.get_backend()} group is up; a {dev.type}"
                           f" rank needs {backend}")
    # an all-reduce brings the communicator up now, so a group that cannot
    # form fails here and not in the first step
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if probe.item() != world:
        raise RuntimeError(f"process group of {world} ranks summed "
                           f"{probe.item()}")
    return dev


def is_lead() -> bool:
    """Whether this process logs and writes: global rank 0, or no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(cfg: MeshConfig = MeshConfig(), device="cuda"):
    """The ("data", "model", "seq") mesh over the ranks of the default
    group (``data`` -1 takes the ranks the other two leave), as a
    ``DeviceMesh`` of ``device``'s type (the card unless the caller asks
    for the CPU); with no group the world-1 ``LocalMesh``. Raises where
    data x model x seq is not the world."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    model, seq = cfg.model, cfg.seq
    data = cfg.data if cfg.data > 0 else world // (model * seq)
    if data * model * seq != world:
        raise ValueError(f"mesh {data}x{model}x{seq} != {world} devices")
    if not dist.is_initialized():
        return LocalMesh()
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (data, model, seq),
                            mesh_dim_names=AXES)


def axis_group(mesh, axis: str):
    """The process group of this rank's ``axis`` of the mesh, or None where
    that axis has one rank (nothing to communicate)."""
    size = mesh.shape[mesh.mesh_dim_names.index(axis)]
    return None if size == 1 else mesh.get_group(axis)


class DataSharding(NamedTuple):
    """The data axis as this rank sees it: its group (None at size 1), its
    rank and size there, and the global rank of the group's rank 0."""
    group: object
    rank: int
    size: int
    src: int


def data_parallel_sharding(mesh) -> DataSharding:
    """How the batch's leading dim is split: over the ``data`` axis."""
    group = axis_group(mesh, "data")
    if group is None:
        return DataSharding(None, 0, 1, 0)
    return DataSharding(group, mesh.get_local_rank("data"),
                        dist.get_world_size(group),
                        dist.get_global_rank(group, 0))


def replicate(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` made equal on every rank of the data axis: broadcast in place
    from the axis' rank 0."""
    sh = data_parallel_sharding(mesh)
    if sh.group is not None:
        dist.broadcast(x, sh.src, group=sh.group)
    return x


def shard_params_replicated(mesh, params: dict) -> dict:
    """Every parameter replicated over the data axis (``replicate``), in
    place."""
    with torch.no_grad():
        for p in params.values():
            replicate(mesh, p.data)
    return params


def map_tensors(fn: Callable, batch):
    """``fn`` applied to every tensor of a batch (tensors, tuples, lists and
    dicts of them, and dataclasses of tensors such as ``CondCubes`` or a
    ``Grid``); anything else passes through."""
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, (tuple, list)):
        return type(batch)(map_tensors(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: map_tensors(fn, v) for k, v in batch.items()}
    if dataclasses.is_dataclass(batch) and not isinstance(batch, type):
        return dataclasses.replace(batch, **{
            f.name: map_tensors(fn, getattr(batch, f.name))
            for f in dataclasses.fields(batch) if f.init})
    return batch


def shard_batch(mesh, batch, device=None):
    """This rank's part of a host batch on ``device``: of every tensor whose
    leading dim the data axis divides, the rank's contiguous rows (the JAX
    sharding's per-device placement); every other tensor (a scalar, a
    leading dim the axis does not divide) whole, and so a ``Grid``'s voxel
    size and origin, its own 3-vectors (the JAX placement splits them over
    3 devices, which changes no value there; here each rank computes on
    what it holds)."""
    from infinicube_tpu_torch.grid.grid import Grid
    sh = data_parallel_sharding(mesh)

    def put(x):
        if sh.size > 1 and x.dim() > 0 and x.shape[0] % sh.size == 0:
            m = x.shape[0] // sh.size
            x = x[sh.rank * m:(sh.rank + 1) * m]
        return x if device is None else x.to(device)

    def whole(x):
        return x if device is None else x.to(device)

    def walk(b):
        if isinstance(b, Grid):
            return dataclasses.replace(b, **{
                f.name: map_tensors(whole if f.name in ("voxel_size",
                                                        "origin") else put,
                                    getattr(b, f.name))
                for f in dataclasses.fields(b)})
        if isinstance(b, (tuple, list)):
            return type(b)(walk(x) for x in b)
        if isinstance(b, dict):
            return {k: walk(v) for k, v in b.items()}
        return map_tensors(put, b)

    return walk(batch)


def rank_seed(seed: int, mesh) -> int:
    """The seed of this data rank's generator: ``seed`` on data rank 0 (so a
    world-1 run draws what a run without a group does), ``seed + (rank <<
    32)`` on the others, so that the ranks' draws differ."""
    return seed + (data_parallel_sharding(mesh).rank << 32)


def all_reduce_grads(grads: list[torch.Tensor], group) -> None:
    """The mean of ``grads`` over ``group``, in place, flattened into
    buckets of one dtype of at most ``BUCKET_BYTES`` (one collective each).
    gloo has no averaging reduction: a sum, then a division by the group's
    size."""
    if group is None or not grads:
        return
    n = dist.get_world_size(group)
    bucket: list[torch.Tensor] = []

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        at = 0
        for g in bucket:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        bucket.clear()

    size = 0
    for g in grads:
        if bucket and (g.dtype != bucket[0].dtype or
                       size + g.numel() * g.element_size() > BUCKET_BYTES):
            flush()
            size = 0
        bucket.append(g)
        size += g.numel() * g.element_size()
    if bucket:
        flush()


def all_reduce_mean(metrics: dict, group, device) -> dict:
    """The mean over ``group`` of each scalar metric (one collective on
    ``device``), as floats; the metrics as floats where there is no
    group."""
    if group is None:
        return {k: float(v) for k, v in metrics.items()}
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k], device=device).float()
                        .reshape(()) for k in keys])
    dist.all_reduce(vals, group=group)
    vals = (vals / dist.get_world_size(group)).tolist()
    return dict(zip(keys, vals))


# ---- sequence parallelism: the DiT's token split and gather -----------------

def _token_slice(n: int, group) -> tuple[int, int]:
    p, r = dist.get_world_size(group), dist.get_rank(group)
    if n % p:
        raise ValueError(f"sequence parallelism: N = {n} tokens do not "
                         f"split over P = {p} ranks")
    return r * (n // p), n // p


def _all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        at, m = _token_slice(x.shape[dim], group)
        ctx.group, ctx.dim = group, dim
        return x.narrow(dim, at, m).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_cat(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        at, m = _token_slice(g.shape[ctx.dim], ctx.group)
        return g.narrow(ctx.dim, at, m).contiguous(), None, None


def split_tokens(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous 1/P of ``x`` along ``dim`` (x whole on every
    rank; None: one rank, x itself). Its gradient comes back whole on every
    rank (an all-gather of the slices' gradients). Raises where P does not
    divide the tokens."""
    return x if group is None else _Split.apply(x, group, dim)


def gather_tokens(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The ranks' slices of ``x`` along ``dim`` concatenated in rank order
    (None: x itself); the gradient each rank gets back is its slice's."""
    return x if group is None else _Gather.apply(x, group, dim)
