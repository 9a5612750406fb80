"""Port parity: ``infinicube_tpu_torch.parallel.mesh`` and the data-parallel
loop over 2 gloo ranks against the JAX mesh and loop on a 2-device CPU mesh.
``make_mesh``'s shapes and its check; ``shard_batch``'s rows against the
JAX sharding's per-device placement (equal); 3 steps of
``training.loop.train`` on a toy net with the draws injected (in the batch)
against the JAX loop: the logged losses, the parameters and the EMA within
1e-5 of each tensor's scale (optax takes Adam's bias corrections in f32,
``tests/test_torch_training.py``; the port averages the ranks' gradients
where XLA differentiates the global mean); one checkpoint written, by rank
0 alone, with both ranks' generator states; the metrics equal on both
ranks; a resumed run equal to the uninterrupted one bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from infinicube_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from infinicube_tpu.parallel.mesh import make_mesh as jax_make_mesh
from infinicube_tpu.parallel.mesh import shard_batch as jax_shard_batch
from infinicube_tpu.training import loop as jloop
from infinicube_tpu.training import state as jstate
from infinicube_tpu_torch.parallel.mesh import (LocalMesh, MeshConfig,
                                                make_mesh, rank_seed)
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.torch_dist import ddp_rank, run_ranks, seeded

TRAIN = dict(learning_rate=0.05, lr_decay_mult=0.5, lr_decay_step=2,
             lr_clip=1e-3, weight_decay=0.1, grad_clip_value=0.05,
             ema_decay=0.9, use_ema=True)
LOOP = dict(log_every=1, val_every=3, val_batches=1, ckpt_every=50)


def _jax_loss(p, rng, batch):
    pred = jnp.tanh((batch["x"] + batch["noise"]) @ p["w1"] + p["b1"]) @ \
        p["w2"]
    loss = jnp.mean((pred - batch["y"]) ** 2)
    return loss, {"mse": loss}


def _batch(seed):
    x, noise, y = seeded(seed, (4, 3), (4, 3), (4, 2))
    return {"x": x, "noise": noise, "y": y}


def test_mesh_without_a_group():
    """No process group: the world-1 mesh; a layout of more ranks than the
    world raises as the JAX check does."""
    mesh = make_mesh(device="cpu")
    assert isinstance(mesh, LocalMesh) and mesh.shape == (1, 1, 1)
    assert rank_seed(5, mesh) == 5
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1 devices"):
        make_mesh(MeshConfig(data=2), "cpu")
    with pytest.raises(AssertionError, match="mesh 2x1x1 != 1 devices"):
        jax_make_mesh(JaxMeshConfig(data=2), jax.devices()[:1])


def test_data_parallel_loop_matches_jax(tmp_path):
    init = dict(zip(("w1", "b1", "w2"),
                    seeded(1, (3, 5), (5,), (5, 2))))
    batches = [_batch(10 + i) for i in range(3)]
    val = [_batch(20)]
    probe = {"rows": np.arange(12, dtype=np.float32).reshape(4, 3),
             "pair": (np.arange(6, dtype=np.float32),
                      np.float32(2.5) * np.ones((), np.float32),
                      np.arange(3, dtype=np.float32))}
    torch_probe = {"rows": torch.from_numpy(probe["rows"]),
                   "pair": tuple(torch.from_numpy(np.asarray(a))
                                 for a in probe["pair"])}
    res = run_ranks(ddp_rank, 2, tmp_path, init, batches, val, torch_probe,
                    LOOP, TRAIN)

    # ---- the JAX loop on a 2-device data mesh ------------------------------
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1, 1),
                ("data", "model", "seq"))
    logged = []
    state = jloop.train(
        jloop.LoopConfig(**LOOP, max_steps=3, ckpt_dir=str(tmp_path / "jax")),
        jstate.TrainConfig(**TRAIN), {k: jnp.asarray(v)
                                      for k, v in init.items()},
        _jax_loss, batches, jax.random.PRNGKey(0),
        logger=lambda s, m: logged.append((s, m)), val_data=val, mesh=mesh)

    # mesh shapes, groups, the probe's rows and the global metric mean
    placed = jax_shard_batch(mesh, probe)
    for r, got in enumerate(res):
        assert got["shapes"] == {"default": (2, 1, 1), "seq": (1, 1, 2),
                                 "model": (1, 2, 1)}
        assert got["groups"] == {"seq": True, "data": False}
        for leaf_t, leaf_j in zip(jax.tree.leaves(got["shard"]),
                                  jax.tree.leaves(placed)):
            shard = [s for s in leaf_j.addressable_shards
                     if s.device == mesh.devices[r, 0, 0]][0]
            np.testing.assert_array_equal(leaf_t.numpy(),
                                          np.asarray(shard.data))
        assert got["mean"] == {"r": 0.5}

    # the losses rank 0 logged, and the validation on both ranks
    train_logs = [(s, m) for s, m in logged if "loss" in m]
    assert [s for s, _ in res[0]["logged"]] == [1, 2, 3, 3]
    assert res[1]["logged"] == []
    for (s, m), (js, jm) in zip(res[0]["logged"][:3], train_logs):
        assert s == js
        for k in ("loss", "mse", "grad_finite"):
            np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-5)
    jval = [m for s, m in logged if "val/val_loss" in m][0]
    assert res[0]["vals"] == res[1]["vals"]
    (step, vm), = res[0]["vals"]
    assert step == 3
    np.testing.assert_allclose(vm["val_loss"], float(jval["val/val_loss"]),
                               rtol=1e-5)

    def close(got, ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())

    for got in res:
        params, ema, step, _ = got["full"]
        assert step == int(state.step) == 3
        for k in init:
            close(params[k], state.params[k])
            close(ema[k], state.ema.params[k])
    # one checkpoint, by rank 0, with both ranks' generator states
    assert res[0]["files"] == res[1]["files"] == ["ckpt_3.pt", "metrics.json"]
    states = res[0]["rng_states"]
    assert len(states) == 2 and not torch.equal(states[0], states[1])
    for r, got in enumerate(res):
        assert torch.equal(states[r], got["full"][3])
        # 2 steps, then resumed for the third: the uninterrupted run's bits
        for a, b in zip(got["resumed"][:2], got["full"][:2]):
            assert all(torch.equal(a[k], b[k]) for k in init)
        assert got["resumed"][2] == 3
        assert torch.equal(got["resumed"][3], got["full"][3])


def test_shard_batch_keeps_a_grids_vectors_whole(monkeypatch):
    """Over a data axis of 3 ranks, a grid's rows split and its voxel size
    and origin (3-vectors, not rows) stay whole on every rank."""
    from infinicube_tpu_torch.grid.grid import make_grid
    from infinicube_tpu_torch.parallel import mesh as pmesh
    monkeypatch.setattr(pmesh, "data_parallel_sharding",
                        lambda mesh: pmesh.DataSharding(None, 1, 3, 0))
    ijk = torch.arange(3 * 4 * 3, dtype=torch.int32).reshape(3, 4, 3)
    grid = make_grid(ijk, torch.ones(3, 4, dtype=torch.bool), 0.5,
                     (1.0, 2.0, 3.0))
    labels = torch.arange(3)
    (got,), got_labels = pmesh.shard_batch(None, ([grid], labels))
    assert torch.equal(got.ijk, ijk[1:2]) and got.mask.shape == (1, 4)
    assert torch.equal(got.keys, grid.keys[1:2])
    assert torch.equal(got.voxel_size, grid.voxel_size)
    assert torch.equal(got.origin, grid.origin)
    assert torch.equal(got_labels, labels[1:2])


def test_gsm_trainer_refuses_a_data_axis(monkeypatch):
    """The GSM batch is one scene's views: a data axis of 2 would split
    them, so ``train.main`` refuses it before building the model."""
    from infinicube_tpu_torch import train as train_cli
    from infinicube_tpu_torch.parallel import mesh as pmesh
    monkeypatch.setattr(train_cli, "data_parallel_sharding",
                        lambda mesh: pmesh.DataSharding(None, 0, 2, 0))
    with pytest.raises(SystemExit, match="data axis of 2 ranks"):
        train_cli.main(["configs/train_gsm.yaml", "--exec", "max_steps=1"],
                       device="cpu")
