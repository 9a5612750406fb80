"""Port parity for the sparse-VAE trainer as a whole: ``encode``, the
teacher-forced ``decode`` and ``vae_loss`` with its metrics of
``infinicube_tpu_torch`` against the JAX package on the same numpy-seeded
points, the same weights (``weights/from_jax``) and the same reparametrize
noise; the CLI's batches against the JAX CLI's; ``evaluate_reconstruction``.
(Every gradient and five train steps: ``tests/test_torch_vae_steps.py``.)
f32 on both sides, small widths: ``f_maps`` 8 on capacities (1024, 512, 256)
around an 8 x 8 x 16 neck. The JAX sparse convs run through their gather
reference here (the JAX package's CPU default; the whole model through the
Pallas window kernels in interpret mode takes minutes to trace), and
``tests/test_torch_sparse_conv_bwd.py`` holds the conv's gradients against
those kernels."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.grid.ops import majority_label as jax_majority_label
from infinicube_tpu.models.vae import loss as jloss
from infinicube_tpu.models.vae import sunet as jsunet
from infinicube_tpu_torch.grid.ops import majority_label
from infinicube_tpu_torch.models.vae.loss import (VAELossConfig,
                                                  kl_divergence, vae_loss)
from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                   SparseVAEConfig,
                                                   build_hash_tree)
from infinicube_tpu_torch.training.state import TrainConfig, TrainState
from infinicube_tpu_torch.weights.from_jax import sparse_vae_from_jax
from tests.test_torch_sparse_vae import random_params
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

SMALL = dict(f_maps=8, c_dim=8, sem_embed_dim=4, neck_dims=(8, 8, 16),
             neck_ijk_min=(-4, -4, -8), capacities=(1024, 512, 256),
             dense_lookup_ijk_min=(-18, -18, -18),
             dense_lookup_dims=(36, 36, 36))
B, N = 2, 200
# f32 on both sides, differing only in summation order
TOL = dict(atol=2e-3, rtol=2e-3)
# The first conv of every SparseResBlock feeds a GroupNorm that, at these
# widths, has one channel per group: its bias shifts a channel's mean, which
# the norm removes, so its gradient is exactly zero and both sides hold
# rounding noise there.
ZERO_GRAD = ".conv1.bias"


def _scene(seed):
    """Points in +-3 m (inside the neck at every level) with labels."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, (B, N, 3)).astype(np.float32)
    labels = rng.integers(0, 23, (B, N)).astype(np.int32)
    return pts, labels


def _jax_batch(jcfg, pts, labels):
    mask = jnp.ones((B, N), bool)
    grids = jsunet.build_hash_tree(jcfg, jnp.asarray(pts), mask)
    sem = jax_majority_label(grids[0], jnp.asarray(pts), jnp.asarray(labels),
                             mask, jcfg.num_semantic)
    return grids, sem


def _port_batch(tcfg, pts, labels):
    mask = torch.ones((B, N), dtype=torch.bool)
    grids = build_hash_tree(tcfg, torch.from_numpy(pts), mask)
    sem = majority_label(grids[0], torch.from_numpy(pts),
                         torch.from_numpy(labels), mask, tcfg.num_semantic)
    return grids, sem


def _models(seed=1):
    jcfg = jsunet.SparseVAEConfig(**SMALL)
    jvae = jsunet.SparseStructureVAE(jcfg)
    grids, sem = _jax_batch(jcfg, *_scene(0))
    shapes = jax.eval_shape(jvae.init, jax.random.PRNGKey(0), grids, sem,
                            jax.random.PRNGKey(1))
    params = random_params(flax.linen.meta.unbox(shapes), seed)
    port = SparseStructureVAE(SparseVAEConfig(**SMALL), device="cpu")
    port.load_state_dict(sparse_vae_from_jax(params))          # strict
    return jvae, jax.tree.map(jnp.asarray, params), port


def _noise(rng, shape):
    """What ``reparametrize`` draws from ``rng`` (sunet.py:266)."""
    return np.array(jax.random.normal(rng, shape))


LATENT = (B, 8, 8, 16, 8)


@pytest.fixture(scope="module")
def pair():
    return _models()


def test_hash_tree_batches_match(pair):
    jvae, _, port = pair
    pts, labels = _scene(3)
    jgrids, jsem = _jax_batch(jvae.cfg, pts, labels)
    tgrids, tsem = _port_batch(port.cfg, pts, labels)
    assert len(tgrids) == len(jgrids) == 3
    for tg, jg in zip(tgrids, jgrids):
        np.testing.assert_array_equal(tg.keys.numpy(),
                                      np.asarray(jg.keys).astype(np.int64))
        assert int(tg.num_dropped.sum()) == 0
        np.testing.assert_allclose(tg.origin.numpy(), np.asarray(jg.origin),
                                   rtol=1e-6)
    np.testing.assert_array_equal(tsem.numpy(), np.asarray(jsem))
    # every level lies inside the dense-lookup bounds and the neck
    assert all(int(p.violations.sum()) == 0
               for p in port.level_plans(tgrids))
    top = tgrids[-1]
    lo = torch.tensor(SMALL["neck_ijk_min"])
    rel = top.ijk[top.mask] - lo
    assert (rel >= 0).all() and (rel < torch.tensor(SMALL["neck_dims"])).all()


def test_encode_matches_jax(pair):
    jvae, params, port = pair
    pts, labels = _scene(3)
    jgrids, jsem = _jax_batch(jvae.cfg, pts, labels)
    mu, logvar = jvae.apply(params, jgrids, jsem,
                            method=jsunet.SparseStructureVAE.encode)
    tgrids, tsem = _port_batch(port.cfg, pts, labels)
    with torch.no_grad():
        tmu, tlogvar = port.encode(tgrids, tsem)
        shared = port.encode(tgrids, tsem, plans=port.level_plans(tgrids))
    assert tuple(tmu.shape) == LATENT
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), **TOL)
    np.testing.assert_allclose(tlogvar.numpy(), np.asarray(logvar), **TOL)
    assert torch.equal(shared[0], tmu) and torch.equal(shared[1], tlogvar)
    assert np.abs(np.asarray(mu)).max() > 0.05


def test_logvar_is_clipped():
    _, _, port = _models(seed=5)
    with torch.no_grad():
        port.neck.to_stats.bias[8:] = 100.0
        port.neck.to_stats.bias[8] = -100.0
        _, logvar = port.neck.encode(torch.zeros((1, 8, 8, 16, 32)))
    assert logvar.max() == 20.0 and logvar.min() == -30.0


def test_reparametrize_draws_or_takes_the_noise():
    mu, logvar = torch.zeros(LATENT), torch.full(LATENT, np.log(4.0))
    noise = torch.ones(LATENT)
    z = SparseStructureVAE.reparametrize(mu, logvar, noise=noise)
    torch.testing.assert_close(z, torch.full(LATENT, 2.0))
    draw = [SparseStructureVAE.reparametrize(
        mu, logvar, torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    assert abs(draw[0].std().item() - 2.0) < 0.05


def _jax_forward(jvae, params, batch, rng):
    grids, sem = batch
    out = jvae.apply(params, grids, sem, rng)
    return jloss.vae_loss(jloss.VAELossConfig(), out, grids[0], sem), out


def test_teacher_forced_forward_and_loss_match_jax(pair):
    jvae, params, port = pair
    pts, labels = _scene(4)
    rng = jax.random.PRNGKey(7)
    jbatch = _jax_batch(jvae.cfg, pts, labels)
    (ref_loss, ref_metrics), ref = _jax_forward(jvae, params, jbatch, rng)
    tgrids, tsem = _port_batch(port.cfg, pts, labels)
    with torch.no_grad():
        out = port(tgrids, tsem, noise=torch.from_numpy(_noise(rng, LATENT)))
        loss, metrics = vae_loss(VAELossConfig(), out, tgrids[0], tsem)
    np.testing.assert_allclose(out["z"].numpy(), np.asarray(ref["z"]), **TOL)
    # the hash tree's grids are reused as they are, coarsest first
    assert out["grid"] is tgrids[0]
    assert [g is t for g, t in zip(out["grids"], tgrids[::-1])] == [True] * 3
    assert len(out["struct"]) == len(ref["struct"]) == 3
    for (lg, tgt, m), (rl, rt, rm) in zip(out["struct"], ref["struct"]):
        np.testing.assert_array_equal(tgt.numpy(), np.asarray(rt))
        np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
        np.testing.assert_allclose(lg.numpy(), np.asarray(rl), **TOL)
        assert 0 < tgt.sum() < m.sum()
    m0 = tgrids[0].mask.numpy()
    np.testing.assert_allclose(out["semantic_logits"].numpy()[m0],
                               np.asarray(ref["semantic_logits"])[m0], **TOL)
    assert abs(loss.item() - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    assert set(metrics) == set(ref_metrics)
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    assert metrics["total"] is loss


def test_loss_terms_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 50, 2)).astype(np.float32)
    target = rng.uniform(size=(2, 50)) < 0.2
    mask = rng.uniform(size=(2, 50)) < 0.8
    from infinicube_tpu_torch.models.vae.loss import semantic_ce, struct_ce
    for adaptive in (True, False):
        ref, rm = jloss.struct_ce(jnp.asarray(logits), jnp.asarray(target),
                                  jnp.asarray(mask), adaptive)
        got, gm = struct_ce(torch.from_numpy(logits),
                            torch.from_numpy(target), torch.from_numpy(mask),
                            adaptive)
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
        for k in rm:
            np.testing.assert_allclose(gm[k].item(), float(rm[k]), rtol=1e-5)
    sl = rng.standard_normal((2, 50, 23)).astype(np.float32)
    st = rng.integers(0, 23, (2, 50)).astype(np.int32)
    ref, rm = jloss.semantic_ce(jnp.asarray(sl), jnp.asarray(st),
                                jnp.asarray(mask))
    got, gm = semantic_ce(torch.from_numpy(sl), torch.from_numpy(st),
                          torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(gm["sem_acc"].item(), float(rm["sem_acc"]),
                               rtol=1e-5)
    mu, lv = sl[..., :8], sl[..., 8:16]
    np.testing.assert_allclose(
        kl_divergence(torch.from_numpy(mu), torch.from_numpy(lv)).item(),
        float(jloss.kl_divergence(jnp.asarray(mu), jnp.asarray(lv))),
        rtol=1e-5)
    # KL annealing: half the weight at half the anneal steps
    cfg = VAELossConfig(struct_weight=0.0, semantic_weight=0.0,
                        kl_weight=1.0, kl_anneal_steps=10)
    jcfg = jloss.VAELossConfig(struct_weight=0.0, semantic_weight=0.0,
                               kl_weight=1.0, kl_anneal_steps=10)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


CLI = ["vae.f_maps=8", "vae.c_dim=8", "vae.sem_embed_dim=4",
       "vae.neck_dims=(8,8,8)", "vae.neck_ijk_min=(-4,-4,-4)",
       "vae.capacities=(1024,512,256)",
       "vae.finest_voxel_size=(0.8,0.8,0.8)", "vae.origin=(0.4,0.4,0.4)",
       "vae.dense_lookup_ijk_min=(-18,-18,-10)",
       "vae.dense_lookup_dims=(36,36,20)", "points_per_sample=300"]


def test_build_vae_batches_equal_the_jax_cli(tmp_path):
    """The synthetic stream of ``build_vae`` is the JAX CLI's, point for
    point: the same grids and labels in the first two training batches."""
    from infinicube_tpu import train as jtrain
    from infinicube_tpu.config import ConfigArgumentParser as JParser
    from infinicube_tpu_torch import train as ttrain
    from infinicube_tpu_torch.config import ConfigArgumentParser
    argv = ["configs/train_vae.yaml", "--exec", "batch_size=2", *CLI]
    _, _, jbatches = jtrain.build_vae(JParser().parse_config(argv))
    params, loss_fn, tbatches = ttrain.build_vae(
        ConfigArgumentParser().parse_config(argv), torch.device("cpu"))
    assert all(p.requires_grad for p in params.values())
    for _ in range(2):
        (jgrids, jsem), (tgrids, tsem) = next(jbatches), next(tbatches)
        assert tgrids[0].ijk.shape == (2, 1024, 3)
        for tg, jg in zip(tgrids, jgrids):
            np.testing.assert_array_equal(
                tg.keys.numpy(), np.asarray(jg.keys).astype(np.int64))
        np.testing.assert_array_equal(tsem.numpy(), np.asarray(jsem))
    loss, metrics = loss_fn(params, torch.Generator().manual_seed(0),
                            (tgrids, tsem))
    assert torch.isfinite(loss)
    assert [int(metrics[f"voxels{l}"]) for l in range(3)] == [
        int(g.mask.sum()) // 2 for g in tgrids]


def test_train_cli_trains_the_vae(tmp_path, capsys):
    import json
    from infinicube_tpu_torch.train import main
    from infinicube_tpu_torch.training.checkpoint import CheckpointManager
    state = main(["configs/train_vae.yaml", "--name", "v", "--logdir",
                  str(tmp_path), "--exec", "max_steps=3", "log_every=1",
                  f"ckpt_dir={tmp_path}/ck", *CLI], device="cpu")
    assert capsys.readouterr().out.strip().endswith(
        "[train] finished at step 3 (0 NaN-skipped steps)")
    recs = [json.loads(l) for l in (tmp_path / "v.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["voxels0"] > r["voxels2"] > 0
               for r in recs)
    assert state.ema.step == 3
    assert CheckpointManager(tmp_path / "ck").latest_step() == 3
    # a data.root that names no existing path: the synthetic stream again
    state = main(["configs/train_vae.yaml", "--name", "m", "--logdir",
                  str(tmp_path), "--exec", "max_steps=1",
                  f"data.root={tmp_path / 'no_such_root'}",
                  f"ckpt_dir={tmp_path}/ck_missing", *CLI], device="cpu")
    assert state.step == 1 and state.num_nan_skips == 0


def test_evaluate_reconstruction_matches_jax(tmp_path):
    from infinicube_tpu.inference import voxel_vae as jeval
    from infinicube_tpu_torch.inference import voxel_vae as teval
    from tests.test_torch_sparse_vae import STRUCT_SCALE
    jvae, params, port = _models(seed=4)
    # scaled struct heads, so that no occupancy decision rests on a logit
    # margin near 0
    params = {"params": {
        k: jax.tree.map(lambda a: a * STRUCT_SCALE, v)
        if k.startswith("struct") else v
        for k, v in params["params"].items()}}
    port.load_state_dict(sparse_vae_from_jax(jax.tree.map(np.asarray,
                                                          params)))
    pts, labels = _scene(8)
    ref = jeval.evaluate_reconstruction(jvae, params, jnp.asarray(pts),
                                        jnp.asarray(labels),
                                        jax.random.PRNGKey(0))
    got = teval.evaluate_reconstruction(port, torch.from_numpy(pts),
                                        torch.from_numpy(labels))
    np.testing.assert_array_equal(
        got["pred_grid"].keys.numpy(),
        np.asarray(ref["pred_grid"].keys).astype(np.int64))
    assert got["grid_iou"] == pytest.approx(ref["grid_iou"], abs=1e-9)
    assert got["semantic_acc"] == pytest.approx(ref["semantic_acc"],
                                                abs=1e-6)
    assert int(got["pred_grid"].mask.sum()) > 0
    np.testing.assert_array_equal(got["gt_sem"].numpy(),
                                  np.asarray(ref["gt_sem"]))
    # the CLI on the same scene, from a trainer's checkpoint
    from infinicube_tpu_torch.training.checkpoint import CheckpointManager
    np.savez(tmp_path / "scene.npz", xyz=pts[0], semantic=labels[0])
    full = SparseStructureVAE(SparseVAEConfig(
        f_maps=8, capacities=(1024, 512, 256)), device="cpu")
    full.init_params(torch.Generator().manual_seed(0))
    state = TrainState.create(TrainConfig(), dict(full.named_parameters()))
    CheckpointManager(tmp_path / "ck").save(1, state, force=True)
    import unittest.mock as mock
    with mock.patch.object(teval, "SparseVAEConfig", lambda: full.cfg):
        scores = teval.main(["--points", str(tmp_path / "scene.npz"),
                             "--checkpoint", str(tmp_path / "ck"),
                             "--output", str(tmp_path / "out")], device="cpu")
    assert set(scores) == {"grid_iou", "semantic_acc"}
    # the hand-off file is the JAX package's format
    from infinicube_tpu.utils.fileio import load_grid_semantic
    ijk, sem, vs, _ = load_grid_semantic(tmp_path / "out" / "pred.npz")
    assert ijk.shape[1] == 3 and len(sem) == len(ijk)
    np.testing.assert_allclose(vs, 0.2, rtol=1e-6)
