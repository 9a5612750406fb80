"""The port's trainer (``infinicube_tpu_torch.config``, ``training/`` and
``train.py``): the counterparts of ``tests/test_training.py``, the train
step held against the JAX ``make_train_step`` on the same toy parameters
and batches, and resume continuing bit for bit. Everything on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from infinicube_tpu.training import state as jstate
from infinicube_tpu_torch.config import (Config, ConfigArgumentParser,
                                         load_config, parse_literal)
from infinicube_tpu_torch.training.checkpoint import (CheckpointManager,
                                                      partial_restore)
from infinicube_tpu_torch.training.logging import JsonlLogger, make_logger
from infinicube_tpu_torch.training.loop import (LoopConfig, LossMeter,
                                                move_batch, train)
from infinicube_tpu_torch.training.state import (TrainConfig, TrainState,
                                                 learning_rate_at,
                                                 make_train_step)
from infinicube_tpu_torch.weights.from_jax import \
    diffusion_train_state_from_jax

TINY = ["diffusion.cube_dims=(8,8,8)", "diffusion.cube_ijk_min=(-4,-4,-4)",
        "diffusion.latent_voxel_size=(1.0,1.0,1.0)",
        "diffusion.latent_origin=(0.5,0.5,0.5)",
        "diffusion.latent_channels=2", "diffusion.model_channels=8",
        "diffusion.channel_mult=(1,2)", "diffusion.attention_ds=()",
        "diffusion.num_res_blocks=1", "diffusion.num_heads=2",
        "diffusion.transformer_depth=1", "diffusion.num_map_types=2",
        "diffusion.dtype=float32"]


def _leaf(values):
    return torch.tensor(values, dtype=torch.float32, requires_grad=True)


def test_config_includes_interpolation_overrides(tmp_path):
    (tmp_path / "base.yaml").write_text(
        "a: 1\nnested:\n  b: 2\n  c: hello\n")
    (tmp_path / "main.yaml").write_text(
        "include_configs:\n  - base.yaml\nnested:\n  b: 3\n"
        "d: ${nested.c}_world\ne: ${a}\n")
    cfg = load_config(tmp_path / "main.yaml", overrides=["nested.c=bye",
                                                         "f.g=[1,2]"])
    assert cfg.a == 1 and cfg.nested.b == 3
    assert cfg.d == "hello_world"      # interpolation before overrides
    assert cfg.e == 1                  # whole-value interpolation keeps type
    assert cfg.nested.c == "bye"
    assert cfg.f.g == [1, 2]


def test_config_parser_flags_and_literals(tmp_path):
    (tmp_path / "c.yaml").write_text("x:\n  y: 1\nname: base\n")
    p = ConfigArgumentParser()
    p.add_argument("--name", type=str, default="run")
    cfg = p.parse_config([str(tmp_path / "c.yaml"), "--x.y", "5",
                          "--z=true", "--exec", "q.r=(1,2)", "s=none"])
    assert cfg.x.y == 5 and cfg.z is True and cfg.q.r == (1, 2)
    assert cfg.s is None and cfg.name == "run"
    assert parse_literal("1e-3") == 1e-3 and parse_literal("abc") == "abc"
    assert p.parse_config(["none"]).get_path("x.y", 7) == 7
    assert Config.wrap({"a": {"b": 1}}).to_dict() == {"a": {"b": 1}}


def test_port_config_matches_the_jax_copy():
    from infinicube_tpu import config as jconfig
    ours = load_config("configs/train_diffusion.yaml", ["batch_size=1"])
    theirs = jconfig.load_config("configs/train_diffusion.yaml",
                                 ["batch_size=1"])
    assert ours.to_dict() == theirs.to_dict()
    assert ours.diffusion.num_train_timesteps == 1000


def test_train_step_nan_guard_and_ema():
    cfg = TrainConfig(learning_rate=0.1, use_ema=True, grad_clip_value=1.0)
    params = {"w": _leaf([1.0, 2.0])}

    def loss_fn(p, gen, batch):
        return torch.sum(p["w"] * batch), {}

    step = make_train_step(cfg, loss_fn)
    state = TrainState.create(cfg, params)
    state, m = step(state, None, torch.tensor([1.0, 1.0]))
    assert float(m["grad_finite"]) == 1.0
    w_after = state.params["w"].detach().clone()
    assert (w_after < torch.tensor([1.0, 2.0])).all()
    ema_after = state.ema.params["w"].clone()
    # NaN batch: update skipped, counters incremented, EMA shadow kept
    state2, m2 = step(state, None, torch.tensor([float("nan"), 1.0]))
    assert float(m2["grad_finite"]) == 0.0
    assert torch.equal(state2.params["w"].detach(), w_after)
    assert state2.num_nan_skips == 1 and state2.step == 2
    assert state2.opt_count == 1
    assert torch.equal(state2.ema.params["w"], ema_after)
    assert state2.ema.step == 2


def _toy_loss_jax(p, rng, batch):
    pred = batch @ (p["enc"]["w"] + p["dec"]["w"])
    loss = jnp.mean((pred - 1.0) ** 2)
    return loss, {"mse": loss}


def _toy_loss_torch(p, gen, batch):
    pred = batch @ (p["enc.w"] + p["dec.w"])
    loss = torch.mean((pred - 1.0) ** 2)
    return loss, {"mse": loss}


def _adam_state(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam


@pytest.mark.parametrize("subs", [None, ("dec",)])
def test_train_step_matches_jax(subs):
    """Five steps, the third on a NaN batch: parameters, Adam moments, EMA
    shadow and step, ``step`` and ``num_nan_skips`` equal the JAX step's to
    1e-5 of each tensor's largest value (optax takes Adam's bias corrections
    1 - b^t in f32, where 1 - 0.999 is off by 1.3e-5 of itself; torch takes
    them in double). Clipping acts (0.05), the rate decays every 2 applied
    updates, weight decay is on."""
    kw = dict(learning_rate=0.05, lr_decay_mult=0.5, lr_decay_step=2,
              lr_clip=1e-3, weight_decay=0.1, grad_clip_value=0.05,
              ema_decay=0.9, use_ema=True, trainable_substrings=subs)
    rng = np.random.default_rng(0)
    w0 = {"enc": rng.standard_normal(3).astype(np.float32),
          "dec": rng.standard_normal(3).astype(np.float32)}
    batches = [rng.standard_normal((8, 3)).astype(np.float32)
               for _ in range(5)]
    batches[2][0, 0] = np.nan
    jcfg = jstate.TrainConfig(**kw)
    js = jstate.TrainState.create(
        jcfg, {k: {"w": jnp.asarray(v)} for k, v in w0.items()})
    jstep = jax.jit(jstate.make_train_step(jcfg, _toy_loss_jax))
    tcfg = TrainConfig(**kw)
    ts = TrainState.create(tcfg, {f"{k}.w": _leaf(v.tolist())
                                  for k, v in w0.items()})
    tstep = make_train_step(tcfg, _toy_loss_torch)
    for i, b in enumerate(batches):
        js, jm = jstep(js, jax.random.PRNGKey(i), jnp.asarray(b))
        ts, tm = tstep(ts, None, torch.from_numpy(b))
        assert float(tm["grad_finite"]) == float(jm["grad_finite"])
        if i != 2:
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=1e-5)
    assert ts.step == int(js.step) == 5
    assert ts.num_nan_skips == int(js.num_nan_skips) == 1
    assert ts.ema.step == int(js.ema.step) == 5
    mu, nu = ts.moments()
    if subs is None:
        adam = _adam_state(js.opt_state)
        assert ts.opt_count == int(adam.count) == 4

    def close(got, ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())

    for k in ("enc", "dec"):
        close(ts.params[f"{k}.w"], js.params[k]["w"])
        close(ts.ema.params[f"{k}.w"], js.ema.params[k]["w"])
        if subs is None:
            close(mu[f"{k}.w"], adam.mu[k]["w"])
            close(nu[f"{k}.w"], adam.nu[k]["w"])
    if subs is not None:                        # the frozen half stayed
        np.testing.assert_array_equal(ts.params["enc.w"].detach().numpy(),
                                      w0["enc"])
        assert set(mu) == {"dec.w"}
    assert learning_rate_at(tcfg, 4) == pytest.approx(0.05 * 0.25)
    assert learning_rate_at(tcfg, 100) == 1e-3


def test_adam_update_from_injected_gradients_matches_optax():
    """One AdamW update from the same given gradient (no loss in between):
    where a gradient is tiny, step 1 of Adam is g / (|g| + eps)."""
    g = np.array([1e-9, -3e-7, 0.2, -4.0], np.float32)
    w = np.array([0.5, -0.5, 1.0, 2.0], np.float32)
    kw = dict(learning_rate=0.01, weight_decay=0.05, grad_clip_value=0.5,
              use_ema=False)
    tx = jstate.make_optimizer(jstate.TrainConfig(**kw))
    upd, _ = tx.update({"w": jnp.asarray(g)}, tx.init({"w": jnp.asarray(w)}),
                       {"w": jnp.asarray(w)})
    ref = np.asarray(optax.apply_updates({"w": jnp.asarray(w)}, upd)["w"])
    cfg = TrainConfig(**kw)
    state = TrainState.create(cfg, {"w": _leaf(w.tolist())})
    step = make_train_step(cfg, lambda p, gen, b: (
        torch.sum(p["w"] * torch.from_numpy(g)), {}))
    state, _ = step(state, None, None)
    np.testing.assert_allclose(state.params["w"].detach().numpy(), ref,
                               rtol=1e-5, atol=1e-8)


def test_checkpoint_roundtrip_and_partial_restore(tmp_path):
    cfg = TrainConfig()
    params = {"a": _leaf([0.0, 1.0, 2.0, 3.0]),
              "b.c": torch.ones((2, 2), requires_grad=True)}
    gen = torch.Generator().manual_seed(3)
    state = TrainState.create(cfg, params, gen)
    step = make_train_step(cfg, lambda p, g, b: (
        (p["a"].sum() + p["b.c"].sum()) * torch.rand((), generator=g), {}))
    state, _ = step(state, gen, None)
    mgr = CheckpointManager(tmp_path / "ck", save_interval_steps=1)
    assert mgr.save(3, state, force=True)
    assert not mgr.save(3, state, force=True)          # already there
    mgr.wait()
    assert mgr.latest_step() == 3
    want = {k: v.detach().clone() for k, v in state.params.items()}
    next_draw = torch.rand((), generator=gen)
    blank = TrainState.create(cfg, {k: torch.zeros_like(v).requires_grad_()
                                    for k, v in params.items()},
                              torch.Generator().manual_seed(0))
    restored = mgr.restore(blank)
    assert restored is blank and restored.step == 1
    for k in want:
        assert torch.equal(restored.params[k].detach(), want[k])
        assert torch.equal(restored.ema.params[k], state.ema.params[k])
        assert torch.equal(restored.moments()[0][k], state.moments()[0][k])
    assert torch.rand((), generator=blank.generator) == next_draw
    raw = mgr.restore()
    assert raw["step"] == 1 and set(raw["params"]) == set(params)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore()
    # keep-last-k
    for s in (4, 5, 6):
        mgr.save(s, state)
    assert mgr.all_steps() == [5, 6]
    # partial restore skips shape mismatches and missing keys
    merged = partial_restore(
        {"a": torch.zeros(4), "b": {"c": torch.zeros((3, 3))},
         "d": torch.zeros(1)},
        {"a": torch.ones(4), "b": {"c": torch.ones((2, 2))}})
    assert torch.equal(merged["a"], torch.ones(4))
    assert merged["b"]["c"].shape == (3, 3) and merged["d"].shape == (1,)


def _regression(seed=0):
    target = torch.tensor([1.0, -2.0, 0.5])

    def loss_fn(p, gen, batch):
        loss = torch.mean((batch @ p["w"] - batch @ target) ** 2)
        return loss, {"mse": loss}

    rng = np.random.default_rng(seed)

    def batches():
        while True:
            yield torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))

    return target, loss_fn, batches


def test_training_loop_reduces_loss(tmp_path):
    target, loss_fn, batches = _regression()
    logs = []
    state = train(LoopConfig(max_steps=200, log_every=100, ckpt_every=1000,
                             ckpt_dir=str(tmp_path / "ck"), resume=False),
                  TrainConfig(learning_rate=0.05, use_ema=False),
                  {"w": _leaf([0.0, 0.0, 0.0])}, loss_fn, batches(),
                  logger=lambda s, m: logs.append((s, m)), device="cpu")
    assert state.step == 200
    assert logs[-1][1]["loss"] < logs[0][1]["loss"]
    assert logs[-1][1]["steps_per_sec"] > 0
    np.testing.assert_allclose(state.params["w"].detach().numpy(),
                               target.numpy(), atol=0.2)
    assert CheckpointManager(tmp_path / "ck").latest_step() == 200


def test_loss_meter_nan_assert():
    m = LossMeter()
    m.update({"a": 1.0})
    m.update({"a": torch.tensor(3.0)})
    assert m.means()["a"] == 2.0
    with pytest.raises(AssertionError):
        m.update({"a": float("nan")})
    m.reset()
    assert m.means() == {}


def test_loggers(tmp_path):
    import json
    log = make_logger("jsonl", str(tmp_path), "r")
    assert isinstance(log, JsonlLogger)
    log(3, {"loss": torch.tensor(0.5)})
    rec = json.loads((tmp_path / "r.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss"] == 0.5
    assert make_logger("none", str(tmp_path))(1, {"a": 1}) is None


def test_train_cli_smoke(tmp_path, capsys):
    from infinicube_tpu_torch.train import main
    state = main(["none", "--name", "smoke", "--logdir", str(tmp_path),
                  "--exec", "max_steps=2", "log_every=1", "ckpt_every=1000",
                  f"ckpt_dir={tmp_path}/ck", *TINY], device="cpu")
    assert (tmp_path / "smoke.jsonl").exists()
    assert capsys.readouterr().out.strip().endswith(
        "[train] finished at step 2 (0 NaN-skipped steps)")
    assert state.ema is not None and state.ema.step == 2
    assert CheckpointManager(tmp_path / "ck").latest_step() == 2


def test_train_cli_reads_the_release_yaml(tmp_path):
    """The real config file with the tiny overrides on top; batch_size and
    the schedule length come from the YAML tree."""
    from infinicube_tpu_torch.train import main
    state = main(["configs/train_diffusion.yaml", "--name", "y", "--logdir",
                  str(tmp_path), "--exec", "max_steps=1", "batch_size=1",
                  f"ckpt_dir={tmp_path}/ck", *TINY], device="cpu")
    assert state.step == 1 and state.num_nan_skips == 0


# tests/test_torch_vae_train.py's CLI: 0.8 m voxels keep the +-5 m points
# of the synthetic stream inside the neck
SMALL_VAE = ["vae.f_maps=8", "vae.c_dim=8", "vae.sem_embed_dim=4",
             "vae.neck_dims=(8,8,8)", "vae.neck_ijk_min=(-4,-4,-4)",
             "vae.capacities=(1024,512,256)",
             "vae.finest_voxel_size=(0.8,0.8,0.8)", "vae.origin=(0.4,0.4,0.4)",
             "vae.dense_lookup_ijk_min=(-18,-18,-10)",
             "vae.dense_lookup_dims=(36,36,20)", "points_per_sample=300"]


@pytest.mark.parametrize("overrides", [
    ["model=vae", "data.root={missing}", *SMALL_VAE],
    ["model=gsm", "data.root={missing}"], ["data.root={missing}"]])
def test_train_cli_names_what_is_not_ported(tmp_path, overrides):
    """A ``data.root`` that names no existing path trains on the synthetic
    stream, as the JAX CLI does (its ``_real_dataset`` returns None), for
    each builder."""
    from infinicube_tpu_torch import train as train_cli
    argv = ["none", "--exec", *TINY, *(
        o.format(missing=tmp_path / "no_such_root") for o in overrides)]
    cfg = ConfigArgumentParser().parse_config(argv)
    kind = cfg.get_path("model", "diffusion")
    params, loss_fn, batches = train_cli.BUILDERS[kind](
        cfg, torch.device("cpu"))
    batch = next(iter(batches))
    if kind == "diffusion":
        latents, cond = batch
        assert latents.shape == (2, 8, 8, 8, 2)
        assert not cond.map_cube.any() and not cond.box_cube.any()
    elif kind == "vae":
        grids, _ = batch
        assert grids[0].capacity == 1024 and grids[0].batch_size == 1
    else:
        assert batch["images"].shape == (2, 64, 96, 3)
    if kind != "gsm":
        state = train_cli.main(["--logdir", str(tmp_path), *argv,
                                "max_steps=1", f"ckpt_dir={tmp_path}/ck"],
                               device="cpu")
        assert state.step == 1 and state.num_nan_skips == 0


def test_default_val_fn_and_topk_monitor(tmp_path):
    """val_data without val_fn triggers the default EMA validation; its
    metrics drive top-k-on-metric checkpoint retention (ckpt_monitor)."""
    target, loss_fn, batches = _regression()

    def val_data():
        vr = np.random.default_rng(1)
        for _ in range(2):
            yield torch.from_numpy(vr.normal(size=(8, 3)).astype(np.float32))

    logs = []
    state = train(
        LoopConfig(max_steps=60, log_every=20, val_every=20, val_batches=2,
                   ckpt_every=20, ckpt_dir=str(tmp_path / "ck"),
                   ckpt_keep=1, ckpt_monitor="val_loss", resume=False),
        TrainConfig(learning_rate=0.05, use_ema=True),
        {"w": _leaf([0.0, 0.0, 0.0])}, loss_fn, batches(),
        logger=lambda s, m: logs.append((s, m)), val_data=val_data,
        device="cpu")
    assert state.step == 60
    val_logs = [(s, m) for s, m in logs if "val/val_loss" in m]
    assert len(val_logs) >= 2            # default val_fn ran on schedule
    assert "val/mse" in val_logs[0][1]   # loss_fn metrics forwarded
    # val loss improves (EMA lags but must still trend down)
    assert val_logs[-1][1]["val/val_loss"] < val_logs[0][1]["val/val_loss"]
    # top-k retention kept the best checkpoint: the last (lowest val loss)
    mgr = CheckpointManager(str(tmp_path / "ck"), 1, 20, monitor="val_loss")
    assert mgr.all_steps() == [60]


def test_trainable_substrings_freeze():
    params = {"enc.w": torch.ones(3, requires_grad=True),
              "dec.w": torch.ones(3, requires_grad=True)}

    def loss_fn(p, gen, batch):
        return torch.mean((batch @ (p["enc.w"] + p["dec.w"])) ** 2), {}

    tc = TrainConfig(learning_rate=0.1, use_ema=False,
                     trainable_substrings=("dec",))
    state = TrainState.create(tc, params)
    state, _ = make_train_step(tc, loss_fn)(state, None, torch.ones((4, 3)))
    assert torch.equal(state.params["enc.w"].detach(), torch.ones(3))
    assert (state.params["dec.w"].detach() - 1).abs().max() > 1e-4


def test_resume_continues_bit_for_bit(tmp_path):
    """Save at step 3, restore, run to step 6: parameters, moments and EMA
    equal an uninterrupted run exactly (the loss draws from the loop's
    generator, whose state travels with the checkpoint)."""
    rng = np.random.default_rng(0)
    data = [torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
            for _ in range(6)]

    def loss_fn(p, gen, batch):
        noise = torch.randn(batch.shape, generator=gen)
        return torch.mean(((batch + 0.1 * noise) @ p["w"] - 1.0) ** 2), {}

    def run(ckpt, max_steps, batches, resume):
        return train(LoopConfig(max_steps=max_steps, log_every=1000,
                                ckpt_every=1000, ckpt_dir=str(ckpt),
                                resume=resume),
                     TrainConfig(learning_rate=0.05, weight_decay=0.01),
                     {"w": _leaf([0.3, -0.2, 0.1])}, loss_fn, batches,
                     torch.Generator().manual_seed(7),
                     logger=lambda s, m: None, device="cpu")

    whole = run(tmp_path / "a", 6, data, False)
    run(tmp_path / "b", 3, data[:3], False)
    resumed = run(tmp_path / "b", 6, data[3:], True)
    assert resumed.step == whole.step == 6
    assert resumed.num_nan_skips == whole.num_nan_skips == 0
    assert torch.equal(resumed.params["w"], whole.params["w"])
    assert torch.equal(resumed.ema.params["w"], whole.ema.params["w"])
    assert resumed.ema.step == whole.ema.step
    for a, b in zip(resumed.moments(), whole.moments()):
        assert torch.equal(a["w"], b["w"])


def test_move_batch_and_device_checks():
    from infinicube_tpu_torch.models.diffusion.model import (CondCubes,
                                                             DiffusionConfig)
    cond = CondCubes.null(1, DiffusionConfig(cube_dims=(2, 2, 2)))
    lat, c = move_batch((torch.zeros(1), cond), torch.device("cpu"))
    assert isinstance(c, CondCubes) and c.map_cube.shape == (1, 2, 2, 2, 3)
    assert move_batch([torch.ones(1), 3], torch.device("cpu"))[1] == 3


def test_train_state_from_jax():
    """A JAX TrainState of the diffusion model as numpy trees becomes the
    port's state: parameters, moments and EMA re-laid out like the
    parameters."""
    import flax
    from infinicube_tpu.models.diffusion import model as jmodel
    from infinicube_tpu_torch.models.diffusion.model import (DiffusionConfig,
                                                             VoxelDiffusion)
    from tests.test_torch_sparse_vae import random_params
    small = dict(cube_dims=(4, 4, 4), model_channels=32, channel_mult=(1,),
                 attention_ds=(), num_heads=2, transformer_depth=2)
    jd = jmodel.VoxelDiffusion(jmodel.DiffusionConfig(**small,
                                                      dtype=jnp.float32))
    shapes = flax.linen.meta.unbox(jax.eval_shape(jd.init,
                                                  jax.random.PRNGKey(0)))
    trees = [random_params(shapes, s) for s in range(4)]
    trees[2] = jax.tree.map(np.abs, trees[2])           # nu >= 0
    sd = diffusion_train_state_from_jax(*trees[:3], count=4, step=5,
                                        num_nan_skips=1,
                                        ema_params=trees[3], ema_step=5)
    td = VoxelDiffusion(DiffusionConfig(**small, dtype=torch.float32),
                        device="cpu", trainable=True)
    ts = TrainState.create(TrainConfig(), td.named_parameters())
    ts.load_state_dict(sd)
    assert ts.step == 5 and ts.opt_count == 4 and ts.ema.step == 5
    name = "middle_transformer.blocks.1.self_q.weight"
    jq = trees[1]["params"]["middle_transformer"]["blocks"]
    (body,) = jq.values()
    np.testing.assert_array_equal(ts.moments()[0][name].numpy(),
                                  body["self_q"]["kernel"][1].T)
    np.testing.assert_array_equal(
        ts.ema.params["in_conv.weight"].numpy(),
        trees[3]["params"]["in_conv"]["kernel"].transpose(4, 3, 0, 1, 2))
    assert float(ts.opt.state[ts.params[name]]["step"]) == 4.0
    with pytest.raises(ValueError):
        diffusion_train_state_from_jax(*trees[:3], count=5, step=5,
                                       num_nan_skips=1)
