"""Port parity for the GSM trainer (``infinicube_tpu_torch.train`` model
``gsm``) against the JAX package, on tests/test_gsm.py's ``tiny_cfg`` and
``make_batch`` with the JAX parameters carried across: the loss of
``gsm_loss`` (tests/test_gsm.py's terms) and every parameter's gradient
against ``jax.grad``, at 2e-3 of each tensor's largest reference value; one
AdamW step from a JAX train state loaded by ``gsm_train_state_from_jax``;
``build_gsm``'s first batch against the JAX CLI's; one step of
``train.main`` on the CPU. The attention, the sparse convs and the XUnet's
convolutions take their plain versions here (CPU tensors).

The gradients are taken on tests/test_torch_gsm.py's ``prior_batch``
(make_batch with a depth prior on part of the frame), and again with the
voxel branch off: in the joint model the pixel branch's gaussians (the
midground's) reach no rendered pixel of this scene, so only the 2-D model
carries a gradient through the pixel branch and its attention. The JAX
side takes the batch as an argument of its jitted function, not as a
constant of it: folded at compile time, the visibility splat decides a near
tie otherwise (voxel 93 of make_batch's scene) and one visible voxel more
changes 14 gaussians."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from infinicube_tpu import train as jtrain
from infinicube_tpu.models.gsm.loss import GSMLossConfig as JLossConfig
from infinicube_tpu.models.gsm.loss import gsm_loss as jgsm_loss
from infinicube_tpu.models.gsm.model import GSM as JGSM
from infinicube_tpu.training import state as jstate
from infinicube_tpu_torch import train as ttrain
from infinicube_tpu_torch.config import Config
from infinicube_tpu_torch.models.gsm import model as tm
from infinicube_tpu_torch.models.gsm.loss import GSMLossConfig, gsm_loss
from infinicube_tpu_torch.training.state import (TrainConfig, TrainState,
                                                 make_train_step)
from infinicube_tpu_torch.weights.from_jax import (gsm_from_jax,
                                                   gsm_train_state_from_jax)
from tests.test_gsm import HW, tiny_cfg
from tests.test_torch_gsm import (one_torch_thread,  # noqa: F401
                                  port_batch, port_tiny_cfg, prior_batch,
                                  random_params)

V = 2


def _sky():
    sky = np.zeros((V,) + HW, bool)
    sky[:, :8] = True
    return sky


@functools.lru_cache(maxsize=None)
def _grads(kind: str):
    """The JAX loss and gradient (tests/test_gsm.py's loss) and the port's,
    on the same parameters and batch; ``kind`` "joint" (both branches) or
    "pixel" (the voxel branch off)."""
    b = prior_batch()
    kw = {} if kind == "joint" else dict(use_voxel_branch=False)
    jm = JGSM(tiny_cfg(**kw))
    params = random_params(jm, b, seed=4)
    ones = jnp.ones((V,) + HW, bool)

    def loss_fn(p, batch):
        o = jm.apply(p, batch)
        loss, _ = jgsm_loss(JLossConfig(), o["render"], batch["images"],
                            ones, jnp.asarray(_sky()),
                            gaussians=o["gaussians"])
        return loss

    ref_loss, ref = jax.jit(jax.value_and_grad(loss_fn))(params, b)
    model = tm.GSM(port_tiny_cfg(**kw))
    model.load_state_dict(gsm_from_jax(params))
    out = model(port_batch(b))
    loss, _ = gsm_loss(GSMLossConfig(), out["render"],
                       torch.from_numpy(np.asarray(b["images"])),
                       torch.ones((V,) + HW, dtype=torch.bool),
                       torch.from_numpy(_sky()), gaussians=out["gaussians"])
    loss.backward()
    return dict(params=params, ref_loss=float(ref_loss),
                ref=gsm_from_jax(jax.tree.map(np.asarray, ref)),
                jref=ref, loss=loss.item(),
                got={k: torch.zeros_like(p) if p.grad is None else p.grad
                     for k, p in model.named_parameters()})


@pytest.mark.parametrize("kind", ["joint", "pixel"])
def test_loss_and_every_gradient_match_jax(kind):
    """Each gradient within 2e-3 of its largest reference value, with a
    floor of 1e-3 of the largest gradient of all for the tensors whose
    gradient is zero or rounding noise: in the joint model the sky's
    (it reaches the loss only through 1 - alpha where the gaussians are all
    but opaque) and the pixel branch's, in the 2-D model the unused
    encoder's, and in both the biases that a GroupNorm follows. The
    gradient reaches the voxel branch in one, the pixel branch's attention
    and the sky in the other."""
    grads = _grads(kind)
    np.testing.assert_allclose(grads["loss"], grads["ref_loss"], rtol=2e-3)
    ref, got = grads["ref"], grads["got"]
    assert set(ref) == set(got)
    floor = 1e-3 * max(np.abs(r.numpy()).max() for r in ref.values())
    noise_only = set()
    for name, r in ref.items():
        r = r.numpy()
        scale = np.abs(r).max()
        if scale <= floor:
            noise_only.add(name)
        np.testing.assert_allclose(got[name].numpy(), r, rtol=0,
                                   atol=2e-3 * max(scale, floor),
                                   err_msg=name)
    carried = set(ref) - noise_only
    if kind == "joint":
        assert {"encoder", "voxel_branch"} <= {n.split(".")[0]
                                               for n in carried}
    else:
        assert "pixel_branch.unet.mid_attn.qkv.weight" in carried
        assert "sky.sky_query" in carried


def test_one_adamw_step_from_the_jax_state():
    """The JAX state after one step (the reference gradient fed to both
    sides as the gradient of a linear loss) loads into the port's state;
    one more step on each side gives the same parameters and Adam moments
    within 1e-5 of each tensor's largest value (optax takes Adam's bias
    corrections in f32, 1 - 0.999 off by 1.3e-5 of itself; torch in
    double). Gradient values below 1e-15 are fed as 0: their squares times
    1 - 0.999 are subnormal, which XLA on the CPU flushes to zero and
    PyTorch keeps."""
    grads = _grads("joint")
    kw = dict(learning_rate=1e-3, weight_decay=0.01, grad_clip_value=0.5,
              use_ema=False)
    jg = jax.tree.map(lambda a: jnp.where(jnp.abs(a) < 1e-15, 0.0, a),
                      grads["jref"])
    jcfg = jstate.TrainConfig(**kw)
    jstep = jax.jit(jstate.make_train_step(jcfg, lambda p, rng, batch: (
        sum(jnp.sum(a * g) for a, g in zip(jax.tree.leaves(p),
                                           jax.tree.leaves(jg))), {})))
    js = jstate.TrainState.create(jcfg, grads["params"])
    js, _ = jstep(js, jax.random.PRNGKey(0), None)
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    sd = gsm_train_state_from_jax(
        *(jax.tree.map(np.asarray, t) for t in (js.params, adam.mu, adam.nu)),
        count=int(adam.count), step=int(js.step), num_nan_skips=0)
    model = tm.GSM(port_tiny_cfg())
    tcfg = TrainConfig(**kw)
    ts = TrainState.create(tcfg, dict(model.named_parameters()))
    ts.load_state_dict(sd)
    g = gsm_from_jax(jax.tree.map(np.asarray, jg))
    tstep = make_train_step(tcfg, lambda p, gen, batch: (
        sum(torch.sum(p[k] * g[k]) for k in p), {}))
    ts, _ = tstep(ts, None, None)
    js, _ = jstep(js, jax.random.PRNGKey(1), None)
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    ref = gsm_train_state_from_jax(
        *(jax.tree.map(np.asarray, t) for t in (js.params, adam.mu, adam.nu)),
        count=int(adam.count), step=int(js.step), num_nan_skips=0)
    assert ts.step == int(js.step) == 2 and ts.opt_count == 2
    mu, nu = ts.moments()
    for name, p in ts.params.items():
        for got, want in ((p.detach(), ref["params"][name]),
                          (mu[name], ref["mu"][name]),
                          (nu[name], ref["nu"][name])):
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=1e-5,
                atol=1e-5 * want.abs().max().item(), err_msg=name)


def _jax_first_batch(monkeypatch):
    """The JAX CLI's first training batch, without its parameter init."""
    monkeypatch.setattr(JGSM, "init", lambda self, *a, **kw: {})
    _, _, batches = jtrain.build_gsm(jtrain.Config({}))
    return next(batches)


def test_build_gsm_first_batch_matches_jax(monkeypatch):
    want = _jax_first_batch(monkeypatch)
    params, _, batches = ttrain.build_gsm(Config({}), torch.device("cpu"))
    got = next(batches)
    for k in ("images", "masks", "Ks", "cam_to_worlds", "depth_prior"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got["grid"].keys.numpy(),
                                  np.asarray(want["grid"].keys))
    np.testing.assert_array_equal(got["grid"].mask.numpy(),
                                  np.asarray(want["grid"].mask))
    # the release configuration, every parameter trained
    assert sum(p.numel() for p in params.values()) == 18_880_213


def test_lpips_checkpoints_stay_out_of_the_parameters(tmp_path):
    """``lpips_checkpoint``: "random" and an ``.npz`` of the lpips library's
    state dict each give a frozen LPIPS (the file's weights, or the same
    random ones from seed 7 every time); ``build_gsm`` keeps it beside the
    model, out of the trained parameters."""
    from infinicube_tpu_torch.models.gsm.lpips import load_lpips
    from tests.torch_mirrors.lpips_torch import LPIPSTorch
    sd = {k: v.numpy() for k, v in LPIPSTorch().state_dict().items()}
    np.savez(tmp_path / "lpips.npz", **sd)
    loaded = load_lpips(str(tmp_path / "lpips.npz"))
    np.testing.assert_array_equal(loaded.net.conv0.weight.numpy(),
                                  sd["net.slice1.0.weight"])
    np.testing.assert_array_equal(loaded.lin4.numpy(),
                                  sd["lin4.model.1.weight"].reshape(-1))
    a, b = load_lpips("random"), load_lpips("random")
    torch.testing.assert_close(a.net.conv28.weight, b.net.conv28.weight,
                               rtol=0, atol=0)
    for lp in (loaded, a):
        assert not any(p.requires_grad for p in lp.parameters())
    params, _, _ = ttrain.build_gsm(Config({"lpips_checkpoint": "random"}),
                                    torch.device("cpu"))
    assert sum(p.numel() for p in params.values()) == 18_880_213


def test_train_main_takes_one_gsm_step_on_the_cpu(tmp_path, capsys):
    import json
    state = ttrain.main(
        ["configs/train_gsm.yaml", "--name", "gsm", "--logdir",
         str(tmp_path), "--exec", "max_steps=1", "log_every=1",
         "ckpt_every=1000", f"ckpt_dir={tmp_path}/ck"], device="cpu")
    assert state.step == 1 and state.num_nan_skips == 0
    line = json.loads((tmp_path / "gsm.jsonl").read_text().splitlines()[0])
    assert np.isfinite(line["loss"]) and line["grad_finite"] == 1.0
    assert "perceptual" in line and "psnr" in line
    assert capsys.readouterr().out.strip().endswith(
        "[train] finished at step 1 (0 NaN-skipped steps)")
