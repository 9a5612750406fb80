"""Port parity for the GSM in ``gsm_bf16_config`` (the voxel, pixel and sky
branches computing in bf16, the parameters and norms in f32) against the
JAX package's ``gsm_bf16_config``, on tests/test_gsm.py's ``tiny_cfg`` with
the JAX parameters carried across by ``gsm_from_jax`` (which serves the
bf16 model unchanged: the parameters stay f32): the gaussians, the renders,
the sky token, ``gsm_loss`` and every parameter's gradient of the whole
model, then the voxel branch, the pixel branch (its attention's gradient
included) and the sky modulator each on its own.

The tolerance is the size of bf16 itself. On the CPU the JAX side runs its
gather route for the sparse convs (``conv_backend="auto"``), which rounds to
bf16 after every tap, and its einsum attention with an f32 softmax; the
port rounds once after f32 sums, as the TPU kernels do, and XLA and
PyTorch round bf16 elementwise work at other places. So the two bf16
models differ by rounding that compounds through the network, the same
order as bf16 moves the model from f32. Each output and gradient is held to
within twice that movement, measured here on the same inputs as the
distance between the port's f32 model (held to the JAX f32 model at 2e-3
by tests/test_torch_gsm.py and tests/test_torch_gsm_train.py) and the JAX
bf16 model, with a floor of 1e-3 of the quantity's scale. A gradient runs
back through the forward's rounding and the two sides' differences add:
each is held in norm to four times bf16's own movement (measured: up to
2.6 times). The voxel branch, the pixel
branch and the sky alone are in tests/test_torch_gsm_bf16_parts.py.

The JAX side's one jitted value_and_grad takes most of this file's time
(about 30 s to trace and compile on one core); the parameters are drawn
over the port's tree (``gsm_to_jax``) so that the JAX model is not traced
twice."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.gsm.loss import GSMLossConfig as JLossConfig
from infinicube_tpu.models.gsm.loss import gsm_loss as jgsm_loss
from infinicube_tpu.models.gsm.model import GSM as JGSM
from infinicube_tpu.models.gsm.model import gsm_bf16_config as j_bf16_config
from infinicube_tpu_torch.models.gsm import model as tm
from infinicube_tpu_torch.models.gsm.loss import GSMLossConfig, gsm_loss
from infinicube_tpu_torch.weights.from_jax import gsm_from_jax, gsm_to_jax
from tests.test_gsm import HW, tiny_cfg
from tests.test_torch_gsm import (one_torch_thread,  # noqa: F401
                                  port_batch, port_tiny_cfg, prior_batch)

V = 2
BF16 = torch.bfloat16
FIELDS = ("means", "scales", "quats", "opacities", "colors")


def _f(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(a, np.float32)


def hold_bf16(got, ref, f32, label, where=None):
    """max|got - ref| <= 2 max|f32 - ref| + 1e-3 max|ref| over ``where``:
    the port's bf16 result (got) no further from the JAX bf16 one (ref)
    than twice the distance of the port's f32 result from it."""
    got, ref, f32 = _f(got), _f(ref), _f(f32)
    if where is not None:
        got, ref, f32 = got[where], ref[where], f32[where]
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    bf16_move = np.abs(f32 - ref).max()
    assert err <= 2 * bf16_move + 1e-3 * scale, \
        f"{label}: {err:.3e} against bf16's own {bf16_move:.3e} " \
        f"(scale {scale:.3e})"
    return err, bf16_move


def hold_grads(got: dict, ref: dict, f32: dict) -> set:
    """Every gradient: those above the floor (1e-3 of the largest of all)
    within four times bf16's own movement in norm (+ 1e-3 of the
    reference's norm), the rest within the floor. Returns the names of the
    gradients above the floor."""
    assert set(ref) == set(got)
    floor = 1e-3 * max(np.abs(_f(g)).max() for g in ref.values())
    carried = set()
    for name, r in ref.items():
        r, g, h = _f(r), _f(got[name]), _f(f32[name])
        assert got[name].dtype == torch.float32, name
        if np.abs(r).max() <= floor:
            assert np.abs(g - r).max() <= floor, name
            continue
        carried.add(name)
        err, move = np.linalg.norm(g - r), np.linalg.norm(h - r)
        assert err <= 4 * move + 1e-3 * np.linalg.norm(r), \
            f"{name}: {err:.3e} against bf16's own {move:.3e}"
    return carried


def random_tree(model: torch.nn.Module, seed: int) -> dict:
    """Numpy parameters in the JAX layout over the port model's tree (as
    tests/test_torch_gsm.py's ``random_params`` draws them: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), the rest N(0, 0.1^2))."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = str(path[-1].key)
        if name == "kernel":
            return (rng.normal(size=a.shape) /
                    np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, gsm_to_jax(model))


def _sky():
    sky = np.zeros((V,) + HW, bool)
    sky[:, :8] = True
    return sky


@functools.lru_cache(maxsize=None)
def _whole():
    """The JAX bf16 model's outputs, loss and gradient (one jitted
    value_and_grad, the batch an argument), and the port's in bf16 and in
    f32 on the same parameters."""
    b = prior_batch()
    jm = JGSM(j_bf16_config(tiny_cfg()))
    params = random_tree(tm.GSM(port_tiny_cfg()), seed=4)
    ones = jnp.ones((V,) + HW, bool)

    def loss_fn(p, batch):
        o = jm.apply(p, batch)
        loss, _ = jgsm_loss(JLossConfig(), o["render"], batch["images"],
                            ones, jnp.asarray(_sky()),
                            gaussians=o["gaussians"])
        return loss, o

    (ref_loss, ref_out), ref = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, b)
    runs = {}
    for name, cfg in (("bf16", tm.gsm_bf16_config(port_tiny_cfg())),
                      ("f32", port_tiny_cfg())):
        model = tm.GSM(cfg)
        model.load_state_dict(gsm_from_jax(params))
        out = model(port_batch(b))
        loss, _ = gsm_loss(GSMLossConfig(), out["render"],
                           torch.from_numpy(np.array(b["images"])),
                           torch.ones((V,) + HW, dtype=torch.bool),
                           torch.from_numpy(_sky()),
                           gaussians=out["gaussians"])
        loss.backward()
        runs[name] = dict(out=out, loss=loss.item(), grads={
            k: torch.zeros_like(p) if p.grad is None else p.grad
            for k, p in model.named_parameters()})
    return dict(ref_out=ref_out, ref_loss=float(ref_loss),
                ref=gsm_from_jax(jax.tree.map(np.asarray, ref)), **runs)


def test_bf16_config_matches_the_reference():
    """Every field of ``gsm_bf16_config()`` the reference's (bf16 in the
    three branches, nothing else changed), and of it applied to a given
    configuration."""
    cfg = tm.gsm_bf16_config()
    assert (cfg.voxel.dtype, cfg.pixel.dtype, cfg.sky.dtype) == (BF16,) * 3
    assert dataclasses.replace(cfg, voxel=tm.GSMConfig().voxel,
                               pixel=tm.GSMConfig().pixel,
                               sky=tm.GSMConfig().sky) == tm.GSMConfig()
    jc = dataclasses.asdict(j_bf16_config())
    tc = dataclasses.asdict(cfg)
    for part in ("voxel", "pixel", "sky"):
        jc[part]["dtype"] = np.dtype(jc[part]["dtype"]).name
        tc[part]["dtype"] = str(tc[part]["dtype"]).removeprefix("torch.")
    jc["voxel"].pop("conv_backend")
    assert jc == tc
    small = tm.gsm_bf16_config(port_tiny_cfg())
    assert small.voxel.f_maps == 16 and small.voxel.dtype == BF16


def test_gsm_from_jax_serves_the_bf16_model():
    """The parameters stay f32: the bf16 model takes the same state dict,
    strictly, with the same names and shapes as the f32 one."""
    f32, bf16 = tm.GSM(port_tiny_cfg()), tm.GSM(
        tm.gsm_bf16_config(port_tiny_cfg()))
    sd = {k: v.shape for k, v in f32.state_dict().items()}
    assert {k: v.shape for k, v in bf16.state_dict().items()} == sd
    assert all(p.dtype == torch.float32 for p in bf16.parameters())


def test_gaussians_renders_and_token_match_jax():
    r = _whole()
    want, got, f32 = (r["ref_out"], r["bf16"]["out"], r["f32"]["out"])
    valid = np.asarray(want["gaussians"]["valid"])
    np.testing.assert_array_equal(got["gaussians"]["valid"].numpy(), valid)
    for k in FIELDS:
        assert got["gaussians"][k].dtype == torch.float32, k
        hold_bf16(got["gaussians"][k], want["gaussians"][k],
                  f32["gaussians"][k], k, valid)
    hold_bf16(got["sky_token"], want["sky_token"], f32["sky_token"],
              "sky token")
    for k in ("rgb", "alpha", "depth"):
        assert got["render"][k].dtype == torch.float32
        hold_bf16(got["render"][k], want["render"][k], f32["render"][k], k)


def test_loss_and_every_gradient_match_jax():
    """The loss, and every parameter's gradient (``hold_grads``). The
    gradient reaches the encoder and the voxel branch (on this scene the
    pixel branch's gaussians reach no rendered pixel: its gradient is held
    in tests/test_torch_gsm_bf16_parts.py)."""
    r = _whole()
    assert abs(r["bf16"]["loss"] - r["ref_loss"]) <= \
        2 * abs(r["f32"]["loss"] - r["ref_loss"]) + 1e-4 * abs(r["ref_loss"])
    carried = hold_grads(r["bf16"]["grads"], r["ref"], r["f32"]["grads"])
    assert {"encoder", "voxel_branch"} <= {n.split(".")[0] for n in carried}
