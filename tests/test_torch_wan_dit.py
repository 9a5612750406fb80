"""Port parity: ``infinicube_tpu_torch.models.wan.dit`` against the JAX
``WanDiT`` on the same weights (carried across by ``weights/from_jax.py``)
and inputs, plus the int8 linear of ``nn/quant.py``."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.wan.dit import WanDiT as JaxDiT
from infinicube_tpu.models.wan.dit import WanDiTConfig as JaxCfg
from infinicube_tpu.models.wan.dit import rope_3d as jax_rope_3d
from infinicube_tpu.models.diffusion.unet3d import \
    timestep_embedding as jax_temb
from infinicube_tpu.nn.quant import int8_matmul as jax_int8_matmul
from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.models.diffusion.unet3d import timestep_embedding
from infinicube_tpu_torch.models.wan.dit import WanDiT, WanDiTConfig, rope_3d
from infinicube_tpu_torch.models.wan.flow_match import FlowMatchSchedule, \
    euler_sample
from infinicube_tpu_torch.nn.quant import int8_matmul
from infinicube_tpu_torch.weights.from_jax import dit_from_jax

# the tiny config of tests/test_wan_torch_parity.py
TINY = dict(dim=64, ffn_dim=128, num_layers=2, num_heads=2, in_channels=4,
            out_channels=4, text_dim=32, freq_dim=32, patch_size=(1, 2, 2),
            buffer_channels=6)
# f32 on both sides, differing only in summation order
TOL = dict(atol=2e-3, rtol=2e-3)


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(1, 2, 4, 6, 4)).astype(np.float32)
    buf = rng.normal(size=(1, 2, 4, 6, 6)).astype(np.float32)
    txt = rng.normal(size=(1, 7, 32)).astype(np.float32)
    t = np.array([700.0], np.float32)
    return lat, t, txt, buf


def _jax_params(cfg, inputs, seed=0):
    """JAX init, with the zero-init head / buffer_embed / modulation filled
    with small random values so that every path shows in the output."""
    p = JaxDiT(cfg).init(jax.random.PRNGKey(seed), *inputs)
    p = jax.tree.map(np.asarray, flax.linen.meta.unbox(p))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        p)


def _run_both(jcfg, tcfg, inputs):
    params = _jax_params(jcfg, inputs)
    ref = np.asarray(JaxDiT(jcfg).apply(params, *inputs), np.float32)
    model = WanDiT(tcfg, device="cpu")
    model.load_state_dict(dit_from_jax(params))
    with torch.no_grad():
        out = model(*map(torch.from_numpy, inputs))
    return out.float().numpy(), ref


@pytest.mark.parametrize("scan_layers", [True, False])
def test_dit_f32_matches_jax(scan_layers):
    inputs = _inputs()
    out, ref = _run_both(
        JaxCfg(**TINY, dtype=jnp.float32, scan_layers=scan_layers),
        WanDiTConfig(**TINY, dtype=torch.float32),
        inputs)
    assert out.shape == ref.shape == (1, 2, 4, 6, 4)
    np.testing.assert_allclose(out, ref, **TOL)


def test_dit_serving_flags_match_jax():
    """attn_quant="qk" + quant_linear: int8 rounding on both sides from the
    same f32 values, gated like every int8 path at cosine >= 0.999."""
    serve = dict(attn_quant="qk", quant_linear=True)
    out, ref = _run_both(JaxCfg(**TINY, **serve, dtype=jnp.float32),
                         WanDiTConfig(**TINY, **serve, dtype=torch.float32),
                         _inputs(2))
    assert _cos(out, ref) >= 0.999
    assert kernels.launches and all(v == 0 for v in kernels.launches.values())


def test_dit_bf16_serving_profile_matches_jax():
    """The full serving profile (bf16 compute, bf16 residual, int8 paths):
    bf16 rounds at other places in the two frameworks, so the int8 gate."""
    serve = dict(attn_quant="qk", quant_linear=True)
    out, ref = _run_both(
        JaxCfg(**TINY, **serve, residual_dtype=jnp.bfloat16),
        WanDiTConfig(**TINY, **serve, residual_dtype=torch.bfloat16),
        _inputs(3))
    assert _cos(out, ref) >= 0.999


def test_fresh_dit_returns_zero():
    """Zero-init head: a freshly initialized DiT outputs exactly 0, as the
    reference's does."""
    m = WanDiT(WanDiTConfig(**TINY, dtype=torch.float32), device="cpu")
    m.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = m(*map(torch.from_numpy, _inputs()))
    assert torch.count_nonzero(out) == 0


def test_rope_and_timestep_tables_match_jax():
    np.testing.assert_allclose(rope_3d((3, 4, 5), 32).numpy(),
                               np.asarray(jax_rope_3d((3, 4, 5), 32)),
                               rtol=1e-6, atol=1e-6)
    t = np.array([0.0, 1.5, 999.0], np.float32)
    np.testing.assert_allclose(timestep_embedding(torch.from_numpy(t),
                                                  33).numpy(),
                               np.asarray(jax_temb(jnp.asarray(t), 33)),
                               atol=1e-4)


def test_int8_matmul_matches_jax():
    """Same int8 operands and exact integer product: equal up to the f32
    rounding of the dequant (scales are applied in the same order)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 37, 48)).astype(np.float32)
    w = rng.normal(size=(48, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    ref = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b)))
    out = int8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                      torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-5)


def test_euler_sampler_matches_schedule():
    """x_T -> x_0 along a constant velocity field lands on x_T - v."""
    s = FlowMatchSchedule(shift=5.0)
    sig = s.sigmas(8)
    assert sig.shape == (9,) and float(sig[0]) == 1.0 and float(sig[-1]) == 0
    x = torch.ones(2, 3)
    out = euler_sample(s, lambda x, t: torch.full_like(x, 0.5), x, 8)
    np.testing.assert_allclose(out.numpy(), 0.5, atol=1e-6)


def test_sp_axis_without_a_group_is_the_local_path():
    """``sp_axis`` set and no group (one rank): the ring is one block and no
    collective, so the output equals the local path's bit for bit and the
    latents' gradient agrees (the ring's hand-written backward against
    autograd through the plain attention). 2 ranks:
    ``tests/test_torch_sp_dit.py``."""
    inputs = _inputs(4)
    params = _jax_params(JaxCfg(**TINY, dtype=jnp.float32), inputs)
    outs, grads = [], []
    for sp in (None, "seq"):
        dit = WanDiT(WanDiTConfig(**TINY, dtype=torch.float32, sp_axis=sp),
                     device="cpu")
        dit.load_state_dict(dit_from_jax(params))
        lat = torch.from_numpy(inputs[0]).requires_grad_()
        out = dit(lat, *map(torch.from_numpy, inputs[1:]))
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append(lat.grad)
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(grads[1], grads[0], atol=1e-5, rtol=1e-5)
