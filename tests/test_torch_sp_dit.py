"""Port parity: the Wan DiT with ``sp_axis`` over 2 gloo ranks
(``WanDiT(..., sp_group=...)``: ring self-attention, each rank's half of
the tokens) against the JAX SP DiT on a 2-device mesh, the tiny config of
``tests/test_sp_dit.py``, weights across by ``weights/from_jax.py``. The
output within atol 2e-3 / rtol 2e-3 (f32 on both sides, as
``tests/test_torch_wan_dit.py``'s tiny DiT); the gradients with respect to
the latents, and the parameter gradients summed over the ranks, against
the port's local path within 1e-5 of each tensor's scale (the same
arithmetic, summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh

from infinicube_tpu.models.wan.dit import WanDiT as JaxDiT
from infinicube_tpu.models.wan.dit import WanDiTConfig as JaxCfg
from infinicube_tpu_torch.models.wan.dit import WanDiT, WanDiTConfig
from infinicube_tpu_torch.weights.from_jax import dit_from_jax
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.test_torch_wan_dit import _jax_params
from tests.torch_dist import run_ranks, sp_dit_rank

# tests/test_sp_dit.py's tiny DiT
CFG = dict(dim=64, ffn_dim=128, num_layers=2, num_heads=4, in_channels=4,
           out_channels=4, text_dim=32, freq_dim=16, buffer_channels=8)
TOL = dict(atol=2e-3, rtol=2e-3)


def _inputs():
    rng = np.random.default_rng(5)
    lat = rng.normal(size=(1, 4, 8, 16, 4)).astype(np.float32)  # 128 tokens
    buf = rng.normal(size=(1, 4, 8, 16, 8)).astype(np.float32)
    txt = rng.normal(size=(1, 8, 32)).astype(np.float32)
    t = np.array([10.0], np.float32)
    return lat, t, txt, buf


def test_sp_dit_matches_jax_and_the_local_path(tmp_path):
    inputs = _inputs()
    jcfg = JaxCfg(**CFG, dtype=jnp.float32, sp_axis="seq")
    params = _jax_params(JaxCfg(**CFG, dtype=jnp.float32), inputs)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "seq"))
    ref = np.asarray(jax.jit(lambda p, *a: JaxDiT(jcfg, sp_mesh=mesh).apply(
        p, *a))(params, *inputs))
    state = dit_from_jax(params)
    cot = np.random.default_rng(6).normal(size=ref.shape).astype(np.float32)
    # 3 tokens: the 2 ranks do not divide them
    odd = (np.zeros((1, 1, 2, 6, 4), np.float32), inputs[1], inputs[2],
           np.zeros((1, 1, 2, 6, 8), np.float32))
    res = run_ranks(sp_dit_rank, 2, tmp_path, CFG, state, inputs, cot, odd)
    local = WanDiT(WanDiTConfig(**CFG, dtype=torch.float32), device="cpu")
    local.load_state_dict(state)
    lat = torch.from_numpy(inputs[0]).requires_grad_()
    out = local(lat, *(torch.from_numpy(a) for a in inputs[1:]))
    (out * torch.from_numpy(cot)).sum().backward()
    for r, (got, dlat, grads, err) in enumerate(res):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
        # both ranks return the whole velocity, the local path's
        torch.testing.assert_close(got, out.detach(), atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(dlat, lat.grad, atol=1e-5, rtol=1e-5)
        for k, p in local.named_parameters():
            scale = p.grad.abs().max().item()
            torch.testing.assert_close(grads[k], p.grad, rtol=0,
                                       atol=1e-5 * scale)
        assert err is not None and "N = 3" in err and "P = 2" in err
    assert torch.equal(res[0][0], res[1][0])

