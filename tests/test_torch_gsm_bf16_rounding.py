"""The bf16 rounding of the GSM's layers in ``gsm_bf16_config``, held where
it shows: each of the port's bf16 layers against the JAX layer of the same
dtype on the same inputs and f32 parameters (numpy, seeded; carried across
by ``gsm_from_jax``), beside the same port layer computed in f32.

tests/test_torch_gsm_bf16.py and tests/test_torch_gsm_bf16_parts.py hold
whole branches within bf16's own scale, and a model that computed in f32
would meet those gates too: on ordinary inputs a bf16 rounding moves a
result by about one ulp, and so does any rounding the two sides make in
different places. Here the inputs make a rounding that both sides make
the same way large: a common offset of 100 (where a bf16 ulp is 0.5) under
weights that cancel it (on a Dense's input, and on a GroupNorm's output,
a conv's operand), and logits of some tens (where a bf16 ulp is 0.125 or
more, which the softmax multiplies). The port's bf16 layer then stays within a quarter of
the f32 layer's distance from the JAX bf16 one, in norm; an f32 layer is
at that distance by definition. Each test prints both distances.
- flax ``Dense(dtype=bf16)`` (operands rounded to bf16) and
  ``Dense(dtype=None)`` (bf16 features into an f32 layer compute in f32);
- flax 0.12's ``MultiHeadDotProductAttention`` in bf16, the sky's encoder:
  q scaled, the logits, their mask and the softmax in bf16;
- the sparse ``SparseResBlock`` in bf16: GroupNorm in f32 with its output
  in bf16, the convs on bf16 operands rounded once (the TPU kernel's
  rounding: ``window_sparse_conv``'s Pallas kernels in interpret mode at
  tests/test_torch_sparse_conv.py's size), the skip ``Dense`` in bf16."""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import torch

from infinicube_tpu.nn.sparse import SparseResBlock as JSparseResBlock
from infinicube_tpu.ops.window_conv import build_window_plan
from infinicube_tpu_torch.nn.layers import (Dense,
                                            MultiHeadDotProductAttention)
from infinicube_tpu_torch.nn.sparse import SparseResBlock, conv_plan
from infinicube_tpu_torch.weights.from_jax import gsm_from_jax
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.test_torch_gsm_bf16 import random_tree
from tests.test_torch_sparse_conv import BOUNDS
from tests.test_torch_sparse_conv import _scene as sparse_scene

BF16 = torch.bfloat16
# the port's bf16 distance from JAX's, as a share of the f32 layer's
SHARE = 0.25


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def hold_rounding(got, ref, f32, label, where=None) -> float:
    """||got - ref|| <= SHARE * ||f32 - ref|| over ``where``: the port's
    bf16 result (got) near the JAX bf16 one (ref), the f32 layer's result
    not. Returns the ratio of the two distances."""
    got, ref, f32 = _np(got), _np(ref), _np(f32)
    if where is not None:
        got, ref, f32 = got[where], ref[where], f32[where]
    err = float(np.linalg.norm(got - ref))
    move = float(np.linalg.norm(f32 - ref))
    print(f"{label}: bf16 {err:.4e}, f32 {move:.4e} "
          f"(ratio {err / move:.4f}, limit {SHARE})")
    assert err <= SHARE * move, f"{label}: {err:.3e} against f32's {move:.3e}"
    return err / move


def _port(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    module.load_state_dict(gsm_from_jax(tree))
    return module


def _offset_rows(rng, shape) -> np.ndarray:
    """Rows of 100 + N(0, 1): in bf16 the noise is kept to steps of 0.5."""
    return (100.0 + rng.normal(size=shape)).astype(np.float32)


def _cancel_offset(kernel: np.ndarray) -> np.ndarray:
    """A kernel [..., in, out] whose columns sum to zero over ``in`` (the
    JAX layout's second-to-last axis), so that an offset common to the
    inputs cancels and their rounding is what is left."""
    k = kernel - kernel.mean(axis=-2, keepdims=True)
    return k.astype(np.float32)


def test_dense_rounds_its_operands_as_flax():
    """``Dense(dtype=bf16)`` on f32 rows 100 + N(0, 1) against flax's: both
    round the rows to bf16 (steps of 0.5) before the product, which the
    zero-sum kernel leaves as most of the result."""
    rng = np.random.default_rng(21)
    x = _offset_rows(rng, (64, 96))
    ports = {name: Dense(96, 80, compute_dtype=d)
             for name, d in (("bf16", BF16), ("f32", torch.float32))}
    tree = random_tree(ports["f32"], seed=22)
    tree["params"]["kernel"] = _cancel_offset(tree["params"]["kernel"])
    ref = fnn.Dense(80, dtype=jnp.bfloat16).apply(tree, jnp.asarray(x))
    with torch.inference_mode():
        got, f32 = (_port(m, tree)(torch.from_numpy(x))
                    for m in ports.values())
    assert ref.dtype == jnp.bfloat16 and got.dtype == BF16
    hold_rounding(got, ref, f32, "Dense(dtype=bf16)")


def test_dense_promotes_bf16_features_as_flax():
    """``Dense(dtype=None)`` on bf16 features with f32 parameters computes
    in f32, as flax's ``promote_dtype`` does: the f32 product of the same
    operands."""
    rng = np.random.default_rng(21)
    t = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32))
    t = t.to(BF16)
    port = Dense(96, 80, compute_dtype=None)
    tree = random_tree(port, seed=22)
    ref = fnn.Dense(80, dtype=None).apply(
        tree, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
    with torch.inference_mode():
        got = _port(port, tree)(t)
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)


def test_sky_attention_rounds_as_flax():
    """The sky's attention (2 heads of 16 on 49 tokens, the last 9 keys
    masked) in bf16 against flax's, its q and k kernels scaled by 6 so
    that the logits reach some tens: rounded to bf16 they move the softmax
    by far more than a bf16 ulp of the output, the same way on both sides.
    The projections' biases are zero here. flax adds a Dense's bias after
    rounding the product to bf16, the port's ``Dense`` inside the product
    (one rounding, as a GEMM's epilogue adds it); that moves q and k by an
    ulp, and the logits by as much as their own rounding."""
    rng = np.random.default_rng(23)
    x = rng.normal(size=(1, 49, 32)).astype(np.float32)
    mask = np.ones((1, 49), bool)
    mask[:, 40:] = False
    ports = {name: torch.nn.ModuleDict({"attn": MultiHeadDotProductAttention(
        32, 2, dtype=d)}) for name, d in (("bf16", BF16),
                                          ("f32", torch.float32))}
    tree = random_tree(ports["f32"], seed=24)
    params = tree["params"]["attn"]
    for name, p in params.items():
        p["bias"] = np.zeros_like(p["bias"])
        if name in ("query", "key"):
            p["kernel"] = 6.0 * p["kernel"]
    jm = fnn.MultiHeadDotProductAttention(num_heads=2, dtype=jnp.bfloat16)
    jx = jnp.asarray(x)
    ref = jm.apply({"params": params}, jx, jx,
                   mask=jnp.asarray(mask)[:, None, None, :])
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.inference_mode():
        got, f32 = (_port(m, tree)["attn"](tx, tm) for m in ports.values())
    assert ref.dtype == jnp.bfloat16 and got.dtype == BF16
    hold_rounding(got, ref, f32, "MultiHeadDotProductAttention(bf16)")


def test_sparse_res_block_rounds_as_the_tpu_kernel():
    """A bf16 ``SparseResBlock`` 16 -> 24 (the skip a bf16 Dense) on bf16
    features, against the JAX block on the window plan, whose Pallas
    kernels add every tap in f32 and round once, as the port's do. Both
    GroupNorms' biases are 100, so that their bf16 outputs, the convs'
    operands, lie in steps of 0.5, and both convs' kernels sum to zero over
    their taps and features. (SiLU at 100 is the identity: elsewhere the
    port's bf16 SiLU rounds once and JAX's twice, after the sigmoid and
    after the product, an ulp apart.) The JAX block runs op by op, so that
    every bf16 rounding its program states is made (under jit XLA may keep
    a value in f32 across a cast to bf16, as it is allowed to)."""
    jg, tg, feats = sparse_scene()
    tf = torch.from_numpy(feats).to(BF16)
    jf = jnp.asarray(tf.float().numpy()).astype(jnp.bfloat16)
    mask = np.asarray(jg.mask)
    ports = {name: SparseResBlock(16, 24, dtype=d)
             for name, d in (("bf16", BF16), ("f32", torch.float32))}
    tree = random_tree(ports["f32"], seed=25)
    params = tree["params"]
    for i, width in enumerate((16, 24)):
        params[f"GroupNormSparse_{i}"]["bias"] = np.full((width,), 100.0,
                                                         np.float32)
        k = params[f"conv{i + 1}"]["kernel"]
        params[f"conv{i + 1}"]["kernel"] = (k - k.mean(axis=(0, 1))).astype(
            np.float32)
    plan = build_window_plan(jg, block_rows=128, window_rows=256,
                             dense_bounds=BOUNDS)
    assert int(np.asarray(plan.num_missed).sum()) == 0
    ref = JSparseResBlock(24, dtype=jnp.bfloat16).apply(tree, jf, plan,
                                                        jg.mask)
    tplan = conv_plan(tg, dense_bounds=BOUNDS)
    with torch.inference_mode():
        got, f32 = (_port(m, tree)(x, tplan, tg.mask) for m, x in
                    zip(ports.values(), (tf, tf.float())))
    assert ref.dtype == jnp.bfloat16 and got.dtype == BF16
    hold_rounding(got, ref, f32, "SparseResBlock(bf16)", mask)
    assert (got[~tg.mask] == 0).all()
