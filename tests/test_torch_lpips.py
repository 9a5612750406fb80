"""Port parity for LPIPS (``infinicube_tpu_torch.models.gsm.lpips``): the
port's VGG16 taps and distances against ``infinicube_tpu/models/gsm/lpips.py``
on the same weights carried across by ``lpips_from_jax``, its gradient with
respect to the images against ``jax.grad``, and ``convert_lpips`` on a
random lpips-library state dict (``tests/torch_mirrors/lpips_torch.py``)
against the JAX package's converter and the library mirror itself. f32 on
both sides, small images, weights scaled by 0.2 so the activations stay
bounded through the 13 convs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.gsm import lpips as jl
from infinicube_tpu_torch.models.gsm import lpips as tl
from infinicube_tpu_torch.weights.from_jax import lpips_from_jax
from tests.torch_mirrors.lpips_torch import LPIPSTorch
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def mirror():
    torch.manual_seed(0)
    m = LPIPSTorch().eval()
    with torch.no_grad():
        for p in m.parameters():
            p.mul_(0.2)
    return m


def _images(seed, shape=(2, 32, 48, 3)):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, shape).astype(np.float32)
                 for _ in range(2))


def test_lpips_from_jax_matches_the_jax_module(mirror):
    """The port on ``lpips_from_jax`` of the JAX params: the five taps and
    the distances, and zero for identical images."""
    params = jl.convert_lpips(mirror.state_dict())
    x, y = _images(1)
    port = tl.LPIPS()
    port.load_state_dict(lpips_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        taps = port.net(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = np.asarray(jl.LPIPS().apply(params, jnp.asarray(x),
                                      jnp.asarray(y)))
    np.testing.assert_allclose(got, ref, **TOL)
    ref_taps = jl.VGG16Features().apply({"params": params["params"]["net"]},
                                        jnp.asarray(x))
    for a, b in zip(taps, ref_taps):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(b), **TOL)
    with torch.no_grad():
        z = port(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(z, 0.0, atol=1e-6)


def test_image_gradient_matches_jax(mirror):
    """The weights are frozen; the gradient reaches the images and is the
    reference's."""
    params = jl.convert_lpips(mirror.state_dict())
    x, y = _images(2, (1, 24, 32, 3))
    port = tl.LPIPS()
    port.load_state_dict(lpips_from_jax(jax.tree.map(np.asarray, params)))
    assert not any(p.requires_grad for p in port.parameters())
    tx = torch.from_numpy(x).requires_grad_()
    port(tx, torch.from_numpy(y)).sum().backward()
    ref = np.asarray(jax.grad(lambda a: jl.LPIPS().apply(
        params, a, jnp.asarray(y)).sum())(jnp.asarray(x)))
    np.testing.assert_allclose(tx.grad.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_convert_lpips_matches_the_library_layout(mirror):
    """``convert_lpips`` of the library's state dict names every parameter
    of the port's module, equals ``lpips_from_jax`` of the JAX converter's
    output, and the port then computes what the library mirror does."""
    sd = mirror.state_dict()
    port = tl.LPIPS()
    converted = tl.convert_lpips(sd)
    assert set(converted) == set(port.state_dict())
    via_jax = lpips_from_jax(jax.tree.map(np.asarray, jl.convert_lpips(sd)))
    for k, v in converted.items():
        torch.testing.assert_close(v, via_jax[k], rtol=0, atol=0)
    port.load_state_dict(converted)
    x, y = _images(3)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        ref = mirror(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(y).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    # numpy arrays convert as tensors do
    from_np = tl.convert_lpips({k: v.numpy() for k, v in sd.items()})
    for k, v in converted.items():
        torch.testing.assert_close(from_np[k], v, rtol=0, atol=0)


def test_random_init_and_dtype():
    """The "random" weights come from the generator (the same seed gives the
    same weights), the heads start at one, and the distance is computed in
    the parameters' dtype."""
    a, b = tl.LPIPS(), tl.LPIPS()
    a.init_params(torch.Generator().manual_seed(7))
    b.init_params(torch.Generator().manual_seed(7))
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    assert float(a.lin2.min()) == float(a.lin2.max()) == 1.0
    assert float(a.net.conv0.weight.std()) > 0
    half = tl.LPIPS(dtype=torch.bfloat16)
    half.load_state_dict({k: v.to(torch.bfloat16)
                          for k, v in a.state_dict().items()})
    x, y = _images(4, (1, 16, 16, 3))
    with torch.no_grad():
        out = half(torch.from_numpy(x), torch.from_numpy(y))
    assert out.dtype == torch.bfloat16 and out.shape == (1,)
