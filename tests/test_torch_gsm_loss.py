"""Port parity for the GSM's training loss (``gsm_loss``, ``perceptual_proxy``,
the LPIPS crop) against ``infinicube_tpu/models/gsm/loss.py``: the total, every
metric and the gradient with respect to the render (rgb, alpha, depth), with
the gradient proxy and with LPIPS at the centre crop, with the depth term
and the gaussian statistics. Inputs from numpy with a seed, LPIPS weights
from the library mirror carried across by ``lpips_from_jax``. f32 on both
sides, atol/rtol 2e-3. The random crop offsets come from a
``torch.Generator`` in the port and from ``jax.random`` in the reference:
the same seed draws other offsets, so the parity runs take the centre."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.gsm import loss as jloss
from infinicube_tpu.models.gsm.lpips import convert_lpips
from infinicube_tpu_torch.models.gsm import loss as tloss
from infinicube_tpu_torch.models.gsm.lpips import LPIPS
from infinicube_tpu_torch.weights.from_jax import lpips_from_jax
from tests.torch_mirrors.lpips_torch import LPIPSTorch
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-3, rtol=2e-3)
V, H, W = 2, 40, 56


@pytest.fixture(scope="module")
def lpips_pair():
    torch.manual_seed(1)
    m = LPIPSTorch().eval()
    with torch.no_grad():
        for p in m.parameters():
            p.mul_(0.2)
    params = convert_lpips(m.state_dict())
    port = LPIPS()
    port.load_state_dict(lpips_from_jax(jax.tree.map(np.asarray, params)))
    return params, port


def _inputs(seed=0, M=300):
    rng = np.random.default_rng(seed)
    f = np.float32
    render = {"rgb": rng.uniform(size=(V, H, W, 3)).astype(f),
              "alpha": rng.uniform(size=(V, H, W)).astype(f),
              "depth": rng.uniform(1, 20, (V, H, W)).astype(f)}
    gt = rng.uniform(size=(V, H, W, 3)).astype(f)
    mask = rng.uniform(size=(V, H, W)) > 0.2
    sky = rng.uniform(size=(V, H, W)) > 0.7
    depth = np.where(rng.uniform(size=(V, H, W)) > 0.3,
                     rng.uniform(1, 20, (V, H, W)), 0).astype(f)
    gaussians = {"scales": rng.uniform(0.01, 0.5, (M, 3)).astype(f),
                 "opacities": rng.uniform(size=M).astype(f),
                 "valid": rng.uniform(size=M) > 0.4}
    return render, gt, mask, sky, depth, gaussians


def _both(cfg, lpips_pair=None, seed=0):
    render, gt, mask, sky, depth, gaussians = _inputs(seed)
    jparams = None if lpips_pair is None else lpips_pair[0]
    jcfg = jloss.GSMLossConfig(**dataclasses.asdict(cfg))

    def jf(r):
        return jloss.gsm_loss(jcfg, r, jnp.asarray(gt), jnp.asarray(mask),
                              jnp.asarray(sky), jnp.asarray(depth),
                              jax.tree.map(jnp.asarray, gaussians),
                              lpips_params=jparams)

    (jtotal, jm), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jax.tree.map(jnp.asarray, render))
    tr = {k: torch.from_numpy(v).requires_grad_() for k, v in render.items()}
    total, m = tloss.gsm_loss(
        cfg, tr, torch.from_numpy(gt), torch.from_numpy(mask),
        torch.from_numpy(sky), torch.from_numpy(depth),
        {k: torch.from_numpy(v) for k, v in gaussians.items()},
        lpips=None if lpips_pair is None else lpips_pair[1])
    total.backward()
    return (total, m, {k: t.grad for k, t in tr.items()}), (jtotal, jm, jg)


def _hold(got, want):
    (total, m, grads), (jtotal, jm, jg) = got, want
    np.testing.assert_allclose(total.item(), float(jtotal), **TOL)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), **TOL,
                                   err_msg=k)
    for k in ("rgb", "alpha", "depth"):
        ref = np.asarray(jg[k])
        assert np.abs(ref).max() > 0, k
        np.testing.assert_allclose(grads[k].numpy(), ref, rtol=2e-3,
                                   atol=2e-3 * np.abs(ref).max(), err_msg=k)


def test_loss_with_the_proxy_matches_jax():
    got, want = _both(tloss.GSMLossConfig())
    assert "perceptual" in got[1] and "depth_l1" in got[1]
    _hold(got, want)


def test_loss_with_lpips_at_the_centre_crop_matches_jax(lpips_pair):
    """lpips_crop 32 on 40 x 56 views: the centre crop on both sides."""
    cfg = tloss.GSMLossConfig(lpips_crop=32)
    got, want = _both(cfg, lpips_pair, seed=1)
    _hold(got, want)
    render, gt, mask, sky, _, _ = _inputs(1)
    _, full = tloss.gsm_loss(
        tloss.GSMLossConfig(lpips_crop=None),
        {k: torch.from_numpy(v) for k, v in render.items()},
        torch.from_numpy(gt), torch.from_numpy(mask), torch.from_numpy(sky),
        lpips=lpips_pair[1])
    assert abs(float(full["perceptual"]) -
               float(got[1]["perceptual"].detach())) > 1e-6


def test_perceptual_proxy_matches_jax():
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(size=(V, 33, 47, 3)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        tloss.perceptual_proxy(torch.from_numpy(a), torch.from_numpy(b)),
        float(jloss.perceptual_proxy(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5)


def test_lpips_crop_offsets():
    """The centre without a generator; with one, offsets inside the image
    that the same seed repeats; full images when the crop is no smaller."""
    img = torch.arange(V * H * W * 3, dtype=torch.float32).reshape(V, H, W, 3)
    a, b = tloss.lpips_crop(img, img + 1, 32)
    assert a.shape == (V, 32, 32, 3)
    torch.testing.assert_close(a, img[:, 4:36, 12:44])
    torch.testing.assert_close(b, a + 1)
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        draws.append(tloss.lpips_crop(img, img, 16, g)[0])
    torch.testing.assert_close(draws[0], draws[1])
    corners = draws[0][:, 0, 0, 0] / 3
    ys, xs = (corners % (H * W)) // W, corners % W
    assert ((ys >= 0) & (ys <= H - 16) & (xs >= 0) & (xs <= W - 16)).all()
    assert tloss.lpips_crop(img, img, 64)[0] is img
    assert tloss.lpips_crop(img, img, None)[0] is img
