"""The port's kitchen-sink NKSR losses against the JAX package's on an
oriented point cloud made from a seed, with the JAX samplers' draws fed to
the port: the samples, the IMLS distance, each loss and its gradient with
respect to a small field's parameters, within 2e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.grid import build as jbuild
from infinicube_tpu.models.vae import nksr_loss as J
from infinicube_tpu_torch.grid import build as tbuild
from infinicube_tpu_torch.models.vae import nksr_loss as T

TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """A bumpy sphere of radius 1.5 with its normals, a two-level grid of
    it, and a field's parameters: a 3-16-1 tanh MLP plus |p| - 1.5."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(1500, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    xyz = (d * (1.5 + 0.05 * np.sin(4 * d[:, :1]))).astype(np.float32)
    nrm = d.astype(np.float32)
    mask = rng.uniform(size=1500) > 0.05
    params = {"w1": rng.normal(0, 0.5, (3, 16)), "b1": rng.normal(0, 0.1, 16),
              "w2": rng.normal(0, 0.1, 16), "b2": np.array(0.02)}
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    return xyz, nrm, mask, params


def _grids(build, arr, xyz):
    m = arr(np.ones((1, len(xyz)), bool))
    p = arr(xyz[None])
    return [build.grid_from_points(p, m, 0.2, 0.1, capacity=2048),
            build.grid_from_points(p, m, 0.4, 0.2, capacity=512)]


def _jfield(p):
    def f(x):
        h = jnp.tanh(x @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"] + jnp.linalg.norm(x, axis=-1) - 1.5
    return f


def _tfield(p):
    def f(x):
        h = torch.tanh(x @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"] + torch.linalg.vector_norm(
            x, dim=-1) - 1.5
    return f


def _tparams(params):
    return {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}


def _t(a):
    return torch.tensor(np.asarray(a))


def _hier_draws(key, n):
    k_slot, k_off = jax.random.split(key)
    return {"u_slot": _t(jax.random.uniform(k_slot, (n,))),
            "u_off": _t(jax.random.uniform(k_off, (n, 3)))}


def _band_draws(key, n):
    k_slot, k_nrm = jax.random.split(key)
    return {"u_slot": _t(jax.random.uniform(k_slot, (n,))),
            "noise": _t(jax.random.normal(k_nrm, (n, 1)))}


SAMPLERS = (("uniform", 300, 0, 4), ("band", 300, 0, 0))


def _samplers(mod):
    return tuple(mod.SamplerConfig(t, n, expand=e, expand_top=et)
                 for t, n, e, et in SAMPLERS)


def _draws(key):
    return [(_hier_draws if s[0] == "uniform" else _band_draws)(
        jax.random.fold_in(key, i), s[1]) for i, s in enumerate(SAMPLERS)]


def test_samples_and_sdf_match_jax(scene):
    xyz, nrm, mask, _ = scene
    key = jax.random.PRNGKey(3)
    jg, tg = _grids(jbuild, jnp.asarray, xyz), _grids(tbuild, _t, xyz)
    want = J.draw_samples(key, _samplers(J), jg, jnp.asarray(xyz),
                          jnp.asarray(nrm), jnp.asarray(mask), 0.1)
    got = T.draw_samples(_samplers(T), tg, _t(xyz), _t(nrm), _t(mask), 0.1,
                         draws=_draws(key))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    for stdv, k in ((0.2, 8), (0.05, 4)):
        sj = J.sdf_from_points(want, jnp.asarray(xyz), jnp.asarray(nrm),
                               jnp.asarray(mask), k=k, stdv=stdv)
        st = T.sdf_from_points(got, _t(xyz), _t(nrm), _t(mask), k=k,
                               stdv=stdv)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)
    # far from the cloud every weight underflows: uniform weights
    far = np.array([[30.0, 0, 0]], np.float32)
    np.testing.assert_allclose(
        T.sdf_from_points(_t(far), _t(xyz), _t(nrm), k=4).numpy(),
        np.asarray(J.sdf_from_points(jnp.asarray(far), jnp.asarray(xyz),
                                     jnp.asarray(nrm), k=4)), **TOL)
    jgt, tgt = jg[0], tg[0]
    np.testing.assert_allclose(T.grid_iou(tgt, tg[0]).numpy(),
                               np.asarray(J.grid_iou(jgt, jg[0])), rtol=1e-6)


@pytest.mark.parametrize("loss", ["udf", "spatial", "surface", "total"])
def test_losses_and_gradients_match_jax(scene, loss):
    xyz, nrm, mask, params = scene
    cfg_kw = dict(voxel_size=0.1, surface_subsample=500, reg_sdf_weight=0.3)
    jcfg, tcfg = J.NKSRLossConfig(**cfg_kw), T.NKSRLossConfig(**cfg_kw)
    key = jax.random.PRNGKey(5)
    jg, tg = _grids(jbuild, jnp.asarray, xyz), _grids(tbuild, _t, xyz)
    jx, jn, jm = (jnp.asarray(a) for a in (xyz, nrm, mask))
    tx, tn, tm = _t(xyz), _t(nrm), _t(mask)
    q = J.draw_samples(key, _samplers(J), jg, jx, jn, jm, 0.1)

    def jloss(p):
        f = _jfield(p)
        if loss == "udf":
            return J.udf_loss(jcfg, f, q, jx, jn, jm)
        if loss == "spatial":
            mixed, reg = J.spatial_loss(jcfg, f, q, jx, jn, jm)
            return mixed + reg
        if loss == "surface":
            v, n = J.gt_surface_loss(jcfg, f, key, jx, jn, jm)
            return v + 2.0 * n
        return J.kitchen_sink_losses(jcfg, f, key, jg, jx, jn, jm,
                                     _samplers(J))[0]

    tp = _tparams(params)
    f = _tfield(tp)
    tq = _t(q)
    if loss == "udf":
        got = T.udf_loss(tcfg, f, tq, tx, tn, tm)
    elif loss == "spatial":
        mixed, reg = T.spatial_loss(tcfg, f, tq, tx, tn, tm)
        got = mixed + reg
    elif loss == "surface":
        v, n = T.gt_surface_loss(tcfg, f, tx, tn, tm,
                                 u_slot=_t(jax.random.uniform(key, (500,))))
        got = v + 2.0 * n
    else:
        k_samp, k_surf = jax.random.split(key)
        got, metrics = T.kitchen_sink_losses(
            tcfg, f, tg, tx, tn, tm, _samplers(T), draws=_draws(k_samp),
            u_surface=_t(jax.random.uniform(k_surf, (500,))))
        assert set(metrics) == {"udf", "spatial", "msa", "gt-surface-value",
                                "gt-surface-normal", "total"}
    want, grads = jax.value_and_grad(jloss)(params)
    assert np.isfinite(float(want)) and float(want) > 0
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    got.backward()
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(grads[k]),
                                   **TOL, err_msg=k)
        assert np.abs(np.asarray(grads[k])).max() > 0, k


def test_surface_loss_draws_from_a_generator(scene):
    """Without injected draws the samplers take a torch.Generator: one seed,
    one answer."""
    xyz, nrm, mask, params = scene
    cfg = T.NKSRLossConfig(voxel_size=0.1, surface_subsample=200)
    tg = _grids(tbuild, _t, xyz)
    out = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        total, _ = T.kitchen_sink_losses(
            cfg, _tfield(_tparams(params)), tg, _t(xyz), _t(nrm), _t(mask),
            _samplers(T), generator=g)
        out.append(total.item())
    assert out[0] == out[1] and np.isfinite(out[0])
    with torch.no_grad():
        v, n = T.gt_surface_loss(cfg, _tfield(_tparams(params)), _t(xyz),
                                 _t(nrm), generator=torch.Generator())
    assert np.isfinite(v.item()) and 0.0 <= n.item() <= 2.0
