"""Port parity: ``infinicube_tpu_torch.ops.gsplat`` against the JAX
package's rasterizer. First the NaN guards (tests/test_gsplat.py:121: a
needle gaussian and behind-camera gaussians give finite gradients, per view
and over a loop of views), then the projection, and the rasterizer with
its capacity semantics: a tile over ``tile_capacity`` keeps its first
instances after the sort, and gaussians that share a tile and a quantized
depth keep the reference's order (a stable sort in span-major order).
Inputs from numpy with a seed; f32 at atol/rtol 2e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.ops import gsplat as jg
from infinicube_tpu_torch.ops import gsplat as tg
from tests.test_torch_gsm import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-3, rtol=2e-3)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_degenerate_gaussian_grads_finite_over_views():
    """A needle gaussian (scale ratio ~1e4) near the camera plus
    behind-camera gaussians: finite gradients for every parameter, per
    view and summed over a loop of views."""
    h, w = 48, 64
    K = torch.tensor([[55.0, 0, w / 2], [0, 55.0, h / 2], [0, 0, 1]])
    v1 = torch.eye(4)
    v1[2, 3] = 6.0                                   # one camera mid-scene
    views = [torch.eye(4), v1]
    means = torch.tensor([[0.0, 0.0, 3.0], [0.5, -0.2, 5.0],
                          [0.0, 0.0, -2.0], [0.1, 0.1, 6.5]])
    quats = torch.tensor([[0.9, 0.1, -0.3, 0.27]]).repeat(4, 1)
    scales = torch.tensor([[0.3, 0.3, 0.3], [29.0, 0.004, 0.06],
                           [0.4, 0.4, 0.4], [1.0, 0.01, 0.5]])
    op = torch.tensor([0.7, 0.002, 0.5, 0.9])
    col = torch.full((4, 3), 0.5)

    def one_view(vm, *p):
        rgb, a, d = tg.render_gaussians(*p, vm, K, (h, w))
        return rgb.sum() + a.sum() + 0.1 * d.sum()

    for vs in (views, views[:1], views[1:]):
        params = [t.clone().requires_grad_() for t in
                  (means, quats, scales, op, col)]
        loss = sum(one_view(vm, *params) for vm in vs)
        grads = torch.autograd.grad(loss, params)
        for g in grads:
            assert torch.isfinite(g).all(), g
        assert sum(float(g.abs().sum()) for g in grads) > 0


def _scene(n, seed, hw=(48, 64), spread=2.0):
    rng = np.random.default_rng(seed)
    h, w = hw
    means = np.stack([rng.uniform(-spread, spread, n),
                      rng.uniform(-spread * h / w, spread * h / w, n),
                      rng.uniform(2.0, 9.0, n)], -1).astype(np.float32)
    means[:4, 2] = [-1.0, 0.005, 50.0, 3.0]          # behind, near, far
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -0.5, (n, 3))).astype(np.float32)
    scales[4] = [2.0, 0.002, 0.05]                   # a needle
    op = rng.uniform(0.2, 0.95, n).astype(np.float32)
    col = rng.uniform(size=(n, 3)).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [0.1, -0.05, 0.2]
    K = np.array([[50.0, 0, w / 2 + 0.3], [0, 52.0, h / 2 - 0.2],
                  [0, 0, 1]], np.float32)
    return means, quats, scales, op, col, view, K


def test_quat_to_rotmat_matches():
    q = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    np.testing.assert_allclose(tg.quat_to_rotmat(_t(q)).numpy(),
                               np.asarray(jg.quat_to_rotmat(jnp.asarray(q))),
                               atol=1e-6)


def test_projection_matches():
    means, quats, scales, _, _, view, K = _scene(400, 1)
    hw = (48, 64)
    pj = jg.project_gaussians(*(jnp.asarray(a) for a in
                                (means, quats, scales, view, K)), hw)
    pt = tg.project_gaussians(*(_t(a) for a in
                                (means, quats, scales, view, K)), hw)
    valid = np.asarray(pj.valid)
    np.testing.assert_array_equal(pt.valid.numpy(), valid)
    assert 100 < valid.sum() < 400
    for name in ("mean2d", "conic", "depth", "radius"):
        np.testing.assert_allclose(getattr(pt, name).numpy()[valid],
                                   np.asarray(getattr(pj, name))[valid],
                                   **TOL, err_msg=name)


@pytest.mark.parametrize("capacity", [256, 12])
def test_rasterize_matches(capacity):
    """400 gaussians at 48x64 with the release tile and span; at capacity
    12 most tiles are over it and keep their 12 front instances."""
    means, quats, scales, op, col, view, K = _scene(400, 2)
    hw = (48, 64)
    out_j = jg.render_gaussians(*(jnp.asarray(a) for a in
                                  (means, quats, scales, op, col, view, K)),
                                hw, tile_capacity=capacity)
    out_t = tg.render_gaussians(*(_t(a) for a in
                                  (means, quats, scales, op, col, view, K)),
                                hw, tile_capacity=capacity)
    proj = tg.project_gaussians(*(_t(a) for a in
                                  (means, quats, scales, view, K)), hw)
    _, k_ok = tg.tile_instances(proj, hw, tile_capacity=capacity)
    full = k_ok.all(1).sum().item()
    assert full >= (6 if capacity == 12 else 0), full     # of 12 tiles
    for name, a, b in zip(("color", "alpha", "depth"), out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)
    assert float(out_t[1].mean()) > 0.2


def test_ties_in_one_tile_keep_the_reference_order():
    """20 gaussians at exactly the same depth, all in tile (0, 0) and some
    reaching into its neighbours, against a capacity of 8: the kept
    instances and their front-to-back order are decided by the tie order
    alone (the packed keys are equal). The port sorts stably in the
    reference's span-major order; the JAX rasterizer on the CPU keeps
    equal keys in input order, so the two agree."""
    n, hw = 20, (32, 32)
    rng = np.random.default_rng(3)
    z = 4.0
    px = rng.uniform(2, 20, (n, 2)).astype(np.float32)   # pixel centers
    K = np.array([[40.0, 0, 16.0], [0, 40.0, 16.0], [0, 0, 1]], np.float32)
    means = np.concatenate([(px - 16.0) / 40.0 * z, np.full((n, 1), z)],
                           -1).astype(np.float32)
    quats = np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1))
    scales = np.full((n, 3), 0.05, np.float32)
    scales[::3] = 0.15                 # wider ones span several tiles
    op = np.full(n, 0.6, np.float32)
    col = rng.uniform(size=(n, 3)).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    args = (means, quats, scales, op, col, view, K)
    out_j = jg.render_gaussians(*(jnp.asarray(a) for a in args), hw,
                                tile_capacity=8)
    out_t = tg.render_gaussians(*(_t(a) for a in args), hw, tile_capacity=8)
    for name, a, b in zip(("color", "alpha", "depth"), out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   err_msg=name)
    # the order inside tile 0: equal keys, ascending span-major position
    proj = tg.project_gaussians(*(_t(a) for a in (means, quats, scales,
                                                  view, K)), hw)
    gid, ok = tg.tile_instances(proj, hw, tile_capacity=8)
    assert ok[0].all()
    r = proj.radius.clamp_max(31.0)
    tmin = torch.floor((proj.mean2d - r[:, None]) / 16).long()
    pos = ((-tmin[:, 1]) * 4 + (-tmin[:, 0])) * n + torch.arange(n)
    in0 = (tmin <= 0).all(1) & proj.valid
    want = torch.arange(n)[in0][torch.argsort(pos[in0])][:8]
    torch.testing.assert_close(gid[0], want)


def test_empty_scene_renders_background():
    K = torch.tensor([[40.0, 0, 16.0], [0, 40.0, 16.0], [0, 0, 1]])
    color, alpha, depth = tg.render_gaussians(
        torch.tensor([[0.0, 0.0, -1.0]]), torch.tensor([[1.0, 0, 0, 0]]),
        torch.full((1, 3), 0.1), torch.tensor([0.5]),
        torch.tensor([[1.0, 0, 0]]), torch.eye(4), K, (32, 32),
        background=torch.tensor([0.2, 0.4, 0.6]))
    torch.testing.assert_close(color[10, 10], torch.tensor([0.2, 0.4, 0.6]))
    assert alpha.abs().max() == 0 and depth.abs().max() == 0


@pytest.mark.parametrize("remat_views", [False, True])
def test_recomputed_chunks_and_views_are_bit_identical(monkeypatch,
                                                        remat_views):
    """With a gradient to record, ``rasterize`` recomputes each tile chunk
    in the backward (and ``render_views(remat=True)`` each view): the
    renders and every gradient are bit for bit those of a pass that keeps
    everything (the recompute replaced by a plain call). Chunks of 5 tiles,
    so the 12 tiles of a 48 x 64 view make 3 of them, one ragged."""
    from infinicube_tpu_torch.models.gsm import renderer
    means, quats, scales, op, col, view, K = map(torch.from_numpy,
                                                 _scene(300, 11))
    c2w = torch.linalg.inv(view)
    gauss = dict(means=means, quats=quats, scales=scales, opacities=op,
                 colors=col, valid=torch.ones(300, dtype=torch.bool))
    real, real_checkpoint = tg.rasterize, tg.checkpoint
    recomputed = []

    def counted(fn, *a, **kw):
        recomputed.append(fn.__name__)
        return real_checkpoint(fn, *a, **kw)

    def run(recompute: bool):
        monkeypatch.setattr(tg, "rasterize", lambda *a, **kw: real(
            *a, **{**kw, "chunk": 5}))
        monkeypatch.setattr(renderer, "rasterize", tg.rasterize)
        if recompute:
            monkeypatch.setattr(tg, "checkpoint", counted)
            monkeypatch.setattr(renderer, "checkpoint", counted)
        else:
            monkeypatch.setattr(tg, "checkpoint",
                                lambda fn, *a, **kw: fn(*a))
            monkeypatch.setattr(renderer, "checkpoint",
                                lambda fn, *a, **kw: fn(*a))
        leaves = {k: v.clone().requires_grad_() for k, v in gauss.items()
                  if k != "valid"}
        out = renderer.render_views({**leaves, "valid": gauss["valid"]},
                                    torch.stack([K, K]),
                                    torch.stack([c2w, c2w]), (48, 64),
                                    tile_capacity=32,
                                    remat=remat_views and recompute)
        loss = (out["rgb"] * torch.linspace(0, 1, 3)).sum() + \
            out["alpha"].sum() + 0.1 * out["depth"].sum()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        monkeypatch.undo()
        return out, grads

    out_a, grads_a = run(True)
    # 3 chunks a view, twice where the view's recompute runs them again
    assert recomputed.count("one_view") == (2 if remat_views else 0)
    assert recomputed.count("_composite") == (12 if remat_views else 6)
    out_b, grads_b = run(False)
    for k in ("rgb", "alpha", "depth"):
        assert torch.equal(out_a[k], out_b[k]), k
    assert float(out_a["alpha"].mean()) > 0.1
    for ga, gb in zip(grads_a, grads_b):
        assert torch.equal(ga, gb)
        assert float(ga.abs().sum()) > 0
