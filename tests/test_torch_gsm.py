"""Port parity: the whole GSM (``infinicube_tpu_torch.models.gsm``) against
the JAX package's on the tiny configuration of tests/test_gsm.py, with the
JAX parameters carried over by ``weights.from_jax.gsm_from_jax``: the voxel
branch's and the pixel branch's gaussians, the sky token, the renders (on
>= 99.9 % of pixels, where splat winners can flip), and the
``decode_all_pixels`` pass; the grid pyramid, ``voxel_preprocess`` and the
dense-bounds derivation. One JAX model, parameters drawn with numpy from a
seed over its parameter shapes (so biases and norm scales are not at their
init values either), two jitted applies. f32 at atol/rtol 2e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinicube_tpu.models.gsm.model import GSM as JGSM
from infinicube_tpu.models.gsm.model import gsm_apply_jit
from infinicube_tpu_torch.grid.build import grid_from_ijk
from infinicube_tpu_torch.models.gsm import model as tm
from infinicube_tpu_torch.models.gsm.encoders import UnifiedEncoderConfig
from infinicube_tpu_torch.models.gsm.pixel_branch import PixelBranchConfig
from infinicube_tpu_torch.models.gsm.sky import SkyConfig
from infinicube_tpu_torch.models.gsm.voxel_branch import VoxelBranchConfig
from infinicube_tpu_torch.weights.from_jax import gsm_from_jax, gsm_to_jax
from tests.test_gsm import make_batch, tiny_cfg

TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch thread for the module: the suite runs files in parallel
    workers, and a thread per core in each of them oversubscribes the
    machine many times over (the tiny models here gain nothing from
    threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_tiny_cfg(**kw) -> tm.GSMConfig:
    """tests/test_gsm.py's tiny_cfg for the port."""
    base = dict(
        encoder=UnifiedEncoderConfig(conv_width=16),
        voxel=VoxelBranchConfig(f_maps=16, levels=2, gaussians_per_voxel=2),
        pixel=PixelBranchConfig(width=8, dims=(1, 2), gs_per_pixel=1),
        sky=SkyConfig(embed_dim=32, num_layers=1, num_heads=2, patch=8),
        dense_dims=(40, 32, 16), dense_ijk_min=(0, -16, -2),
        render_tile_capacity=64)
    base.update(kw)
    return tm.GSMConfig(**base)


def random_params(model, batch, seed=0):
    """Numpy parameters over the JAX model's parameter shapes: kernels
    N(0, 1/fan_in) (fan_in: all axes but the last), norm scales
    1 + N(0, 0.1^2), everything else N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               batch))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_batch(b):
    g = b["grid"]
    out = {k: torch.as_tensor(np.array(v)) for k, v in b.items()
           if k != "grid"}
    out["grid"] = grid_from_ijk(torch.as_tensor(np.array(g.ijk)),
                                torch.as_tensor(np.array(g.mask)),
                                torch.as_tensor(np.array(g.voxel_size)),
                                torch.as_tensor(np.array(g.origin)),
                                g.capacity)
    np.testing.assert_array_equal(out["grid"].keys.numpy(),
                                  np.asarray(g.keys))
    return out


def prior_batch():
    """tests/test_gsm.py's batch with a nonzero depth prior on part of the
    frame (the buffer depth) and the foreground from the grid where there
    is depth: the rest of the non-sky frame is midground, the pixel
    branch's."""
    b = make_batch()
    depth = np.zeros(b["images"].shape[:3] + (1,), np.float32)
    depth[:, 16:, 10:30] = np.random.default_rng(1).uniform(
        2, 12, (2, 16, 20, 1))
    b["depth_prior"] = jnp.asarray(depth)
    b["masks"] = b["masks"].at[..., 3].set(jnp.asarray(depth[..., 0] > 0,
                                                       jnp.float32))
    return b


@pytest.fixture(scope="module")
def run():
    b = prior_batch()
    jm = JGSM(tiny_cfg())
    params = random_params(jm, b)
    want = gsm_apply_jit(jm, params, b)
    want_all = gsm_apply_jit(jm, params, b, True)
    model = tm.GSM(port_tiny_cfg())
    model.load_state_dict(gsm_from_jax(params))
    tb = port_batch(b)
    with torch.inference_mode():
        got = model(tb)
        got_all = model(tb, decode_all_pixels=True)
    n_pix = int(np.prod(b["images"].shape[:3]))   # 1 gaussian a pixel
    return dict(b=b, tb=tb, params=params, want=want, got=got,
                want_all=want_all, got_all=got_all, n_pix=n_pix)


def _hold_gaussians(got, want, sl):
    np.testing.assert_array_equal(got["valid"].numpy()[sl],
                                  np.asarray(want["valid"])[sl])
    v = np.asarray(want["valid"])[sl]
    assert v.sum() > 20
    for k in ("means", "scales", "quats", "opacities", "colors"):
        np.testing.assert_allclose(got[k].numpy()[sl][v],
                                   np.asarray(want[k])[sl][v], **TOL,
                                   err_msg=k)


def test_gsm_from_jax_names_every_parameter(run):
    sd = gsm_from_jax(run["params"])
    model = tm.GSM(port_tiny_cfg())
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    # gsm_to_jax is its inverse and lays the tree out as flax does
    model.load_state_dict(sd)
    back = gsm_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(run["params"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(run["params"])):
        np.testing.assert_array_equal(a, b)


def test_voxel_branch_gaussians_match(run):
    n_vox = run["want"]["gaussians"]["valid"].shape[0] - run["n_pix"]
    _hold_gaussians(run["got"]["gaussians"], run["want"]["gaussians"],
                    slice(0, n_vox))


def test_pixel_branch_gaussians_match(run):
    n_vox = run["want"]["gaussians"]["valid"].shape[0] - run["n_pix"]
    _hold_gaussians(run["got"]["gaussians"], run["want"]["gaussians"],
                    slice(n_vox, None))


def test_sky_token_and_masks_match(run):
    np.testing.assert_allclose(run["got"]["sky_token"].numpy(),
                               np.asarray(run["want"]["sky_token"]), **TOL)
    for k in ("sky_mask", "effective_mask"):
        np.testing.assert_array_equal(run["got"][k].numpy(),
                                      np.asarray(run["want"][k]))


@pytest.mark.parametrize("which", ["static", "decode_all"])
def test_renders_match(run, which):
    got = run["got" if which == "static" else "got_all"]["render"]
    want = run["want" if which == "static" else "want_all"]["render"]
    for k in ("rgb", "alpha", "depth"):
        a, b = got[k].numpy(), np.asarray(want[k])
        close = np.isclose(a, b, **TOL)
        close = close.all(-1) if k == "rgb" else close
        assert close.mean() >= 0.999, (k, close.mean())
    assert float(np.asarray(want["alpha"]).mean()) > 0.2


def test_decode_all_pixels_match(run):
    g, w = run["got_all"]["gaussians"], run["want_all"]["gaussians"]
    n_vox = w["valid"].shape[0] - run["n_pix"]
    assert bool(np.asarray(w["valid"])[n_vox:].all())
    _hold_gaussians(g, w, slice(None))


def test_grid_pyramid_and_voxel_preprocess_match(run):
    jm = JGSM(tiny_cfg())
    model = tm.GSM(port_tiny_cfg())
    for gj, gt in zip(jm.grid_pyramid(run["b"]["grid"]),
                      model.grid_pyramid(run["tb"]["grid"])):
        np.testing.assert_array_equal(gt.keys.numpy(), np.asarray(gj.keys))
        np.testing.assert_allclose(gt.voxel_size.numpy(),
                                   np.asarray(gj.voxel_size))
    for kw in (dict(surface_only=True),
               dict(crop_min=(2.0, -3.0, -1.0), crop_max=(10.0, 3.0, 2.0)),
               dict(coarsen=(2, 2, 2))):
        gj = JGSM.voxel_preprocess(run["b"]["grid"], **kw)
        gt = tm.GSM.voxel_preprocess(run["tb"]["grid"], **kw)
        np.testing.assert_array_equal(gt.keys.numpy(), np.asarray(gj.keys))


def test_voxel_branch_dense_bounds_and_config_fields():
    from infinicube_tpu.models.gsm.voxel_branch import VoxelBranchConfig as J
    bounds = ((-8, -64, -8), (224, 128, 48))
    for level in range(3):
        assert VoxelBranchConfig(dense_lookup_bounds=bounds).\
            level_dense_bounds(level) == \
            J(dense_lookup_bounds=bounds).level_dense_bounds(level)
    assert VoxelBranchConfig().level_dense_bounds(0) is None
    # the release configuration's fields and values are the reference's
    from infinicube_tpu.models.gsm.model import GSMConfig as JC
    jc, tc = dataclasses.asdict(JC()), dataclasses.asdict(tm.GSMConfig())
    for part in ("voxel", "pixel", "sky"):
        jc[part]["dtype"] = np.dtype(jc[part]["dtype"]).name
        tc[part]["dtype"] = str(tc[part]["dtype"]).removeprefix("torch.")
    jc["voxel"].pop("conv_backend")
    assert jc == tc
