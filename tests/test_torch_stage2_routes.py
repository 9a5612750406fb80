"""Stage 2's two routes against each other, in the port and in the JAX
package: on a world whose voxels each carry a random class, the splat
route (voxel centers, the winner by quantized depth) and the DDA route (the
first cell a ray enters) often pick neighbouring voxels, so their semantic
buffers agree far less than on a scene of coherent surfaces (the gate of
tests/test_buffers.py:110), while depths and hit masks still agree. The
port shows exactly the reference's agreement: what ``chip_smoke.py``'s
splat-against-DDA check on a random-weight stage-1 world can hold the
routes to is depth, hits, and the class where both see the same voxel."""

import jax.numpy as jnp
import numpy as np
import torch

from infinicube_tpu.camera.conventions import flu_to_opencv
from infinicube_tpu.grid.build import grid_from_ijk as jax_grid_from_ijk
from infinicube_tpu.inference import guidance_buffer_generation as jgb
from infinicube_tpu.utils import buffers as jb
from infinicube_tpu.utils.world_grid import WorldGrid as JaxWorldGrid
from infinicube_tpu_torch.camera.conventions import \
    flu_to_opencv as torch_flu_to_opencv
from infinicube_tpu_torch.camera.pinhole import PinholeCamera
from infinicube_tpu_torch.inference import guidance_buffer_generation as tgb
from infinicube_tpu_torch.utils import buffers as tb
from infinicube_tpu_torch.utils.world_grid import WorldGrid
from tests.test_torch_guidance_buffers import _trajectory, _world_points

CAM = dict(fx=60.0, fy=60.0, cx=40.0, cy=30.0, w=80, h=60)


def _jax_dda(world, poses):
    """The JAX package's DDA route on a world, as its
    ``generate_buffers_for_world`` builds the grid (its CLI takes the splat
    route only)."""
    ijk = world.ijk()
    cap = 1 << int(np.ceil(np.log2(len(ijk))))
    grid = jax_grid_from_ijk(
        jnp.asarray(ijk, jnp.int32)[None], jnp.ones((1, len(ijk)), bool),
        jnp.asarray(world.voxel_size, jnp.float32),
        jnp.asarray(world.origin, jnp.float32), capacity=cap)
    order = np.lexsort((ijk[:, 2], ijk[:, 1], ijk[:, 0]))
    sem = jnp.zeros((cap,), jnp.int32).at[:len(ijk)].set(
        jnp.asarray(world.semantics[order], jnp.int32))
    poses_cv = np.stack([flu_to_opencv(p) for p in poses])
    return jb.generate_guidance_buffers(
        grid, sem, jnp.zeros_like(sem), jgb.PinholeCamera(**CAM),
        jnp.asarray(poses_cv, jnp.float32), method="dda")


def _agreement(dda, splat):
    d1, d2 = dda["depth"], splat["depth"]
    both = (d1 > 0) & (d2 > 0)
    return ((np.abs(d1 - d2)[both] < 1.0).mean(),
            (dda["semantic"][both] == splat["semantic"][both]).mean(),
            ((d1 > 0) == (d2 > 0)).mean())


def test_routes_agree_on_classes_only_where_surfaces_are_coherent():
    pts, sem = _world_points()
    poses = _trajectory(1, yaw=0.013, offset=(0.037, 0.011))
    jw, tw = JaxWorldGrid(0.2), WorldGrid(0.2)
    for w in (jw, tw):
        w.merge_points(pts, sem)
        w.semantics = np.random.default_rng(3).integers(
            1, 23, w.num_voxels).astype(np.int32)
    ref = [{k: np.asarray(v) for k, v in r.items()} for r in (
        _jax_dda(jw, poses),
        jgb.generate_buffers_for_world(jw, poses, jgb.PinholeCamera(**CAM)))]
    grid, sem, inst = tgb.world_to_grid(tw, device="cpu")
    poses_cv = torch.as_tensor(
        np.stack([torch_flu_to_opencv(p) for p in poses]), dtype=torch.float32)
    got = [{k: v.numpy() for k, v in tb.generate_guidance_buffers(
        grid, sem, inst, PinholeCamera(**CAM), poses_cv, method=m).items()}
        for m in ("dda", "splat")]
    ref_agree, got_agree = _agreement(*ref), _agreement(*got)
    np.testing.assert_allclose(got_agree, ref_agree, atol=0.01)
    close, sem_eq, hits = ref_agree
    # depths and hits agree as on a coherent scene; classes do not
    assert close > 0.85 and hits > 0.9 and sem_eq < 0.85
