"""Stage 3 on the card against the CPU at small sizes: the rasterizer with a
tile over capacity, the lifter, and the whole GSM (K4 in its voxel branch,
``flash_attn_f32`` at its bottleneck) under one random init, static and
every-pixel passes. Needs an NVIDIA GPU and skips without one; imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_stage3_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.grid.build import grid_from_points
from infinicube_tpu_torch.models.gsm import lifter
from infinicube_tpu_torch.models.gsm.encoders import UnifiedEncoderConfig
from infinicube_tpu_torch.models.gsm.model import GSM, GSMConfig
from infinicube_tpu_torch.models.gsm.pixel_branch import PixelBranchConfig
from infinicube_tpu_torch.models.gsm.sky import SkyConfig
from infinicube_tpu_torch.models.gsm.voxel_branch import VoxelBranchConfig
from infinicube_tpu_torch.ops import gsplat

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _share_close(a, b, atol):
    ok = (a.cpu() - b).abs() <= atol
    return (ok.all(-1) if ok.dim() == 3 else ok).float().mean().item()


def _scene(n=6000, seed=0):
    """Gaussians before an identity camera at 64x96, 800 of them in one
    tile, each depth at the center of its log-depth quantum."""
    rng = np.random.default_rng(seed)
    h, w, f = 64, 96, 60.0
    u, v = rng.uniform(-8, w + 8, n), rng.uniform(-8, h + 8, n)
    u[:800], v[:800] = rng.uniform(16, 32, 800), rng.uniform(16, 32, 800)
    top = (1 << gsplat.depth_bits_for(24)) - 1
    span = np.log(gsplat._ZFAR / gsplat._ZNEAR)
    k = rng.integers(int(top * np.log(200) / span), int(top * np.log(4000)
                                                        / span), n)
    k[:600] = k[0]
    z = gsplat._ZNEAR * np.exp((k + 0.5) / top * span)
    means = np.stack([(u - w / 2) / f * z, (v - h / 2) / f * z, z], -1)
    scales = (z * rng.uniform(0.5, 6, n) / f / 3)[:, None] * \
        rng.uniform(0.3, 1, (n, 3))
    arrs = (means, rng.normal(size=(n, 4)), scales, rng.uniform(.1, .9, n),
            rng.uniform(size=(n, 3)), np.eye(4),
            [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    return [torch.tensor(np.asarray(a), dtype=torch.float32) for a in arrs]


def test_rasterizer_card_matches_cpu(card):
    args = _scene()
    ref = gsplat.render_gaussians(*args, (64, 96))
    got = gsplat.render_gaussians(*(a.cuda() for a in args), (64, 96))
    proj = gsplat.project_gaussians(*args[:3], *args[5:], (64, 96))
    _, ok = gsplat.tile_instances(proj, (64, 96))
    assert ok.all(1).any()
    for a, b in zip(got[:2], ref[:2]):
        assert _share_close(a, b, 1e-3) >= 0.999
    d_ok = ((got[2].cpu() - ref[2]).abs() <= 1e-3 * ref[2].abs())[
        ref[1] > 1e-6]
    assert d_ok.float().mean() >= 0.999


def _world(dev):
    rng = np.random.default_rng(1)
    ground = np.stack([rng.uniform(2, 20, 4000), rng.uniform(-6, 6, 4000),
                       np.zeros(4000)], -1)
    wall = np.stack([np.full(1500, 18.0), rng.uniform(-6, 6, 1500),
                     rng.uniform(0, 4, 1500)], -1)
    pts = torch.tensor(np.concatenate([ground, wall]), dtype=torch.float32,
                       device=dev)[None]
    return grid_from_points(pts, torch.ones(pts.shape[:2], dtype=torch.bool,
                                            device=dev), 0.4, 0.2, 8192)


def _cameras(dev, V=2, hw=(32, 48)):
    h, w = hw
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
    poses = np.stack([T] * V)
    poses[:, :3, 3] = [[0.03 + 1.1 * i, 0.07 - 0.4 * i, 1.53]
                       for i in range(V)]
    K = np.array([[30.3, 0, w / 2 + 0.2], [0, 30.1, h / 2 - 0.1], [0, 0, 1]],
                 np.float32)
    return (torch.tensor(np.stack([K] * V), device=dev),
            torch.tensor(poses, device=dev))


def test_lifter_card_matches_cpu(card):
    out = {}
    for dev in ("cuda", "cpu"):
        grid = _world(dev)
        Ks, poses = _cameras(dev)
        feats = torch.randn((2, 32, 48, 8),
                            generator=torch.Generator().manual_seed(2)).to(
            dev)
        out[dev] = (lifter.lift_features(grid, feats, Ks, poses, (0, 0, 0),
                                         (1, 1, 1))[0],
                    lifter.sample_image_features(
                        grid.voxel_centers()[0], feats, Ks, poses))
    for a, b in zip(out["cuda"], out["cpu"]):
        assert _share_close(a, b, 1e-3) >= 0.999


def _cfg():
    return GSMConfig(encoder=UnifiedEncoderConfig(conv_width=16),
                     voxel=VoxelBranchConfig(f_maps=16, levels=2,
                                             gaussians_per_voxel=2),
                     pixel=PixelBranchConfig(width=8, dims=(1, 2, 4, 8),
                                             gs_per_pixel=1, view_chunk=1),
                     sky=SkyConfig(embed_dim=32, num_layers=1, num_heads=2),
                     render_tile_capacity=64)


def test_gsm_card_matches_cpu(card):
    """The GSM with the launch counts its config implies: 6 K4 (3
    SparseResBlocks) and 2 ``flash_attn_f32`` (one a view chunk, 64
    channels at the bottleneck in 4 heads of 16, padded to 64) a pass."""
    cpu = GSM(_cfg())
    cpu.init_params(torch.Generator().manual_seed(3))
    gpu = GSM(_cfg(), device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(4)
    depth = rng.uniform(3, 15, (2, 32, 48, 1)).astype(np.float32)
    depth[:, :10] = 0
    masks = np.ones((2, 32, 48, 4), np.float32)
    masks[..., 0] = masks[..., 3] = (depth[..., 0] > 0)
    masks[:, 20:, :10, 3] = 0                   # some midground
    arrays = {"images": rng.uniform(size=(2, 32, 48, 3)), "masks": masks,
              "depth_prior": depth}
    outs = {}
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        Ks, poses = _cameras(dev)
        batch = {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                                 device=dev) for k, v in arrays.items()}
        batch.update(grid=_world(dev), Ks=Ks, cam_to_worlds=poses)
        kernels.reset_launches()
        with torch.inference_mode():
            outs[dev] = (model(batch), model(batch, decode_all_pixels=True))
        if dev == "cuda":
            assert kernels.launches["sparse_conv_f32"] == 12
            assert kernels.launches["flash_attn_f32"] == 4
    for got, ref in zip(outs["cuda"], outs["cpu"]):
        g, r = got["gaussians"], ref["gaussians"]
        assert torch.equal(g["valid"].cpu(), r["valid"])
        for k in ("means", "scales", "quats", "opacities", "colors"):
            err = (g[k].cpu() - r[k]).abs().max().item()
            assert err <= 1e-3 * r[k].abs().max().item(), k
        for k in ("rgb", "alpha", "depth"):
            assert _share_close(got["render"][k], ref["render"][k],
                                1e-3) >= 0.999, k
