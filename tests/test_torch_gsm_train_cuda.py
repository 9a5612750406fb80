"""The GSM trainer's kernel and a tiny train step on the card: the f32
flash-attention backward (``flash_attn_f32_bwd``) against
``attention_bwd_plain`` and the forward's log-sum-exp against
``attention_plain``'s, two runs bit-identical; then one train step of a
tiny GSM, card against CPU from one random init. Needs an NVIDIA GPU and
skips without one; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_gsm_train_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.grid.build import grid_from_points
from infinicube_tpu_torch.models.gsm.encoders import UnifiedEncoderConfig
from infinicube_tpu_torch.models.gsm.loss import GSMLossConfig, gsm_loss
from infinicube_tpu_torch.models.gsm.model import GSM, GSMConfig
from infinicube_tpu_torch.models.gsm.pixel_branch import PixelBranchConfig
from infinicube_tpu_torch.models.gsm.sky import SkyConfig
from infinicube_tpu_torch.models.gsm.voxel_branch import VoxelBranchConfig
from infinicube_tpu_torch.ops import attention as att
from infinicube_tpu_torch.training.state import (TrainConfig, TrainState,
                                                 make_train_step)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("B,nq,nk,h,d", [(1, 600, 600, 4, 64),
                                         (2, 37, 21, 2, 64),
                                         (1, 300, 257, 2, 96),
                                         (1, 130, 200, 3, 128)])
def test_f32_backward_kernel_matches_plain(card, B, nq, nk, h, d):
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn((B, n, h, d), generator=g, device="cuda")
                   for n in (nq, nk, nk, nq))
    scale = d ** -0.5
    o, lse = kernels.flash_attn_f32(q, k, v, scale, return_lse=True)
    ref_o, ref_lse = att.attention_plain(q, k, v, scale, return_lse=True)
    assert (lse - ref_lse).abs().max().item() <= 1e-5
    delta = att.attention_delta(ref_o, do)
    got = kernels.flash_attn_f32_bwd(q, k, v, do, ref_lse, delta, scale)
    again = kernels.flash_attn_f32_bwd(q, k, v, do, ref_lse, delta, scale)
    ref = att.attention_bwd_plain(q, k, v, ref_o, do, ref_lse, scale)
    for a, b, c in zip(got, ref, again):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
        assert torch.equal(a, c)


def _scene(dev):
    rng = np.random.default_rng(0)
    pts = np.concatenate([
        np.stack([rng.uniform(1, 15, 800), rng.uniform(-6, 6, 800),
                  rng.uniform(0, 0.3, 800)], -1),
        np.stack([np.full(400, 12.0), rng.uniform(-6, 6, 400),
                  rng.uniform(0, 4, 400)], -1)])
    grid = grid_from_points(torch.tensor(pts[None], dtype=torch.float32,
                                         device=dev),
                            torch.ones((1, 1200), dtype=torch.bool,
                                       device=dev), 0.5, 0.25, capacity=2048)
    T = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    T[:, :3, 0], T[:, :3, 1], T[:, :3, 2] = [0, -1, 0], [0, 0, -1], [1, 0, 0]
    T[0, :3, 3], T[1, :3, 3] = [0, 0, 1.5], [1.0, 0.5, 1.5]
    K = np.array([[40.0, 0, 24], [0, 40.0, 16], [0, 0, 1]], np.float32)
    masks = np.ones((2, 32, 48, 4), np.float32)
    masks[:, :8, :, 0] = 0.0
    arrays = dict(images=rng.uniform(size=(2, 32, 48, 3)), masks=masks,
                  Ks=np.stack([K, K]), cam_to_worlds=T,
                  depth_prior=np.zeros((2, 32, 48, 1)))
    return {"grid": grid, **{k: torch.tensor(np.asarray(a),
                                             dtype=torch.float32, device=dev)
                             for k, a in arrays.items()}}


def test_tiny_gsm_train_step_card_against_cpu(card):
    """One train step of a tiny 2-D GSM (the pixel branch and its attention
    carry the gradient), card against CPU: the loss within 2e-3, each
    clipped gradient within 2e-3 of its largest CPU value (with a floor of
    1e-3 of the largest gradient, for those that are rounding noise), the
    parameters moved; the card's step launched the attention forward and
    backward."""
    from torch.func import functional_call
    cfg = GSMConfig(encoder=UnifiedEncoderConfig(conv_width=16),
                    voxel=VoxelBranchConfig(f_maps=16, levels=2,
                                            gaussians_per_voxel=2),
                    pixel=PixelBranchConfig(width=8, dims=(1, 2),
                                            gs_per_pixel=1),
                    sky=SkyConfig(embed_dim=32, num_layers=1, num_heads=2,
                                  patch=8),
                    use_voxel_branch=False, render_tile_capacity=64)
    tcfg = TrainConfig(learning_rate=1e-3, use_ema=False)
    results = {}
    for dev in ("cpu", "cuda"):
        model = GSM(cfg, device=dev)
        if dev == "cpu":
            model.init_params(torch.Generator().manual_seed(5))
        else:
            model.load_state_dict(results["cpu"]["init"])
        init = {k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()}
        batch = _scene(dev)

        def loss_fn(p, gen, b):
            out = functional_call(model, p, (b,))
            valid = b["masks"][..., 0] * b["masks"][..., 2] > 0
            return gsm_loss(GSMLossConfig(), out["render"], b["images"],
                            valid, out["sky_mask"],
                            gaussians=out["gaussians"])

        state = TrainState.create(tcfg, dict(model.named_parameters()))
        kernels.reset_launches()
        state, m = make_train_step(tcfg, loss_fn)(state, None, batch)
        results[dev] = dict(init=init, loss=float(m["loss"]),
                            launches=dict(kernels.launches),
                            grads={k: p.grad.cpu()
                                   for k, p in state.params.items()
                                   if p.grad is not None},
                            moved=sum(not torch.equal(
                                p.detach().cpu(), init[k])
                                for k, p in state.params.items()))
    cpu, cuda = results["cpu"], results["cuda"]
    assert abs(cuda["loss"] - cpu["loss"]) <= 2e-3 * abs(cpu["loss"])
    assert cuda["launches"]["flash_attn_f32"] >= 1
    assert cuda["launches"]["flash_attn_f32_bwd"] == 1
    assert set(cuda["grads"]) == set(cpu["grads"])
    floor = 1e-3 * max(g.abs().max().item() for g in cpu["grads"].values())
    for k, g in cpu["grads"].items():
        lim = 2e-3 * max(g.abs().max().item(), floor)
        assert (cuda["grads"][k] - g).abs().max().item() <= lim, k
    assert cuda["moved"] > 0 and cpu["moved"] > 0
