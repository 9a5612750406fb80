"""The Wan VAE's routed convs on the card: K3 (bf16) and ``conv3x3x3_f32``
at ragged, non-cubic VAE shapes against ``conv3x3x3_plain``; the routed
causal conv with and without history, card against CPU; a small routed VAE
decode with its exact K3 launches, card against CPU and against its
``"xla"``-route twin; and a dtype the kernels do not take raising. Needs an
NVIDIA GPU and skips without one; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_wan_vae_route_cuda.py -m cuda -q
"""

import math

import pytest
import torch

from infinicube_tpu_torch import kernels
from infinicube_tpu_torch.models.wan.vae3d import (RoutedCausalConv3d,
                                                   VideoVAE, VideoVAEConfig,
                                                   decoder_schedule)
from infinicube_tpu_torch.ops.dense_conv import (conv3x3x3_plain,
                                                 pack_conv_weight)

pytestmark = pytest.mark.cuda

# (D, H, W, C, O): the decode tile's latent level with its 2 history
# frames, the whole frame's latent level, a ragged tile of each encode
# level's width, a 1-frame streaming chunk with its history
SHAPES = ((26, 32, 32, 384, 384), (26, 60, 104, 384, 384),
          (11, 60, 40, 96, 96), (11, 30, 20, 192, 192),
          (7, 15, 26, 192, 384), (3, 60, 104, 384, 384))


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_at_vae_shapes(gen, shape, dtype):
    D, H, W, C, O = shape
    x = torch.randn((1, D, H, W, C), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((O, C, 3, 3, 3), generator=gen, device="cuda") /
         math.sqrt(27 * C)).to(dtype)
    b = 0.1 * torch.randn(O, generator=gen, device="cuda")
    run = kernels.conv3x3x3_bf16 if dtype == torch.bfloat16 else \
        kernels.conv3x3x3_f32
    got = run(x, pack_conv_weight(w, dtype), b).float()
    ref = conv3x3x3_plain(x, w, b).float()
    err = (got - ref).abs().max().item()
    top = ref.abs().max().item()
    if dtype == torch.bfloat16:
        assert _cos(got, ref) >= 0.9999 and err <= 2e-2 * top
    else:
        assert err <= 1e-4 * top


@pytest.mark.parametrize("history", [False, True])
def test_routed_conv_card_matches_cpu(gen, history):
    conv = RoutedCausalConv3d(96, 192, dtype=torch.bfloat16, device="cuda")
    conv.reset_parameters(gen)
    cpu = RoutedCausalConv3d(96, 192, dtype=torch.bfloat16, device="cpu")
    cpu.load_state_dict(conv.state_dict())
    x = torch.randn((1, 96, 5, 30, 52), generator=gen,
                    device="cuda").to(torch.bfloat16)
    ctx = torch.randn((1, 2, 30, 52, 96), generator=gen,
                      device="cuda").to(torch.bfloat16) if history else None
    kernels.reset_launches()
    with torch.no_grad():
        got = conv(x, ctx)
        ref = cpu(x.cpu(), None if ctx is None else ctx.cpu())
    assert kernels.launches["conv3x3x3_bf16"] == 1
    assert got.shape == ref.shape == (1, 192, 5, 30, 52)
    assert _cos(got.float().cpu(), ref.float()) >= 0.9999


def test_routed_vae_decode_on_the_card(gen):
    cfg = dict(latent_channels=4, base_channels=64, channel_mult=(1, 2),
               num_res_blocks=1)
    vaes = {}
    for impl, dev in (("auto", "cuda"), ("xla", "cuda"), ("auto", "cpu")):
        vae = VideoVAE(VideoVAEConfig(**cfg, conv_impl=impl), device=dev)
        if not vaes:
            vae.init_params(gen)
            sd = vae.state_dict()
        else:
            vae.load_state_dict(sd)
        vaes[impl, dev] = vae
    z = torch.randn((1, 3, 12, 20, 4), generator=gen, device="cuda")
    routed = sum(2 for _, kind, _ in decoder_schedule(VideoVAEConfig(**cfg))
                 if kind == "res") + 4           # the middle's two blocks
    with torch.no_grad():
        kernels.reset_launches()
        got = vaes["auto", "cuda"].decode(z)
        assert kernels.launches["conv3x3x3_bf16"] == routed
        twin = vaes["xla", "cuda"].decode(z)
        assert kernels.launches["conv3x3x3_bf16"] == routed
        ref = vaes["auto", "cpu"].decode(z.cpu())
    assert got.shape == (1, 3, 24, 40, 3)
    assert _cos(got.cpu(), ref) >= 0.999
    assert _cos(got, twin) >= 0.999


def test_routed_conv_takes_bf16_or_f32_only(gen):
    conv = RoutedCausalConv3d(64, 64, dtype=torch.float16, device="cuda")
    x = torch.zeros((1, 64, 2, 8, 8), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError):
        with torch.no_grad():
            conv(x)
