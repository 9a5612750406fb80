"""Rules of the PyTorch port: it imports no JAX and nothing of the JAX
package, CPU tensors take the plain versions (launch counters stay at 0),
CUDA-only wrappers refuse CPU tensors, and entry points do not carry on
quietly on the CPU when no card is present."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from infinicube_tpu_torch import kernels

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "infinicube_tpu_torch"
FORBIDDEN = ("jax", "flax", "transformers", "infinicube_tpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch thread for the module: the suite runs files in parallel
    workers, and a thread per core in each of them oversubscribes the
    machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _OnCard(torch.Tensor):
    """A CPU tensor that claims to lie on the card (so are its results)."""
    is_cuda = True


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "chip_time_kernels.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(ast.parse(path.read_text()))
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import infinicube_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules and 'flax' not in sys.modules\n"
        "assert not any(k == 'infinicube_tpu' or k.startswith("
        "'infinicube_tpu.') for k in sys.modules)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_cpu_tensors_take_plain_versions():
    from infinicube_tpu_torch.models.wan.dit import WanDiT, WanDiTConfig
    from infinicube_tpu_torch.ops.attention import multi_head_attention
    from infinicube_tpu_torch.ops.flash_attention import mha_quantized
    from infinicube_tpu_torch.ops.ring_attention import \
        ring_attention_virtual
    kernels.reset_launches()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 40, 2, 64), generator=g) for _ in range(3))
    multi_head_attention(q, k, v)
    ring_attention_virtual(q, k, v, 2)
    mha_quantized(q, k, v)
    mha_quantized(q, k, v, quant="qkv")
    for quant in ("qk", "qkv"):
        cfg = WanDiTConfig(dim=64, ffn_dim=64, num_layers=1, num_heads=1,
                           in_channels=4, out_channels=4, text_dim=16,
                           freq_dim=16, buffer_channels=4, attn_quant=quant,
                           quant_linear=True)
        dit = WanDiT(cfg, device="cpu")
        with torch.no_grad():
            dit(torch.randn(1, 1, 4, 4, 4), torch.ones(1),
                torch.randn(1, 3, 16))
    _stage1_on_cpu()
    _train_step_on_cpu()
    assert kernels.launches and all(v == 0 for v in kernels.launches.values())


def _stage1_on_cpu():
    """The stage-1 ops and models on CPU tensors: the dense conv, the sparse
    conv, a small UNet and a small VAE decode."""
    from infinicube_tpu_torch.grid.build import grid_from_ijk
    from infinicube_tpu_torch.models.diffusion.model import (
        CondCubes, DiffusionConfig, VoxelDiffusion)
    from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                       SparseVAEConfig)
    from infinicube_tpu_torch.nn.sparse import conv_plan
    from infinicube_tpu_torch.ops.dense_conv import conv3x3x3
    from infinicube_tpu_torch.ops.window_conv import window_sparse_conv
    g = torch.Generator().manual_seed(0)
    conv3x3x3(torch.randn((1, 4, 4, 4, 8)), torch.randn((8, 8, 3, 3, 3)),
              torch.zeros(8))
    grid = grid_from_ijk(torch.randint(-4, 4, (1, 50, 3), generator=g),
                         torch.ones((1, 50), dtype=torch.bool), 0.2, 0.1, 64)
    window_sparse_conv(conv_plan(grid, ((-8, -8, -8), (16, 16, 16))),
                       torch.randn((1, 64, 4)), torch.randn((27, 4, 4)))
    vd = VoxelDiffusion(DiffusionConfig(
        cube_dims=(4, 4, 4), model_channels=32, channel_mult=(1, 2),
        attention_ds=(2,), num_heads=4, transformer_depth=1,
        dtype=torch.float32), device="cpu")
    vd.init_params(g, zero_init_layers=False)
    vd.sample(vd.encode_conditions(
        torch.zeros((1, 3, 4, 3)), torch.ones((1, 3, 4), dtype=torch.bool),
        torch.eye(4).expand(1, 2, 4, 4), torch.ones((1, 2, 3)),
        torch.ones((1, 2), dtype=torch.bool)), num_steps=1, generator=g)
    # int8 serving: the level-0 convs of a 4 x 8 x 16 cube quantize
    vq = VoxelDiffusion(DiffusionConfig(
        cube_dims=(4, 8, 16), model_channels=64, channel_mult=(1,),
        attention_ds=(), transformer_depth=1, dtype=torch.float32,
        serve_quant=True), device="cpu")
    vq.init_params(g, zero_init_layers=False)
    for sampler in ("ddim", "ddpm", "dpmpp"):
        vq.sample(CondCubes.null(1, vq.cfg), num_steps=1, generator=g,
                  guidance_scale=2.0, sampler=sampler)
    vae = SparseStructureVAE(SparseVAEConfig(
        f_maps=8, c_dim=8, sem_embed_dim=4, neck_dims=(4, 4, 4),
        neck_ijk_min=(-2, -2, -2), capacities=(512, 256, 64)), device="cpu")
    vae.init_params(g)
    vae.decode(torch.randn((1, 4, 4, 4, 8), generator=g))


def _train_step_on_cpu():
    """Gradients through the attention, the dense conv and a small trainable
    UNet on CPU tensors: plain versions and autograd."""
    from infinicube_tpu_torch.models.diffusion.model import (
        CondCubes, DiffusionConfig, VoxelDiffusion)
    from infinicube_tpu_torch.ops.attention import multi_head_attention
    from infinicube_tpu_torch.ops.dense_conv import Conv3x3x3
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 9, 2, 64), generator=g, requires_grad=True)
    multi_head_attention(q, q, q).sum().backward()
    conv = Conv3x3x3(8, 8)
    conv.reset_parameters(g)
    conv(torch.randn((1, 3, 3, 3, 8), generator=g,
                     requires_grad=True)).sum().backward()
    cfg = DiffusionConfig(cube_dims=(4, 4, 4), model_channels=32,
                          channel_mult=(1, 2), attention_ds=(2,), num_heads=4,
                          transformer_depth=1, dtype=torch.float32,
                          remat=True)
    vd = VoxelDiffusion(cfg, device="cpu", trainable=True)
    vd.init_params(g, zero_init_layers=False)
    loss, _ = vd.train_loss(torch.randn((1, 4, 4, 4, 8), generator=g),
                            CondCubes.null(1, cfg), generator=g)
    loss.backward()
    assert all(p.grad is not None for p in vd.unet.parameters())
    _vae_train_step_on_cpu(g)


def _vae_train_step_on_cpu(g):
    """The sparse VAE's teacher-forced forward, loss and backward on CPU
    tensors: the sparse conv's plain forward and backward."""
    from infinicube_tpu_torch.grid.ops import majority_label
    from infinicube_tpu_torch.models.vae.loss import VAELossConfig, vae_loss
    from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                       SparseVAEConfig,
                                                       build_hash_tree)
    vae = SparseStructureVAE(SparseVAEConfig(
        f_maps=8, c_dim=8, sem_embed_dim=4, neck_dims=(4, 4, 4),
        neck_ijk_min=(-2, -2, -2), capacities=(128, 64, 32)), device="cpu")
    vae.init_params(g)
    pts = torch.rand((1, 60, 3), generator=g) * 2.0 - 1.0
    mask = torch.ones((1, 60), dtype=torch.bool)
    grids = build_hash_tree(vae.cfg, pts, mask)
    sem = majority_label(grids[0], pts, torch.randint(0, 23, (1, 60),
                                                      generator=g), mask, 23)
    loss, _ = vae_loss(VAELossConfig(), vae(grids, sem, generator=g),
                       grids[0], sem)
    loss.backward()
    assert all(p.grad is not None for p in vae.parameters())


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback inside the wrappers: a tensor off the card is an error."""
    x = torch.zeros((1, 64, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        kernels.flash_attn_bf16(x, x, x, 0.125)
    q8 = torch.zeros((1, 128, 64), dtype=torch.int8)
    s = torch.ones((1, 1))
    with pytest.raises(ValueError):
        kernels.flash_attn_int8qk(q8, q8, s, s, x, 128, 0.125)
    with pytest.raises(ValueError):
        kernels.conv3x3x3_bf16(torch.zeros((1, 4, 4, 4, 8),
                                           dtype=torch.bfloat16),
                               torch.zeros((8, 216), dtype=torch.bfloat16),
                               torch.zeros(8))
    with pytest.raises(ValueError):
        kernels.conv3x3x3_bf16(torch.zeros((1, 4, 4, 4, 8),
                                           dtype=torch.bfloat16),
                               torch.zeros((8, 216), dtype=torch.bfloat16),
                               None)
    with pytest.raises(ValueError):
        kernels.flash_attn_bf16(x, x, x, 0.125, return_lse=True)
    with pytest.raises(ValueError):
        kernels.flash_attn_bf16_bwd(x, x, x, x, torch.zeros((1, 1, 64)),
                                    torch.zeros((1, 1, 64)), 0.125)
    with pytest.raises(ValueError):
        kernels.sparse_conv_f32(torch.zeros((1, 64, 4)),
                                torch.zeros((1, 64, 27), dtype=torch.int32),
                                torch.zeros((27, 4, 4)),
                                torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.sparse_conv_f32_wgrad(
            torch.zeros((1, 64, 4)),
            torch.zeros((1, 64, 27), dtype=torch.int32),
            torch.zeros((1, 64, 4)))
    with pytest.raises(ValueError):
        kernels.conv3x3x3_int8(torch.zeros((1, 4, 4, 4, 32),
                                           dtype=torch.int8),
                               torch.zeros((32, 864), dtype=torch.int8),
                               torch.ones((3, 32)), torch.zeros(32))
    with pytest.raises(ValueError):
        kernels.flash_attn_int8qkv(q8, q8, s, s,
                                   torch.zeros((1, 64, 128),
                                               dtype=torch.int8),
                                   torch.ones((1, 64)), 1, 100, 128, 0.125)
    assert kernels.launches and all(v == 0 for v in kernels.launches.values())


@pytest.mark.parametrize("entry", ["dit", "vae", "t5", "generator",
                                   "voxel_diffusion", "sparse_vae",
                                   "world_generator", "trainable_diffusion",
                                   "train_loop", "train_cli",
                                   "train_vae_cli", "voxel_vae_cli",
                                   "single_chunk_cli",
                                   "serve_quant_diffusion", "sparse_unet",
                                   "cond_encoders", "alt_diffusion",
                                   "brick_vae", "process_clip",
                                   "vae_batches", "gsm_batches",
                                   "lidar_depth_image", "from_checkpoint",
                                   "convert_load", "sp_dit",
                                   "init_distributed", "make_mesh",
                                   "batch2device",
                                   "render_gaussian_scene", "vis_cli"])
def test_entry_points_default_to_the_card(entry):
    """Built without device="cpu" and with no card present, they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from infinicube_tpu_torch.models.wan.dit import WanDiT, WanDiTConfig
    from infinicube_tpu_torch.models.wan.pipeline import (
        WanPipelineConfig, WanVideoGenerator)
    from infinicube_tpu_torch.models.wan.t5 import T5Config, T5Encoder
    from infinicube_tpu_torch.models.wan.vae3d import (VideoVAE,
                                                       VideoVAEConfig)
    from infinicube_tpu_torch.inference.voxel_world_generation import \
        VoxelWorldGenerator
    from infinicube_tpu_torch.models.diffusion.model import (
        DiffusionConfig, VoxelDiffusion)
    from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                       SparseVAEConfig)
    from infinicube_tpu_torch.inference.voxel_vae import main as eval_main
    from infinicube_tpu_torch.inference.voxel_generation_single_chunk \
        import main as single_chunk_main
    from infinicube_tpu_torch.train import main as train_main
    from infinicube_tpu_torch.training.loop import LoopConfig, train
    from infinicube_tpu_torch.training.state import TrainConfig
    from infinicube_tpu_torch.data_process import \
        generate_additional_attributes as gaa
    from infinicube_tpu_torch.training import data_glue
    from infinicube_tpu_torch.convert import load_pipeline_checkpoint
    from infinicube_tpu_torch.parallel.mesh import (init_distributed,
                                                    make_mesh)
    from infinicube_tpu_torch.utils.common import batch2device
    from infinicube_tpu_torch.visualize.cli import main as vis_main
    from infinicube_tpu_torch.visualize.render import render_gaussian_scene
    tiny_vae = VideoVAEConfig(latent_channels=4, base_channels=8,
                              channel_mult=(1, 2), num_res_blocks=1)
    from infinicube_tpu_torch.models.diffusion.model import CondEncoders
    from infinicube_tpu_torch.models.diffusion.unet_sparse import (
        SparseUNet, SparseUNetConfig)
    tiny_unet = DiffusionConfig(cube_dims=(4, 4, 4), model_channels=32,
                                channel_mult=(1,), attention_ds=(),
                                transformer_depth=1)
    alt_unet = dataclasses.replace(tiny_unet, use_semantic_cond=True,
                                   use_image_cond="lss", num_classes=2,
                                   context_dim=8)
    build = {
        "dit": lambda: WanDiT(WanDiTConfig(dim=64, ffn_dim=64, num_layers=1,
                                           num_heads=1)),
        "vae": lambda: VideoVAE(tiny_vae),
        "t5": lambda: T5Encoder(T5Config.tiny()),
        "generator": lambda: WanVideoGenerator(WanPipelineConfig(
            dit=WanDiTConfig(dim=64, ffn_dim=64, num_layers=1, num_heads=1,
                             text_dim=64), vae=tiny_vae,
            t5=T5Config.tiny())),
        "voxel_diffusion": lambda: VoxelDiffusion(tiny_unet),
        "sparse_vae": lambda: SparseStructureVAE(SparseVAEConfig(
            f_maps=8, neck_dims=(4, 4, 4), capacities=(64, 32, 16))),
        "world_generator": lambda: VoxelWorldGenerator(
            VoxelDiffusion(tiny_unet), lambda latents: None),
        "trainable_diffusion": lambda: VoxelDiffusion(tiny_unet,
                                                      trainable=True),
        "train_loop": lambda: train(
            LoopConfig(max_steps=1, resume=False), TrainConfig(),
            {"w": torch.zeros(2, requires_grad=True)},
            lambda p, g, b: (p["w"].sum(), {}), [None]),
        "train_cli": lambda: train_main(
            ["none", "--exec", "max_steps=1", "diffusion.cube_dims=(4,4,4)",
             "diffusion.model_channels=32", "diffusion.channel_mult=(1,)",
             "diffusion.attention_ds=()", "diffusion.transformer_depth=1"]),
        "train_vae_cli": lambda: train_main(
            ["none", "--exec", "model=vae", "max_steps=1", "vae.f_maps=8",
             "vae.neck_dims=(4,4,4)", "vae.capacities=(64,32,16)"]),
        "voxel_vae_cli": lambda: eval_main(
            ["--points", str(ROOT / "README.md"), "--output", "unused"]),
        "single_chunk_cli": lambda: single_chunk_main(
            ["--output", "unused", "--ddim_steps", "1"]),
        "serve_quant_diffusion": lambda: VoxelDiffusion(
            dataclasses.replace(tiny_unet, serve_quant=True)),
        "sparse_unet": lambda: SparseUNet(SparseUNetConfig(model_channels=8)),
        "cond_encoders": lambda: CondEncoders(alt_unet),
        "alt_diffusion": lambda: VoxelDiffusion(alt_unet),
        # the brick plan follows its grid's device; the model that builds
        # it, on its default device, refuses to start without a card
        "brick_vae": lambda: SparseStructureVAE(SparseVAEConfig(
            f_maps=8, neck_dims=(4, 4, 4), capacities=(64, 32, 16),
            conv_backend="brick")),
        # the data path: the tensors it builds from host numpy go to the
        # card unless the caller asks for the CPU
        "process_clip": lambda: gaa.process_clip(ROOT / "no_clip", "c"),
        "lidar_depth_image": lambda: gaa.lidar_depth_image(
            np.zeros((4, 3)), np.eye(4), np.eye(3), (4, 4)),
        "vae_batches": lambda: next(data_glue.vae_batches(
            [], SparseVAEConfig())),
        "gsm_batches": lambda: next(data_glue.gsm_batches([], None)),
        # the released-weights path: the card is asked for before any file
        # is read
        "from_checkpoint": lambda: WanVideoGenerator.from_checkpoint(
            ROOT / "no_checkpoint"),
        "convert_load": lambda: load_pipeline_checkpoint(
            ROOT / "no_checkpoint"),
        # sequence and data parallelism, the utilities and the viewers
        "sp_dit": lambda: WanDiT(WanDiTConfig(dim=64, ffn_dim=64,
                                              num_layers=1, num_heads=1,
                                              sp_axis="seq")),
        "init_distributed": lambda: init_distributed(),
        "make_mesh": lambda: make_mesh(),
        "batch2device": lambda: batch2device({"x": torch.zeros(1)}),
        "render_gaussian_scene": lambda: render_gaussian_scene(
            {k: np.zeros((1, n)) for k, n in (("means", 3), ("quats", 4),
                                              ("scales", 3), ("colors", 3))}
            | {"opacities": np.zeros(1)}, np.eye(4)),
        "vis_cli": lambda: vis_main(["grid", str(ROOT / "no_world.npz")]),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


def test_train_loop_refuses_parameters_on_another_device():
    """A loop asked for one device does not train parameters that lie on
    another."""
    from infinicube_tpu_torch.training.loop import LoopConfig, train
    from infinicube_tpu_torch.training.state import TrainConfig
    with pytest.raises(ValueError, match="is on"):
        train(LoopConfig(max_steps=1, resume=False), TrainConfig(),
              {"w": torch.zeros(2, device="meta", requires_grad=True)},
              lambda p, g, b: (p["w"].sum(), {}), [None], device="cpu")


def test_sparse_conv_gradient_on_the_card_goes_through_the_kernels(
        monkeypatch):
    """What this test guarded while K4 had no backward (``SparseConv3d``
    raised on a CUDA tensor that needs a gradient) now holds the other way:
    a gradient on the card goes through the kernels' wrappers, K4 for the
    forward, K4 counted as dgrad with the reversed weights and a zero poison
    vector for dx, K6 for dW, and never through a plain version. Checked
    without a card: the tensors claim to be on one, and stand-ins that
    record their calls take the wrappers' place."""
    from infinicube_tpu_torch.grid.build import grid_from_ijk
    from infinicube_tpu_torch.nn import sparse
    from infinicube_tpu_torch.ops import window_conv

    def plain(t):
        return t.as_subclass(torch.Tensor)

    g = torch.Generator().manual_seed(0)
    grid = grid_from_ijk(torch.randint(-3, 3, (1, 40, 3), generator=g),
                         torch.ones((1, 40), dtype=torch.bool), 0.2, 0.1, 64)
    plan = sparse.conv_plan(grid, ((-8, -8, -8), (16, 16, 16)))
    conv = sparse.SparseConv3d(4, 8)
    conv.reset_parameters(g)
    calls = []
    conv_plain, bwd_plain = (window_conv.sparse_conv_plain,
                             window_conv.sparse_conv_bwd_plain)

    def fake_k4(feats, nbr, w_pack, poison, dgrad=False):
        calls.append(("dgrad" if dgrad else "fwd", tuple(w_pack.shape),
                      poison.tolist()))
        w = conv.kernel.detach()
        assert torch.equal(plain(w_pack),
                           window_conv.pack_sparse_weight(w, dgrad))
        return conv_plain(plan, plain(feats),
                          window_conv.rev_w(w) if dgrad else w)

    def fake_k6(feats, nbr, gout):
        calls.append(("wgrad", tuple(gout.shape), None))
        zero_w = torch.zeros((27, feats.shape[-1], gout.shape[-1]))
        return bwd_plain(plan, plain(feats), zero_w, plain(gout))[1]

    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(window_conv.kernels, "sparse_conv_f32", fake_k4)
    monkeypatch.setattr(window_conv.kernels, "sparse_conv_f32_wgrad", fake_k6)
    monkeypatch.setattr(window_conv, "sparse_conv_plain", refuse)
    monkeypatch.setattr(window_conv, "sparse_conv_bwd_plain", refuse)
    x = torch.randn((1, 64, 4), generator=g)
    feats = x.clone().as_subclass(_OnCard).requires_grad_()
    cot = torch.randn((1, 64, 8), generator=g)
    conv(feats, plan).backward(cot)
    assert [c[0] for c in calls] == ["fwd", "dgrad", "wgrad"]
    assert calls[0][1] == (2, 27, 8, 4) and calls[1][1] == (2, 27, 4, 8)
    assert calls[1][2] == [0] and calls[2][1] == (1, 64, 8)
    monkeypatch.undo()
    ref_dx, ref_dw = bwd_plain(plan, x, conv.kernel.detach(), cot)
    torch.testing.assert_close(plain(feats.grad), ref_dx)
    torch.testing.assert_close(conv.kernel.grad, ref_dw)
    # nothing asks for a gradient: the forward alone
    calls.clear()
    monkeypatch.setattr(window_conv.kernels, "sparse_conv_f32", fake_k4)
    with torch.no_grad():
        conv(feats, plan)
    assert [c[0] for c in calls] == ["fwd"]


def test_int8_conv_on_the_card_takes_k7_where_the_rule_holds(monkeypatch):
    """``Conv3x3x3(quant=True)`` on a CUDA-claiming input: K7's wrapper,
    after the wrappers of its three quantize-prologue kernels, exactly where
    ``int8_conv_applies`` holds for the input (the reference's rule), K3's
    wrapper elsewhere, and never a plain version. Checked without a card:
    stand-ins that record their calls take the wrappers' place and compute
    the plain results on the CPU."""
    from infinicube_tpu_torch.ops import dense_conv
    int8_plain, bf16_plain = (dense_conv.conv3x3x3_int8_plain,
                              dense_conv.conv3x3x3_plain)
    quantize = dense_conv.quantize_for_conv
    prologue = ["int8_conv_amax", "int8_conv_quantize_w",
                "int8_conv_quantize_x"]
    calls = []

    def plain(t):
        return t.as_subclass(torch.Tensor)

    def fake_k7(x8, w8_packed, sw, bias):
        calls.append("k7")
        O, C = w8_packed.shape[0], x8.shape[-1]
        w8 = plain(w8_packed).reshape(O, 3, 3, 3, C).permute(0, 4, 2, 3, 1)
        return int8_plain(plain(x8), w8, plain(sw), plain(bias),
                          torch.bfloat16)

    def fake_k3(x, w_packed, bias):
        calls.append("k3")
        O, C = w_packed.shape[0], x.shape[-1]
        w = plain(w_packed).reshape(O, 3, 3, 3, C).permute(0, 4, 1, 2, 3)
        return bf16_plain(plain(x), w, plain(bias))

    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    def fake_prologue(name):
        def run(*args):
            calls.append(name)
            return getattr(dense_conv, f"{name}_plain")(
                *(plain(a) for a in args))
        return run

    monkeypatch.setattr(dense_conv.kernels, "conv3x3x3_int8", fake_k7)
    monkeypatch.setattr(dense_conv.kernels, "conv3x3x3_bf16", fake_k3)
    for name in ("int8_conv_amax", "int8_conv_quantize_x",
                 "int8_conv_quantize_w"):
        monkeypatch.setattr(dense_conv.kernels, name, fake_prologue(name))
    monkeypatch.setattr(dense_conv, "conv3x3x3_int8_plain", refuse)
    monkeypatch.setattr(dense_conv, "conv3x3x3_plain", refuse)
    monkeypatch.setattr(dense_conv, "quantize_for_conv", refuse)
    g = torch.Generator().manual_seed(0)
    # (B, D, H, W, C, O): int8 at 4 x 8 x 16 and 64 channels; not at C = 16,
    # not on a 4^3 cube, not with W = 12
    for shape in [(2, 4, 8, 16, 64, 64), (2, 4, 8, 16, 16, 64),
                  (1, 4, 4, 4, 64, 64), (1, 4, 8, 12, 64, 96),
                  (1, 3, 4, 32, 128, 64)]:
        B, D, H, W, C, O = shape
        conv = dense_conv.Conv3x3x3(C, O, dtype=torch.bfloat16, quant=True)
        conv.reset_parameters(g)
        x = torch.randn((B, D, H, W, C), generator=g).to(torch.bfloat16)
        calls.clear()
        with torch.no_grad():
            out = conv(x.as_subclass(_OnCard))
        want = "k7" if dense_conv.int8_conv_applies((B, D, H, W), C, O) \
            else "k3"
        assert calls == ([*prologue, "k7"] if want == "k7" else ["k3"]), \
            (shape, calls)
        wq = conv.weight.to(torch.bfloat16)
        bias = conv.bias.to(torch.bfloat16).float()
        ref = int8_plain(*quantize(x, wq), bias,
                         torch.bfloat16) if want == "k7" else \
            bf16_plain(x, wq, bias)
        assert torch.equal(plain(out), ref)
    assert dense_conv.int8_conv_applies((2, 4, 8, 16), 64, 64)
    assert dense_conv.int8_conv_applies((1, 3, 4, 32), 128, 64)


def test_bf16_sparse_conv_on_cpu_tensors_launches_nothing(monkeypatch):
    """A bf16 sparse ResBlock (its convs, their gradients) and the bf16
    attention with a gradient on CPU tensors take the plain versions: no
    bf16 kernel wrapper is called and nothing is counted."""
    from infinicube_tpu_torch.grid.build import grid_from_ijk
    from infinicube_tpu_torch.nn.sparse import SparseResBlock, conv_plan
    from infinicube_tpu_torch.ops.attention import multi_head_attention

    def refuse(*a, **kw):
        raise AssertionError("a kernel ran on a CPU tensor")

    for name in ("sparse_conv_bf16", "sparse_conv_bf16_wgrad",
                 "flash_attn_bf16", "flash_attn_bf16_bwd"):
        monkeypatch.setattr(kernels, name, refuse)
    kernels.reset_launches()
    g = torch.Generator().manual_seed(0)
    grid = grid_from_ijk(torch.randint(-3, 3, (1, 40, 3), generator=g),
                         torch.ones((1, 40), dtype=torch.bool), 0.2, 0.1, 64)
    block = SparseResBlock(12, 16, dtype=torch.bfloat16)
    for conv in (block.conv1, block.conv2):
        conv.reset_parameters(g)
    x = torch.randn((1, 64, 12), generator=g, requires_grad=True)
    out = block(x, conv_plan(grid, ((-8, -8, -8), (16, 16, 16))), grid.mask)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert x.grad is not None and block.conv1.kernel.grad.dtype == \
        torch.float32
    q = torch.randn((1, 9, 2, 64), generator=g).bfloat16().requires_grad_()
    multi_head_attention(q, q, q).float().sum().backward()
    assert all(v == 0 for v in kernels.launches.values())


def test_bf16_sparse_conv_on_the_card_goes_through_the_bf16_kernels(
        monkeypatch):
    """A bf16 ``SparseConv3d`` whose feats claim to be on the card: the
    forward, dx and dW go to ``sparse_conv_bf16`` (counted as dgrad for
    dx, with the reversed pack and no poison) and
    ``sparse_conv_bf16_wgrad``, the packs bf16 [27, N, K] cached per
    weight version and dtype, dW rounded to bf16 and handed back as f32;
    never a plain version and never an f32 kernel."""
    from infinicube_tpu_torch.grid.build import grid_from_ijk
    from infinicube_tpu_torch.nn import sparse
    from infinicube_tpu_torch.ops import window_conv

    def plain(t):
        return t.as_subclass(torch.Tensor)

    g = torch.Generator().manual_seed(1)
    grid = grid_from_ijk(torch.randint(-3, 3, (1, 40, 3), generator=g),
                         torch.ones((1, 40), dtype=torch.bool), 0.2, 0.1, 64)
    plan = sparse.conv_plan(grid, ((-8, -8, -8), (16, 16, 16)))
    conv = sparse.SparseConv3d(8, 16, dtype=torch.bfloat16)
    conv.reset_parameters(g)
    calls = []
    conv_plain, bwd_plain = (window_conv.sparse_conv_plain,
                             window_conv.sparse_conv_bwd_plain)
    w16 = conv.kernel.detach().bfloat16()

    def fake_k4(feats, nbr, w_pack, poison, dgrad=False):
        calls.append(("dgrad" if dgrad else "fwd", tuple(w_pack.shape),
                      w_pack.dtype, poison.tolist()))
        assert torch.equal(plain(w_pack),
                           window_conv.pack_sparse_weight(w16, dgrad))
        return conv_plain(plan, plain(feats),
                          window_conv.rev_w(w16) if dgrad else w16)

    def fake_k6(feats, nbr, gout):
        calls.append(("wgrad", tuple(gout.shape), gout.dtype, None))
        zero_w = torch.zeros((27, feats.shape[-1], gout.shape[-1]))
        return bwd_plain(plan, plain(feats), zero_w, plain(gout))[1]

    def refuse(*a, **kw):
        raise AssertionError("a plain version or an f32 kernel ran")

    monkeypatch.setattr(window_conv.kernels, "sparse_conv_bf16", fake_k4)
    monkeypatch.setattr(window_conv.kernels, "sparse_conv_bf16_wgrad",
                        fake_k6)
    for name in ("sparse_conv_f32", "sparse_conv_f32_wgrad"):
        monkeypatch.setattr(window_conv.kernels, name, refuse)
    monkeypatch.setattr(window_conv, "sparse_conv_plain", refuse)
    monkeypatch.setattr(window_conv, "sparse_conv_bwd_plain", refuse)
    x = torch.randn((1, 64, 8), generator=g).bfloat16()
    feats = x.clone().as_subclass(_OnCard).requires_grad_()
    cot = torch.randn((1, 64, 16), generator=g).bfloat16()
    out = conv(feats, plan)
    assert out.dtype == torch.bfloat16
    out.backward(cot)
    bf = torch.bfloat16
    assert calls == [("fwd", (27, 16, 8), bf, [0]),
                     ("dgrad", (27, 8, 16), bf, [0]),
                     ("wgrad", (1, 64, 16), bf, None)]
    # the packs are cached per weight version and dtype
    packs = conv._packed[1]
    assert set(packs) == {False, True} and conv._packed[0][3] == bf
    monkeypatch.undo()
    ref_dx, ref_dw = bwd_plain(plan, x, w16, cot)
    torch.testing.assert_close(plain(feats.grad), ref_dx, rtol=0, atol=0)
    assert conv.kernel.grad.dtype == torch.float32
    torch.testing.assert_close(conv.kernel.grad, ref_dw.float(), rtol=0,
                               atol=0)


def test_sparse_attention_on_the_card_goes_through_the_kernels(monkeypatch):
    """``sparse_attention`` on a CUDA tensor: each sample's active rows go
    through ``flash_attn_f32`` (and ``flash_attn_f32_bwd`` for a gradient),
    a sample without an active row through nothing, and neither the einsum
    nor a plain attention ever runs. Checked without a card: the tensors
    claim to be on one, and stand-ins that record their calls take the
    wrappers' place."""
    from infinicube_tpu_torch.nn import sparse
    from infinicube_tpu_torch.nn.layers import Dense
    from infinicube_tpu_torch.ops import attention

    def plain(t):
        return t.as_subclass(torch.Tensor)

    plain_attn, plain_bwd = (attention.attention_plain,
                             attention.attention_bwd_plain)
    calls = []

    def fake_fwd(q, k, v, scale, return_lse=False):
        calls.append(("fwd", q.shape[1], q.shape[-1]))
        out = plain_attn(plain(q), plain(k), plain(v), scale, return_lse)
        return out

    def fake_bwd(q, k, v, do, lse, delta, scale):
        calls.append(("bwd", q.shape[1], q.shape[-1]))
        o = plain_attn(plain(q), plain(k), plain(v), scale)
        return plain_bwd(plain(q), plain(k), plain(v), o, plain(do),
                         plain(lse), scale)

    def refuse(*a, **kw):
        raise AssertionError("a plain attention ran on a CUDA tensor")

    monkeypatch.setattr(attention.kernels, "flash_attn_f32", fake_fwd)
    monkeypatch.setattr(attention.kernels, "flash_attn_f32_bwd", fake_bwd)
    monkeypatch.setattr(attention, "attention_plain", refuse)
    monkeypatch.setattr(sparse, "_attention_plain", refuse)
    g = torch.Generator().manual_seed(0)
    F = 64
    qkv, proj = Dense(F, 3 * F, compute_dtype=None), \
        Dense(F, F, compute_dtype=None)
    mask = torch.zeros((3, 30), dtype=torch.bool)
    mask[0, :17] = True
    mask[2, 5:26] = True
    x = torch.randn((3, 30, F), generator=g).as_subclass(_OnCard)
    x.requires_grad_()
    out = sparse.sparse_attention(x, mask, 4, qkv, proj)
    assert [c[:2] for c in calls] == [("fwd", 17), ("fwd", 21)]
    assert all(c[2] == 64 for c in calls)     # d = 16 padded to 64
    calls.clear()
    out.sum().backward()
    assert sorted(c[:2] for c in calls) == [("bwd", 17), ("bwd", 21)]
    assert torch.isfinite(plain(x.grad)).all()
