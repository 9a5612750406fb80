"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``infinicube_tpu_torch/csrc`` and then:

1. setup: torch version, the card's name and power limit, build seconds;
2. kernel checks: K1 (int8-QK flash attention, on wgmma and TMA) and K2
   (bf16 flash attention) against their plain PyTorch versions at the DiT's
   head shape (h=12, d=128), with a different quantization scale in every
   block of q and k; then held against them again at the release shape
   (N=37,440) and timed there beside the plain versions, their bounds (and
   the share of it reached) and, for K2, ``scaled_dot_product_attention`` as
   a yardstick;
3. model check: a full-width 2-layer serving DiT on the card (kernels)
   against the same weights on the CPU (plain versions);
4. serving: ``WanVideoGenerator(WanPipelineConfig.serving())`` with random
   weights (all three towers at full width) answers 3 requests of 17 frames
   at 480x832, 4 steps each; the launch counters show each request went
   through K1 and K2 (30 layers x 2 CFG passes x 4 steps);
5. one sequential-CFG denoise step of the 30-layer DiT at 93 frames @ 480p,
   then one step each at 17 and 93 frames under ``torch.profiler``: the
   kernels that take the most device time and the device's busy share.

Then stage 1, the voxel-world generator (the Wan towers freed first):

6. kernel checks: K2 at the UNet's head dim 96 (N = 4,096 and 512, h = 8)
   and K3 (dense 3x3x3 conv) at six release shapes, each against its plain
   version and timed beside it, its bound and the library call
   (``scaled_dot_product_attention``, cuDNN ``conv3d``);
7. model checks: the release-width UNet on a 16^3 cube, card (bf16, K3/K2)
   against the CPU (f32, plain versions), and the release-width VAE decoder
   on an 8^3 neck, card (K4) against the CPU: identical grids at every level
   and matching semantic logits;
8. serving: ``VoxelWorldGenerator.generate_trajectory`` with the release
   ``DiffusionConfig()`` (the 750M UNet, bf16) and ``SparseVAEConfig()``
   (f32), random weights, along an 80 m ego path (3 chunks, DDIM-10, SDEdit
   from the previous chunk); the launch counters show each chunk went
   through K3 48 x 10, K2 10 x 10 and K4 12 times;
9. where the time goes: one DDIM step of the release UNet and one VAE decode,
   timed and under ``torch.profiler``; then K4 (sparse conv, 3xTF32 on the
   tensor cores) against its plain version on the decoded grids at
   capacities 131,072 and 32,768, timed beside its bounds (3 TF32 products
   at 495 TFLOP/s, and the f32 CUDA-core bound), with a dense-bounds
   violation NaN-poisoning exactly its batch row.

Then training the voxel diffusion model (stage 1's models freed first):

10. kernel checks: K2 with its log-sum-exp store against
    ``attention_plain``'s output and lse, and K5 (the flash-attention
    backward, on wgmma and TMA) against ``attention_bwd_plain`` on the plain
    output and lse, at the UNet's shapes (N = 4,096 and 512, h = 8, d = 96)
    and at d = 128 with Nq != Nk, neither a multiple of 64, twice,
    bit-identical; K3 as the conv's input gradient against
    ``conv3x3x3_bwd_plain``'s dx at the six release shapes with C and O
    swapped; each timed beside its plain version, its bound and the library
    call (cuDNN's backward-data; for K5 the backward of
    ``scaled_dot_product_attention`` with its backend pinned, which computes
    D itself, against K5 plus ``attention_delta``);
11. model check: the release-width UNet on a 16^3 cube, ``train_loss``
    gradients on the card (bf16, K2/K3/K5) against the CPU (f32, plain
    versions), zero-init layers filled: every parameter's gradient finite
    and non-zero, the per-tensor cosines, the worst one gated;
12. training: ``infinicube_tpu_torch.train.main`` on
    ``configs/train_diffusion.yaml`` at full width (750M UNet, bf16 over f32
    parameters, 64^3 cube), batch 1, EMA on, 3 steps: finite losses,
    parameters moved, no skipped step, exact launch counts per step (K3 48
    forward + 47 input-gradient, K2 10, K5 10), the JSONL log, the final
    checkpoint written to a temporary directory and read back;
13. where the time goes: one train step split into forward, backward and
    optimizer + EMA, the whole step under ``torch.profiler``, and peak
    memory, without and with ``remat`` (and at batch 2 with ``remat``).

Then training the sparse structure VAE (the UNet freed first):

14. kernel checks: K4 forward against ``sparse_conv_plain``, K4 as the
    sparse conv's input gradient (on the output gradient, with the pack of
    the reversed, transposed weights and no poison) and K6 (the weight
    gradient) against ``sparse_conv_bwd_plain`` on real grids: phase 9's
    decoded grids and the three levels of a 200,000-point training batch,
    at the VAE's (F, Fo); the plain dW also summed in f64; K6 run twice,
    bit-identical; each timed beside its plain version and its bound (K6's
    3xTF32 bound beside its f32 CUDA-core one, and the rows of the 32-row
    chunks it walks against the present pairs);
15. model check: the release-width VAE on a small scene, ``vae_loss`` and
    every parameter's gradient on the card (K4, K4-dgrad, K6) against the
    CPU (plain versions), same weights and reparametrize noise;
16. training: ``infinicube_tpu_torch.train.main`` on
    ``configs/train_vae.yaml`` with 200,000 points per sample, 3 steps: finite
    losses, parameters moved, no skipped step, exact launch counts per step
    (K4 24, K4-dgrad 24, K6 24), no plain version called, the active voxels
    of every level, the JSONL log, the checkpoint written and read back; then
    ``evaluate_reconstruction`` with the trained weights;
17. where the time goes: one train step split into batch making, plans,
    forward, backward (of it K4-dgrad and K6) and optimizer + EMA, the whole
    step under ``torch.profiler``, and peak memory.

Then int8 serving (the VAE trainer freed first):

18. kernel checks: K7 (the int8 dense conv, on s8 wgmma and TMA) against
    ``conv3x3x3_int8_plain`` at six of the release UNet's 23 int8 shapes at
    CFG batch 2, each input channel with its own range: every output equal,
    two runs bit-identical; timed beside the plain version, its bound, K3
    and cuDNN's bf16 conv3d, and with its quantize prologue; the prologue's
    three kernels (``int8_conv_amax``, ``int8_conv_quantize_x``,
    ``int8_conv_quantize_w``) bit-equal to their plain versions and to
    ``quantize_for_conv`` + ``pad_channels`` + ``pack_int8_weight``, from
    the f32 weights, the CFG pair's halves at other ranges, each timed
    beside its plain version and its byte bound, host-timed and as device
    time alone with its share of that bound (amax beside
    ``torch.linalg.vector_norm`` timed both ways); K8 (int8-PV flash
    attention) against ``int8qkv_attention_plain`` at N = 7,800 and 37,440
    (a scale per 1,536-row block of q and k and per channel of v), timed
    beside K1 on the same inputs, each with its share of its bound;
19. model checks: the release-width UNet's int8 serving twin on a 16^3 cube,
    card against the CPU and against the card's bf16 forward; the 2-layer
    full-width DiT with ``attn_quant="qkv"``, card against the CPU;
20. serving: ``generate_trajectory`` with ``DiffusionConfig(serve_quant=
    True)`` and CFG 2.0 (3 chunks of DDIM-10; per chunk exactly K7 23 x 10
    and as many of each prologue kernel, K3 25 x 10, K2 10 x 10, K4 12, the
    23 derived with the port's rule),
    ``generate_blocks`` over a 2 x 2 tiling with one tile skipped, one chunk
    each through DDPM and DPM++, the single-chunk CLI into a temporary
    directory, and one 17-frame, 4-step video request with int8-PV
    self-attention (K8 240 launches, K1 none);
21. where the time goes: one CFG DDIM step at batch 2, int8 and bf16,
    timed, profiled (with the device time of K7's quantize prologue and of
    K7) and with peak memory; the final-latent cosine of a
    DDIM-10 chunk, int8 against bf16, from the same noise.

Then every width and f32 (the int8 models freed first):

22. kernel checks: the head dims and widths the kernels take only padded,
    through the entry points a model calls, each against its plain version
    at the true width: ``multi_head_attention`` at d = 16, 32 and 48 (bf16
    forward and gradients through K2 and K5, f32 forward through
    ``flash_attn_f32``), ``mha_quantized`` at d = 16 and 96 (K1, K8), and
    ``window_sparse_conv`` at 30 -> 30 and 30 -> 62 (K4, K4-dgrad, K6), their
    launches listed under each kernel's ``padded_widths`` (no path counts
    them); the int8 conv at 16^3, 64 -> 72 and 72 -> 104 (K7 on
    operands zero-padded to multiples of 32) equal to the unpadded
    ``conv3x3x3_int8_plain``; ``conv3x3x3_f32`` (3xTF32 on ``wgmma``)
    against the plain f32 conv (cuDNN, TF32 off) at the six release shapes,
    forward and as dgrad, the split-K shapes twice bit-identical, timed
    beside the plain version, cuDNN's f32 conv3d forward and backward-data,
    its 3xTF32 bound and the f32 CUDA-core bound; ``flash_attn_f32``
    (3xTF32) against the plain f32 attention at the UNet's two
    SelfAttention3D shapes, at Nq != Nk with d = 64 and at the GSM pixel
    branch's SelfAttn2D shape (N = 5,280, 4 heads of 64), the split-keys
    path at N = 512 twice bit-identical, timed beside the plain version,
    its bounds and ``scaled_dot_product_attention`` in f32;
23. model check: the f32 release-width UNet, SelfAttention3D included, on a
    16^3 cube, card against the CPU;
24. the f32 stage-1 path: one chunk of ``evaluation_api`` with the release
    ``DiffusionConfig(dtype=torch.float32)`` UNet on the 64^3 cube (DDIM-2)
    and the release VAE's decode, exactly 96 f32 conv launches, 20 of
    ``flash_attn_f32`` (10 a UNet call) and 12 of K4.

Then stage 2, the guidance buffers, on phase 8's world (saved there with
``save_voxel_world``):

25. checks: ``splat_frame`` for 2 frames at 480x832 and its z-buffer's
    winner slots, card against CPU; the DDA route for 1 frame at 240x416,
    card against CPU (semantic and instance equal on >= 99.9 % of pixels,
    depth within 1e-3 m where the winners agree); splat against DDA
    (depth within 1 m and hit masks, tests/test_buffers.py:110's gates,
    where the splat footprint closes the voxel lattice, and the class
    where both routes see the same voxel);
26. the main path: the CLI (``guidance_buffer_generation.main``) for 93
    frames at 480x832 along the ego path, its six tars of 93 members read
    back through the port's own reader and png decoder equal to the
    buffers; ``generate_buffers_for_world`` with the scene's 4 boxes as
    cars driving; no kernel launched (the stage is plain PyTorch, as the
    reference is XLA);
27. where the time goes: 93 splat frames, one DDA chunk of 8 frames, the
    coordinate buffer, writing the tars and the previews, peak memory, and
    8 splat frames and the DDA chunk under ``torch.profiler``.

Then stage 3, the feed-forward Gaussian scene, on phase 26's world with
its 4 cars driving (ids 10000-10003), written as a stage-2 buffer folder
(six tars, ``world.npz``, the colored semantic buffer as the video):

28. checks, card against CPU: ``render_gaussians`` at 480x832 on 200,000
    gaussians with 3,000 in one tile (over its capacity of 256), color and
    alpha within 1e-3 and depth within 1e-3 relative where alpha > 1e-6,
    on every pixel; ``lift_features``, ``visible_voxel_mask`` and
    ``sample_image_features`` on the world's scene grid (capacity 2^18,
    the reference's cap) from 2 views at 240x416; ``flash_attn_f32`` at
    the pixel branch's bottleneck (B = 4, N = 6,240, 4 heads of 64) and K4
    on the voxel branch's three levels of that grid at their widths, each
    against its plain version at its gate, timed beside it, its bounds
    and (for the attention) ``scaled_dot_product_attention``;
29. model check: the release-width GSM with weights from a random numpy
    parameter tree through ``gsm_from_jax``, 2 views at 240x416 and the
    world's 20,000 voxels nearest the first camera, every pixel decoding,
    card against CPU: every gaussian within 1e-3 of its field's scale
    (beside the same card run with the plain sparse conv in K4's place);
    the CPU's and the card's gaussians each rendered on both devices,
    every pixel within 1e-3; each device's own renders within 1e-3 on
    >= 99.9 % of pixels, or on the share the card's gaussians reach
    against the CPU's when both are rendered on the CPU, less 0.1 %;
30. the main path: ``scene_gaussian_generation.main`` on the folder with
    its defaults (8 views), ``reconstruct_scene`` at the e2e release
    settings (16 frames at stride 6, 16 views, the release crop) with the
    scene grid's dropped voxels, the static and object gaussians written
    and read back (the 4 cars present), and
    ``feedforward_reconstruction.reconstruct`` in dual mode with psnr and
    ssim; exact K4 and ``flash_attn_f32`` launches for each, no other
    kernel;
31. where the time goes: the load, the masks, the static pass split into
    encoder, voxel branch, pixel branch, sky and render, the dynamic pass,
    peak memory, one GSM forward under ``torch.profiler``, and one XUnet
    view chunk with and without cuDNN.

Then training the GSM (stage 3's models freed first):

32. kernel checks: ``flash_attn_f32`` with its log-sum-exp store against
    ``attention_plain``'s output and lse (within 1e-5), then
    ``flash_attn_f32_bwd`` (the f32 flash-attention backward, 3xTF32 on
    tf32 ``wgmma`` fed by TMA; where its 64-row items are fewer than the
    SMs, its streamed axis in ranges, printed) against
    ``attention_bwd_plain`` at the GSM's train shape (3 views, N = 5,280,
    4 heads of 64), at d = 96 and 128 with Nq != Nk and at 37 x 21: dq, dk
    and dv each within 1e-4 * max|ref|, two runs bit-identical; timed
    beside the plain version, its bounds and the f32
    backward of ``scaled_dot_product_attention``; then d = 40 through
    ``multi_head_attention``'s padding with a gradient;
33. the GSM trainer: ``train.main`` on ``configs/train_gsm.yaml`` (the
    release ``GSMConfig``, f32, LPIPS random), 3 steps with exact launches a
    step (K4, K4-dgrad and K6 10 each, ``flash_attn_f32`` 2 with the remat
    recompute, ``flash_attn_f32_bwd`` 1), no plain version called, the
    checkpoint read back; the release-scale step of
    ``benchmarks/bench_gsm_train.py``'s scene built with the port (200,000
    points, a 65,536-slot grid at 0.4 m, 3 views of 480x704) in f32 with
    LPIPS at the 224 crop, 3 steps after a warm-up split into batch,
    forward, backward and optimizer + EMA, peak memory, one step under
    ``torch.profiler``, and one XUnet view chunk forward and backward with
    PyTorch's own convolutions, with cuDNN's and with cuDNN in the backward
    only; the tiny GSM's loss and every gradient, card against CPU, with
    both branches and with the voxel branch off.

Then training the GSM in ``gsm_bf16_config`` (the voxel, pixel and sky
branches in bf16, as ``benchmarks/bench_gsm_train.py`` runs it):

34. kernel checks: ``sparse_conv_bf16`` (forward and, counted as dgrad,
    the input gradient) and ``sparse_conv_bf16_wgrad`` against
    ``sparse_conv_plain`` and ``sparse_conv_bwd_plain`` at the voxel
    branch's seven shapes on the three levels of the bench's 65,536-slot
    grid (64->64, 64->128, 128->128, 128->256, 256->256, 384->128,
    192->64; the work items with a stage, of all the persistent blocks
    walk, printed from ``kernels.sparse_conv_schedule``): every element
    within one bf16 ulp (floor 2^-16 of max|ref|), the bit-equal share
    printed, two runs bit-identical, timed
    beside the plain versions and their bounds (bf16 operations at 989
    TFLOP/s against the bytes), the weight gradient also as device time
    alone (calls queued behind ``torch.cuda._sleep``) with its share of the
    bound; 30->62 through the padding with a gradient; a poisoned batch
    element; the weight gradient on tables its walk over the present (row,
    tap) pairs meets (``kernels.sparse_wgrad_plan``): 3,712 voxels at the
    front of 65,536 slots at the seven shapes, two batch elements of
    unequal fills, taps no row has (their dW exactly 0) and a table with no
    voxel (dW all 0), each twice bit-identical and within one bf16 ulp of
    ``sparse_conv_bwd_plain``; then K2 with its lse store and K5
    in bf16 at the pixel branch's training bottleneck [3, 5,280, 4, 64]
    at their gates, twice bit-identical, beside
    ``scaled_dot_product_attention``;
35. the release-scale step of the bench's scene in ``gsm_bf16_config``:
    3 steps after a warm-up split as phase 33's, exact launches a step
    (the bf16 sparse-conv kernels 10 each, K2 2 with the remat recompute,
    K5 1, no f32 sparse conv or attention), finite losses and gradients,
    f32 gaussians, steps/s, peak memory, one step under
    ``torch.profiler``; then a tiny bf16 GSM's loss and every gradient,
    card against CPU from one init, both branches and the voxel branch
    off: each parameter group's gradient at cosine >= 0.999.

Then the video stage's last three paths (the bf16 GSM freed first):

36. K3 at the Wan VAE's routed conv shapes, each with its 2 history frames,
    against ``conv3x3x3_plain`` at its gate: the five of a release decode
    tile (24 latent frames of 32 x 32), the whole frame's latent level
    [1, 26, 60, 104] 384->384 and one of each level of a 93-frame encode
    tile of 480 x 256; the f32 conv at the decode tile's latent shape;
    each timed beside the plain version, its bound and its share of it,
    and cuDNN's conv3d on the same padded input;
37. the release VAE (``VideoVAEConfig.wan21``, random weights) with
    ``conv_impl="auto"`` and its ``"xla"`` twin on the same weights: a
    decode tile and an encode tile card against card, the routed card
    decode against the CPU's plain routed f32 decode on a cut clip, exact
    K3 launches (28 a decode and 20 an encode call, derived from the
    schedules with the port's rule and printed term by term), a decode
    tile profiled on each route; then the video stage's VAE work on each
    route, the tiled decode of 24 latent frames at 60 x 104 (8 tiles) and
    the two tiled buffer encodes of 93 frames at 480 x 832 (4 tiles each),
    timed with peak memory, the routed one the main path (K3 384);
38. ``decode_streaming_host`` at chunks of 1, 2 and 3 against the
    whole-clip decode at 480 x 832 with 9 latent frames on both routes,
    then the routed streaming decode of 24 latent frames at chunk 2 (the
    main path, K3 28 a chunk), timed with peak memory beside the tiled
    decode;
39. ``WanVideoGenerator.train_loss``: a 2-layer full-width DiT's loss and
    every gradient card (bf16, K2 / K5) against the CPU (f32) with the
    worst cosine gated, then the 30-layer 1.3B DiT at 17 frames @ 480x832
    with AdamW (EMA off): a warm-up step, then 3 steps (the main path, K2
    60 and K5 60 a step exactly) split into forward, backward and
    optimizer, peak memory, one step under ``torch.profiler``.

Then the chained pipeline and stage 3's frozen towers:

40. ``examples.e2e_pipeline.run_pipeline`` at the release profile, cut as
    phases 4 and 8 cut it: the release UNet with the sparse VAE's structure
    decode at DDIM-2, 17 buffer frames at 480x832, the serving video stage
    at 4 steps, the release GSM on 16 views; then
    ``e2e_stage3_resume.resume`` on the artifacts; each stage's seconds
    and peak memory, the artifact set, the resume's gaussians against the
    chain's where it read the chain's frames, exact launches (the ``e2e``
    path of every kernel);
41. on phase 30's 16 views: a release-width GSM with ``encoders=("conv",
    "dav2")`` (``DAv2Config.vits()``) timed with exact launches, the DAv2
    refiner's output card against CPU on one view (cosine >= 0.9999);
    SegFormer b0's sky masks of the 16 frames card against CPU, equal but
    at near ties of the top two logits (within 1e-4), both timed.

Then stage 1's leftovers (the towers freed first):

42. the alternative conditioning at the release width: the condition
    encoders' extra cube on the 64^3 cube from 3 views at 480x832, card
    against CPU in f32, for LSS and for lift3d; the release-width UNet on
    a 16^3 cube with every condition on (in_conv 40 wide, cross-attention
    on a 77 x 768 context, 10 classes), card against CPU at phase 7's gate
    and its int8 twin at phase 19's; ``VoxelDiffusion.sample`` on the
    release 64^3 cube after one ``encode_extra`` (a semantic cube, a
    20,000-point scan, 3 views through LSS, a class and the context), CFG
    2.0 as the doubled batch, DDIM-10, in bf16 and through the int8 twin,
    with seconds a step, peak memory and exact launches a step (K3 48 and
    K2 10; int8: K7 and each prologue kernel 23, K3 25, K2 10), no plain
    version called; ``train.main`` on configs/train_diffusion.yaml with the
    same ``diffusion.*`` keys, batch 1, 3 steps, exact launches a step (K3
    48, K3-dgrad 47, K2 10, K5 10), the UNet moved and the condition
    encoders not (the synthetic stream's conditions are the null ones),
    the checkpoint read back;
43. the sparse side: ``sparse_attention``'s card route (each sample's
    active rows through ``flash_attn_f32`` or K2) against its plain version
    on the CPU at the VAE's level-2 width, f32 and bf16, one sample without
    an active row; the release-width VAE with ``attention_levels=(2,)`` and
    the normal and color heads, loss and every gradient card against CPU;
    ``SparseUNet(SparseUNetConfig())`` card against CPU without and with a
    context; ``train.main`` on configs/train_vae.yaml at 200,000 points
    with those ``vae.*`` keys, 3 steps, exact launches a step (K4,
    K4-dgrad and K6 24 each, ``flash_attn_f32`` 2 and its backward 2) and
    the peak against the 17 GB of one sample's dense level-2 logits;
    ``SparseUNet`` on that scene's hash-tree levels 1-2 timed with exact
    launches (K4 10, ``flash_attn_f32`` 2); one ``conv_backend="brick"``
    VAE forward against the ``ConvPlan`` one.

Then training on real clips (phase 43's models freed first):

44. a Waymo-scale clip from a seeded numpy frame source (8 frames of about
    200,000 LiDAR points with Waymo semantics: road, sidewalk, building
    walls, trees and 6 cars, 2 of them driving; the map polylines; the
    three front cameras at 480x704) through ``waymo2shards.convert_clip``,
    ``process_clip`` (without voxel buffers) and ``generate_voxel_buffers``
    for 2 frames on the card, each timed; ``WaymoClipDataset`` over it with
    the exact sample count; ``knn_bruteforce`` card against CPU, 65,536
    queries against one frame's points (4,096 of them on the CPU):
    distances within 1e-5 relative (or 2 f32 ulps of the terms that
    cancel), the nearest index equal but at top-two ties within 1e-6;
    ``sdf_from_points`` and ``gt_surface_loss`` with their gradients card
    against CPU at cosine >= 0.9999; then ``train.main`` with
    ``data.root`` on the clip, a warm-up step and 3 more each, no plain
    version called, exact launches a step (batch making and step): the
    release VAE (K4, K4-dgrad, K6 24 each), the release UNet at batch 1 on
    the frozen VAE's latents (that VAE's checkpoint; the encode's K4 12,
    K3 48, K3-dgrad 47, K2 10, K5 10), ``scale_factor.json`` within 1e-4
    relative of 1 / numpy's float64 std of the first batch's latents, and the release GSM on the three
    views (phase 33's counts at 3 views); ms a step split into batch
    making and the rest, steps/s as logged, peak GiB. Its launches are the
    ``real_data`` path of every kernel.

Then the released-weights path (phase 44's models freed first):

45. random weights, seeded, in the released Wan2.1 layouts and files: the
    DiT mirror (tests/torch_mirrors) at the published 1.3B widths as one
    f32 ``diffusion_pytorch_model.safetensors`` (written by
    ``write_safetensors``: the machine has no safetensors package), the
    VAE mirror at its release defaults as ``Wan2.1_VAE.pth``, and a
    Wan-layout umt5 at full width but 2 of its 24 blocks in bf16 (its keys
    from names and shapes) as ``models_t5_umt5-xxl-enc-bf16.pth``;
    ``python -m infinicube_tpu_torch.convert`` in a process of its own
    (seconds to read, convert and write each tower, its peak host memory);
    ``WanVideoGenerator.from_checkpoint`` with the serving profile (seconds,
    peak device memory), every loaded tensor equal to the in-memory
    conversion bit for bit; the loaded DiT in f32 against the mirror on one
    latent frame at 480p (1,560 tokens; cosine >= 0.99999, max-abs <= 1e-3
    of max|ref|; ``flash_attn_f32`` 60 launches) and in bf16 (cosine >=
    0.99, max-abs <= 0.1 of max|ref|; K2 60), their launches the
    ``weights_dit`` path; then one request of 93 frames at 480x832, 2
    steps, from the checkpoint with exact launches (K1 and K2 120 each, K3
    0), its phase seconds and peak: the ``weights`` path.

Then sequence and data parallelism and the viewers:

46. (a) ``ops/ring_attention``'s ring of P = 2 and 4 virtual ranks on the
    card (the module's ``ring_forward`` and ``ring_backward``, the exchange
    a rotation of the ranks' blocks) at the 1.3B DiT's release shape
    [1, 37,440, 12, 128] in bf16, and ``ring_attention`` there with no
    group (one block; its backward through autograd), the output and dq,
    dk, dv against one K2 and one K5 call over the whole sequence (cosine
    >= 0.9999, max-abs <= 2e-2 of max|ref|); at N = 4,096 in bf16 and,
    P = 2, f32 against the plain versions (f32: cosine >= 0.99999, max-abs
    <= 1e-4 of max|ref|); a rank's share forward and backward and the
    single calls in device time; exact launches, the ``ring`` path; (b) a
    world-1 NCCL group through a ``file://`` store, the 1.3B DiT at release
    width (random weights, bf16) with ``sp_axis`` over it for one 93-frame
    forward, bit-equal to the local path, K2 60: the ``sp_dit`` path; (c)
    3 steps of the release diffusion trainer (configs/train_diffusion.yaml
    as it is: the 750M UNet at batch 2) through ``train.main`` with RANK=0
    WORLD_SIZE=1 under that group, the losses bit-equal to the same steps
    run before the group came up, exact launches: the ``ddp_train`` path;
    (d) ``render_gaussian_scene`` at 640x480 on 200,000 random gaussians,
    card against CPU (within one step on 99.9 % of the pixels), and
    ``vis_grid`` on a small world: the ``viewers`` path (no kernel).

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
...}``. Any failed check exits non-zero. Without a card it exits 2 and prints
no result."""

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# peaks of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12               # CUDA cores, no tensor cores
PEAK_TF32 = 495e12             # tensor cores; K4 runs 3 TF32 products
HBM_BYTES_S = 3.35e12
H, D = 12, 128                 # the 1.3B DiT's heads
N_SERVE = 5 * 30 * 52          # 17 frames @ 480x832: 7,800 tokens
N_RELEASE = 24 * 30 * 52       # 93 frames @ 480x832: 37,440 tokens
TEXT_LEN = 512
H96, D96 = 8, 96               # the voxel UNet's SelfAttention3D heads
# K3 at the release UNet's shapes: (cube edge, C, O)
K3_SHAPES = ((64, 16, 192), (64, 192, 192), (64, 384, 384),
             (32, 1152, 384), (16, 1536, 768), (8, 1536, 768))
STAGE1_DDIM = 10               # examples/e2e_pipeline.py E2E_DDIM default
# K7's quantize prologue: one launch of each per K7 launch
INT8_PROLOGUE = ("int8_conv_amax", "int8_conv_quantize_x",
                 "int8_conv_quantize_w")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def cuda_ms(fn, warmup=2, iters=10):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters=20):
    """The device's time per call of ``fn`` with the host out of the way:
    ``iters`` calls queued behind ``torch.cuda._sleep``, which keeps the
    card busy while the host issues them, timed by CUDA events from the end
    of the sleep to the end of the last call; NaN where issuing them took
    the host as long as the sleep."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters if host_ms < 5.0 else math.nan


def bound_ms(flops_by_peak, nbytes):
    """(least ms, what sets it): operations over their peak vs bytes over
    the HBM rate, whichever is larger."""
    t_ops = sum(f / p for f, p in flops_by_peak)
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def rand(shape, g, dtype=torch.bfloat16):
    return torch.randn(shape, generator=g, device="cuda", dtype=dtype)


def k2_gate(got, ref, label):
    """K2 against the plain f32 attention: cosine >= 0.9999 and max-abs
    within 2e-2 and within 2e-2 * max|ref| (random q, k make the outputs
    small averages of v, ~sqrt(e / Nk), so an absolute limit alone would be
    loose). Returns the max-abs error."""
    got, ref = got.float(), ref.float()
    c, err = cos(got, ref), (got - ref).abs().max().item()
    lim = 2e-2 * min(1.0, ref.abs().max().item())
    print(f"{label}: cosine {c:.7f} max_abs_err {err:.3e} (limit {lim:.3e})")
    check(c >= 0.9999 and err <= lim, f"{label}: cos {c} err {err}")
    return err


def scale_blocks(x, block, lo, hi):
    """Each block of rows times its own factor, lo to hi, so that every
    quantization block of q and of k gets a different scale."""
    n = x.shape[1]
    f = torch.logspace(math.log10(lo), math.log10(hi), -(-n // block),
                       device=x.device)
    return x * f.repeat_interleave(block)[:n, None, None].to(x.dtype)


def kernel_checks(kernels, att, fa):
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}

    def k1_inputs(n):
        block, npad = fa.quant_blocks(n)
        q = scale_blocks(rand((1, n, H, D), g), block, 0.25, 4.0)
        k = scale_blocks(rand((1, n, H, D), g), block, 4.0, 0.25)
        v = rand((1, n, H, D), g)
        q8, sq = fa.block_quantize(fa.fold_heads(q, npad), block)
        k8, sk = fa.block_quantize(fa.fold_heads(k, npad), block)
        return (q, k, v), (q8, k8, sq, sk, v, block, D ** -0.5)

    def k1_check(got, ref, n):
        c, err = cos(got, ref), (got.float() - ref.float()).abs().max().item()
        print(f"[k1] N={n}: cosine {c:.6f} max_abs_err {err:.3e}")
        check(c >= 0.999, f"K1 cosine {c} at N={n}")
        return err

    def k2_check(got, ref, nq, nk):
        return k2_gate(got, ref, f"[k2] Nq={nq} Nk={nk}")

    # K1 against the plain int8 path: the serving N and a ragged N
    for n in (N_SERVE, 1000):
        (q, k, v), args = k1_inputs(n)
        got = fa.mha_quantized(q, k, v)
        k1_check(got, fa.int8qk_attention_plain(*args), n)

    # K2 against the plain f32 path: cross-attention and a ragged self N
    for nq, nk in ((N_SERVE, TEXT_LEN), (1000, 1000)):
        q, k, v = rand((1, nq, H, D), g), rand((1, nk, H, D), g), \
            rand((1, nk, H, D), g)
        got = att.multi_head_attention(q, k, v)
        k2_check(got, att.attention_plain(q.float(), k.float(), v.float(),
                                          D ** -0.5), nq, nk)

    # kernel times at the serving smoke's shape (17 frames)
    (q, k, v), args = k1_inputs(N_SERVE)
    kv = rand((1, TEXT_LEN, H, D), g)
    print(f"[k1] N={N_SERVE}: kernel "
          f"{cuda_ms(lambda: kernels.flash_attn_int8qk(*args)):.3f} ms; [k2] "
          f"Nq={N_SERVE} Nk={TEXT_LEN}: kernel "
          f"{cuda_ms(lambda: kernels.flash_attn_bf16(q, kv, kv, D ** -0.5)):.4f}"
          f" ms")

    # the release shape: held against the plain versions, then timed
    n = N_RELEASE
    (q, k, v), args = k1_inputs(n)
    k1_err = k1_check(kernels.flash_attn_int8qk(*args),
                      fa.int8qk_attention_plain(*args), n)
    k1_ms = cuda_ms(lambda: kernels.flash_attn_int8qk(*args), 2, 5)
    k1_plain = cuda_ms(lambda: fa.int8qk_attention_plain(*args), 1, 1)
    k1_e2e = cuda_ms(lambda: fa.mha_quantized(q, k, v), 1, 5)
    bh = H
    flops = 2.0 * n * n * D * bh      # each of QK^T (int8) and PV (bf16)
    nbytes = 2 * n * D * bh + 2 * 2 * n * D * bh
    b_ms, b_by = bound_ms([(flops, PEAK_INT8), (flops, PEAK_BF16)], nbytes)
    print(f"[k1] N={n}: kernel {k1_ms:.3f} ms ({2 * flops / k1_ms / 1e9:.1f}"
          f" TFLOP/s, {100 * b_ms / k1_ms:.1f} % of its bound), with quantize"
          f" prologue {k1_e2e:.3f} ms, plain {k1_plain:.1f} ms, bound "
          f"{b_ms:.3f} ms ({b_by}); no single PyTorch call computes it")
    out["flash_attn_int8qk"] = dict(
        name="flash_attn_int8qk", route="cuda",
        source="infinicube_tpu_torch/csrc/flash_attention.cu",
        replaces="infinicube_tpu/ops/flash_attention.py:263",
        max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    del q, k, v, args

    q, k, v = rand((1, n, H, D), g), rand((1, TEXT_LEN, H, D), g), \
        rand((1, TEXT_LEN, H, D), g)
    k2_err = k2_check(kernels.flash_attn_bf16(q, k, v, D ** -0.5),
                      att.attention_plain(q.float(), k.float(), v.float(),
                                          D ** -0.5), n, TEXT_LEN)
    k2_ms = cuda_ms(lambda: kernels.flash_attn_bf16(q, k, v, D ** -0.5))
    k2_plain = cuda_ms(lambda: att.attention_plain(q, k, v, D ** -0.5), 1, 3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt))
    flops = 2.0 * n * TEXT_LEN * D * bh
    nbytes = 2 * 2 * n * D * bh + 2 * 2 * TEXT_LEN * D * bh
    b_ms, b_by = bound_ms([(2 * flops, PEAK_BF16)], nbytes)
    print(f"[k2] Nq={n} Nk={TEXT_LEN}: kernel {k2_ms:.4f} ms, plain "
          f"{k2_plain:.3f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    out["flash_attn_bf16"] = dict(
        name="flash_attn_bf16", route="cuda",
        source="infinicube_tpu_torch/csrc/flash_attention.cu",
        replaces="infinicube_tpu/ops/attention.py:72",
        max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)
    return out


def fill_zero_init(dit, gen, std=0.02):
    """The DiT's head and buffer embedder start at zero, which would make its
    output exactly 0 and hide the attention kernels: fill them."""
    with torch.no_grad():
        for layer in (dit.head, dit.buffer_embed):
            layer.weight.normal_(0.0, std, generator=gen)


def model_check(WanDiT, cfg):
    """Same weights and inputs: 2 layers on the card (K1/K2) vs the CPU
    (plain versions)."""
    gen = torch.Generator().manual_seed(1)
    cpu = WanDiT(cfg, device="cpu").eval().requires_grad_(False)
    cpu.init_params(gen)
    fill_zero_init(cpu, gen)
    cpu.to(torch.bfloat16)
    card = WanDiT(cfg, device="cuda").eval().requires_grad_(False)
    card.to(torch.bfloat16)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    lat = torch.from_numpy(rng.standard_normal((1, 3, 16, 32, 16),
                                               dtype=np.float32))
    buf = torch.from_numpy(rng.standard_normal((1, 3, 16, 32, 32),
                                               dtype=np.float32))
    txt = torch.from_numpy(rng.standard_normal((1, TEXT_LEN, 4096),
                                               dtype=np.float32))
    t = torch.tensor([600.0])
    with torch.no_grad():
        ref = cpu(lat, t, txt, buf)
        got = card(*(x.cuda() for x in (lat, t, txt, buf)))
    torch.cuda.synchronize()
    c = cos(got.cpu(), ref)
    print(f"[model] 2-layer dim-1536 DiT, N={3 * 8 * 16}: card vs cpu "
          f"cosine {c:.6f}, |out| max {ref.abs().max().item():.3f}")
    check(torch.isfinite(got).all().item(), "model output not finite")
    check(c >= 0.999, f"model cosine {c}")


def profile_step(gen, text, null, num_frames, seed):
    """One sequential-CFG denoise step of the DiT under the profiler."""
    T, Hl, Wl = dataclasses.replace(gen.cfg, num_frames=num_frames).latent_thw
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn((1, T, Hl, Wl, 32), generator=g, device="cuda")
    noise = torch.randn((1, T, Hl, Wl, 16), generator=g, device="cuda")
    profile(lambda: gen._denoise(text, null, buf, 1, 5.0, noise=noise),
            f"{num_frames}f CFG step")


def profile(fn, label, shares=None):
    """``fn()`` under ``torch.profiler``: the kernels that take the most
    device time, and the device's busy share of the wall time (the
    profiler's own host cost included); with ``shares`` ({label: kernel
    name parts}) also the device time of the kernels whose names hold one
    of the parts, and its share of the busy time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (host ops also carry their kernels' time);
    # busy time is the union of their intervals
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           n + 1)
    busy_us, last = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy_us += max(0.0, b - max(a, last))
        last = max(last, b)
    busy_ms = busy_us / 1e3
    print(f"[profile] {label}: wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{len(spans)} device events")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile]   {ms:9.2f} ms {100 * ms / busy_ms:5.1f} % "
              f"x{n:<5d} {name[:90]}")
    for what, parts in (shares or {}).items():
        ms = sum(m for name, (m, _) in by_name.items()
                 if any(p in name for p in parts))
        print(f"[profile]   {what}: {ms:.3f} ms, {100 * ms / busy_ms:.2f} % "
              f"of the busy time")


# ---------------------------------------------------------------------------
# stage 1: the voxel-world generator
# ---------------------------------------------------------------------------


def k2_d96_checks(kernels, att):
    """K2 at the UNet's SelfAttention3D shapes against the plain version,
    timed beside it, its bound and ``scaled_dot_product_attention``."""
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for n in (4096, 512):
        q, k, v = (rand((1, n, H96, D96), g) for _ in range(3))
        got = att.multi_head_attention(q, k, v)
        ref = att.attention_plain(q.float(), k.float(), v.float(),
                                  D96 ** -0.5)
        err = k2_gate(got, ref, f"[k2/96] N={n} h={H96}")
        ms = cuda_ms(lambda: kernels.flash_attn_bf16(q, k, v, D96 ** -0.5))
        plain = cuda_ms(lambda: att.attention_plain(q, k, v, D96 ** -0.5),
                        1, 3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = cuda_ms(lambda: torch.nn.functional
                      .scaled_dot_product_attention(qt, kt, vt))
        b_ms, b_by = bound_ms([(4.0 * n * n * D96 * H96, PEAK_BF16)],
                              4 * 2 * n * D96 * H96)
        print(f"[k2/96] N={n}: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
              f"sdpa {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(shape=f"N={n} h={H96} d={D96}", max_abs_err=err,
                         ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib))
    return rows


def k3_checks(kernels, dc):
    """K3 at the release UNet's conv shapes against the plain
    f32-accumulating conv on the same bf16 inputs, timed beside it, its
    bound (2*V*27*C*O at the bf16 peak) and cuDNN's bf16 conv3d
    (channels_last_3d)."""
    g = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for n, C, O in K3_SHAPES:
        x = rand((1, n, n, n, C), g)
        w = (torch.randn((O, C, 3, 3, 3), generator=g, device="cuda") /
             math.sqrt(27 * C)).to(torch.bfloat16)
        b = 0.1 * torch.randn(O, generator=g, device="cuda")
        wp = dc.pack_conv_weight(w)
        got = kernels.conv3x3x3_bf16(x, wp, b).float()
        ref = dc.conv3x3x3_plain(x, w, b).float()
        c, err = cos(got, ref), (got - ref).abs().max().item()
        lim = 2e-2 * ref.abs().max().item()
        shape = f"[1,{n},{n},{n},{C}]->{O}"
        print(f"[k3] {shape}: cosine {c:.7f} max_abs_err {err:.3e} "
              f"(limit {lim:.3e})")
        check(c >= 0.9999 and err <= lim, f"K3 at {shape}: cos {c} err {err}")
        del got, ref
        ms = cuda_ms(lambda: kernels.conv3x3x3_bf16(x, wp, b), 2, 5)
        plain = cuda_ms(lambda: dc.conv3x3x3_plain(x, w, b), 1, 2)
        xl = x.permute(0, 4, 1, 2, 3)
        wl = w.contiguous(memory_format=torch.channels_last_3d)
        bb = b.to(torch.bfloat16)
        lib = cuda_ms(lambda: torch.nn.functional.conv3d(xl, wl, bb,
                                                         padding=1), 2, 5)
        V = n ** 3
        flops = 2.0 * V * 27 * C * O
        b_ms, b_by = bound_ms([(flops, PEAK_BF16)],
                              2 * (V * C + 27 * C * O + V * O) + 4 * O)
        print(f"[k3] {shape}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s), plain {plain:.3f} ms, cudnn {lib:.3f} ms, bound "
              f"{b_ms:.3f} ms ({b_by})")
        rows.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        del x, w, wp, xl, wl
    torch.cuda.empty_cache()
    return rows


def unet_check(VoxelDiffusion, DiffusionConfig):
    """The release-width UNet (4 levels, depth-12 middle transformer) on a
    16^3 cube: card (bf16, K3/K2) against the CPU (f32, plain versions) on
    the same weights, zero-init layers filled."""
    base = DiffusionConfig(cube_dims=(16, 16, 16))
    cpu = VoxelDiffusion(dataclasses.replace(base, dtype=torch.float32),
                         device="cpu")
    cpu.init_params(torch.Generator().manual_seed(7), zero_init_layers=False)
    card = VoxelDiffusion(base, device="cuda")
    card.load_params(cpu.unet.state_dict())
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, 16, 16),
                                             dtype=np.float32))
    t = torch.tensor([500])
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = cpu.unet(x, t)
        cpu_s = time.perf_counter() - t0
        got = card.unet(x.cuda(), t.cuda()).cpu()
    c = cos(got, ref)
    print(f"[model] release-width UNet on 16^3: card vs cpu cosine {c:.6f}, "
          f"|out| max {ref.abs().max().item():.3f} (cpu {cpu_s:.1f} s)")
    check(torch.isfinite(got).all().item(), "UNet output not finite")
    check(c >= 0.999, f"UNet cosine {c}")


def scale_struct_heads(state, factor=20.0):
    """Struct-head weights times ``factor`` (both sides get the same), so
    that no occupancy decision rests on a logit margin near 0."""
    for k in state:
        if k.startswith("struct"):
            state[k] = state[k] * factor
    return state


def vae_check(SparseStructureVAE, SparseVAEConfig):
    """The release-width decoder (f_maps 64) on an 8^3 neck: card (K4)
    against the CPU (plain gather conv) on the same weights: identical grid
    at every level and semantic-logit cosine >= 0.999."""
    cfg = SparseVAEConfig(neck_dims=(8, 8, 8), neck_ijk_min=(-4, -4, -4),
                          capacities=(8192, 4096, 512))
    cpu = SparseStructureVAE(cfg, device="cpu")
    cpu.init_params(torch.Generator().manual_seed(8))
    cpu.load_state_dict(scale_struct_heads(cpu.state_dict()))
    card = SparseStructureVAE(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    z = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 8, 8, 8, 8), dtype=np.float32))
    ref = cpu.decode(z)
    got = card.decode(z.cuda())
    sizes = []
    for lvl, (rg, gg) in enumerate(zip(ref["grids"], got["grids"])):
        same = torch.equal(rg.keys, gg.keys.cpu()) and \
            torch.equal(rg.mask, gg.mask.cpu())
        n_diff = int((rg.keys != gg.keys.cpu()).sum())
        sizes.append(int(rg.mask.sum()))
        check(same, f"VAE grid {lvl} differs in {n_diff} slots")
    m = ref["grid"].mask
    c = cos(got["semantic_logits"].cpu()[m], ref["semantic_logits"][m])
    print(f"[model] release-width VAE decoder on an 8^3 neck: identical "
          f"grids (voxels per level {sizes}), semantic-logit cosine {c:.7f}")
    check(c >= 0.999, f"VAE semantic-logit cosine {c}")


def stage1_scene():
    """The e2e release profile's scene: an 80 m ego path along x, its two
    map polylines (examples/e2e_pipeline.py:123-126) and 4 boxes."""
    ego = np.tile(np.eye(4), (81, 1, 1))
    ego[:, 0, 3] = np.linspace(0, 80, 81)
    maps = {"road_edge": np.stack([np.linspace(0, 80, 200),
                                   np.full(200, -4.0), np.zeros(200)], -1),
            "road_line": np.stack([np.linspace(0, 80, 200),
                                   np.full(200, 4.0), np.zeros(200)], -1)}
    poses = np.tile(np.eye(4), (4, 1, 1))
    poses[:, :3, 3] = [[8.0, -2.0, 0.8], [25.0, 2.0, 0.8],
                       [47.0, -2.0, 0.8], [70.0, 2.0, 0.8]]
    poses[1, :2, :2] = [[0.0, -1.0], [1.0, 0.0]]
    boxes = {"poses": poses, "lwhs": np.array([[4.5, 2.0, 1.6]] * 4)}
    return ego, maps, boxes


def build_stage1(mods, label, **cfg):
    """The release UNet (``DiffusionConfig(**cfg)``) and VAE with random
    weights, the zero-init layers filled."""
    t0 = time.perf_counter()
    diffusion = mods.VoxelDiffusion(mods.DiffusionConfig(**cfg),
                                    device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    diffusion.init_params(g, zero_init_layers=False)
    vae = mods.SparseStructureVAE(mods.SparseVAEConfig(), device="cuda")
    vae.init_params(g)
    n_params = sum(p.numel() for p in diffusion.unet.parameters())
    torch.cuda.synchronize()
    print(f"[{label}] UNet {n_params:,} parameters and the VAE built with "
          f"random weights in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB resident")
    return diffusion, vae


def chunk_launches(diffusion, steps, unet_calls=None):
    """Exact launches of one chunk of ``steps`` sampler steps (one UNet call
    a step; CFG batches its pair) and a VAE decode, derived with the port's
    own rule: one UNet call of the serving twin runs with hooks on its 3x3x3
    convs, and a conv is int8 (K7) where it quantizes and
    ``int8_conv_applies`` holds for its input, else K3."""
    from infinicube_tpu_torch.ops.dense_conv import (Conv3x3x3,
                                                     int8_conv_applies)
    net = diffusion.unet_serve
    seen = []

    def hook(m, args):
        x = args[0]
        seen.append(m.quant and int8_conv_applies(x.shape[:4], x.shape[-1],
                                                  m.weight.shape[0]))
    hooks = [m.register_forward_pre_hook(hook) for m in net.modules()
             if isinstance(m, Conv3x3x3)]
    try:
        D, H, W = diffusion.cfg.cube_dims
        with torch.no_grad():
            net(torch.zeros((2, D, H, W, 16), device="cuda"),
                torch.tensor([500, 500], device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    n_int8 = sum(seen)
    return n_int8, {"conv3x3x3_int8": n_int8 * steps,
                    **{k: n_int8 * steps for k in INT8_PROLOGUE},
                    "conv3x3x3_bf16": (len(seen) - n_int8) * steps,
                    "flash_attn_bf16": 10 * steps, "sparse_conv_f32": 12,
                    "flash_attn_int8qk": 0, "flash_attn_int8qkv": 0,
                    "conv3x3x3_bf16_dgrad": 0, "conv3x3x3_f32": 0,
                    "flash_attn_f32": 0, "flash_attn_f32_bwd": 0}


def run_chunks(kernels, gen, label, run, want, n_chunks):
    """``run()`` (a generation through ``gen``) with the launch counts set to
    0 first; each chunk's launches held to ``want``. Returns the world and
    the run's launches."""
    snaps = []
    sample_chunk = gen._sample_chunk

    def counted_sample_chunk(*a, **kw):
        snaps.append(dict(kernels.launches))
        return sample_chunk(*a, **kw)

    gen._sample_chunk = counted_sample_chunk
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        world = run()
    finally:
        gen._sample_chunk = sample_chunk
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    ends = snaps[1:] + [launches]
    check(len(gen.last_chunks) == n_chunks,
          f"{len(gen.last_chunks)} chunks, want {n_chunks}")
    for i, (chunk, a, b) in enumerate(zip(gen.last_chunks, snaps, ends)):
        delta = {k: b[k] - a[k] for k in b}
        lat = chunk["latents"]
        print(f"[{label}] chunk {i}: sample {chunk['sample_s']:.2f} s, decode "
              f"{chunk['decode_s']:.2f} s, {chunk['merged']} voxels merged, "
              f"overlap {chunk['overlap']} cells, |latents| max "
              f"{lat.abs().max().item():.3f}; launches "
              f"{ {k: v for k, v in delta.items() if v} }")
        check(all(delta[k] == v for k, v in want.items()),
              f"chunk {i} launches {delta}, want {want}")
        check(torch.isfinite(lat).all().item(), f"chunk {i} latents")
        check(i == 0 or chunk["overlap"] > 0, f"chunk {i} has no overlap")
    print(f"[{label}] world: {world.num_voxels} voxels after {wall:.2f} s; "
          f"launches {launches}")
    check(world.num_voxels > 0, "empty world")
    return world, launches


def serve_stage1(kernels, mods, world_path):
    """The main path: 3 chunks of release stage 1, per-chunk launch counts;
    the world is saved to ``world_path`` with the port's
    ``save_voxel_world`` (stage 2's input, phases 25-27)."""
    from infinicube_tpu_torch.inference.guidance_buffer_generation import \
        save_voxel_world
    diffusion, vae = build_stage1(mods, "stage1")
    gen = mods.VoxelWorldGenerator(
        diffusion, mods.vae_decode_fn(vae),
        mods.WorldGenConfig(ddim_steps=STAGE1_DDIM))
    n_int8, want = chunk_launches(diffusion, STAGE1_DDIM)
    check(n_int8 == 0 and want["conv3x3x3_bf16"] == 48 * STAGE1_DDIM,
          f"bf16 serving: {want}")
    ego, maps, boxes = stage1_scene()
    world, launches = run_chunks(
        kernels, gen, "stage1",
        lambda: gen.generate_trajectory(ego, map_points=maps, boxes=boxes,
                                        seed=0), want, 3)
    save_voxel_world(world_path, world)
    print(f"[stage1] world saved: {world.num_voxels} voxels -> {world_path}")
    return diffusion, vae, gen, launches


def stage1_time(profile_fn, diffusion, vae, gen):
    """One DDIM step of the release UNet and one VAE decode, timed, then
    under the profiler. Returns the decode's output (its grids feed the K4
    checks)."""
    ego, maps, boxes = stage1_scene()
    cond = gen._cond_for_chunk(np.eye(4), maps, boxes)
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((1, 64, 64, 64, 8), generator=g, device="cuda")
    t = torch.tensor([500], device="cuda")
    step = lambda: diffusion.denoise(x, t, cond)  # noqa: E731
    step()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    print(f"[stage1] one DDIM step (UNet call on 64^3): {step_ms:.1f} ms, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    profile_fn(step, "stage1 DDIM step")
    latents = gen.last_chunks[-1]["latents"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = vae.decode(latents)
    torch.cuda.synchronize()
    print(f"[stage1] one VAE decode: {(time.perf_counter() - t0) * 1e3:.1f} "
          f"ms, voxels per level "
          f"{[int(gr.mask.sum()) for gr in dec['grids']]}, dropped "
          f"{[int(gr.num_dropped.sum()) for gr in dec['grids']]}")
    profile_fn(lambda: vae.decode(latents), "stage1 VAE decode")
    return dec


def tf32x3_bounds(flops, nbytes):
    """The bound of a 3xTF32 kernel: its 3 TF32 products per f32 product on
    the tensor cores (3 * flops at 495 TFLOP/s) against the bytes, the
    share's yardstick; and beside it the f32 CUDA-core bound (flops at 67
    TFLOP/s). Returns (bound ms, what sets it, CUDA-core bound ms)."""
    b_ms, b_by = bound_ms([(3 * flops, PEAK_TF32)], nbytes)
    return b_ms, b_by, bound_ms([(flops, PEAK_F32)], nbytes)[0]


def sparse_conv_bytes(kind, active, cap, F, Fo, elt, pack):
    """The bytes a sparse conv of ``cap`` slots, ``active`` of them voxels,
    must move with ``elt``-byte features: the gathered operand over the
    active rows only (a padding slot is never a neighbour), the dense
    output over every slot, the nbr table, and ``pack`` bytes of weights
    read (forward, dx) or of dW written. ``kind``: "fwd" reads feats [., F]
    and writes [cap, Fo]; "dx" reads g [., Fo] and writes [cap, F]; "dw"
    reads feats and g over the active rows."""
    rows = {"fwd": active * F + cap * Fo, "dx": active * Fo + cap * F,
            "dw": active * (F + Fo)}[kind]
    return elt * rows + 4 * 27 * cap + pack


def k4_bounds(pairs, F, Fo, nbytes):
    """K4's bounds (``tf32x3_bounds``) for 2 * pairs * F * Fo f32
    operations."""
    flops = 2.0 * pairs * F * Fo
    return (flops, *tf32x3_bounds(flops, nbytes))


def k4_checks(kernels, mods, dec, vcfg):
    """K4 on the decoded grids (capacity 131,072 at 64 -> 64 and 32,768 at
    256 -> 256) against the plain gather version, max-abs <= 1e-4 *
    max|ref|, timed beside it, ``window_sparse_conv`` (the pack made per
    call) and its bounds (``k4_bounds``); then a dense-bounds violation in
    one batch row."""
    g = torch.Generator(device="cuda").manual_seed(10)
    ws = mods.window_conv
    rows = []
    for grid, level, F, Fo in ((dec["grids"][-1], 0, 64, 64),
                               (dec["grids"][0], 2, 256, 256)):
        plan = mods.conv_plan(grid, dense_bounds=vcfg.level_dense_bounds(level))
        cap = grid.capacity
        feats = torch.randn((1, cap, F), generator=g, device="cuda")
        feats = torch.where(grid.mask[..., None], feats, 0.0)
        w = torch.randn((27, F, Fo), generator=g, device="cuda") / \
            math.sqrt(27 * F)
        pack = ws.pack_sparse_weight(w)
        got = kernels.sparse_conv_f32(feats, plan.nbr, pack, plan.violations)
        ref = ws.sparse_conv_plain(plan, feats, w)
        err = (got - ref).abs().max().item()
        lim = 1e-4 * ref.abs().max().item()
        shape = f"{cap} x ({F}->{Fo})"
        pairs = int((plan.nbr >= 0).sum())
        print(f"[k4] {shape}: {int(grid.mask.sum())} voxels, {pairs} "
              f"neighbour pairs; max_abs_err {err:.3e} (limit {lim:.3e})")
        check(err <= lim, f"K4 at {shape}: err {err}")
        ms = cuda_ms(lambda: kernels.sparse_conv_f32(feats, plan.nbr, pack,
                                                     plan.violations), 2, 5)
        with torch.no_grad():
            call_ms = cuda_ms(lambda: ws.window_sparse_conv(plan, feats, w),
                              2, 5)
        plain = cuda_ms(lambda: ws.sparse_conv_plain(plan, feats, w), 1, 2)
        flops, b_ms, b_by, f32_ms = k4_bounds(
            pairs, F, Fo, sparse_conv_bytes(
                "fwd", int(grid.mask.sum()), cap, F, Fo, 4, 8 * 27 * F * Fo))
        print(f"[k4] {shape}: kernel {ms:.3f} ms ({flops / ms / 1e9:.2f} "
              f"TFLOP/s of f32 work, {100 * b_ms / ms:.1f} % of its bound), "
              f"with the pack made per call {call_ms:.3f} ms, plain "
              f"{plain:.3f} ms, bound {b_ms:.3f} ms ({b_by}, 3 TF32 products"
              f" at 495 TFLOP/s; the f32 CUDA-core bound {f32_ms:.3f} ms)")
        rows.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None,
                         f32_core_bound_ms=f32_ms, per_call_pack_ms=call_ms))
    # batch row 1 is row 0 moved outside the level-2 dense bounds
    grid = dec["grids"][0]
    ijk = torch.stack([grid.ijk[0], grid.ijk[0] + torch.tensor(
        [600, 0, 0], dtype=torch.int32, device="cuda")])
    g2 = mods.grid_from_ijk(ijk, grid.mask.expand(2, -1), grid.voxel_size,
                            grid.origin, grid.capacity)
    plan = mods.conv_plan(g2, dense_bounds=vcfg.level_dense_bounds(2))
    viol = plan.violations.tolist()
    check(viol[0] == 0 and viol[1] > 0, f"violations {viol}")
    feats = torch.randn((2, grid.capacity, 32), generator=g, device="cuda")
    w = torch.randn((27, 32, 32), generator=g, device="cuda") / 30.0
    out = kernels.sparse_conv_f32(feats, plan.nbr, ws.pack_sparse_weight(w),
                                  plan.violations)
    ref = ws.sparse_conv_plain(plan, feats, w)
    err = (out[0] - ref[0]).abs().max().item()
    check(torch.isnan(out[1]).all().item() and
          torch.isfinite(out[0]).all().item() and
          err <= 1e-4 * ref[0].abs().max().item(),
          f"dense-bounds poison: row 1 NaN {torch.isnan(out[1]).all()}, "
          f"row 0 err {err}")
    print(f"[k4] dense-bounds violation ({viol[1]} voxels in row 1): row 1 "
          f"all NaN, row 0 within the gate (err {err:.2e})")
    return rows


def entry(name, source, replaces, rows, headline):
    """One kernel of the summary line: the headline shape's numbers (and
    a 3xTF32 kernel's f32 CUDA-core bound beside its bound), the largest
    error over all shapes, and every shape's numbers."""
    e = dict(rows[headline])
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms") + \
        (("f32_core_bound_ms",) if "f32_core_bound_ms" in e else ())
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                **{k: e[k] for k in keys}, headline_shape=e["shape"],
                shapes=rows)


def stage1(kernels, att, dense_conv, world_path):
    """Phases 6-9. Returns the summary entries of K3 and K4 (and K2's d=96
    rows), the launch counts of the stage-1 main path and the decoded grids
    of phase 9 (coarsest first); phase 8's world goes to ``world_path``."""
    from infinicube_tpu_torch.grid.build import grid_from_ijk
    from infinicube_tpu_torch.inference.voxel_world_generation import (
        VoxelWorldGenerator, WorldGenConfig, vae_decode_fn)
    from infinicube_tpu_torch.models.diffusion.model import (DiffusionConfig,
                                                             VoxelDiffusion)
    from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                       SparseVAEConfig)
    from infinicube_tpu_torch.nn.sparse import conv_plan
    from infinicube_tpu_torch.ops import window_conv
    mods = types.SimpleNamespace(
        VoxelDiffusion=VoxelDiffusion, DiffusionConfig=DiffusionConfig,
        SparseStructureVAE=SparseStructureVAE,
        SparseVAEConfig=SparseVAEConfig,
        VoxelWorldGenerator=VoxelWorldGenerator,
        WorldGenConfig=WorldGenConfig, vae_decode_fn=vae_decode_fn,
        conv_plan=conv_plan, grid_from_ijk=grid_from_ijk,
        window_conv=window_conv)
    # ---- 6. kernel checks -----------------------------------------------------
    k2_rows = k2_d96_checks(kernels, att)
    k3_rows = k3_checks(kernels, dense_conv)
    # ---- 7. model checks ------------------------------------------------------
    unet_check(VoxelDiffusion, DiffusionConfig)
    vae_check(SparseStructureVAE, SparseVAEConfig)
    # ---- 8. serving stage 1: the main path --------------------------------
    diffusion, vae, sgen, stage1_launches = serve_stage1(kernels, mods,
                                                         world_path)
    # ---- 9. where the time goes; K4 on the decoded grids ------------------
    dec = stage1_time(profile, diffusion, vae, sgen)
    k4_rows = k4_checks(kernels, mods, dec, vae.cfg)

    return {"flash_attn_bf16": k2_rows,
            "conv3x3x3_bf16": entry(
                "conv3x3x3_bf16", "infinicube_tpu_torch/csrc/dense_conv.cu",
                "infinicube_tpu/ops/dense_conv.py:177", k3_rows, 1),
            "sparse_conv_f32": entry(
                "sparse_conv_f32", "infinicube_tpu_torch/csrc/sparse_conv.cu",
                "infinicube_tpu/ops/window_conv.py:222", k4_rows, 1)}, \
        stage1_launches, dec["grids"]


# ---------------------------------------------------------------------------
# training the voxel diffusion model
# ---------------------------------------------------------------------------

# the sparse conv's bf16 kernels, which only the GSM in gsm_bf16_config runs
BF16_SPARSE = {"sparse_conv_bf16": 0, "sparse_conv_bf16_dgrad": 0,
               "sparse_conv_bf16_wgrad": 0}
# per train step at batch 1 without remat: every 3x3x3 conv forward (48), its
# input gradient except in_conv's (47), every SelfAttention3D forward and
# backward (10 each); remat runs the 22 ResBlocks' two convs once more
STEP_LAUNCHES = {"conv3x3x3_bf16": 48, "conv3x3x3_bf16_dgrad": 47,
                 "flash_attn_bf16": 10, "flash_attn_bf16_bwd": 10,
                 "flash_attn_int8qk": 0, "sparse_conv_f32": 0,
                 "sparse_conv_f32_dgrad": 0, "sparse_conv_f32_wgrad": 0,
                 "conv3x3x3_int8": 0, "flash_attn_int8qkv": 0,
                 **{k: 0 for k in INT8_PROLOGUE},
                 "conv3x3x3_f32": 0, "flash_attn_f32": 0,
                 "flash_attn_f32_bwd": 0, **BF16_SPARSE}
REMAT_EXTRA_K3 = 44
TRAIN_STEPS = 3


def gate(got, ref, label):
    """cosine >= 0.9999 and max-abs within 2e-2 of the largest reference
    value. Returns the max-abs error."""
    got, ref = got.float(), ref.float()
    c, err = cos(got, ref), (got - ref).abs().max().item()
    lim = 2e-2 * ref.abs().max().item()
    print(f"{label}: cosine {c:.7f} max_abs_err {err:.3e} (limit {lim:.3e})")
    check(torch.isfinite(got).all().item(), f"{label}: not finite")
    check(c >= 0.9999 and err <= lim, f"{label}: cos {c} err {err}")
    return err


def sdpa_backward_ms(q, k, v, do):
    """The backward of ``scaled_dot_product_attention`` on the same inputs,
    its backend pinned (``torch.nn.attention.sdpa_kernel``): flash where it
    takes the shape, else the memory-efficient one. SDPA's backward computes
    D = sum(o * do) itself, so it is the yardstick of K5 plus
    ``attention_delta``. Returns (ms, the backend's name)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend):
                out = torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt)
            return cuda_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True)), backend.name
        except RuntimeError:
            continue
    raise RuntimeError("no pinned SDPA backend takes this shape")


def k5_checks(kernels, att):
    """K2 with the log-sum-exp store (the variant the training forward
    launches) against ``attention_plain``'s output and lse, then K5 against
    ``attention_bwd_plain`` on the plain f32 output and lse, so that neither
    side of K5's gate takes anything from K2, run twice (bit-identical); K5
    timed beside the plain version, its bound (10*Nq*Nk*d*B*h bf16
    operations) and, with ``attention_delta`` on its side, the pinned
    backward of ``scaled_dot_product_attention``."""
    g = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for nq, nk, h, d in ((4096, 4096, H96, D96), (512, 512, H96, D96),
                         (1000, 777, H, D)):
        q, k, v, do = (rand((1, n, h, d), g) for n in (nq, nk, nk, nq))
        scale = d ** -0.5
        shape = f"Nq={nq} Nk={nk} h={h} d={d}"
        o, lse = kernels.flash_attn_bf16(q, k, v, scale, return_lse=True)
        ref_o, ref_lse = att.attention_plain(q.float(), k.float(), v.float(),
                                             scale, return_lse=True)
        o_err = k2_gate(o, ref_o, f"[k5] {shape} K2 with the lse store, o")
        lse_err = (lse - ref_lse).abs().max().item()
        print(f"[k5] {shape} K2 with the lse store, lse: max_abs_err "
              f"{lse_err:.3e} (limit 1.000e-03)")
        check(lse.shape == (1, h, nq) and lse.dtype == torch.float32 and
              lse_err <= 1e-3, f"{shape}: lse {lse.shape} err {lse_err}")
        ref_delta = att.attention_delta(ref_o, do)
        got = kernels.flash_attn_bf16_bwd(q, k, v, do, ref_lse, ref_delta,
                                          scale)
        ref = att.attention_bwd_plain(q.float(), k.float(), v.float(),
                                      ref_o, do.float(), ref_lse, scale)
        err = max(gate(a, b, f"[k5] {shape} d{name}")
                  for a, b, name in zip(got, ref, "qkv"))
        again = kernels.flash_attn_bf16_bwd(q, k, v, do, ref_lse, ref_delta,
                                            scale)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"[k5] {shape}: two runs differ")
        del ref_o, ref_lse, ref_delta, ref, again
        delta = att.attention_delta(o, do)
        ms = cuda_ms(lambda: kernels.flash_attn_bf16_bwd(q, k, v, do, lse,
                                                         delta, scale))
        delta_ms = cuda_ms(lambda: att.attention_delta(o, do))
        fwd_ms = cuda_ms(lambda: kernels.flash_attn_bf16(q, k, v, scale))
        fwd_lse_ms = cuda_ms(lambda: kernels.flash_attn_bf16(
            q, k, v, scale, return_lse=True))
        with_delta = cuda_ms(lambda: kernels.flash_attn_bf16_bwd(
            q, k, v, do, lse, att.attention_delta(o, do), scale))
        plain = cuda_ms(lambda: att.attention_bwd_plain(q, k, v, o, do, lse,
                                                        scale), 1, 3)
        lib, backend = sdpa_backward_ms(q, k, v, do)
        flops = 10.0 * nq * nk * d * h
        nbytes = 2 * d * h * (3 * nq + 4 * nk) + 2 * 4 * h * nq
        b_ms, b_by = bound_ms([(flops, PEAK_BF16)], nbytes)
        print(f"[k5] {shape}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s of the 5 products counted, {100 * b_ms / ms:.1f} % "
              f"of its bound), delta {delta_ms:.4f} ms, kernel + delta "
              f"{with_delta:.4f} ms, plain {plain:.3f} ms, sdpa backward "
              f"({backend}, pinned) {lib:.4f} ms: kernel + delta / sdpa "
              f"{with_delta / lib:.2f}x; bound {b_ms:.4f} ms ({b_by}); K2 "
              f"forward {fwd_ms:.4f} ms, with the lse store "
              f"{fwd_lse_ms:.4f} ms")
        rows.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                         library_backend=backend, delta_ms=delta_ms,
                         with_delta_ms=with_delta, k2_ms=fwd_ms,
                         k2_with_lse_ms=fwd_lse_ms,
                         k2_with_lse_o_max_abs_err=o_err,
                         k2_with_lse_max_abs_err=lse_err))
    return rows


def k3_dgrad_checks(kernels, dc):
    """K3 on the output gradient with the flipped, in/out-swapped pack and no
    bias, against the dx of ``conv3x3x3_bwd_plain`` on the same bf16 values,
    at the release convs' shapes (n, C, O: the forward conv is C -> O, the
    input gradient O -> C); timed beside the plain dx (an f32 conv), its
    bound (2*V*27*C*O at the bf16 peak) and cuDNN's bf16 backward-data."""
    g = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for n, C, O in K3_SHAPES:
        x = rand((1, n, n, n, C), g)
        w = (torch.randn((O, C, 3, 3, 3), generator=g, device="cuda") /
             math.sqrt(27 * C)).to(torch.bfloat16)
        go = rand((1, n, n, n, O), g)
        wp = dc.pack_conv_weight(dc.dgrad_weight(w))
        got = kernels.conv3x3x3_bf16(go, wp, None)
        ref = dc.conv3x3x3_bwd_plain(x, w, go)[0]
        shape = f"[1,{n},{n},{n},{O}]->{C}"
        err = gate(got, ref, f"[k3 dgrad] {shape}")
        del got, ref
        ms = cuda_ms(lambda: kernels.conv3x3x3_bf16(go, wp, None), 2, 5)
        wd, zero = dc.dgrad_weight(w), torch.zeros(C, device="cuda")
        plain = cuda_ms(lambda: dc.conv3x3x3_plain(go, wd, zero), 1, 2)
        gl, xl = go.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3)
        wl = w.contiguous(memory_format=torch.channels_last_3d)
        lib = cuda_ms(lambda: torch.ops.aten.convolution_backward(
            gl, xl, wl, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False,
            [0, 0, 0], 1, [True, False, False]), 2, 5)
        V = n ** 3
        flops = 2.0 * V * 27 * C * O
        b_ms, b_by = bound_ms([(flops, PEAK_BF16)],
                              2 * (V * C + 27 * C * O + V * O))
        print(f"[k3 dgrad] {shape}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f}"
              f" TFLOP/s), plain {plain:.3f} ms, cudnn backward-data "
              f"{lib:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
        rows.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        del x, w, go, wp, wd, gl, xl, wl
    torch.cuda.empty_cache()
    return rows


def train_grad_check(mods):
    """``train_loss`` gradients of the release-width UNet on a 16^3 cube:
    card (bf16, kernels) against the CPU (f32, plain versions), same weights
    (zero-init layers filled), batch and draws."""
    base = mods.DiffusionConfig(cube_dims=(16, 16, 16))
    cpu = mods.VoxelDiffusion(dataclasses.replace(base, dtype=torch.float32),
                              device="cpu", trainable=True)
    cpu.init_params(torch.Generator().manual_seed(13),
                    zero_init_layers=False)
    card = mods.VoxelDiffusion(base, device="cuda", trainable=True)
    card.load_params(cpu.unet.state_dict())
    rng = np.random.default_rng(13)
    B = 2
    lat = torch.from_numpy(rng.standard_normal((B, 16, 16, 16, 8),
                                               dtype=np.float32))
    noise = torch.from_numpy(rng.standard_normal((B, 16, 16, 16, 8),
                                                 dtype=np.float32))
    cond = mods.CondCubes(
        torch.from_numpy((rng.random((B, 16, 16, 16, 3)) < 0.1)
                         .astype(np.float32)),
        torch.from_numpy(rng.standard_normal((B, 16, 16, 16, 2),
                                             dtype=np.float32)))
    draws = dict(t=torch.tensor([700, 150]), noise=noise,
                 drop=(torch.tensor([False, True]),
                       torch.tensor([False, False])))
    losses = {}
    for name, model in (("cpu", cpu), ("card", card)):
        t0 = time.perf_counter()
        loss, _ = model.train_loss(lat, cond, **draws)
        loss.backward()
        losses[name] = (loss.item(), time.perf_counter() - t0)
    grads_cpu = {k: p.grad for k, p in cpu.named_parameters().items()}
    # A key bias shifts every logit of a query alike, so the softmax does not
    # see it: the gradient of each self_k.bias is exactly zero and both sides
    # hold rounding noise there (bf16 noise on the card). Such tensors
    # (reference below 1e-6 of the largest gradient) must be finite on the
    # card; all others must be non-zero and are held by their cosine.
    g_max = max(gr.abs().max().item() for gr in grads_cpu.values())
    floor = 1e-6 * g_max
    cosines, zero, bad = {}, {}, []
    for k, p in card.named_parameters().items():
        gr = p.grad
        if gr is None or not torch.isfinite(gr).all():
            bad.append(k)
        elif grads_cpu[k].abs().max().item() < floor:
            zero[k] = gr.abs().max().item()
        elif not gr.any():
            bad.append(k)
        else:
            cosines[k] = cos(gr.cpu(), grads_cpu[k])
    check(not bad, f"parameters without a finite, non-zero gradient: {bad}")
    check(all(k.endswith("self_k.bias") for k in zero),
          f"zero reference gradients: {zero}")
    order = sorted(cosines, key=cosines.get)
    vals = np.array([cosines[k] for k in order])
    print(f"[model] release-width UNet on 16^3, train_loss: loss card "
          f"{losses['card'][0]:.6f} vs cpu {losses['cpu'][0]:.6f} (cpu "
          f"{losses['cpu'][1]:.1f} s); {len(cosines)} parameter tensors "
          f"with finite, non-zero gradients and {len(zero)} whose gradient "
          f"is zero by construction (the key biases; on the card at most "
          f"{max(zero.values()) / g_max:.1e} of the largest gradient); "
          f"gradient cosine card vs cpu: median {np.median(vals):.6f}, 1st percentile "
          f"{np.percentile(vals, 1):.6f}, worst {vals[0]:.6f}")
    for k in order[:6]:
        print(f"[model]   cosine {cosines[k]:.6f}  {k} "
              f"(|g| max {grads_cpu[k].abs().max().item():.3e})")
    check(abs(losses["card"][0] - losses["cpu"][0]) <=
          2e-2 * abs(losses["cpu"][0]), f"loss {losses}")
    check(vals[0] >= 0.99, f"worst gradient cosine {vals[0]} ({order[0]})")
    return float(vals[0])


def counting_steps(kernels, loop):
    """Make ``loop.make_train_step`` record every step's launches. Returns
    (the list they go to, the function that undoes the patch)."""
    per_step, make_step = [], loop.make_train_step

    def counted_make_step(*args):
        step = make_step(*args)

        def counted(state, generator, batch):
            before = dict(kernels.launches)
            out = step(state, generator, batch)
            per_step.append({k: v - before[k]
                             for k, v in kernels.launches.items()})
            return out
        return counted

    loop.make_train_step = counted_make_step

    def undo():
        loop.make_train_step = make_step
    return per_step, undo


def train_main_path(kernels):
    """The trainer's CLI path at full width: 3 optimizer steps at batch 1."""
    from infinicube_tpu_torch import train as train_cli
    from infinicube_tpu_torch.training import loop
    from infinicube_tpu_torch.training.checkpoint import CheckpointManager
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    per_step, undo = counting_steps(kernels, loop)
    try:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train_cli.main(
            [os.path.join(ROOT, "configs", "train_diffusion.yaml"), "--name",
             "smoke", "--logdir", tmp, "--exec", "batch_size=1",
             f"max_steps={TRAIN_STEPS}", "log_every=1",
             f"ckpt_dir={tmp}/ck"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_params = sum(p.numel() for p in state.params.values())
        check(n_params == 750_431_048, f"{n_params} parameters")
        logs = [json.loads(line) for line in
                open(os.path.join(tmp, "smoke.jsonl"))]
        print(f"[train] {n_params:,} parameters, {TRAIN_STEPS} steps at "
              f"batch 1 through train.main in {wall:.1f} s (model build, "
              f"steps and the final checkpoint), peak {peak:.1f} GiB")
        check(len(logs) == TRAIN_STEPS and
              [r["step"] for r in logs] == list(range(1, TRAIN_STEPS + 1)),
              f"JSONL log {logs}")
        for r, delta in zip(logs, per_step):
            print(f"[train] step {r['step']}: loss {r['loss']:.6f}, "
                  f"grad_finite {r['grad_finite']:.0f}, "
                  f"{r['steps_per_sec']:.3f} steps/s; launches {delta}")
            check(math.isfinite(r["loss"]) and r["grad_finite"] == 1.0,
                  f"step {r['step']}: {r}")
            check(delta == STEP_LAUNCHES,
                  f"step {r['step']} launches {delta}, want {STEP_LAUNCHES}")
        check(len(per_step) == TRAIN_STEPS, f"{len(per_step)} steps counted")
        check(state.step == TRAIN_STEPS and state.num_nan_skips == 0,
              f"step {state.step}, {state.num_nan_skips} skipped")
        # the true initialiser: the parameters the EMA shadow lags behind
        # are the ones that moved
        moved = [k for k, p in state.params.items()
                 if not torch.equal(p.detach(), state.ema.params[k])]
        print(f"[train] {len(moved)} of {len(state.params)} parameter "
              f"tensors moved in {TRAIN_STEPS} steps from the zero-init "
              f"start (out_conv first)")
        check("out_conv.weight" in moved and len(moved) > 1,
              f"parameters moved: {moved[:5]}")
        mgr = CheckpointManager(os.path.join(tmp, "ck"))
        check(mgr.all_steps() == [TRAIN_STEPS], f"steps {mgr.all_steps()}")
        size = os.path.getsize(mgr._path(TRAIN_STEPS))
        t0 = time.perf_counter()
        sd = mgr.restore()
        read_s = time.perf_counter() - t0
        same = all(torch.equal(sd["params"][k], p.detach()) and
                   torch.equal(sd["ema"]["params"][k], state.ema.params[k])
                   for k, p in state.params.items())
        mu, _ = state.moments()
        same = same and all(torch.equal(sd["mu"][k], m)
                            for k, m in mu.items())
        print(f"[train] final checkpoint: {size / 1e9:.2f} GB, read back in "
              f"{read_s:.1f} s, parameters, moments and EMA "
              f"{'identical' if same else 'DIFFER'}")
        check(same and sd["step"] == TRAIN_STEPS, "checkpoint differs")
        del sd
    finally:
        undo()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[train] main path launches {launches}")
    return launches


def train_time(kernels, mods, dense_conv):
    """One train step of the release UNet split into its parts (and the
    time its backward spends in the plain-PyTorch dW tap products), then
    under the profiler, without and with remat; peak memory incl. batch 2."""
    from infinicube_tpu_torch.training.state import (TrainConfig, TrainState,
                                                     grads_finite,
                                                     make_train_step)
    cfg = TrainConfig()
    model = mods.VoxelDiffusion(mods.DiffusionConfig(), device="cuda",
                                trainable=True)
    g = torch.Generator(device="cuda").manual_seed(14)
    model.init_params(g, zero_init_layers=False)
    state = TrainState.create(cfg, model.named_parameters())
    params = state.params

    def batch(B):
        return (torch.randn((B, 64, 64, 64, 8), generator=g, device="cuda"),
                mods.CondCubes.null(B, model.cfg, "cuda"))

    def loss_fn(p, gen, b):
        return model.train_loss(*b, generator=gen, params=p)

    step_fn = make_train_step(cfg, loss_fn)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def optimize():
        finite = grads_finite([p.grad for p in params.values()])
        torch.nn.utils.clip_grad_value_(list(params.values()),
                                        cfg.grad_clip_value)
        state.opt.step()
        state.ema.update(params, cfg.ema_decay, apply=finite)
        return finite

    # CUDA events around every conv_weight_grad call of one backward
    wgrad, spans = dense_conv.conv_weight_grad, []

    def timed_wgrad(x, go):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        dw = wgrad(x, go)
        ev[1].record()
        spans.append(ev)
        return dw

    out = {}
    for remat, B in ((False, 1), (True, 1), (True, 2)):
        model.unet.remat = remat
        label = f"batch {B}{' remat' if remat else ''}"
        b = batch(B)
        for _ in range(2):                           # warm-up
            step_fn(state, g, b)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        _, step_ms = timed(lambda: step_fn(state, g, b))
        counts = dict(kernels.launches)
        _, more_ms = timed(lambda: [step_fn(state, g, b) for _ in range(2)])
        step_ms = (step_ms + more_ms) / 3            # mean of 3 steps
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = dict(STEP_LAUNCHES)
        want["conv3x3x3_bf16"] += REMAT_EXTRA_K3 if remat else 0
        check(counts == want, f"{label}: launches {counts}, want {want}")
        for p in params.values():
            p.grad = None
        (loss, _), fwd_ms = timed(lambda: loss_fn(params, g, b))
        dense_conv.conv_weight_grad = timed_wgrad
        try:
            _, bwd_ms = timed(loss.backward)
        finally:
            dense_conv.conv_weight_grad = wgrad
        dw_ms = sum(a.elapsed_time(b_) for a, b_ in spans)
        check(len(spans) == 48, f"{len(spans)} conv weight gradients")
        spans.clear()
        finite, opt_ms = timed(optimize)
        del loss
        print(f"[train time] {label}: step {step_ms:.1f} ms "
              f"({1e3 / step_ms:.2f} steps/s), peak {peak:.1f} GiB; split "
              f"forward {fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms (of it "
              f"{dw_ms:.1f} ms in the 48 convs' dW tap products), clip + "
              f"AdamW + EMA + finiteness {opt_ms:.1f} ms (finite {finite}); "
              f"launches {counts}")
        out[label] = dict(step_ms=step_ms, peak_gib=peak, forward_ms=fwd_ms,
                          backward_ms=bwd_ms, wgrad_ms=dw_ms,
                          optimizer_ms=opt_ms)
        if B == 1:
            profile(lambda: step_fn(state, g, b), f"train step, {label}")
    return out


def diffusion_train(kernels, att, dense_conv):
    """Phases 10-13. Returns the summary entries of K5 and K3-dgrad and the
    launch counts of the training main path."""
    from infinicube_tpu_torch.models.diffusion.model import (CondCubes,
                                                             DiffusionConfig,
                                                             VoxelDiffusion)
    mods = types.SimpleNamespace(VoxelDiffusion=VoxelDiffusion,
                                 DiffusionConfig=DiffusionConfig,
                                 CondCubes=CondCubes)
    k5_rows = k5_checks(kernels, att)
    dgrad_rows = k3_dgrad_checks(kernels, dense_conv)
    train_grad_check(mods)
    torch.cuda.empty_cache()
    launches = train_main_path(kernels)
    torch.cuda.empty_cache()
    train_time(kernels, mods, dense_conv)
    return {"flash_attn_bf16_bwd": entry(
                "flash_attn_bf16_bwd",
                "infinicube_tpu_torch/csrc/flash_attention_bwd.cu",
                "infinicube_tpu/ops/attention.py:72", k5_rows, 0),
            "conv3x3x3_bf16_dgrad": entry(
                "conv3x3x3_bf16_dgrad",
                "infinicube_tpu_torch/csrc/dense_conv.cu",
                "infinicube_tpu/ops/dense_conv.py:302", dgrad_rows, 1)}, \
        launches


# ---------------------------------------------------------------------------
# training the sparse structure VAE
# ---------------------------------------------------------------------------

# per train step: every SparseConv3d forward (6 encoder and 6 decoder
# SparseResBlocks, two convs each), its input gradient and its weight gradient
VAE_STEP_LAUNCHES = {"sparse_conv_f32": 24, "sparse_conv_f32_dgrad": 24,
                     "sparse_conv_f32_wgrad": 24, "conv3x3x3_bf16": 0,
                     "conv3x3x3_bf16_dgrad": 0, "flash_attn_bf16": 0,
                     "flash_attn_bf16_bwd": 0, "flash_attn_int8qk": 0,
                     "conv3x3x3_int8": 0, "flash_attn_int8qkv": 0,
                     "conv3x3x3_f32": 0, "flash_attn_f32": 0,
                     "flash_attn_f32_bwd": 0,
                     **{k: 0 for k in INT8_PROLOGUE}, **BF16_SPARSE}
VAE_POINTS = 200_000


def vae_points(seed, n=VAE_POINTS, batch=1):
    """The synthetic stream's kind of sample: uniform points in a +-5 m cube
    with random labels (``train.build_vae``)."""
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-5, 5, (batch, n, 3)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 23, (batch, n)).astype(
        np.int32))
    return pts, labels


def sparse_bwd_checks(kernels, mods, dec_grids, vcfg):
    """K4 as the input gradient and K6 against ``sparse_conv_bwd_plain`` on
    the decoded grids of the stage-1 part and on the three levels of a
    200,000-point training batch. Gates: dx max-abs <= 1e-4 * max|ref|, dW
    max-abs <= 5e-4 * max|ref| (a dW element sums up to 10^5 products in f32,
    in another order than the plain version's matmul; its distance from the
    plain version summed in f64 is printed beside); K6 twice, bit-identical.
    Timed beside the plain versions and the bounds (``k4_bounds``: 2 *
    present (row, tap) pairs * F * Fo as 3 TF32 products at 495 TFLOP/s
    against the bytes, the f32 CUDA-core bound beside), with the rows of the
    32-row chunks K6 walks (those where some row has the tap) against the
    pairs."""
    g = torch.Generator(device="cuda").manual_seed(15)
    ws = mods.window_conv
    pts, _ = vae_points(15)
    tree = mods.build_hash_tree(vcfg, pts.cuda(), torch.ones(
        (1, VAE_POINTS), dtype=torch.bool, device="cuda"))
    cases = [("decoded", dec_grids[-1], 0, 64, 64),
             ("decoded", dec_grids[0], 2, 256, 256),
             ("batch", tree[0], 0, 32, 64), ("batch", tree[0], 0, 64, 64),
             ("batch", tree[1], 1, 128, 128), ("batch", tree[1], 1, 256, 128),
             ("batch", tree[2], 2, 256, 256)]
    dx_rows, dw_rows = [], []
    for origin, grid, level, F, Fo in cases:
        plan = mods.conv_plan(grid,
                              dense_bounds=vcfg.level_dense_bounds(level))
        check(int(plan.violations.sum()) == 0, f"{origin} level {level}: "
              f"violations {plan.violations.tolist()}")
        cap, m = grid.capacity, grid.mask[..., None]
        feats = torch.where(m, torch.randn((1, cap, F), generator=g,
                                           device="cuda"), 0.0)
        gout = torch.where(m, torch.randn((1, cap, Fo), generator=g,
                                          device="cuda"), 0.0)
        w = torch.randn((27, F, Fo), generator=g, device="cuda") / \
            math.sqrt(27 * F)
        pack = ws.pack_sparse_weight(w)
        dpack = ws.pack_sparse_weight(w, dgrad=True)
        zero = torch.zeros_like(plan.violations)
        out = kernels.sparse_conv_f32(feats, plan.nbr, pack, plan.violations)
        ref_out = ws.sparse_conv_plain(plan, feats, w)
        dx = kernels.sparse_conv_f32(gout, plan.nbr, dpack, zero, dgrad=True)
        dw = kernels.sparse_conv_f32_wgrad(feats, plan.nbr, gout)
        dw2 = kernels.sparse_conv_f32_wgrad(feats, plan.nbr, gout)
        ref_dx, ref_dw = ws.sparse_conv_bwd_plain(plan, feats, w, gout)
        _, dw64 = ws.sparse_conv_bwd_plain(plan, feats.double(), w.double(),
                                           gout.double())
        pairs = int((plan.nbr >= 0).sum())
        shape = f"{origin} L{level} {cap} x ({F}->{Fo})"
        dx_err = (dx - ref_dx).abs().max().item()
        dw_err = (dw - ref_dw).abs().max().item()
        fwd_err = (out - ref_out).abs().max().item()
        fwd_lim = 1e-4 * ref_out.abs().max().item()
        dx_lim = 1e-4 * ref_dx.abs().max().item()
        dw_lim = 5e-4 * ref_dw.abs().max().item()
        print(f"[k4 dgrad] {shape}: {int(grid.mask.sum())} voxels, {pairs} "
              f"neighbour pairs; dx max_abs_err {dx_err:.3e} (limit "
              f"{dx_lim:.3e}); the forward K4 {fwd_err:.3e} (limit "
              f"{fwd_lim:.3e})")
        check(torch.isfinite(out).all().item() and fwd_err <= fwd_lim,
              f"K4 at {shape}: err {fwd_err}")
        print(f"[k6] {shape}: dW max_abs_err {dw_err:.3e} (limit "
              f"{dw_lim:.3e}); against the plain dW summed in f64: kernel "
              f"{(dw.double() - dw64).abs().max().item():.3e}, plain f32 "
              f"{(ref_dw.double() - dw64).abs().max().item():.3e}; two runs "
              f"{'bit-identical' if torch.equal(dw, dw2) else 'DIFFER'}")
        check(torch.isfinite(dx).all().item() and dx_err <= dx_lim,
              f"K4 dgrad at {shape}: err {dx_err}")
        check(torch.isfinite(dw).all().item() and dw_err <= dw_lim,
              f"K6 at {shape}: err {dw_err}")
        check(torch.equal(dw, dw2), f"K6 at {shape}: two runs differ")
        check(bool((dx[~grid.mask] == 0).all()), f"{shape}: dx padding rows")
        del dw64, dw2, out, ref_out
        active = int(grid.mask.sum())
        flops, b_ms, b_by, f32_ms = k4_bounds(pairs, F, Fo, sparse_conv_bytes(
            "dx", active, cap, F, Fo, 4, 8 * 27 * F * Fo))
        _, w_ms, w_by, w_f32_ms = k4_bounds(pairs, F, Fo, sparse_conv_bytes(
            "dw", active, cap, F, Fo, 4, 4 * 27 * F * Fo))
        # the rows of the 32-row chunks K6 walks: per tap, those with a
        # present neighbour in some row (the chunks restart with each range
        # of rows, and the ranges are multiples of 32)
        has = (plan.nbr >= 0).reshape(-1, 27)
        has = torch.nn.functional.pad(has, (0, 0, 0, (-has.shape[0]) % 32))
        walked = 32 * int(has.reshape(-1, 32, 27).any(dim=1).sum())
        fwd_ms = cuda_ms(lambda: kernels.sparse_conv_f32(
            feats, plan.nbr, pack, plan.violations), 2, 5)
        dx_ms = cuda_ms(lambda: kernels.sparse_conv_f32(
            gout, plan.nbr, dpack, zero, dgrad=True), 2, 5)
        dw_ms = cuda_ms(lambda: kernels.sparse_conv_f32_wgrad(
            feats, plan.nbr, gout), 2, 5)
        # the plain version computes both gradients in one pass over the
        # taps: its time stands beside each kernel
        plain = cuda_ms(lambda: ws.sparse_conv_bwd_plain(plan, feats, w,
                                                         gout), 1, 2)
        print(f"[k4 dgrad] {shape}: kernel {dx_ms:.3f} ms ("
              f"{flops / dx_ms / 1e9:.2f} TFLOP/s of f32 work, "
              f"{100 * b_ms / dx_ms:.1f} % of its bound; the forward K4 "
              f"{fwd_ms:.3f} ms); bound {b_ms:.3f} ms ({b_by}, 3 TF32 "
              f"products at 495 TFLOP/s; the f32 CUDA-core bound "
              f"{f32_ms:.3f} ms); [k6] kernel {dw_ms:.3f} ms "
              f"({flops / dw_ms / 1e9:.2f} TFLOP/s of f32 work, "
              f"{100 * w_ms / dw_ms:.1f} % of its bound), bound {w_ms:.3f} "
              f"ms ({w_by}, 3 TF32 products at 495 TFLOP/s; the f32 "
              f"CUDA-core bound {w_f32_ms:.3f} ms), walking {walked} chunk "
              f"rows for the {pairs} pairs ({walked / max(pairs, 1):.2f}x); "
              f"plain dx + dW {plain:.3f} ms; no single library call")
        common = dict(shape=shape, plain_ms=plain, library_ms=None,
                      pairs=pairs)
        dx_rows.append(dict(common, max_abs_err=dx_err,
                            ms=dx_ms, bound_ms=b_ms, bound_by=b_by,
                            f32_core_bound_ms=f32_ms, k4_forward_ms=fwd_ms,
                            k4_forward_err=fwd_err))
        dw_rows.append(dict(common, max_abs_err=dw_err, ms=dw_ms,
                            bound_ms=w_ms, bound_by=w_by,
                            f32_core_bound_ms=w_f32_ms, chunk_rows=walked))
        del feats, gout, dx, dw, ref_dx, ref_dw, plan, pack, dpack
    torch.cuda.empty_cache()
    # launches made here to compare and time are no main-path launches
    return dx_rows, dw_rows


def vae_grad_check(mods, extra=None, prepare=None, outputs_only=()):
    """``vae_loss`` and every parameter's gradient of the release-width VAE
    (f_maps 64) on a small scene with reduced capacities: card (K4,
    K4-dgrad, K6) against the CPU (plain versions), same weights, batch and
    reparametrize noise. f32 on both sides. ``extra``: more config fields;
    ``prepare(model)`` edits the CPU model's weights; the parameters named
    by the ``outputs_only`` prefixes get no gradient on either side."""
    cfg = mods.SparseVAEConfig(neck_dims=(8, 8, 16), neck_ijk_min=(-4, -4, -8),
                               capacities=(8192, 4096, 1024),
                               dense_lookup_ijk_min=(-18, -18, -18),
                               dense_lookup_dims=(36, 36, 36),
                               **(extra or {}))
    cpu = mods.SparseStructureVAE(cfg, device="cpu")
    cpu.init_params(torch.Generator().manual_seed(16))
    if prepare is not None:
        prepare(cpu)
    card = mods.SparseStructureVAE(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(16)
    B, N = 2, 3000
    pts = torch.from_numpy(rng.uniform(-3, 3, (B, N, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 23, (B, N)).astype(np.int32))
    noise = torch.from_numpy(rng.standard_normal((B, 8, 8, 16, 8),
                                                 dtype=np.float32))
    losses, sizes = {}, None
    for name, model in (("cpu", cpu), ("card", card)):
        dev = model.device
        mask = torch.ones((B, N), dtype=torch.bool, device=dev)
        t0 = time.perf_counter()
        grids = mods.build_hash_tree(cfg, pts.to(dev), mask)
        sem = mods.majority_label(grids[0], pts.to(dev), labels.to(dev), mask,
                                  cfg.num_semantic)
        out = model(grids, sem, noise=noise)
        loss, metrics = mods.vae_loss(mods.VAELossConfig(), out, grids[0],
                                      sem)
        loss.backward()
        losses[name] = (loss.item(), time.perf_counter() - t0)
        n_vox = [int(gr.mask.sum()) for gr in grids]
        check(sizes in (None, n_vox), f"voxels {n_vox} vs {sizes}")
        check(all(int(gr.num_dropped.sum()) == 0 for gr in grids),
              "the scene overflows a capacity")
        sizes = n_vox
    for name, model in (("cpu", cpu), ("card", card)):
        got = [k for k, p in model.named_parameters()
               if k.startswith(outputs_only) and p.grad is not None]
        check(not got, f"{name}: output-only parameters with a gradient "
              f"{got}")
    grads_cpu = {k: p.grad for k, p in cpu.named_parameters()
                 if not k.startswith(outputs_only)}
    g_max = max(gr.abs().max().item() for gr in grads_cpu.values())
    floor = 1e-6 * g_max
    cosines, zero, bad = {}, {}, []
    for k, p in card.named_parameters():
        gr = p.grad
        if k.startswith(outputs_only):
            continue
        if gr is None or not torch.isfinite(gr).all():
            bad.append(k)
        elif grads_cpu[k].abs().max().item() < floor:
            zero[k] = gr.abs().max().item()
        elif not gr.any():
            bad.append(k)
        else:
            cosines[k] = cos(gr.cpu(), grads_cpu[k])
    check(not bad, f"parameters without a finite, non-zero gradient: {bad}")
    order = sorted(cosines, key=cosines.get)
    vals = np.array([cosines[k] for k in order])
    rel = abs(losses["card"][0] - losses["cpu"][0]) / abs(losses["cpu"][0])
    print(f"[model] release-width VAE {extra or ''}, voxels per level "
          f"{sizes} (batch {B}),"
          f" vae_loss: card {losses['card'][0]:.6f} vs cpu "
          f"{losses['cpu'][0]:.6f} (relative {rel:.2e}; cpu "
          f"{losses['cpu'][1]:.1f} s); {len(cosines)} parameter tensors with "
          f"finite, non-zero gradients; tensors whose reference gradient is "
          f"below 1e-6 of the largest: {sorted(zero) or 'none'}; gradient "
          f"cosine card vs cpu: median {np.median(vals):.7f}, worst "
          f"{vals[0]:.7f}")
    for k in order[:4]:
        print(f"[model]   cosine {cosines[k]:.7f}  {k} "
              f"(|g| max {grads_cpu[k].abs().max().item():.3e})")
    check(rel <= 1e-4, f"loss {losses}")
    check(len(zero) <= 2, f"zero reference gradients: {zero}")
    check(vals[0] >= 0.999, f"worst gradient cosine {vals[0]} ({order[0]})")


def vae_train_main_path(kernels, mods):
    """The VAE trainer's CLI path at the release config: 3 optimizer steps
    on 200,000-point samples, then a reconstruction with the trained
    weights."""
    from infinicube_tpu_torch import train as train_cli
    from infinicube_tpu_torch.inference.voxel_vae import \
        evaluate_reconstruction
    from infinicube_tpu_torch.training import loop
    from infinicube_tpu_torch.training.checkpoint import CheckpointManager
    ws = mods.window_conv
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vae_")
    per_step, undo = counting_steps(kernels, loop)
    plain_calls, plains = [], (ws.sparse_conv_plain, ws.sparse_conv_bwd_plain)

    def no_plain(*a, **kw):
        plain_calls.append(1)
        raise RuntimeError("a plain version was called on the card")

    ws.sparse_conv_plain = ws.sparse_conv_bwd_plain = no_plain
    try:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train_cli.main(
            [os.path.join(ROOT, "configs", "train_vae.yaml"), "--name",
             "smoke", "--logdir", tmp, "--exec", f"max_steps={TRAIN_STEPS}",
             f"points_per_sample={VAE_POINTS}", "log_every=1",
             f"ckpt_dir={tmp}/ck"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_params = sum(p.numel() for p in state.params.values())
        logs = [json.loads(line) for line in
                open(os.path.join(tmp, "smoke.jsonl"))]
        print(f"[vae train] {n_params:,} parameters, {TRAIN_STEPS} steps at "
              f"batch 1, {VAE_POINTS:,} points per sample, through "
              f"train.main in {wall:.1f} s (model build, batches, steps and "
              f"the final checkpoint), peak {peak:.1f} GiB")
        check(len(logs) == TRAIN_STEPS and
              [r["step"] for r in logs] == list(range(1, TRAIN_STEPS + 1)),
              f"JSONL log {logs}")
        for r, delta in zip(logs, per_step):
            vox = [int(r[f"voxels{l}"]) for l in range(3)]
            print(f"[vae train] step {r['step']}: loss {r['loss']:.4f} "
                  f"(struct ce {r['struct0_ce']:.3f} {r['struct1_ce']:.3f} "
                  f"{r['struct2_ce']:.3f}, semantic ce "
                  f"{r['semantic_ce']:.3f}, kl {r['kl']:.4f}), grad_finite "
                  f"{r['grad_finite']:.0f}, {r['steps_per_sec']:.3f} steps/s,"
                  f" active voxels per level {vox}; launches {delta}")
            check(math.isfinite(r["loss"]) and r["grad_finite"] == 1.0,
                  f"step {r['step']}: {r}")
            check(delta == VAE_STEP_LAUNCHES, f"step {r['step']} launches "
                  f"{delta}, want {VAE_STEP_LAUNCHES}")
            check(vox[0] > 90_000 and vox[0] > vox[1] > vox[2] > 0,
                  f"step {r['step']}: active voxels {vox}")
        check(len(per_step) == TRAIN_STEPS, f"{len(per_step)} steps counted")
        check(not plain_calls, "a plain version ran on the card")
        check(state.step == TRAIN_STEPS and state.num_nan_skips == 0,
              f"step {state.step}, {state.num_nan_skips} skipped")
        moved = [k for k, p in state.params.items()
                 if not torch.equal(p.detach(), state.ema.params[k])]
        print(f"[vae train] {len(moved)} of {len(state.params)} parameter "
              f"tensors moved in {TRAIN_STEPS} steps")
        check(len(moved) == len(state.params),
              f"parameters that did not move: "
              f"{sorted(set(state.params) - set(moved))[:5]}")
        mgr = CheckpointManager(os.path.join(tmp, "ck"))
        check(mgr.all_steps() == [TRAIN_STEPS], f"steps {mgr.all_steps()}")
        size = os.path.getsize(mgr._path(TRAIN_STEPS))
        sd = mgr.restore()
        mu, _ = state.moments()
        same = all(torch.equal(sd["params"][k], p.detach()) and
                   torch.equal(sd["ema"]["params"][k], state.ema.params[k])
                   and torch.equal(sd["mu"][k], mu[k])
                   for k, p in state.params.items())
        print(f"[vae train] final checkpoint: {size / 1e6:.1f} MB, read "
              f"back: parameters, moments and EMA "
              f"{'identical' if same else 'DIFFER'}")
        check(same and sd["step"] == TRAIN_STEPS, "checkpoint differs")
        # reconstruction with the trained weights (random after 3 steps, so
        # the scores are only held to be finite)
        vae = mods.SparseStructureVAE(mods.SparseVAEConfig(), device="cuda")
        vae.load_state_dict(sd["params"])
        vae.eval().requires_grad_(False)
        pts, labels = vae_points(17)
        t0 = time.perf_counter()
        res = evaluate_reconstruction(vae, pts, labels)
        torch.cuda.synchronize()
        print(f"[vae train] evaluate_reconstruction on {VAE_POINTS:,} points "
              f"({int(res['gt_grid'].mask.sum())} input voxels, "
              f"{int(res['pred_grid'].mask.sum())} predicted): grid IoU "
              f"{res['grid_iou']:.4f}, semantic accuracy "
              f"{res['semantic_acc']:.4f}, {time.perf_counter() - t0:.2f} s")
        check(math.isfinite(res["grid_iou"]) and
              math.isfinite(res["semantic_acc"]) and
              0.0 <= res["grid_iou"] <= 1.0, f"reconstruction {res}")
        check(not plain_calls, "a plain version ran on the card")
    finally:
        undo()
        ws.sparse_conv_plain, ws.sparse_conv_bwd_plain = plains
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[vae train] main path launches {launches}")
    return launches


def vae_train_time(kernels, mods):
    """One train step of the release VAE on a 200,000-point sample, split
    into batch making (grids and labels), conv plans, forward (plans
    included), backward (of it K4-dgrad and K6, by CUDA events) and
    optimizer + EMA; then under the profiler; peak memory."""
    from torch.func import functional_call

    from infinicube_tpu_torch.training.state import (TrainConfig, TrainState,
                                                     grads_finite,
                                                     make_train_step)
    cfg, vcfg = TrainConfig(), mods.SparseVAEConfig()
    model = mods.SparseStructureVAE(vcfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(18)
    model.init_params(g)
    state = TrainState.create(cfg, dict(model.named_parameters()))
    params = state.params
    pts, labels = (a.cuda() for a in vae_points(18))
    mask = torch.ones((1, VAE_POINTS), dtype=torch.bool, device="cuda")

    def make_batch():
        grids = mods.build_hash_tree(vcfg, pts, mask)
        return grids, mods.majority_label(grids[0], pts, labels, mask,
                                          vcfg.num_semantic)

    def loss_fn(p, gen, b):
        out = functional_call(model, p, b, {"generator": gen})
        return mods.vae_loss(mods.VAELossConfig(), out, b[0][0], b[1])

    step_fn = make_train_step(cfg, loss_fn)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def optimize():
        finite = grads_finite([p.grad for p in params.values()])
        torch.nn.utils.clip_grad_value_(list(params.values()),
                                        cfg.grad_clip_value)
        state.opt.step()
        state.ema.update(params, cfg.ema_decay, apply=finite)
        return finite

    spans = {"dgrad": [], "wgrad": [], "fwd": []}
    k4, k6 = kernels.sparse_conv_f32, kernels.sparse_conv_f32_wgrad

    def with_events(fn, key):
        def wrapped(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            spans[key(kw)].append(ev)
            return out
        return wrapped

    for _ in range(2):                               # warm-up
        step_fn(state, g, make_batch())
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    (_, step_ms) = timed(lambda: [step_fn(state, g, make_batch())
                                  for _ in range(3)])
    step_ms /= 3
    counts = {k: v // 3 for k, v in kernels.launches.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(counts == VAE_STEP_LAUNCHES, f"launches per step {counts}")
    b, batch_ms = timed(make_batch)
    _, plan_ms = timed(lambda: model.level_plans(b[0]))
    for p in params.values():
        p.grad = None
    kernels.sparse_conv_f32 = with_events(
        k4, lambda kw: "dgrad" if kw.get("dgrad") else "fwd")
    kernels.sparse_conv_f32_wgrad = with_events(k6, lambda kw: "wgrad")
    try:
        (loss, _), fwd_ms = timed(lambda: loss_fn(params, g, b))
        _, bwd_ms = timed(loss.backward)
    finally:
        kernels.sparse_conv_f32, kernels.sparse_conv_f32_wgrad = k4, k6
    ms = {k: sum(a.elapsed_time(b_) for a, b_ in v) for k, v in spans.items()}
    check([len(v) for v in spans.values()] == [24, 24, 24],
          f"timed launches {[len(v) for v in spans.values()]}")
    finite, opt_ms = timed(optimize)
    vox = [int(gr.mask.sum()) for gr in b[0]]
    print(f"[vae train time] batch 1, {VAE_POINTS:,} points, active voxels "
          f"per level {vox}: step with its batch {step_ms:.1f} ms "
          f"({1e3 / step_ms:.2f} steps/s), peak {peak:.2f} GiB; split: batch "
          f"(hash tree + labels) {batch_ms:.1f} ms, forward {fwd_ms:.1f} ms "
          f"(of it the 3 conv plans {plan_ms:.1f} ms, the 24 K4 "
          f"{ms['fwd']:.1f} ms), backward {bwd_ms:.1f} ms (of it the 24 "
          f"K4-dgrad {ms['dgrad']:.1f} ms, the 24 K6 {ms['wgrad']:.1f} ms), "
          f"clip + AdamW + EMA + finiteness {opt_ms:.1f} ms (finite "
          f"{finite}); launches {counts}")
    del loss
    profile(lambda: step_fn(state, g, make_batch()), "VAE train step")


def vae_train(kernels, dec_grids):
    """Phases 14-17. Returns the summary entries of K4-dgrad and K6 and the
    launch counts of the VAE-training main path."""
    from infinicube_tpu_torch.grid.ops import majority_label
    from infinicube_tpu_torch.models.vae.loss import VAELossConfig, vae_loss
    from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                       SparseVAEConfig,
                                                       build_hash_tree)
    from infinicube_tpu_torch.nn.sparse import conv_plan
    from infinicube_tpu_torch.ops import window_conv
    mods = types.SimpleNamespace(
        SparseStructureVAE=SparseStructureVAE,
        SparseVAEConfig=SparseVAEConfig, build_hash_tree=build_hash_tree,
        majority_label=majority_label, VAELossConfig=VAELossConfig,
        vae_loss=vae_loss, conv_plan=conv_plan, window_conv=window_conv)
    dx_rows, dw_rows = sparse_bwd_checks(kernels, mods, dec_grids,
                                         SparseVAEConfig())
    vae_grad_check(mods)
    torch.cuda.empty_cache()
    launches = vae_train_main_path(kernels, mods)
    torch.cuda.empty_cache()
    vae_train_time(kernels, mods)
    return {"sparse_conv_f32_dgrad": entry(
                "sparse_conv_f32_dgrad",
                "infinicube_tpu_torch/csrc/sparse_conv.cu",
                "infinicube_tpu/ops/window_conv.py:320", dx_rows, 1),
            "sparse_conv_f32_wgrad": entry(
                "sparse_conv_f32_wgrad",
                "infinicube_tpu_torch/csrc/sparse_conv_bwd.cu",
                "infinicube_tpu/ops/window_conv.py:252", dw_rows, 1)}, \
        launches


# ---------------------------------------------------------------------------
# int8 serving: stage 1 in its tracked configuration, the DiT with int8 PV
# ---------------------------------------------------------------------------

# K7 at six of the release UNet's 23 int8 shapes, CFG batch 2: (cube edge,
# C, O)
K7_SHAPES = ((64, 192, 192), (64, 576, 192), (32, 384, 384),
             (32, 1152, 384), (32, 768, 768), (16, 384, 768))
GUIDANCE = 2.0      # the tracked stage-1 configuration serves with CFG
INT8_CONVS = 23     # int8 convs of one release UNet call (the port's rule)


def k7_prologue_inputs(g, n, C, O):
    """bf16 x [2, n, n, n, C] with its own range in every channel and a CFG
    pair whose halves differ, and the f32 weight parameter [O, C, 3, 3,
    3]."""
    x = torch.randn((2, n, n, n, C), generator=g, device="cuda") * \
        torch.logspace(-1, 1, C, device="cuda")
    x[1] *= 4.0                     # the CFG pair's halves differ
    wf = torch.randn((O, C, 3, 3, 3), generator=g, device="cuda") / \
        math.sqrt(27 * C)           # the f32 parameter
    return x.to(torch.bfloat16), wf


def k7_checks(kernels, dc):
    """K7 against ``conv3x3x3_int8_plain`` on the same int8 inputs (one
    prologue, so the integer sums are exact on both sides; each input
    channel has its own range), gated on bit-equality (every output equal),
    and the cosine >= 0.99999 and max-abs <= 8e-3 * max|ref| gate besides;
    timed beside the plain version, its bound (2*V*27*C*O int8 operations
    at 1,979 TOP/s against the bytes), K3 on the same bf16 input and
    cuDNN's bf16 conv3d. Then its quantize prologue's three kernels against
    their plain versions (bit-equal) and against ``quantize_for_conv``
    followed by ``pad_channels`` and ``pack_int8_weight``, from the f32
    parameter, with a CFG pair whose halves have other ranges; each timed
    beside its plain version and its bound (bytes), host-timed and as device
    time alone. Returns the rows of K7 and of each prologue kernel."""
    g = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    pro = {"int8_conv_amax": [], "int8_conv_quantize_x": [],
           "int8_conv_quantize_w": []}
    for n, C, O in K7_SHAPES:
        x, wf = k7_prologue_inputs(g, n, C, O)
        w = wf.to(torch.bfloat16)
        b = 0.1 * torch.randn(O, generator=g, device="cuda")
        x8, w8, sw = dc.quantize_for_conv(x, w)
        w8p = dc.pack_int8_weight(w8)
        got = kernels.conv3x3x3_int8(x8, w8p, sw, b)
        again = kernels.conv3x3x3_int8(x8, w8p, sw, b)
        ref = dc.conv3x3x3_int8_plain(x8, w8, sw, b, torch.bfloat16)
        c = cos(got.float(), ref.float())
        err = (got.float() - ref.float()).abs().max().item()
        lim = 8e-3 * ref.abs().max().item()
        same = (got == ref).float().mean().item()
        shape = f"[2,{n},{n},{n},{C}]->{O}"
        splits = kernels.k7_splits(2, n, n, n, C, O,
                                   torch.cuda.get_device_properties(0)
                                   .multi_processor_count)
        print(f"[k7] {shape} ({splits} K slices): cosine {c:.8f} "
              f"max_abs_err {err:.3e} (limit {lim:.3e}), {100 * same:.4f} % "
              f"of outputs equal, two runs "
              f"{'bit-identical' if torch.equal(got, again) else 'DIFFER'}")
        check(c >= 0.99999 and err <= lim, f"K7 at {shape}: cos {c} err {err}")
        check(torch.equal(got, ref), f"K7 at {shape}: not bit-equal")
        check(torch.equal(got, again), f"K7 at {shape}: two runs differ")
        del got, again, ref
        # the prologue: the card's kernels against their plain versions
        amax = kernels.int8_conv_amax(x)
        x8k = kernels.int8_conv_quantize_x(x, amax)
        w8k, swk = kernels.int8_conv_quantize_w(wf, amax)
        ref_amax = dc.int8_conv_amax_plain(x)
        ok = (torch.equal(amax, ref_amax) and
              torch.equal(x8k, dc.int8_conv_quantize_x_plain(x, ref_amax))
              and all(torch.equal(a, b_) for a, b_ in zip(
                  (w8k, swk), dc.int8_conv_quantize_w_plain(wf, ref_amax)))
              and torch.equal(x8k, dc.pad_channels(x8, 32, -1))
              and torch.equal(w8k, dc.pack_int8_weight(
                  dc.pad_channels(w8, 32, 0, 1)))
              and torch.equal(swk, dc.pad_channels(sw, 32, 1)))
        print(f"[k7 prologue] {shape}: amax, x8, the weight pack and sw "
              f"{'bit-equal' if ok else 'DIFFER'} to the plain prologue")
        check(ok, f"K7 prologue at {shape} differs from the plain one")
        del x8k, w8k, swk
        ms = cuda_ms(lambda: kernels.conv3x3x3_int8(x8, w8p, sw, b), 2, 5)
        with torch.no_grad():
            full_ms = cuda_ms(lambda: dc.conv3x3x3(x, wf, b, quant=True), 2,
                              5)
        plain = cuda_ms(lambda: dc.conv3x3x3_int8_plain(x8, w8, sw, b,
                                                        torch.bfloat16), 1, 1)
        wp = dc.pack_conv_weight(w)
        k3 = cuda_ms(lambda: kernels.conv3x3x3_bf16(x, wp, b), 2, 5)
        xl = x.permute(0, 4, 1, 2, 3)
        wl = w.contiguous(memory_format=torch.channels_last_3d)
        bb = b.to(torch.bfloat16)
        lib = cuda_ms(lambda: torch.nn.functional.conv3d(xl, wl, bb,
                                                         padding=1), 2, 5)
        V = 2 * n ** 3
        ops = 2.0 * V * 27 * C * O
        b_ms, b_by = bound_ms([(ops, PEAK_INT8)],
                              V * C + 27 * C * O + 2 * V * O + 16 * O)
        # the prologue's passes, each beside its plain version and its bytes
        pro_ms = {
            "int8_conv_amax": (
                cuda_ms(lambda: kernels.int8_conv_amax(x), 2, 5),
                cuda_ms(lambda: dc.int8_conv_amax_plain(x), 1, 3),
                2 * V * C + 4 * C,
                cuda_ms(lambda: torch.linalg.vector_norm(
                    x, float("inf"), dim=(0, 1, 2, 3)), 1, 5)),
            "int8_conv_quantize_x": (
                cuda_ms(lambda: kernels.int8_conv_quantize_x(x, amax), 2, 5),
                cuda_ms(lambda: dc.int8_conv_quantize_x_plain(x, ref_amax),
                        1, 3),
                2 * V * C + 4 * C + V * C, None),
            "int8_conv_quantize_w": (
                cuda_ms(lambda: kernels.int8_conv_quantize_w(wf, amax), 2, 5),
                cuda_ms(lambda: dc.int8_conv_quantize_w_plain(wf, ref_amax),
                        1, 3),
                4 * 27 * C * O + 4 * C + 27 * C * O + 12 * O, None)}
        # and as device time alone (the host-timed calls above include the
        # host's time to issue them; the profiler's kernel records, which
        # chip_time_kernels.py sums, read below the bytes bound in this
        # long-lived process, so the calls are queued behind a sleep)
        pro_dev = {
            "int8_conv_amax": queued_ms(lambda: kernels.int8_conv_amax(x)),
            "int8_conv_quantize_x": queued_ms(
                lambda: kernels.int8_conv_quantize_x(x, amax)),
            "int8_conv_quantize_w": queued_ms(
                lambda: kernels.int8_conv_quantize_w(wf, amax))}
        norm_dev = queued_ms(lambda: torch.linalg.vector_norm(
            x, float("inf"), dim=(0, 1, 2, 3)))
        for name, (k_ms, p_ms, nbytes, lib_ms) in pro_ms.items():
            pb_ms, pb_by = bound_ms([], nbytes)
            pro[name].append(dict(
                shape=shape, max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                bound_ms=pb_ms, bound_by=pb_by, library_ms=lib_ms,
                device_ms=pro_dev[name],
                device_bound_share=pb_ms / pro_dev[name],
                **({"library_device_ms": norm_dev} if lib_ms else {})))
        print(f"[k7] {shape}: kernel {ms:.3f} ms ({ops / ms / 1e9:.1f} "
              f"TOP/s, {100 * b_ms / ms:.1f} % of its bound), with the "
              f"quantize prologue {full_ms:.3f} ms, plain {plain:.2f} ms, "
              f"bound {b_ms:.3f} ms ({b_by}); K3 {k3:.3f} ms, cudnn bf16 "
              f"{lib:.3f} ms")
        print(f"[k7 prologue] {shape}: " + ", ".join(
            f"{k} {v[0]:.4f} ms, device alone {pro_dev[k]:.4f} ms "
            f"({100 * bound_ms([], v[2])[0] / pro_dev[k]:.1f} % of its bytes "
            f"bound {bound_ms([], v[2])[0]:.4f}; plain {v[1]:.3f})"
            for k, v in pro_ms.items())
              + f"; amax as torch.linalg.vector_norm "
              f"{pro_ms['int8_conv_amax'][3]:.4f} ms, device alone "
              f"{norm_dev:.4f} ms")
        rows.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                         k3_ms=k3, with_prologue_ms=full_ms, splits=splits,
                         bit_equal=True))
        del x, w, wf, x8, w8, w8p, wp, xl, wl, amax
    torch.cuda.empty_cache()
    return rows, pro


def k8_checks(kernels, fa):
    """K8 against ``int8qkv_attention_plain`` on the same int8 inputs at the
    DiT's 17- and 93-frame N (a different scale in every 1,536-row block of
    q and k and in every channel of v), gated at the int8 cosine >= 0.999;
    timed beside K1 on the same q, k (and bf16 v) and the plain version."""
    g = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for n in (N_SERVE, N_RELEASE):
        block, npad = fa.quant_blocks(n)
        q = scale_blocks(rand((1, n, H, D), g), block, 0.25, 4.0)
        k = scale_blocks(rand((1, n, H, D), g), block, 4.0, 0.25)
        v = rand((1, n, H, D), g) * torch.logspace(
            -1, 1, D, device="cuda").to(torch.bfloat16)
        q8, sq = fa.block_quantize(fa.fold_heads(q, npad), block)
        k8, sk = fa.block_quantize(fa.fold_heads(k, npad), block)
        v8, sv = fa.channel_quantize(fa.fold_heads(v, npad))
        v8t = fa.pack_v8(v8)
        args = (q8, k8, sq, sk, v8t, sv, 1, n, block, D ** -0.5)
        got = kernels.flash_attn_int8qkv(*args)
        ref = fa.int8qkv_attention_plain(q8, k8, sq, sk, v8, sv, n, block,
                                         D ** -0.5, torch.float32)
        ref = ref.reshape(1, H, n, D).permute(0, 2, 1, 3)
        c, err = cos(got, ref), (got.float() - ref).abs().max().item()
        print(f"[k8] N={n}: cosine {c:.6f} (gate 0.999) max_abs_err "
              f"{err:.3e}")
        check(c >= 0.999, f"K8 cosine {c} at N={n}")
        del got, ref
        ms = cuda_ms(lambda: kernels.flash_attn_int8qkv(*args), 2, 5)
        k1 = cuda_ms(lambda: kernels.flash_attn_int8qk(
            q8, k8, sq, sk, v, block, D ** -0.5), 2, 5)
        e2e = cuda_ms(lambda: fa.mha_quantized(q, k, v, quant="qkv"), 1, 5)
        plain = cuda_ms(lambda: fa.int8qkv_attention_plain(
            q8, k8, sq, sk, v8, sv, n, block, D ** -0.5, torch.float32), 0, 1)
        ops = 4.0 * n * n * D * H        # QK^T and PV, both int8
        b_ms, b_by = bound_ms([(ops, PEAK_INT8)], 3 * n * D * H +
                              2 * n * D * H + 4 * H * (D + 2 * npad // block))
        k1_e2e = cuda_ms(lambda: fa.mha_quantized(q, k, v), 1, 5)
        print(f"[k8] N={n}: kernel {ms:.3f} ms ({ops / ms / 1e9:.1f} TOP/s, "
              f"{100 * b_ms / ms:.1f} % of its bound), with the quantize "
              f"prologue {e2e:.3f} ms; K1 {k1:.3f} ms (with its prologue "
              f"{k1_e2e:.3f} ms), K8 / K1 {ms / k1:.2f}; plain {plain:.1f} "
              f"ms, bound {b_ms:.3f} ms ({b_by})")
        rows.append(dict(shape=f"N={n} h={H} d={D}", max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, k1_ms=k1, with_prologue_ms=e2e,
                         k1_with_prologue_ms=k1_e2e, k8_over_k1=ms / k1,
                         share_of_bound=b_ms / ms, cosine=c))
        del q, k, v, q8, k8, v8, v8t, args
    torch.cuda.empty_cache()
    return rows


def unet_int8_check(VoxelDiffusion, DiffusionConfig):
    """The release-width UNet's serving twin on a 16^3 cube at batch 2: the
    card (K7 where the rule holds, K3, K2) against the CPU (the plain
    versions and the same int8 rule, bf16 like the card), and against the
    card's full-precision forward (the reference's int8 gate, 0.999). Card
    and CPU round bf16 sums in other orders, and int8 rounding turns an
    activation's last-bit difference into a whole int8 step wherever it
    sits near a rounding boundary, so the two int8 forwards differ by about
    as much as int8 from bf16: gated at 0.9995."""
    base = DiffusionConfig(cube_dims=(16, 16, 16), serve_quant=True)
    cpu = VoxelDiffusion(base, device="cpu")
    cpu.init_params(torch.Generator().manual_seed(14),
                    zero_init_layers=False)
    card = VoxelDiffusion(base, device="cuda")
    card.load_params(cpu.unet.state_dict())
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 16, 16),
                                             dtype=np.float32))
    t = torch.tensor([500, 500])
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = cpu.unet_serve(x, t)
        cpu_s = time.perf_counter() - t0
        got = card.unet_serve(x.cuda(), t.cuda()).cpu()
        full = card.unet(x.cuda(), t.cuda()).cpu()
    c, c_full = cos(got, ref), cos(got, full)
    print(f"[model] release-width int8 UNet on 16^3, batch 2: card vs cpu "
          f"cosine {c:.7f} (gate 0.9995), int8 vs bf16 on the card "
          f"{c_full:.6f} (gate 0.999), |out| max "
          f"{ref.abs().max().item():.3f} (cpu {cpu_s:.1f} s)")
    check(torch.isfinite(got).all().item(), "int8 UNet output not finite")
    check(c >= 0.9995 and c_full >= 0.999,
          f"int8 UNet cosines {c}, {c_full}")


def serve_int8(kernels, mods, sc):
    """Phase 20: stage 1 in its tracked configuration (int8 convs, CFG
    2.0): 3 trajectory chunks, a 2 x 2 block tiling with one tile skipped,
    one chunk each of DDPM and DPM++, and the single-chunk CLI; each with
    exact launch counts. Returns the model, VAE, generator and the launches
    of each path."""
    diffusion, vae = build_stage1(mods, "int8", serve_quant=True)
    n_int8, want = chunk_launches(diffusion, STAGE1_DDIM)
    print(f"[int8] the port's rule makes {n_int8} of 48 convs of a UNet "
          f"call int8; per chunk of DDIM-{STAGE1_DDIM} with CFG: {want}")
    check(n_int8 == INT8_CONVS, f"{n_int8} int8 convs, want {INT8_CONVS}")
    gen = mods.VoxelWorldGenerator(
        diffusion, mods.vae_decode_fn(vae),
        mods.WorldGenConfig(ddim_steps=STAGE1_DDIM, guidance_scale=GUIDANCE))
    ego, maps, boxes = stage1_scene()
    paths = {}
    _, paths["stage1_int8"] = run_chunks(
        kernels, gen, "int8",
        lambda: gen.generate_trajectory(ego, map_points=maps, boxes=boxes,
                                        seed=0), want, 3)
    # blocks: 51.2 m tiles every 38.4 m over [0, 60]^2, the far corner out
    centers = gen._block_centers((0.0, 0.0), (60.0, 60.0))
    check(len(centers) == 4, f"{len(centers)} blocks")
    skip = lambda c: bool(c[0] > 40 and c[1] > 40)   # noqa: E731
    _, paths["stage1_blocks"] = run_chunks(
        kernels, gen, "blocks",
        lambda: gen.generate_blocks((0.0, 0.0), (60.0, 60.0), maps, boxes,
                                    seed=1, skip_empty_fn=skip), want, 3)
    print(f"[blocks] latent table: {len(gen._table_keys)} cells")
    check(len(gen._table_keys) > 64 ** 3, "latent table")
    cond = gen._cond_for_chunk(np.eye(4), maps, boxes)
    kernels.reset_launches()
    for sampler in ("ddpm", "dpmpp"):
        before = dict(kernels.launches)
        g = torch.Generator(device="cuda").manual_seed(2)
        t0 = time.perf_counter()
        lat, (ijk, sem) = diffusion.evaluation_api(
            cond, mods.vae_decode_fn(vae), num_steps=STAGE1_DDIM,
            guidance_scale=GUIDANCE, sampler=sampler, generator=g)
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in kernels.launches.items()}
        print(f"[{sampler}] one chunk, {STAGE1_DDIM} steps: "
              f"{time.perf_counter() - t0:.2f} s, {len(ijk)} voxels, "
              f"|latents| max {lat.abs().max().item():.3f}; launches "
              f"{ {k: v for k, v in delta.items() if v} }")
        check(torch.isfinite(lat).all().item() and len(ijk) > 0,
              f"{sampler} chunk")
        check(all(delta[k] == v for k, v in want.items()),
              f"{sampler} launches {delta}, want {want}")
    paths["stage1_samplers"] = dict(kernels.launches)
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launches()
        t0 = time.perf_counter()
        sc.main(["--output", tmp, "--ddim_steps", str(STAGE1_DDIM)])
        torch.cuda.synchronize()
        paths["single_chunk"] = dict(kernels.launches)
        out = np.load(os.path.join(tmp, "chunk.npz"))
        print(f"[single chunk] the CLI at the release config (bf16, no "
              f"guidance): {len(out['ijk'])} voxels in "
              f"{time.perf_counter() - t0:.1f} s; launches "
              f"{ {k: v for k, v in paths['single_chunk'].items() if v} }")
        check(paths["single_chunk"]["conv3x3x3_bf16"] == 48 * STAGE1_DDIM,
              f"single chunk launches {paths['single_chunk']}")
    torch.cuda.empty_cache()
    return diffusion, vae, gen, paths


def wan_qkv(kernels, WanPipelineConfig, WanVideoGenerator):
    """Phase 20's video request: the serving profile with int8-PV
    self-attention (K8), one 17-frame, 4-step request."""
    serve = WanPipelineConfig.serving()
    cfg = dataclasses.replace(serve, dit=dataclasses.replace(
        serve.dit, attn_quant="qkv"))
    t0 = time.perf_counter()
    gen = WanVideoGenerator(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    gen.init_params(g)
    fill_zero_init(gen.dit, g)
    gen.cast_params_bf16()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    sem = rng.integers(0, 256, (17, 480, 832, 3), dtype=np.uint8)
    coo = rng.integers(0, 256, (17, 480, 832, 3), dtype=np.uint8)
    kernels.reset_launches()
    t0 = time.perf_counter()
    frames = gen.generate(sem, coo, "a realistic driving scene at dusk",
                          negative_prompt="blurry", seed=0, num_steps=4)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    print(f"[wan qkv] towers built in {build_s:.1f} s; one request "
          f"(17f, 4 steps) {wall:.2f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(isinstance(frames, np.ndarray) and frames.shape ==
          (17, 480, 832, 3) and frames.min() != frames.max(), "qkv frames")
    check(launches["flash_attn_int8qkv"] == 30 * 2 * 4 and
          launches["flash_attn_int8qk"] == 0 and
          launches["flash_attn_bf16"] == 30 * 2 * 4,
          f"qkv request launches {launches}")
    return launches


def int8_time(diffusion, gen, mods):
    """Phase 21: one CFG DDIM step (batch 2) through the int8 twin and
    through the bf16 UNet, timed, profiled, with peak memory; then a DDIM-10
    chunk from the same noise through each, and their final latents'
    cosine."""
    ego, maps, boxes = stage1_scene()
    cond = gen._cond_for_chunk(np.eye(4), maps, boxes)
    null = mods.CondCubes.null(1, diffusion.cfg, "cuda")
    cond2 = mods.CondCubes(torch.cat([cond.map_cube, null.map_cube]),
                           torch.cat([cond.box_cube, null.box_cube]))
    g = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn((2, 64, 64, 64, 8), generator=g, device="cuda")
    t = torch.tensor([500, 500], device="cuda")
    for label, serve in (("int8", True), ("bf16", False)):
        def step():
            with torch.no_grad():
                return diffusion.denoise(x, t, cond2, serve=serve)
        step()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"[time] one CFG DDIM step (batch 2, 64^3), {label}: "
              f"{np.mean(times):.1f} ms (runs {[round(v, 1) for v in times]}"
              f"), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        profile(step, f"CFG DDIM step, {label}", shares={
            "K7's quantize prologue (its three kernels)": (
                "int8_conv_amax", "int8_conv_quantize"),
            "K7 (and its split-K reduce)": ("conv3x3x3_wgmma_kernel<1,",
                                            "int8_splitk")})
    bf16 = mods.VoxelDiffusion(mods.DiffusionConfig(), device="cuda")
    bf16.load_params(diffusion.unet.state_dict())
    x_T = torch.randn((1, 64, 64, 64, 8), generator=g, device="cuda")
    lat = [m.sample(cond, STAGE1_DDIM, GUIDANCE, noise=x_T)
           for m in (diffusion, bf16)]
    c = cos(lat[0], lat[1])
    print(f"[time] DDIM-{STAGE1_DDIM} chunk with CFG {GUIDANCE}, same noise: "
          f"final latents int8 vs bf16 cosine {c:.6f}")
    check(c >= 0.99, f"int8 vs bf16 chunk cosine {c}")


def int8_serving(kernels, dense_conv, fa):
    """Phases 18-21. Returns the summary entries of K7, its three prologue
    kernels and K8 and the launches of the new paths."""
    from infinicube_tpu_torch.inference import \
        voxel_generation_single_chunk as sc
    from infinicube_tpu_torch.inference.voxel_world_generation import (
        VoxelWorldGenerator, WorldGenConfig, vae_decode_fn)
    from infinicube_tpu_torch.models.diffusion.model import (CondCubes,
                                                             DiffusionConfig,
                                                             VoxelDiffusion)
    from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                       SparseVAEConfig)
    from infinicube_tpu_torch.models.wan.dit import WanDiT
    from infinicube_tpu_torch.models.wan.pipeline import (WanPipelineConfig,
                                                          WanVideoGenerator)
    mods = types.SimpleNamespace(
        VoxelDiffusion=VoxelDiffusion, DiffusionConfig=DiffusionConfig,
        CondCubes=CondCubes, SparseStructureVAE=SparseStructureVAE,
        SparseVAEConfig=SparseVAEConfig,
        VoxelWorldGenerator=VoxelWorldGenerator,
        WorldGenConfig=WorldGenConfig, vae_decode_fn=vae_decode_fn)
    t0 = time.perf_counter()

    def phase(n):
        print(f"[int8] phase {n} at {time.perf_counter() - t0:.1f} s")
    # ---- 18. kernel checks ------------------------------------------------
    phase(18)
    k7_rows, prologue_rows = k7_checks(kernels, dense_conv)
    k8_rows = k8_checks(kernels, fa)
    # ---- 19. model checks -------------------------------------------------
    phase(19)
    unet_int8_check(VoxelDiffusion, DiffusionConfig)
    serve = WanPipelineConfig.serving()
    model_check(WanDiT, dataclasses.replace(serve.dit, num_layers=2,
                                            attn_quant="qkv"))
    # ---- 20. serving ------------------------------------------------------
    phase(20)
    diffusion, vae, gen, paths = serve_int8(kernels, mods, sc)
    # ---- 21. where the time goes ------------------------------------------
    phase(21)
    int8_time(diffusion, gen, mods)
    del diffusion, vae, gen
    torch.cuda.empty_cache()
    phase("20, video")
    paths["wan_qkv"] = wan_qkv(kernels, WanPipelineConfig, WanVideoGenerator)
    phase("end")
    prologue = {name: entry(name, "infinicube_tpu_torch/csrc/dense_conv.cu",
                            "infinicube_tpu/ops/dense_conv.py:251", r, 0)
                for name, r in prologue_rows.items()}
    return {"conv3x3x3_int8": entry(
                "conv3x3x3_int8", "infinicube_tpu_torch/csrc/dense_conv.cu",
                "infinicube_tpu/ops/dense_conv.py:136", k7_rows, 0),
            **prologue,
            "flash_attn_int8qkv": entry(
                "flash_attn_int8qkv",
                "infinicube_tpu_torch/csrc/flash_attention.cu",
                "infinicube_tpu/ops/flash_attention.py:159", k8_rows, 1)}, \
        paths


# ---------------------------------------------------------------------------
# every width and f32: K7 at widths that are not multiples of 32, the f32
# conv, an f32 stage-1 model
# ---------------------------------------------------------------------------

# K7 at widths the int8 rule admits and the kernel takes only padded to 32
K7_PADDED_SHAPES = ((16, 64, 72), (16, 72, 104))
F32_STEPS = 2       # DDIM steps of the f32 main path


def k7_padded_checks(dc):
    """The int8 conv through ``conv3x3x3(quant=True)`` (K7 on operands
    zero-padded to multiples of 32, the output sliced back) against the
    unpadded ``conv3x3x3_int8_plain``: equal outputs."""
    g = torch.Generator(device="cuda").manual_seed(16)
    for n, C, O in K7_PADDED_SHAPES:
        check(dc.int8_conv_applies((2, n, n, n), C, O),
              f"the int8 rule does not hold at {n}^3 {C}->{O}")
        x = (torch.randn((2, n, n, n, C), generator=g, device="cuda") *
             torch.logspace(-1, 1, C, device="cuda")).to(torch.bfloat16)
        w = (torch.randn((O, C, 3, 3, 3), generator=g, device="cuda") /
             math.sqrt(27 * C)).to(torch.bfloat16)
        b = 0.1 * torch.randn(O, generator=g, device="cuda")
        with torch.no_grad():
            got = dc.conv3x3x3(x, w, b, quant=True)
        x8, w8, sw = dc.quantize_for_conv(x, w)
        ref = dc.conv3x3x3_int8_plain(x8, w8, sw, b, torch.bfloat16)
        err = (got.float() - ref.float()).abs().max().item()
        print(f"[k7 padded] [2,{n}^3] {C}->{O} (K7 at {-(-C // 32) * 32}->"
              f"{-(-O // 32) * 32}): max_abs_err {err:.3e}, outputs equal "
              f"{torch.equal(got, ref)}")
        check(got.shape == ref.shape and torch.equal(got, ref),
              f"padded K7 at {n}^3 {C}->{O}: err {err}")


def f32_conv_checks(kernels, dc):
    """``conv3x3x3_f32`` (3xTF32) at the release UNet's conv shapes against
    the plain f32 conv (cuDNN, TF32 off) on the same inputs, max-abs <=
    1e-4 * max|ref|, forward and as dgrad (the flipped, swapped pack, no
    bias), each run twice bit-identical where it splits K; timed beside the
    plain version, cuDNN's f32 conv3d forward and backward-data
    (channels_last_3d), its 3xTF32 bound (3 * 2*V*27*C*O at 495 TFLOP/s)
    and the f32 CUDA-core bound (2*V*27*C*O at 67 TFLOP/s)."""
    g = torch.Generator(device="cuda").manual_seed(17)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for n, C, O in K3_SHAPES:
        x = torch.randn((1, n, n, n, C), generator=g, device="cuda")
        w = torch.randn((O, C, 3, 3, 3), generator=g, device="cuda") / \
            math.sqrt(27 * C)
        b = 0.1 * torch.randn(O, generator=g, device="cuda")
        go = torch.randn((1, n, n, n, O), generator=g, device="cuda")
        wp = dc.pack_conv_weight(w, torch.float32)
        wd = dc.pack_conv_weight(dc.dgrad_weight(w), torch.float32)
        shape = f"[1,{n},{n},{n},{C}]->{O}"
        errs = []
        for label, run, ref_fn, out_ch in (
                ("forward", lambda: kernels.conv3x3x3_f32(x, wp, b),
                 lambda: dc.conv3x3x3_plain(x, w, b), O),
                ("dgrad", lambda: kernels.conv3x3x3_f32(go, wd, None),
                 lambda: dc.conv3x3x3_plain(go, dc.dgrad_weight(w),
                                            torch.zeros(C, device="cuda")),
                 C)):
            got, ref = run(), ref_fn()
            err = (got - ref).abs().max().item()
            lim = 1e-4 * ref.abs().max().item()
            src = (go if label == "dgrad" else x).shape
            splits = kernels.f32_conv_splits(*src, out_ch, sms)
            same = torch.equal(got, run()) if splits > 1 else None
            print(f"[f32 conv] {label} {shape}: cosine {cos(got, ref):.8f} "
                  f"max_abs_err {err:.3e} (limit {lim:.3e}), {splits} K "
                  f"slice(s)" + ("" if same is None else
                                 f", two runs bit-identical {same}"))
            check(torch.isfinite(got).all().item() and err <= lim,
                  f"conv3x3x3_f32 {label} at {shape}: err {err}")
            check(same is not False, f"conv3x3x3_f32 {label} at {shape}: "
                  "split runs differ")
            errs.append(err)
            del got, ref
        iters = 3 if n == 64 else 10
        ms = cuda_ms(lambda: kernels.conv3x3x3_f32(x, wp, b), 1, iters)
        dg_ms = cuda_ms(lambda: kernels.conv3x3x3_f32(go, wd, None), 1,
                        iters)
        plain = cuda_ms(lambda: dc.conv3x3x3_plain(x, w, b), 1, 3)
        xl, gl = x.permute(0, 4, 1, 2, 3), go.permute(0, 4, 1, 2, 3)
        wl = w.contiguous(memory_format=torch.channels_last_3d)
        lib = cuda_ms(lambda: torch.nn.functional.conv3d(xl, wl, b,
                                                         padding=1), 1, iters)
        lib_dg = cuda_ms(lambda: torch.nn.grad.conv3d_input(
            xl.shape, wl, gl, padding=1), 1, iters)
        V = n ** 3
        flops = 2.0 * V * 27 * C * O
        b_ms, b_by, core_ms = tf32x3_bounds(
            flops, 4 * (V * C + 27 * C * O + V * O + O))
        print(f"[f32 conv] {shape}: kernel {ms:.3f} ms ({flops / ms / 1e9:.2f}"
              f" TFLOP/s of f32 work, {100 * b_ms / ms:.1f} % of its bound), "
              f"dgrad {dg_ms:.3f} ms; plain {plain:.3f} ms; cudnn f32 "
              f"{lib:.3f} ms, backward-data {lib_dg:.3f} ms; bound "
              f"{b_ms:.3f} ms ({b_by}, 3 TF32 products at 495 TFLOP/s; the "
              f"f32 CUDA-core bound {core_ms:.3f} ms)")
        rows.append(dict(shape=shape, max_abs_err=max(errs), ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib, dgrad_ms=dg_ms,
                         library_dgrad_ms=lib_dg, f32_core_bound_ms=core_ms))
        del x, w, go, wp, wd, xl, gl, wl
        torch.cuda.empty_cache()
    return rows


# flash_attn_f32's shapes: the UNet's two SelfAttention3D ones, Nq != Nk at
# d = 64, and the GSM pixel branch's SelfAttn2D at inference (N = 5,280, 4
# heads of 64): (Nq, Nk, heads, head dim)
F32_ATTN_SHAPES = ((4096, 4096, H96, D96), (512, 512, H96, D96),
                   (1000, 777, 4, 64), (5280, 5280, 4, 64))


def f32_attn_checks(kernels, att):
    """``flash_attn_f32`` (3xTF32, through ``multi_head_attention``, no
    gradient) against ``attention_plain`` in f32 on the same inputs, max-abs
    <= 1e-4 * max|ref| (as ``conv3x3x3_f32``); where the keys are split
    into ranges (N = 512), two runs bit-identical; timed with CUDA events
    beside the plain version, its 3xTF32 bound, the f32 CUDA-core bound and
    ``scaled_dot_product_attention`` on f32 inputs (TF32 off); at N = 512
    the host's time to issue a call bounds both (``chip_time_kernels.py``
    times their device time alone)."""
    g = torch.Generator(device="cuda").manual_seed(20)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for nq, nk, h, d in F32_ATTN_SHAPES:
        q, k, v = (rand((1, n, h, d), g, torch.float32) for n in (nq, nk, nk))
        scale = d ** -0.5
        shape = f"Nq={nq} Nk={nk} h={h} d={d}"
        before = kernels.launches["flash_attn_f32"]
        with torch.no_grad():
            got = att.multi_head_attention(q, k, v)
        check(kernels.launches["flash_attn_f32"] == before + 1,
              f"[f32 attn] {shape}: not through flash_attn_f32")
        ref = att.attention_plain(q, k, v, scale)
        err = (got - ref).abs().max().item()
        lim = 1e-4 * ref.abs().max().item()
        splits = kernels.f32_attn_splits(1, h, nq, nk, d, sms)
        same = torch.equal(got, kernels.flash_attn_f32(q, k, v, scale)) \
            if splits > 1 else None
        print(f"[f32 attn] {shape}: cosine {cos(got, ref):.8f} max_abs_err "
              f"{err:.3e} (limit {lim:.3e}), {splits} key range(s)" +
              ("" if same is None else f", two runs bit-identical {same}"))
        check(torch.isfinite(got).all().item() and err <= lim,
              f"flash_attn_f32 at {shape}: err {err}")
        check(same is not False, f"flash_attn_f32 at {shape}: split runs "
              "differ")
        ms = cuda_ms(lambda: kernels.flash_attn_f32(q, k, v, scale), 2, 10)
        plain = cuda_ms(lambda: att.attention_plain(q, k, v, scale), 1, 3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = cuda_ms(lambda: torch.nn.functional
                      .scaled_dot_product_attention(qt, kt, vt), 2, 10)
        flops = 4.0 * nq * nk * d * h
        b_ms, b_by, core_ms = tf32x3_bounds(flops, 4 * 2 * (nq + nk) * d * h)
        print(f"[f32 attn] {shape}: kernel {ms:.4f} ms ({flops / ms / 1e9:.2f}"
              f" TFLOP/s of f32 work, {100 * b_ms / ms:.1f} % of its bound), "
              f"plain {plain:.3f} ms, sdpa f32 {lib:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}, 3 TF32 products at 495 TFLOP/s; the "
              f"f32 CUDA-core bound {core_ms:.4f} ms)")
        rows.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                         f32_core_bound_ms=core_ms, key_ranges=splits))
        del q, k, v, qt, kt, vt, got, ref
    torch.cuda.empty_cache()
    return rows


def f32_config(DiffusionConfig, **kw):
    """The release UNet computing in f32, SelfAttention3D blocks at the
    release ``attention_ds`` included (``flash_attn_f32``)."""
    return DiffusionConfig(dtype=torch.float32, **kw)


def unet_f32_check(kernels, VoxelDiffusion, DiffusionConfig):
    """The f32 release-width UNet on a 16^3 cube: card (``conv3x3x3_f32``,
    ``flash_attn_f32`` in its 10 SelfAttention3D blocks, TF32 off) against
    the CPU (plain versions), same weights: cosine >= 0.99999 and max-abs
    <= 1e-3 * max|ref|."""
    base = f32_config(DiffusionConfig, cube_dims=(16, 16, 16))
    cpu = VoxelDiffusion(base, device="cpu")
    cpu.init_params(torch.Generator().manual_seed(18), zero_init_layers=False)
    card = VoxelDiffusion(base, device="cuda")
    card.load_params(cpu.unet.state_dict())
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, 16, 16),
                                             dtype=np.float32))
    t = torch.tensor([500])
    before = kernels.launches["flash_attn_f32"]
    with torch.no_grad():
        ref = cpu.unet(x, t)
        got = card.unet(x.cuda(), t.cuda()).cpu()
    attn = kernels.launches["flash_attn_f32"] - before
    c, err = cos(got, ref), (got - ref).abs().max().item()
    lim = 1e-3 * ref.abs().max().item()
    print(f"[model] f32 release-width UNet (with SelfAttention3D, "
          f"{attn} flash_attn_f32 launches) on 16^3: card vs cpu cosine "
          f"{c:.8f}, max_abs_err {err:.3e} (limit {lim:.3e})")
    check(attn == 10, f"f32 UNet: {attn} f32 attention launches, want 10")
    check(torch.isfinite(got).all().item(), "f32 UNet output not finite")
    check(c >= 0.99999 and err <= lim, f"f32 UNet: cos {c} err {err}")


def serve_f32(kernels, mods):
    """The f32 stage-1 path: one chunk of ``evaluation_api`` with the f32
    release UNet on the 64^3 cube (DDIM-2) and the release VAE's decode;
    exactly 48 f32 conv and 10 f32 attention launches a step and K4 12,
    nothing else."""
    diffusion = mods.VoxelDiffusion(f32_config(mods.DiffusionConfig),
                                    device="cuda")
    g = torch.Generator(device="cuda").manual_seed(19)
    diffusion.init_params(g, zero_init_layers=False)
    vae = mods.SparseStructureVAE(mods.SparseVAEConfig(), device="cuda")
    vae.init_params(g)
    gen = mods.VoxelWorldGenerator(
        diffusion, mods.vae_decode_fn(vae),
        mods.WorldGenConfig(ddim_steps=F32_STEPS))
    _, maps, boxes = stage1_scene()
    cond = gen._cond_for_chunk(np.eye(4), maps, boxes)
    want = {k: 0 for k in kernels.launches} | {
        "conv3x3x3_f32": 48 * F32_STEPS, "flash_attn_f32": 10 * F32_STEPS,
        "sparse_conv_f32": 12}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    lat, (ijk, _) = diffusion.evaluation_api(
        cond, mods.vae_decode_fn(vae), num_steps=F32_STEPS,
        guidance_scale=1.0, generator=g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    print(f"[f32] one chunk, f32 UNet, DDIM-{F32_STEPS} and decode: "
          f"{wall:.2f} s, {len(ijk)} voxels, |latents| max "
          f"{lat.abs().max().item():.3f}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(lat.dtype == torch.float32 and torch.isfinite(lat).all().item(),
          "f32 chunk latents")
    check(launches == want, f"f32 chunk launches {launches}, want {want}")
    return launches


def widths_and_f32(kernels, att, dense_conv):
    """Phases 22-24. Returns the summary entries of ``conv3x3x3_f32`` and
    ``flash_attn_f32``, the launches of the f32 path and the padded-width
    checks of phase 22 (kernel -> rows and launches)."""
    from infinicube_tpu_torch.inference.voxel_world_generation import (
        VoxelWorldGenerator, WorldGenConfig, vae_decode_fn)
    from infinicube_tpu_torch.models.diffusion.model import (DiffusionConfig,
                                                             VoxelDiffusion)
    from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                       SparseVAEConfig)
    mods = types.SimpleNamespace(
        VoxelDiffusion=VoxelDiffusion, DiffusionConfig=DiffusionConfig,
        SparseStructureVAE=SparseStructureVAE,
        SparseVAEConfig=SparseVAEConfig,
        VoxelWorldGenerator=VoxelWorldGenerator,
        WorldGenConfig=WorldGenConfig, vae_decode_fn=vae_decode_fn)
    # ---- 22. kernel checks --------------------------------------------------
    padding = padding_checks(kernels)
    k7_padded_checks(dense_conv)
    rows = f32_conv_checks(kernels, dense_conv)
    attn_rows = f32_attn_checks(kernels, att)
    # ---- 23. model check ----------------------------------------------------
    unet_f32_check(kernels, VoxelDiffusion, DiffusionConfig)
    # ---- 24. the f32 stage-1 path -------------------------------------------
    launches = serve_f32(kernels, mods)
    torch.cuda.empty_cache()
    return {"conv3x3x3_f32": entry(
                "conv3x3x3_f32", "infinicube_tpu_torch/csrc/dense_conv.cu",
                "infinicube_tpu/ops/dense_conv.py:177", rows, 1),
            "flash_attn_f32": entry(
                "flash_attn_f32",
                "infinicube_tpu_torch/csrc/flash_attention_f32.cu",
                "infinicube_tpu/ops/attention.py:72", attn_rows, 0)}, \
        launches, padding


# ---------------------------------------------------------------------------
# head dims and widths the kernels take only padded (phase 22)
# ---------------------------------------------------------------------------

# attention at head dims below 64 (the e2e demo's GSM attends at d = 16):
# (batch, N, heads, head dim); K1 and K8 at d = 16 and 96
PAD_ATTN = ((1, 5280, 4, 16), (1, 5280, 4, 32), (2, 1000, 3, 48))
PAD_INT8 = ((1, 7800, 4, 16), (1, 7800, 4, 96))
# sparse-conv widths 2 mod 4: (F, Fo)
PAD_SPARSE = ((30, 30), (30, 62))


def padding_checks(kernels):
    """Phase 22's checks of the two closed faults, each through the entry
    point a model calls and against the plain version at the true width:
    ``multi_head_attention`` at d = 16, 32 and 48 (bf16 forward and dq, dk,
    dv through K2 and K5 at K2's / K5's gates; f32 forward through
    ``flash_attn_f32``, max-abs <= 1e-4 * max|ref|), ``mha_quantized`` at
    d = 16 and 96 (K1 and K8, cosine >= 0.999 against the plain int8
    attention on the unpadded int8 inputs), and ``window_sparse_conv`` at
    30 -> 30 and 30 -> 62 on a voxel sheet (K4 forward and dx <= 1e-4, K6
    dW <= 5e-4 * max|ref|). Returns {kernel: {"rows": [...], "launches":
    n}}: these launches compare, so no path counts them."""
    from infinicube_tpu_torch.grid.build import grid_from_ijk
    from infinicube_tpu_torch.nn.sparse import conv_plan
    from infinicube_tpu_torch.ops import attention as att
    from infinicube_tpu_torch.ops import flash_attention as fa
    from infinicube_tpu_torch.ops import window_conv as wc
    g = torch.Generator(device="cuda").manual_seed(22)
    rows = {}
    before = dict(kernels.launches)

    def note(name, shape, err):
        rows.setdefault(name, []).append({"shape": shape, "max_abs_err": err})

    for B, n, h, d in PAD_ATTN:
        q, k, v, do = (rand((B, n, h, d), g, torch.float32)
                       for _ in range(4))
        leaves = [t.to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
        out = att.multi_head_attention(*leaves)
        out.backward(do.to(torch.bfloat16))
        ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
        ref = att.attention_plain(*ref_leaves, d ** -0.5)
        ref.backward(do.to(torch.bfloat16).float())
        shape = f"{B}x{n}x{h}x{d}"
        check(out.shape == (B, n, h, d), f"padded K2 output {out.shape}")
        note("flash_attn_bf16", shape,
             k2_gate(out, ref, f"[pad] K2 {shape}"))
        note("flash_attn_bf16_bwd", shape, max(
            gate(a.grad, b.grad, f"[pad] K5 d{nm} {shape}")
            for nm, a, b in zip("qkv", leaves, ref_leaves)))
        with torch.no_grad():
            o32 = att.multi_head_attention(q, k, v)
            r32 = att.attention_plain(q, k, v, d ** -0.5)
        err = (o32 - r32).abs().max().item()
        lim = 1e-4 * r32.abs().max().item()
        print(f"[pad] flash_attn_f32 {shape}: max_abs_err {err:.3e} (limit "
              f"{lim:.3e})")
        check(o32.shape == (B, n, h, d) and err <= lim,
              f"padded flash_attn_f32 {shape}: err {err}")
        note("flash_attn_f32", shape, err)
    for B, n, h, d in PAD_INT8:
        q = scale_blocks(rand((B, n, h, d), g), 1536, 0.25, 4.0)
        k = scale_blocks(rand((B, n, h, d), g), 1536, 4.0, 0.25)
        v = rand((B, n, h, d), g)
        block, npad = fa.quant_blocks(n)
        q8, sq = fa.block_quantize(fa.fold_heads(q, npad), block)
        k8, sk = fa.block_quantize(fa.fold_heads(k, npad), block)
        v8, sv = fa.channel_quantize(fa.fold_heads(v, npad))
        shape = f"{B}x{n}x{h}x{d}"
        for quant, name in (("qk", "flash_attn_int8qk"),
                            ("qkv", "flash_attn_int8qkv")):
            out = fa.mha_quantized(q, k, v, quant=quant)
            if quant == "qk":
                ref = fa.int8qk_attention_plain(q8, k8, sq, sk, v, block,
                                                d ** -0.5)
            else:
                ref = fa.int8qkv_attention_plain(
                    q8, k8, sq, sk, v8, sv, n, block, d ** -0.5,
                    torch.float32).reshape(B, h, n, d).permute(0, 2, 1, 3)
            c = cos(out, ref)
            err = (out.float() - ref.float()).abs().max().item()
            print(f"[pad] {name} {shape}: cosine {c:.6f} max_abs_err "
                  f"{err:.3e}")
            check(out.shape == (B, n, h, d) and c >= 0.999,
                  f"padded {name} {shape}: cos {c}")
            note(name, shape, err)
    n_pts, cap = 60000, 65536
    ij = torch.randint(-60, 60, (1, n_pts, 2), generator=g, device="cuda")
    kk = (torch.sin(ij[..., :1] * 0.3) * 3).round().int()
    grid = grid_from_ijk(torch.cat([ij, kk], -1).int(), torch.ones(
        (1, n_pts), dtype=torch.bool, device="cuda"), 0.2, 0.1, cap)
    plan = conv_plan(grid, dense_bounds=((-64, -64, -64), (128, 128, 128)))
    m = grid.mask[..., None]
    for F, Fo in PAD_SPARSE:
        x = torch.where(m, rand((1, cap, F), g, torch.float32), 0.0)
        w = rand((27, F, Fo), g, torch.float32) / (27 * F) ** 0.5
        gout = torch.where(m, rand((1, cap, Fo), g, torch.float32), 0.0)
        feats, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = wc.window_sparse_conv(plan, feats, wl)
        out.backward(gout)
        ref = wc.sparse_conv_plain(plan, x, w)
        ref_dx, ref_dw = wc.sparse_conv_bwd_plain(plan, x, w, gout)
        shape = f"{F}->{Fo}"
        for name, got, want, rel in (
                ("sparse_conv_f32", out, ref, 1e-4),
                ("sparse_conv_f32_dgrad", feats.grad, ref_dx, 1e-4),
                ("sparse_conv_f32_wgrad", wl.grad, ref_dw, 5e-4)):
            err = (got - want).abs().max().item()
            lim = rel * want.abs().max().item()
            print(f"[pad] {name} {shape}: max_abs_err {err:.3e} (limit "
                  f"{lim:.3e})")
            check(got.shape == want.shape and err <= lim,
                  f"padded {name} {shape}: err {err}")
            note(name, shape, err)
    after = dict(kernels.launches)
    out = {name: {"rows": r, "launches": after[name] - before[name]}
           for name, r in rows.items()}
    for name, e in out.items():
        check(e["launches"] > 0, f"{name} not launched in phase 22's checks")
    print(f"[pad] launches {({k: v['launches'] for k, v in out.items()})}")
    return out


# ---------------------------------------------------------------------------
# stage 2: the guidance buffers
# ---------------------------------------------------------------------------

STAGE2_FRAMES = 93
STAGE2_DDA_CHUNK = 8
CAMERA_HEIGHT = 1.8


def stage2_poses(gb, n=STAGE2_FRAMES):
    """The camera along phase 8's ego path, 1.8 m up, resampled to ``n``
    FLU poses as the CLI does."""
    ego, _, _ = stage1_scene()
    cam = ego.copy()
    cam[:, 2, 3] = CAMERA_HEIGHT
    return cam, gb.resample_trajectory(cam, n)


def stage2_objects(bf, n=STAGE2_FRAMES):
    """The stage-1 scene's 4 boxes as cars driving 0.25 m a frame along x,
    ids 10000-10003."""
    _, _, boxes = stage1_scene()
    M = len(boxes["poses"])
    poses = np.repeat(boxes["poses"][None], n, 0).astype(np.float32)
    poses[:, :, 0, 3] += 0.25 * np.arange(n)[:, None]
    return bf.DynamicObjects(
        poses=torch.from_numpy(poses),
        lwh=torch.tensor(boxes["lwhs"], dtype=torch.float32),
        ids=torch.arange(10000, 10000 + M, dtype=torch.int32),
        sem=torch.ones(M, dtype=torch.int32),
        valid=torch.ones((n, M), dtype=torch.bool))


def hold_buffers(got, ref, label, atol):
    """Card against CPU: semantic and instance equal on >= 99.9 % of pixels,
    depth within ``atol`` where the winners agree (a pixel whose class,
    instance or depth differs has another winner: at most 0.1 %)."""
    same = (got.semantic.cpu() == ref.semantic) & \
        (got.instance.cpu() == ref.instance)
    close = (got.depth.cpu() - ref.depth).abs() <= atol
    s_sem = (got.semantic.cpu() == ref.semantic).float().mean().item()
    s_ins = (got.instance.cpu() == ref.instance).float().mean().item()
    s_all = (same & close).float().mean().item()
    d_err = (got.depth.cpu() - ref.depth)[same].abs().max().item()
    print(f"[stage2] {label}: semantic equal {100 * s_sem:.4f} %, instance "
          f"{100 * s_ins:.4f} %, class, instance and depth (<= {atol}) "
          f"{100 * s_all:.4f} %; depth max err where the class agrees "
          f"{d_err:.3e}; hit share {(ref.depth > 0).float().mean():.3f}")
    check(s_sem >= 0.999 and s_ins >= 0.999 and s_all >= 0.999,
          f"{label}: card against CPU")


def stage2_checks(gb, bf, world):
    """Phase 25: ``splat_frame`` for 2 frames at 480x832 on phase 8's world,
    card against CPU (and the z-buffer's winner slots, depth within 1e-3 m
    where they agree); the DDA route for 1 frame at 240x416 card against
    CPU; splat against DDA at tests/test_buffers.py:110's depth and hit
    gates, held where the splat footprint closes the voxel lattice
    (whole-frame numbers printed beside: nearer, the splat route leaves
    holes by design, the reference's as much as the port's), and the class
    where both routes see the same voxel."""
    from infinicube_tpu_torch.camera.conventions import flu_to_opencv
    cam = gb.DEFAULT_CAMERA
    _, poses = stage2_poses(gb)
    objs = stage2_objects(bf)
    sides = {}
    for dev in ("cuda", "cpu"):
        grid, sem, inst = gb.world_to_grid(world, device=dev)
        pcv = torch.as_tensor(np.stack([flu_to_opencv(p) for p in poses]),
                              dtype=torch.float32, device=dev)
        sides[dev] = (grid, sem, inst, pcv, objs.to(dev),
                      cam.intrinsics_matrix(dev))
    frames = (0, STAGE2_FRAMES // 2)
    out = {}
    for dev, (grid, sem, inst, pcv, ob, K) in sides.items():
        pts_of = bf.splat_points(grid, sem, inst, ob)
        fbs, wins = [], []
        for t in frames:
            pts, att, val, rad = pts_of(t)
            fbs.append(bf.splat_frame(pts, att, val, rad, K, pcv[t],
                                      (cam.h, cam.w)))
            wins.append(bf.splat_winner_slots(pts, val, rad, K, pcv[t],
                                              (cam.h, cam.w)))
        out[dev] = fbs, wins
    for i, t in enumerate(frames):
        hold_buffers(out["cuda"][0][i], out["cpu"][0][i],
                     f"splat frame {t}, card vs CPU", 1e-3)
        (wc, zc), (wh, zh) = out["cuda"][1][i], out["cpu"][1][i]
        agree = (wc.cpu() == wh) & (wh >= 0)
        share = (wc.cpu() == wh).float().mean().item()
        zerr = (zc.cpu() - zh)[agree].abs().max().item()
        print(f"[stage2] splat frame {t}: winner slots equal on "
              f"{100 * share:.4f} % of pixels, z max err there {zerr:.3e}")
        check(share >= 0.999 and zerr <= 1e-3, f"splat frame {t} winners")
    half = cam.rescale(0.5)
    dda = {}
    for dev, (grid, sem, inst, pcv, ob, K) in sides.items():
        mn, mx = (b[0].cpu().numpy() for b in grid.bbox_ijk())
        t0 = time.perf_counter()
        blocks = bf.build_static_blocks(grid, sem, inst, tuple(mn),
                                        tuple(mx - mn + 1))
        fb = bf.render_sequence(blocks, ob, half.intrinsics_matrix(dev),
                                pcv[:1], (half.h, half.w))
        if dev == "cuda":
            torch.cuda.synchronize()
        print(f"[stage2] DDA frame 0 at {half.h}x{half.w} on {dev}: "
              f"{time.perf_counter() - t0:.2f} s (blocks "
              f"{tuple(int(v) for v in mx - mn + 1)}"
              f")")
        dda[dev] = fb, blocks
    one = lambda fb: bf.FrameBuffers(fb.depth[0], fb.semantic[0],  # noqa
                                     fb.instance[0])
    hold_buffers(one(dda["cuda"][0]), one(dda["cpu"][0]),
                 "DDA frame 0 (240x416), card vs CPU", 1e-3)
    fb_dda, blocks = dda["cuda"]
    del dda
    grid, sem, inst, pcv, ob, K = sides["cuda"]
    Kh = half.intrinsics_matrix("cuda")
    spl = bf.render_sequence_splat(grid, sem, inst, ob, Kh, pcv[:1],
                                   (half.h, half.w))
    d1, d2 = fb_dda.depth[0], spl.depth[0]
    s1, s2 = fb_dda.semantic[0], spl.semantic[0]
    # the splat route's footprint (at most 5 x 5 px) closes the voxel
    # lattice only where a voxel spans at most 5 px: beyond fx * vs / 5 m;
    # nearer, the reference's splat route leaves holes the DDA fills. The
    # gates (tests/test_buffers.py:110's) hold on the whole frame; the
    # share beyond that distance is printed beside it
    z_closed = half.fx * float(world.voxel_size.max()) / \
        (2 * bf._STENCIL + 1)
    agree = {}
    for label, region in (("whole frame", torch.ones_like(d1, dtype=bool)),
                          (f"beyond {z_closed:.1f} m", d1 >= z_closed)):
        both = (d1 > 0) & (d2 > 0) & region
        close = ((d1 - d2).abs()[both] < 1.0).float().mean().item()
        sem_eq = (s1[both] == s2[both]).float().mean().item()
        hits = ((d1 > 0) == (d2 > 0))[region].float().mean().item()
        agree[label] = close, hits
        print(f"[stage2] splat vs DDA, frame 0 at 240x416, {label} "
              f"({100 * region.float().mean().item():.1f} % of pixels): "
              f"depth within 1 m on {100 * close:.2f} % of the pixels both "
              f"hit, semantic equal {100 * sem_eq:.2f} %, hit masks equal "
              f"{100 * hits:.2f} %")
    close, hits = agree["whole frame"]
    check(close > 0.85 and hits > 0.9, "splat against DDA, whole frame")
    # the classes: the splat's winner is a voxel center, the DDA's the
    # first cell a ray enters, often the neighbour, and a random-weight
    # world's voxels each carry their own class, so the class agrees by
    # pixel far less than on coherent surfaces, the reference's routes
    # alike (tests/test_torch_stage2_routes.py); where both routes see the
    # same static voxel (no car in front), the class must agree
    from infinicube_tpu_torch.camera.projection import \
        posed_rays_from_intrinsics
    from infinicube_tpu_torch.ops.raycast import dda_first_hit
    ro, rd = posed_rays_from_intrinsics(Kh, pcv[0], (half.h, half.w))
    hit = dda_first_hit(blocks.occ, ro.reshape(-1, 3), rd.reshape(-1, 3),
                        blocks.voxel_size, blocks.origin, blocks.ijk_min,
                        max_steps=768, skip_dist=blocks.skip)
    pts, _, val, rad = bf.splat_points(grid, sem, inst, ob)(0)
    win, _ = bf.splat_winner_slots(pts, val, rad, Kh, pcv[0],
                                   (half.h, half.w))
    C = grid.capacity
    win = win.reshape(-1)
    no_car = (fb_dda.instance[0] < 10000) & (spl.instance[0] < 10000)
    same = hit.hit & (win >= 0) & (win < C) & no_car.reshape(-1) & (
        grid.ijk[0][win.clamp(0, C - 1)] == hit.ijk).all(-1)
    both = (d1 > 0) & (d2 > 0)
    share = same.float().sum().item() / max(1, both.sum().item())
    sem_same = (s1.reshape(-1)[same] == s2.reshape(-1)[same]).float().mean()
    print(f"[stage2] splat vs DDA, frame 0: the same static voxel on "
          f"{100 * share:.2f} % of the pixels both hit, the class equal "
          f"there on {100 * sem_same.item():.4f} %")
    check(same.any().item() and sem_same.item() >= 0.999,
          "splat and DDA classes on the same voxel")


def stage2_main_path(kernels, gb, bf, world_path, tmp):
    """Phase 26: the CLI in-process on phase 8's world (93 frames, the
    default camera, the trajectory along the ego path), its six tars of 93
    members read back through the port's own reader and decoder, equal to
    the buffers; then ``generate_buffers_for_world`` with 4 cars driving.
    Returns the launches of the path (the stage has no kernel) and the
    cars' buffers."""
    from infinicube_tpu_torch.data.codec import decode_member
    from infinicube_tpu_torch.data.tario import TarReader
    cam_path, _ = stage2_poses(gb)
    pose_file = os.path.join(tmp, "ego_poses.npy")
    np.save(pose_file, cam_path)
    out = os.path.join(tmp, "buffers")
    kernels.reset_launches()
    t0 = time.perf_counter()
    bufs = gb.main(["--voxel_world", world_path, "--output", out,
                    "--poses", pose_file, "--num_frames",
                    str(STAGE2_FRAMES)])
    torch.cuda.synchronize()
    print(f"[stage2] CLI: {STAGE2_FRAMES} frames at 480x832, buffers, tars "
          f"and previews in {time.perf_counter() - t0:.2f} s")
    T, H, W = STAGE2_FRAMES, 480, 832
    check(bufs["depth"].shape == (T, H, W) and bufs["semantic"].shape ==
          (T, H, W) and bufs["instance"].shape == (T, H, W) and
          bufs["coordinate"].shape == (T, H, W, 3), "stage-2 buffer shapes")
    check(bufs["depth"].is_cuda, "stage-2 buffers not made on the card")
    hit = (bufs["depth"] > 0).float().mean().item()
    check(hit > 0 and torch.isfinite(bufs["coordinate"]).all().item(),
          f"stage-2 hit share {hit}")
    want = {"depth": np.clip(bufs["depth"].cpu().numpy() * 100.0, 0,
                             65535).astype(np.uint16),
            "semantic": bufs["semantic"].cpu().numpy().astype(np.uint8),
            "instance": bufs["instance"].cpu().numpy().astype(np.uint16)}
    for name in ("depth", "instance", "semantic", "pose", "intrinsic",
                 "dynamic_object_info"):
        with TarReader(os.path.join(out, f"{name}.tar")) as r:
            names = r.names()
            check(len(names) == T, f"{name}.tar holds {len(names)} members")
            if name in want:
                got = np.stack([decode_member("png", r.read(n))
                                for n in names])
                check(np.array_equal(got, want[name]),
                      f"{name}.tar's pngs differ from the buffers")
    print(f"[stage2] six tars of {T} members, the pngs read back equal to "
          f"the buffers; hit share {hit:.3f}; previews "
          f"{sorted(os.listdir(out))}")
    world = gb.load_voxel_world(world_path)
    _, poses = stage2_poses(gb)
    objs = stage2_objects(bf)
    cars = gb.generate_buffers_for_world(world, poses, objects=objs)
    torch.cuda.synchronize()
    ids = set(cars["instance"].unique().tolist())
    print(f"[stage2] with 4 cars driving: instance ids {sorted(ids)}, car "
          f"pixels {(cars['instance'] >= 10000).float().mean():.4f}")
    check(ids & set(range(10000, 10004)), "no car in the instance buffer")
    check((cars["semantic"][cars["instance"] >= 10000] == 1).all().item(),
          "car ids without the car class")
    launches = dict(kernels.launches)
    check(not any(launches.values()),
          f"stage 2 launched kernels: {launches}")
    return launches, cars


def stage2_time(gb, bf, world, tmp):
    """Phase 27, where the time goes: 93 frames of the splat route (and ms
    a frame), one DDA chunk of 8 frames at 480x832 (with its static blocks),
    the coordinate buffer, writing the tars and the previews, the peak
    memory, and 8 splat frames and the DDA chunk under
    ``torch.profiler``."""
    from infinicube_tpu_torch.camera.conventions import flu_to_opencv
    cam = gb.DEFAULT_CAMERA
    _, poses = stage2_poses(gb)
    objs = stage2_objects(bf).to("cuda")
    K = cam.intrinsics_matrix("cuda")
    pcv = torch.as_tensor(np.stack([flu_to_opencv(p) for p in poses]),
                          dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grid, sem, inst = gb.world_to_grid(world, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fb = bf.render_sequence_splat(grid, sem, inst, objs, K, pcv,
                                  (cam.h, cam.w))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    coord = bf.generate_coordinate_buffer(fb.depth, K, pcv)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bufs = {"depth": fb.depth, "semantic": fb.semantic,
            "instance": fb.instance, "coordinate": coord}
    gb.write_buffer_tars(os.path.join(tmp, "timed"), bufs, poses, cam)
    t4 = time.perf_counter()
    gb.write_preview_videos(os.path.join(tmp, "timed"), bufs)
    t5 = time.perf_counter()
    print(f"[stage2-time] grid {1e3 * (t1 - t0):.1f} ms; splat "
          f"{STAGE2_FRAMES} frames {t2 - t1:.3f} s "
          f"({1e3 * (t2 - t1) / STAGE2_FRAMES:.2f} ms a frame); coordinate "
          f"buffer {1e3 * (t3 - t2):.1f} ms; tars {t4 - t3:.2f} s; previews "
          f"{t5 - t4:.2f} s; peak {peak:.2f} GiB ({resident:.2f} GiB "
          f"resident before)")
    mn, mx = (b[0].cpu().numpy() for b in grid.bbox_ijk())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = bf.build_static_blocks(grid, sem, inst, tuple(mn),
                                    tuple(mx - mn + 1))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    chunk = pcv[:STAGE2_DDA_CHUNK]
    bf.render_sequence(blocks, objs, K, chunk, (cam.h, cam.w),
                       frame_chunk=STAGE2_DDA_CHUNK)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"[stage2-time] DDA: static blocks "
          f"{tuple(int(v) for v in mx - mn + 1)} in "
          f"{1e3 * (t1 - t0):.1f} ms; one chunk of {STAGE2_DDA_CHUNK} frames "
          f"at 480x832 {t2 - t1:.3f} s "
          f"({1e3 * (t2 - t1) / STAGE2_DDA_CHUNK:.1f} ms a frame); peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    profile(lambda: bf.render_sequence_splat(grid, sem, inst, objs, K,
                                             pcv[:8], (cam.h, cam.w)),
            "8 splat frames at 480x832")
    profile(lambda: bf.render_sequence(blocks, objs, K, chunk,
                                       (cam.h, cam.w),
                                       frame_chunk=STAGE2_DDA_CHUNK),
            f"one DDA chunk of {STAGE2_DDA_CHUNK} frames at 480x832")


def stage2(kernels, world_path):
    """Phases 25-27 on phase 8's world. Returns the stage-2 path's
    launches."""
    from infinicube_tpu_torch.inference import guidance_buffer_generation as gb
    from infinicube_tpu_torch.utils import buffers as bf
    world = gb.load_voxel_world(world_path)
    print(f"[stage2] world {world_path}: {world.num_voxels} voxels")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stage2_")
    try:
        # ---- 25. card against CPU, splat against DDA ----------------------
        stage2_checks(gb, bf, world)
        torch.cuda.empty_cache()
        # ---- 26. the stage-2 main path ------------------------------------
        launches, _ = stage2_main_path(kernels, gb, bf, world_path, tmp)
        torch.cuda.empty_cache()
        # ---- 27. where the time goes --------------------------------------
        stage2_time(gb, bf, world, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# stage 3: the feed-forward Gaussian scene
# ---------------------------------------------------------------------------

# examples/e2e_pipeline.py's release profile: every 6th of 93 frames -> 16
# views, the release GSMConfig with the demo world's raycast crop
STAGE3_FRAMES, STAGE3_STRIDE, STAGE3_VIEWS = 16, 6, 16
STAGE3_CROP = dict(dense_dims=(512, 256, 64), dense_ijk_min=(-32, -128, -16))
GSM_ATTN = (4, 60 * 104, 4, 64)   # one view chunk at the XUnet's bottleneck
RASTER_GAUSSIANS = 200_000
RASTER_CROWD = 3_000              # gaussians in one tile, over its capacity


def gsm_kernels(cfg):
    """The GSM's sparse-conv and attention kernels for its dtypes: K4 or its
    bf16 twin (the voxel branch's dtype), ``flash_attn_f32`` or K2 (the
    pixel branch's)."""
    bf16 = torch.bfloat16
    return ("sparse_conv_bf16" if cfg.voxel.dtype == bf16 else
            "sparse_conv_f32",
            "flash_attn_bf16" if cfg.pixel.dtype == bf16 else
            "flash_attn_f32")


def gsm_launches(cfg, views, forwards=1):
    """Exact sparse-conv and attention launches (``gsm_kernels``) of
    ``forwards`` GSM forwards at ``views`` views: two sparse convs per
    SparseResBlock (an encoder block per level, a decoder block per level
    but the coarsest), and per UNet view chunk the bottleneck attention
    plus the per-stage ones."""
    levels = min(cfg.voxel.levels, cfg.grid_levels)
    k4 = 2 * (2 * levels - 1) if cfg.use_voxel_branch else 0
    p = cfg.pixel
    chunks = -(-views // (p.view_chunk or views))
    attn = chunks * (1 + 2 * sum(p.self_attn_per_stage)) \
        if cfg.use_pixel_branch else 0
    conv, att = gsm_kernels(cfg)
    return {conv: forwards * k4, att: forwards * attn}


def stage3_folder(gb, bf, world_path, tmp):
    """Phase 26's world with the 4 cars driving as a stage-2 buffer folder,
    as examples/e2e_pipeline.py leaves it: the six tars of 93 frames,
    ``world.npz`` and the video (here the colored semantic buffer, the
    video model's conditioning, through ``write_video``: png frames where
    no video writer is installed)."""
    from infinicube_tpu_torch.utils.fileio import write_video
    from infinicube_tpu_torch.utils.semantic import \
        generate_rgb_semantic_buffer
    folder = os.path.join(tmp, "buffers")
    t0 = time.perf_counter()
    world = gb.load_voxel_world(world_path)
    _, poses = stage2_poses(gb)
    cars = gb.generate_buffers_for_world(world, poses,
                                         objects=stage2_objects(bf))
    gb.write_buffer_tars(folder, cars, poses, gb.DEFAULT_CAMERA)
    shutil.copy(world_path, os.path.join(folder, "world.npz"))
    sem = generate_rgb_semantic_buffer(cars["semantic"].cpu().numpy(),
                                       cars["instance"].cpu().numpy())
    write_video(os.path.join(folder, "video.mp4"),
                (sem * 255).astype(np.uint8))
    print(f"[stage3] buffer folder (93 frames with 4 cars, world, video) "
          f"written in {time.perf_counter() - t0:.2f} s: "
          f"{sorted(os.listdir(folder))}")
    return folder


def hold_share(got, ref, atol, label, rel=None, where=None, share=0.999,
               rows=False):
    """Card against CPU: the elements within ``atol`` (or ``rel`` of |ref|)
    on >= ``share`` of them (with ``rows``, of the rows along the last
    axis: a pixel's color, a voxel's features), ``where`` selecting, and
    the worst error printed; a share below 1 where a last-bit difference
    can move a threshold (a pixel's winner). Returns the max-abs error."""
    got, ref = got.float().cpu(), ref.float().cpu()
    lim = atol if rel is None else rel * ref.abs()
    ok = (got - ref).abs() <= lim
    if rows:
        ok = ok.all(-1)
    if where is not None:
        ok = ok[where]
    frac = ok.float().mean().item()
    err = (got - ref).abs().max().item()
    print(f"[stage3] {label}: within {atol if rel is None else f'{rel} rel'}"
          f" on {100 * frac:.4f} % (gate {100 * share:.1f} %), max-abs "
          f"{err:.3e}")
    check(frac >= share, f"{label}: {frac}")
    return err


def raster_scene(gsm_ops, dev, seed=30):
    """``RASTER_GAUSSIANS`` gaussians before an identity camera at 480x832,
    ``RASTER_CROWD`` of them in one tile; every depth at the center of its
    log-depth quantum (so the packed keys cannot differ between devices),
    a tenth of them sharing a depth (ties)."""
    rng = np.random.default_rng(seed)
    n, h, w = RASTER_GAUSSIANS, 480, 832
    fx, cx, cy = 480.0, 416.0, 240.0
    u = rng.uniform(-20, w + 20, n)
    v = rng.uniform(-20, h + 20, n)
    u[:RASTER_CROWD] = rng.uniform(100, 116, RASTER_CROWD)
    v[:RASTER_CROWD] = rng.uniform(200, 216, RASTER_CROWD)
    top = (1 << gsm_ops.depth_bits_for(30 * 52)) - 1
    span = math.log(gsm_ops._ZFAR / gsm_ops._ZNEAR)
    k = rng.integers(int(top * math.log(3.0 / gsm_ops._ZNEAR) / span),
                     int(top * math.log(60.0 / gsm_ops._ZNEAR) / span), n)
    k[:n // 10] = k[0]
    z = gsm_ops._ZNEAR * np.exp((k + 0.5) / top * span)
    means = np.stack([(u - cx) / fx * z, (v - cy) / fx * z, z], -1)
    r_px = rng.uniform(0.5, 12.0, n)
    scales = (z * r_px / fx / 3.0)[:, None] * rng.uniform(0.3, 1.0, (n, 3))
    arrs = [means, rng.normal(size=(n, 4)), scales,
            rng.uniform(0.1, 0.9, n), rng.uniform(size=(n, 3)),
            np.eye(4), [[fx, 0, cx], [0, fx, cy], [0, 0, 1]]]
    return [torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
            for a in arrs]


def stage3_kernel_rows(kernels, att, wc, grid):
    """Phase 28's kernel checks: ``flash_attn_f32`` at the GSM's shape and
    K4 on the voxel branch's three levels of this grid, each against its
    plain version and timed beside it and its bounds. Returns the rows of
    each."""
    from infinicube_tpu_torch.models.gsm.model import GSM, GSMConfig
    from infinicube_tpu_torch.nn.sparse import conv_plan
    g = torch.Generator(device="cuda").manual_seed(31)
    B, N, h, d = GSM_ATTN
    q, k, v = (rand((B, N, h, d), g, torch.float32) for _ in range(3))
    scale = d ** -0.5
    with torch.no_grad():
        got = att.multi_head_attention(q, k, v)
    ref = att.attention_plain(q, k, v, scale)
    err = (got - ref).abs().max().item()
    lim = 1e-4 * ref.abs().max().item()
    shape = f"GSM B={B} N={N} h={h} d={d}"
    print(f"[stage3] flash_attn_f32 {shape}: max_abs_err {err:.3e} (limit "
          f"{lim:.3e})")
    check(torch.isfinite(got).all().item() and err <= lim,
          f"flash_attn_f32 at {shape}: err {err}")
    ms = cuda_ms(lambda: kernels.flash_attn_f32(q, k, v, scale), 2, 10)
    plain = cuda_ms(lambda: att.attention_plain(q, k, v, scale), 1, 3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt), 2, 10)
    flops = 4.0 * N * N * d * h * B
    b_ms, b_by, core_ms = tf32x3_bounds(flops, 4 * 4 * N * d * h * B)
    print(f"[stage3] flash_attn_f32 {shape}: kernel {ms:.4f} ms "
          f"({100 * b_ms / ms:.1f} % of its bound), plain {plain:.3f} ms, "
          f"sdpa f32 {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; f32 "
          f"CUDA-core {core_ms:.4f} ms)")
    attn_rows = [dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain,
                      bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                      f32_core_bound_ms=core_ms)]
    del q, k, v, qt, kt, vt, got, ref

    cfg = GSMConfig(**STAGE3_CROP)
    grids = GSM(cfg, device="cuda").grid_pyramid(grid)
    fm = cfg.voxel.f_maps
    # (F, Fo) of each level's first conv of its encoder and decoder blocks
    # (the coarsest level has no decoder block: its second encoder conv)
    widths = [(fm, fm, 3 * fm)] + [(fm * 2 ** (l - 1), fm * 2 ** l,
                                    3 * fm * 2 ** l)
                                   for l in range(1, len(grids))]
    widths[-1] = widths[-1][:2] + (widths[-1][1],)
    k4_rows = []
    for level, (gl, (f_enc, fo, f_dec)) in enumerate(zip(grids, widths)):
        plan = conv_plan(gl)
        pairs = int((plan.nbr >= 0).sum())
        for i, F in enumerate((f_enc, f_dec)):
            x = torch.where(gl.mask[..., None],
                            rand((1, gl.capacity, F), g, torch.float32), 0.0)
            w = rand((27, F, fo), g, torch.float32) / math.sqrt(27 * F)
            pack = wc.pack_sparse_weight(w)
            out = kernels.sparse_conv_f32(x, plan.nbr, pack, plan.violations)
            ref = wc.sparse_conv_plain(plan, x, w)
            err = (out - ref).abs().max().item()
            lim = 1e-4 * ref.abs().max().item()
            shape = f"GSM level {level}: {gl.capacity} x ({F}->{fo})"
            print(f"[stage3] K4 {shape}, {int(gl.mask.sum())} voxels, "
                  f"{pairs} pairs: max_abs_err {err:.3e} (limit {lim:.3e})")
            check(err <= lim, f"K4 at {shape}: err {err}")
            if i:
                continue
            ms = cuda_ms(lambda: kernels.sparse_conv_f32(
                x, plan.nbr, pack, plan.violations), 2, 5)
            plain = cuda_ms(lambda: wc.sparse_conv_plain(plan, x, w), 1, 2)
            flops, b_ms, b_by, f32_ms = k4_bounds(
                pairs, F, fo, sparse_conv_bytes(
                    "fwd", int(gl.mask.sum()), gl.capacity, F, fo, 4,
                    8 * 27 * F * fo))
            print(f"[stage3] K4 {shape}: kernel {ms:.3f} ms "
                  f"({100 * b_ms / ms:.1f} % of its bound), plain "
                  f"{plain:.3f} ms, bound {b_ms:.3f} ms ({b_by}; f32 "
                  f"CUDA-core {f32_ms:.3f} ms)")
            k4_rows.append(dict(shape=shape, max_abs_err=err, ms=ms,
                                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                library_ms=None, f32_core_bound_ms=f32_ms))
    return attn_rows, k4_rows


def stage3_checks(kernels, att, wc, sg, folder):
    """Phase 28: the rasterizer at 480x832 on 200,000 gaussians with a tile
    over capacity, card against CPU (color and alpha within 1e-3, depth
    within 1e-3 relative where alpha > 1e-6, every pixel); the lifter
    (``lift_features``, ``visible_voxel_mask``, ``sample_image_features``)
    on the world's scene grid, 2 views at 240x416, card against CPU;
    ``flash_attn_f32`` and K4 at the GSM's shapes (``stage3_kernel_rows``).
    Returns those rows."""
    from infinicube_tpu_torch.models.gsm import lifter
    from infinicube_tpu_torch.ops import gsplat
    out = {}
    for dev in ("cuda", "cpu"):
        args = raster_scene(gsplat, dev)
        t0 = time.perf_counter()
        out[dev] = gsplat.render_gaussians(*args, (480, 832))
        if dev == "cuda":
            torch.cuda.synchronize()
            proj = gsplat.project_gaussians(*args[:3], *args[5:], (480, 832))
            gid, ok = gsplat.tile_instances(proj, (480, 832))
            print(f"[stage3] render_gaussians {RASTER_GAUSSIANS} gaussians at"
                  f" 480x832 on the card: {1e3 * (time.perf_counter() - t0):.1f}"
                  f" ms; {int(ok.all(1).sum())} tiles at capacity 256, "
                  f"{int(ok.sum())} instances kept")
            check(ok.all(1).any().item(), "no tile over capacity")
    (c1, a1, d1), (c0, a0, d0) = out["cuda"], out["cpu"]
    hold_share(c1, c0, 1e-3, "render color, card vs CPU", share=1.0,
               rows=True)
    hold_share(a1, a0, 1e-3, "render alpha, card vs CPU", share=1.0)
    hold_share(d1, d0, None, "render depth, card vs CPU", rel=1e-3,
               where=a0 > 1e-6, share=1.0)
    check(a0.mean().item() > 0.3, f"render alpha mean {a0.mean()}")
    del out

    data = sg.load_buffer_folder(folder, num_frames=2, stride=40)
    sides = {}
    for dev in ("cuda", "cpu"):
        grid, _ = sg.scene_grid(data["world"], dev)
        Ks = torch.as_tensor(data["Ks"], device=dev).clone()
        Ks[:, :2] *= 0.5
        poses = torch.as_tensor(data["poses_cv"], device=dev)
        g = torch.Generator().manual_seed(32)
        feats = torch.randn((2, 240, 416, 64), generator=g).to(dev)
        lifted = lifter.lift_features(grid, feats, Ks, poses,
                                      STAGE3_CROP["dense_ijk_min"],
                                      STAGE3_CROP["dense_dims"])
        vis = lifter.visible_voxel_mask(grid, Ks, poses,
                                        STAGE3_CROP["dense_ijk_min"],
                                        STAGE3_CROP["dense_dims"],
                                        ray_hw=(120, 208))
        pts = grid.voxel_centers()[0][grid.mask[0]]
        sampled = lifter.sample_image_features(pts, feats, Ks, poses)
        sides[dev] = lifted[0], vis[0], sampled, grid
    (l1, v1, s1, grid), (l0, v0, s0, _) = sides["cuda"], sides["cpu"]
    print(f"[stage3] scene grid: capacity {grid.capacity}, "
          f"{int(grid.mask.sum())} voxels, {int(grid.num_dropped[0])} "
          f"dropped; {int(v0.sum())} visible from 2 views")
    hold_share(l1, l0, 1e-3, "lift_features, card vs CPU", rows=True)
    hold_share(v1.float(), v0.float(), 0.5, "visible_voxel_mask, card vs CPU")
    hold_share(s1, s0, 1e-3 * s0.abs().max().item(),
               "sample_image_features, card vs CPU", rows=True)
    del sides, l1, l0, s1, s0
    attn_rows, k4_rows = stage3_kernel_rows(kernels, att, wc, grid)
    torch.cuda.empty_cache()
    return attn_rows, k4_rows


def random_gsm_tree(model, seed=33):
    """A random numpy parameter tree in the flax layout of ``model``:
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), the rest
    N(0, 0.1^2)."""
    from infinicube_tpu_torch.weights.from_jax import gsm_to_jax
    rng = np.random.default_rng(seed)

    def draw(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = draw(val)
            elif key == "kernel":
                fan_in = int(np.prod(val.shape[:-1]))
                out[key] = (rng.normal(size=val.shape) /
                            math.sqrt(fan_in)).astype(np.float32)
            else:
                out[key] = ((key == "scale") + 0.1 * rng.normal(
                    size=val.shape)).astype(np.float32)
        return out

    return draw(gsm_to_jax(model))


def stage3_batch(sg, data, dev, views, scale=1.0, nearest=None):
    """``scene_gaussian_generation.scene_batch`` at ``views`` views, the
    images, buffers and intrinsics subsampled by ``scale``, the world cut
    to its ``nearest`` voxels to the first camera."""
    step = int(round(1 / scale))
    data = dict(data)
    for k in ("depth", "instance", "video"):
        data[k] = data[k][:, ::step, ::step]
    data["Ks"] = data["Ks"].copy()
    data["Ks"][:, :2] *= scale
    if nearest is not None:
        world = dict(data["world"])
        centers = world["ijk"] * world["voxel_size"] + world["origin"]
        dist = np.linalg.norm(centers - data["poses_cv"][0][:3, 3], axis=-1)
        keep = np.sort(np.argsort(dist, kind="stable")[:nearest])
        world["ijk"] = world["ijk"][keep]
        data["world"] = world
        print(f"[stage3] the world cut to its {len(keep)} voxels within "
              f"{dist[keep].max():.1f} m of the first camera (of "
              f"{len(dist)})")
    return sg.scene_batch(data, views, dev)[0]


@contextlib.contextmanager
def plain_sparse_conv(wc):
    """The sparse convs through ``sparse_conv_plain`` on the card in K4's
    place (the witness of K4's share in phase 29's differences)."""
    kernel_route = wc._forward
    wc._forward = lambda plan, feats, w, w_pack=None: \
        wc.sparse_conv_plain(plan, feats, w)
    try:
        yield
    finally:
        wc._forward = kernel_route


def hold_gaussians(got, ref, n_pix, hw, poses, voxel_size, label,
                   gate=True):
    """Every gaussian of ``got`` against ``ref``: scales, quats, opacities
    and colors within 1e-3 * max|ref| of the field; the means of the voxel
    branch's gaussians within 1e-3 of the voxel size, those of the pixel
    branch within 1e-3 of their distance from their view's camera (the
    depth along the ray is the field that branch decodes)."""
    g = {k: v.float().cpu() for k, v in got.items()}
    n_vox = ref["means"].shape[0] - n_pix
    view = torch.arange(n_pix) // (n_pix // len(poses))
    dist = (ref["means"][n_vox:] - poses[view, :3, 3].cpu()).norm(dim=-1)
    lims = {"means": torch.cat([torch.full((n_vox,), 1e-3 * voxel_size),
                                1e-3 * dist])}
    for k in ("scales", "quats", "opacities", "colors"):
        lims[k] = torch.full((ref[k].shape[0],),
                             1e-3 * ref[k].abs().max().item())
    for k, lim in lims.items():
        diff = (g[k] - ref[k]).abs().reshape(ref[k].shape[0], -1).amax(-1)
        ratio = diff / lim
        i = int(ratio.argmax())
        where = "pixel" if i >= n_vox else "voxel"
        print(f"[stage3] {label}, gaussians {k}: within their limit on "
              f"{100 * (ratio <= 1).float().mean().item():.4f} %, worst "
              f"{ratio[i].item():.3f} of it at a {where} gaussian "
              f"(|difference| {diff[i].item():.3e}, limit "
              f"{lim[i].item():.3e}); max-abs {diff.max().item():.3e}")
        if gate:
            check(bool((ratio <= 1).all()), f"{label} gaussians {k}: worst "
                  f"{ratio[i].item()} of the limit")


def render_shares(a, b, label):
    """Pixel shares where two renders agree: rgb (all three channels) and
    alpha within 1e-3, depth within 1e-3 relative where b's alpha > 1e-6.
    Returns them by key."""
    out = {}
    for k in ("rgb", "alpha", "depth"):
        x, y = a[k].float().cpu(), b[k].float().cpu()
        if k == "depth":
            ok = ((x - y).abs() <= 1e-3 * y.abs())[b["alpha"].cpu() > 1e-6]
        else:
            ok = (x - y).abs() <= 1e-3
            ok = ok.all(-1) if k == "rgb" else ok
        out[k] = ok.float().mean().item()
    print(f"[stage3] {label}: " + ", ".join(
        f"{k} within 1e-3 on {100 * v:.4f} %" for k, v in out.items()))
    return out


def stage3_model_check(sg, gsm, wc, folder):
    """Phase 29: the release-width GSM, its weights by ``gsm_from_jax`` from
    a random numpy parameter tree, on 2 views at 240x416 (frames 0 and 12)
    and the world's 20,000 voxels nearest the first camera, every pixel
    decoding (so the pixel branch's gaussians render too), card against
    CPU: valid masks equal; every gaussian within 1e-3 of its field's scale
    (``hold_gaussians``); the card run again with the plain sparse conv in
    K4's place, printed beside it. Renders: the CPU's gaussians and the
    card's, each rendered on the card and on the CPU, agree within 1e-3 on
    every pixel (depth within 1e-3 relative where alpha > 1e-6), so the
    renderer adds no difference of its own. The card's gaussians rendered
    on the CPU against the CPU's (the CPU's gaussians moved by the measured
    card-CPU difference) give the pixel share that difference alone
    reaches: a gaussian that moves across a log-depth quantum swaps places
    with its neighbours in the sort, and a tile over its capacity keeps
    another set. Each device's own renders then agree within 1e-3 on
    >= 99.9 % of pixels, or on no less than that share less 0.1 %."""
    from infinicube_tpu_torch.models.gsm.renderer import render_views
    from infinicube_tpu_torch.weights.from_jax import gsm_from_jax
    cfg = gsm.GSMConfig(**STAGE3_CROP)
    data = sg.load_buffer_folder(folder, num_frames=2, stride=12)
    sd = gsm_from_jax(random_gsm_tree(gsm.GSM(cfg)))
    outs, batches = {}, {}
    for name, dev in (("card", "cuda"), ("card, plain sparse conv", "cuda"),
                      ("cpu", "cpu")):
        if dev not in batches:
            model = gsm.GSM(cfg, device=dev)
            model.load_state_dict(sd)
            batches[dev] = stage3_batch(sg, data, dev, 2, scale=0.5,
                                        nearest=20_000)
        route = plain_sparse_conv(wc) if "plain" in name else \
            contextlib.nullcontext()
        t0 = time.perf_counter()
        with torch.inference_mode(), route:
            outs[name] = model(batches[dev], decode_all_pixels=True)
        print(f"[stage3] release-width GSM, 2 views at 240x416, "
              f"{int(batches[dev]['grid'].mask.sum())} voxels, {name}: "
              f"{time.perf_counter() - t0:.2f} s (" + ", ".join(
                  f"{k} {v:.2f}" for k, v in model.last_phase_seconds.items())
              + ")")
    got, ref = outs["card"], outs["cpu"]
    b_gpu, b_cpu = batches["cuda"], batches["cpu"]
    n_vox = int(b_cpu["grid"].mask.sum())
    check(n_vox == 20_000, f"the cut world holds {n_vox} voxels")
    gv, rv = got["gaussians"]["valid"].cpu(), ref["gaussians"]["valid"]
    check(torch.equal(gv, rv), f"valid masks differ ({int((gv != rv).sum())})")
    hw = (240, 416)
    n_pix = 2 * hw[0] * hw[1] * cfg.pixel.gs_per_pixel
    vs = float(b_cpu["grid"].voxel_size.max())
    for name in ("card, plain sparse conv", "card"):
        hold_gaussians(outs[name]["gaussians"], ref["gaussians"], n_pix, hw,
                       b_cpu["cam_to_worlds"], vs, name, gate=name == "card")
    print(f"[stage3] {int(rv.sum())} valid gaussians of {rv.numel()} "
          f"({int(rv[:-n_pix].sum())} of the voxel branch), the masks "
          f"equal")
    card_gs = {k: v.cpu() for k, v in got["gaussians"].items()}
    with torch.inference_mode():
        renders = {}
        for gs_name, gs in (("CPU's", ref["gaussians"]), ("card's", card_gs)):
            for dev, b in (("cuda", b_gpu), ("cpu", b_cpu)):
                renders[gs_name, dev] = render_views(
                    {k: v.to(dev) for k, v in gs.items()}, b["Ks"],
                    b["cam_to_worlds"], hw)
    for gs_name in ("CPU's", "card's"):
        shares = render_shares(renders[gs_name, "cuda"],
                               renders[gs_name, "cpu"],
                               f"the {gs_name} gaussians rendered, card vs "
                               f"CPU")
        check(min(shares.values()) == 1.0, f"the {gs_name} gaussians "
              f"rendered: {shares}")
    witness = render_shares(renders["card's", "cpu"], renders["CPU's", "cpu"],
                            "the card's gaussians against the CPU's, both "
                            "rendered on the CPU")
    own = render_shares(got["render"], ref["render"],
                        "each device's own render")
    for k, share in own.items():
        gate = min(0.999, witness[k] - 1e-3)
        check(share >= gate, f"own renders {k}: {share} (gate {gate})")
    del outs, got, ref, renders, card_gs, batches
    torch.cuda.empty_cache()


def stage3_main_path(kernels, sg, ff, gsm, folder, tmp):
    """Phase 30: ``scene_gaussian_generation.main`` on the buffer folder
    with its defaults (16 frames, 8 views), then ``reconstruct_scene`` at
    the e2e release settings (16 frames at stride 6, 16 views, the release
    crop) with its outputs written and read back, then
    ``feedforward_reconstruction.reconstruct`` in dual mode; exact K4 and
    ``flash_attn_f32`` launches for each. Returns the path's launches."""
    from infinicube_tpu_torch.utils import gaussian_io as gio
    cfg = gsm.GSMConfig(**STAGE3_CROP)
    total = {}
    out = os.path.join(tmp, "scene")
    kernels.reset_launches()
    t0 = time.perf_counter()
    sg.main(["--buffer_folder", folder, "--output", out])
    torch.cuda.synchronize()
    data8 = sg.load_buffer_folder(folder, 16)
    sel = np.linspace(0, 15, 8).astype(int)
    dyn = bool((data8["instance"][sel] >= sg.DYNAMIC_ID_BASE).any())
    want = gsm_launches(cfg, 8, 1 + dyn)
    got = {k: kernels.launches[k] for k in want}
    objs = gio.load_pkl(os.path.join(out, "decoded_gs_object.pkl"))
    static = gio.load_pkl(os.path.join(out, "decoded_gs_static.pkl"))
    print(f"[stage3] CLI (8 views of 16 frames): {time.perf_counter() - t0:.2f}"
          f" s, {len(static['means'])} static gaussians, objects "
          f"{sorted(objs)}, launches {got} (want {want})")
    check(got == want, f"CLI launches {got}, want {want}")
    check(sorted(os.listdir(out)) == ["composite_frame0.png",
                                      "decoded_gs_object.pkl",
                                      "decoded_gs_static.pkl",
                                      "decoded_gs_static.splat"],
          f"CLI outputs {os.listdir(out)}")
    for k, v in dict(kernels.launches).items():
        total[k] = total.get(k, 0) + v

    kernels.reset_launches()
    t0 = time.perf_counter()
    data = sg.load_buffer_folder(folder, STAGE3_FRAMES, STAGE3_STRIDE)
    static, objs, res, model, _ = sg.reconstruct_scene(
        data, cfg=cfg, max_views=STAGE3_VIEWS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = gsm_launches(cfg, STAGE3_VIEWS, 2)
    got = {k: kernels.launches[k] for k in want}
    grid, _ = sg.scene_grid(data["world"], "cuda")
    rel = os.path.join(tmp, "release")
    gio.save_pkl(os.path.join(rel, "decoded_gs_static.pkl"), static)
    gio.save_pkl(os.path.join(rel, "decoded_gs_object.pkl"), objs)
    gio.save_splat(os.path.join(rel, "decoded_gs_static.splat"), static)
    back = gio.load_pkl(os.path.join(rel, "decoded_gs_static.pkl"))
    back_obj = gio.load_pkl(os.path.join(rel, "decoded_gs_object.pkl"))
    splat = gio.load_splat(os.path.join(rel, "decoded_gs_static.splat"))
    rgb = res["render"]["rgb"]
    print(f"[stage3] release reconstruct_scene ({STAGE3_VIEWS} views of "
          f"480x832, frames 0-{STAGE3_STRIDE * (STAGE3_FRAMES - 1)} at "
          f"stride {STAGE3_STRIDE}): {wall:.2f} s with the load; scene grid "
          f"capacity {grid.capacity}, {int(grid.mask.sum())} voxels, "
          f"num_dropped {int(grid.num_dropped[0])}; {len(static['means'])} "
          f"static gaussians, objects {sorted(objs)} "
          f"({[len(o['means']) for o in objs.values()]} gaussians); "
          f"launches {got} (want {want})")
    check(got == want, f"release launches {got}, want {want}")
    check(sorted(back_obj) == list(range(10000, 10004)),
          f"car ids {sorted(back_obj)}")
    check(all(np.isfinite(v).all() for v in back.values()) and
          len(splat["means"]) == len(back["means"]) > 0, "static gaussians")
    check(tuple(rgb.shape) == (STAGE3_VIEWS, 480, 832, 3) and
          torch.isfinite(rgb).all().item(), f"renders {tuple(rgb.shape)}")
    for k, v in dict(kernels.launches).items():
        total[k] = total.get(k, 0) + v

    kernels.reset_launches()
    batch = stage3_batch(sg, data, "cuda", STAGE3_VIEWS)
    t0 = time.perf_counter()
    _, metrics, _, _ = ff.reconstruct(batch, "dual", cfg=cfg)
    torch.cuda.synchronize()
    want = gsm_launches(cfg, STAGE3_VIEWS, 1)
    got = {k: kernels.launches[k] for k in want}
    print(f"[stage3] feedforward reconstruct (dual, {STAGE3_VIEWS} views): "
          f"{time.perf_counter() - t0:.2f} s, psnr {metrics['psnr']:.3f} "
          f"ssim {metrics['ssim']:.4f} (random weights), launches {got}")
    check(got == want and all(math.isfinite(v) for v in metrics.values()),
          f"feedforward launches {got}, metrics {metrics}")
    for k, v in dict(kernels.launches).items():
        total[k] = total.get(k, 0) + v
    others = {k: v for k, v in total.items()
              if v and k not in ("sparse_conv_f32", "flash_attn_f32")}
    check(not others, f"stage 3 launched other kernels: {others}")
    del res, model, batch
    torch.cuda.empty_cache()
    return total


def stage3_time(sg, gsm, folder):
    """Phase 31, where the time goes at the release settings: the load,
    the masks and the batch, the static pass split into encoder, voxel
    branch, pixel branch, sky and render, the dynamic pass, peak memory,
    and one static GSM forward under ``torch.profiler``."""
    from infinicube_tpu_torch.models.gsm.pixel_branch import xunet_cudnn
    cfg = gsm.GSMConfig(**STAGE3_CROP)
    model = gsm.GSM(cfg, device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = sg.load_buffer_folder(folder, STAGE3_FRAMES, STAGE3_STRIDE)
    t1 = time.perf_counter()
    batch = stage3_batch(sg, data, "cuda", STAGE3_VIEWS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with torch.inference_mode():
        model(batch)
        split = dict(model.last_phase_seconds)
        t3 = time.perf_counter()
        model(batch, decode_all_pixels=True)
        torch.cuda.synchronize()
    t4 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[stage3-time] load {t1 - t0:.2f} s, masks and batch "
          f"{t2 - t1:.3f} s, static pass {t3 - t2:.3f} s (" +
          ", ".join(f"{k} {v:.3f}" for k, v in split.items()) +
          f"), dynamic pass {t4 - t3:.3f} s; stage 3 in all {t4 - t0:.2f} s;"
          f" peak {peak:.2f} GiB ({resident:.2f} GiB resident before)")
    with torch.inference_mode():
        profile(lambda: model(batch), f"one static GSM forward, "
                f"{STAGE3_VIEWS} views at 480x832")
        # one XUnet view chunk without cuDNN (the port's choice) and with
        unet = model.pixel_branch.unet
        x = torch.rand((4, 480, 832, 5), device="cuda")
        off = cuda_ms(lambda: unet(x), 1, 3)
        with xunet_cudnn():
            on = cuda_ms(lambda: unet(x), 1, 3)
    print(f"[stage3-time] one XUnet view chunk (4 x 480x832): {off:.1f} ms "
          f"without cuDNN, {on:.1f} ms with cuDNN's own choice of f32 "
          f"algorithms (TF32 off)")
    del model, batch
    torch.cuda.empty_cache()


def stage3(kernels, att, world_path):
    """Phases 28-31 on phase 26's world with its 4 cars. Returns the rows
    of ``flash_attn_f32`` and K4 at the GSM's shapes, the stage-3 path's
    launches and phase 30's 16 views (phase 41's input)."""
    from infinicube_tpu_torch.inference import feedforward_reconstruction as ff
    from infinicube_tpu_torch.inference import guidance_buffer_generation as gb
    from infinicube_tpu_torch.inference import scene_gaussian_generation as sg
    from infinicube_tpu_torch.models.gsm import model as gsm
    from infinicube_tpu_torch.ops import window_conv as wc
    from infinicube_tpu_torch.utils import buffers as bf
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stage3_")
    t0 = time.perf_counter()

    def done(phase):
        print(f"[stage3] {phase} done at {time.perf_counter() - t0:.1f} s")

    try:
        folder = stage3_folder(gb, bf, world_path, tmp)
        # ---- 28. card against CPU, the kernels at the GSM's shapes -------
        attn_rows, k4_rows = stage3_checks(kernels, att, wc, sg, folder)
        done("phase 28")
        # ---- 29. the release-width GSM, card against CPU -----------------
        stage3_model_check(sg, gsm, wc, folder)
        done("phase 29")
        # ---- 30. the stage-3 main path -----------------------------------
        launches = stage3_main_path(kernels, sg, ff, gsm, folder, tmp)
        done("phase 30")
        # ---- 31. where the time goes -------------------------------------
        stage3_time(sg, gsm, folder)
        done("phase 31")
        views = sg.load_buffer_folder(folder, STAGE3_FRAMES, STAGE3_STRIDE)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return attn_rows, k4_rows, launches, views


# ---------------------------------------------------------------------------
# training the GSM
# ---------------------------------------------------------------------------

# the f32 attention backward at the GSM's train shape (3 views at 480x704:
# 60 x 88 tokens at the XUnet's bottleneck, 4 heads of 64), at d = 96 and
# 128 with Nq != Nk, and off the tile (37 x 21); d = 40 through the padding
F32_BWD_SHAPES = ((3, 5280, 5280, 4, 64), (1, 4096, 4096, 8, 96),
                  (1, 1000, 777, 4, 128), (2, 37, 21, 2, 64))
F32_BWD_PADDED = (1, 1000, 1000, 4, 40)
GSM_TRAIN_STEPS = 3
GSM_TRAIN_VIEWS, GSM_TRAIN_HW = 3, (480, 704)
# benchmarks/bench_gsm_train.py's conv-plan cube for its scene at 0.4 m
GSM_TRAIN_BOUNDS = ((-8, -64, -8), (224, 128, 48))


def gsm_step_launches(kernels, cfg, views):
    """Exact launches of one GSM train step: the forward's (K4 and the
    bottleneck attention, ``gsm_launches``, or their bf16 twins), every
    sparse conv's input and weight gradient (K4-dgrad, K6), the attention
    once more where its remat block is recomputed in the backward, and its
    backward; nothing else."""
    conv, att = gsm_kernels(cfg)
    fwd = gsm_launches(cfg, views)
    k4, attn = fwd[conv], fwd[att]
    return {k: 0 for k in kernels.launches} | {
        conv: k4, conv + "_dgrad": k4, conv + "_wgrad": k4,
        att: attn * (2 if cfg.pixel.unet_remat else 1), att + "_bwd": attn}


def f32_bwd_checks(kernels, att):
    """Phase 32. ``flash_attn_f32`` with its lse store against
    ``attention_plain``'s output (1e-4 * max|ref|) and lse (1e-5), then
    ``flash_attn_f32_bwd`` against ``attention_bwd_plain`` on the plain
    output and lse: dq, dk and dv each within 1e-4 * max|ref|, two runs
    bit-identical; timed beside the plain version, its bound (10 * Nq * Nk
    * d * B * h as 3 TF32 products, the f32 CUDA-core bound beside it) and
    the backward of ``scaled_dot_product_attention`` in f32 (TF32 off, its
    backend pinned), which computes D itself (so beside the kernel plus
    ``attention_delta``). Then d = 40 through ``multi_head_attention``'s
    padding with a gradient: one launch of each kernel, the gradients
    against the plain attention's under autograd. Returns the rows and the
    padded call's entry (as phase 22's ``padded_widths``)."""
    g = torch.Generator(device="cuda").manual_seed(32)
    rows = []
    for B, nq, nk, h, d in F32_BWD_SHAPES:
        q, k, v, do = (rand((B, n, h, d), g, torch.float32)
                       for n in (nq, nk, nk, nq))
        scale = d ** -0.5
        shape = f"B={B} Nq={nq} Nk={nk} h={h} d={d}"
        o, lse = kernels.flash_attn_f32(q, k, v, scale, return_lse=True)
        ref_o, ref_lse = att.attention_plain(q, k, v, scale, return_lse=True)
        o_err = (o - ref_o).abs().max().item()
        o_lim = 1e-4 * ref_o.abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        print(f"[f32 bwd] {shape} forward with the lse store: o max_abs_err "
              f"{o_err:.3e} (limit {o_lim:.3e}), lse max_abs_err "
              f"{lse_err:.3e} (limit 1.000e-05)")
        check(o_err <= o_lim and lse.shape == (B, h, nq) and lse_err <= 1e-5,
              f"[f32 bwd] {shape}: o err {o_err}, lse err {lse_err}")
        ref_delta = att.attention_delta(ref_o, do)
        got = kernels.flash_attn_f32_bwd(q, k, v, do, ref_lse, ref_delta,
                                         scale)
        ref = att.attention_bwd_plain(q, k, v, ref_o, do, ref_lse, scale)
        errs = []
        for a, b, name in zip(got, ref, "qkv"):
            err = (a - b).abs().max().item()
            lim = 1e-4 * b.abs().max().item()
            print(f"[f32 bwd] {shape} d{name}: cosine {cos(a, b):.8f} "
                  f"max_abs_err {err:.3e} (limit {lim:.3e})")
            check(torch.isfinite(a).all().item() and err <= lim,
                  f"[f32 bwd] {shape} d{name}: err {err}")
            errs.append(err)
        again = kernels.flash_attn_f32_bwd(q, k, v, do, ref_lse, ref_delta,
                                           scale)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"[f32 bwd] {shape}: two runs differ")
        del ref_o, ref_lse, ref_delta, ref, again, got
        delta = att.attention_delta(o, do)
        ms = cuda_ms(lambda: kernels.flash_attn_f32_bwd(q, k, v, do, lse,
                                                        delta, scale))
        with_delta = cuda_ms(lambda: kernels.flash_attn_f32_bwd(
            q, k, v, do, lse, att.attention_delta(o, do), scale))
        fwd_ms = cuda_ms(lambda: kernels.flash_attn_f32(q, k, v, scale))
        fwd_lse_ms = cuda_ms(lambda: kernels.flash_attn_f32(
            q, k, v, scale, return_lse=True))
        plain = cuda_ms(lambda: att.attention_bwd_plain(q, k, v, o, do, lse,
                                                        scale), 1, 3)
        lib, backend = sdpa_backward_ms(q, k, v, do)
        flops = 10.0 * nq * nk * d * h * B
        nbytes = 4 * B * h * (d * (3 * nq + 4 * nk) + 2 * nq)
        b_ms, b_by, core_ms = tf32x3_bounds(flops, nbytes)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = tuple(kernels.f32_bwd_splits(B, h, nq, nk, d, sms, dkv)
                       for dkv in (True, False))
        print(f"[f32 bwd] {shape}: ranges of the streamed axis (dK/dV pass, "
              f"dQ pass) {splits}")
        print(f"[f32 bwd] {shape}: kernel {ms:.4f} ms ({flops / ms / 1e9:.2f}"
              f" TFLOP/s of the 5 products counted, {100 * b_ms / ms:.1f} % "
              f"of its bound), kernel + delta {with_delta:.4f} ms, plain "
              f"{plain:.3f} ms, sdpa f32 backward ({backend}, pinned) "
              f"{lib:.4f} ms: kernel + delta / sdpa {with_delta / lib:.2f}x; "
              f"bound {b_ms:.4f} ms ({b_by}, 3 TF32 products at 495 "
              f"TFLOP/s; the f32 CUDA-core bound {core_ms:.4f} ms); forward "
              f"{fwd_ms:.4f} ms, with the lse store {fwd_lse_ms:.4f} ms")
        rows.append(dict(shape=shape, max_abs_err=max(errs), ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib, library_backend=backend,
                         splits=splits,
                         f32_core_bound_ms=core_ms, with_delta_ms=with_delta,
                         forward_ms=fwd_ms, forward_with_lse_ms=fwd_lse_ms,
                         forward_o_max_abs_err=o_err,
                         forward_lse_max_abs_err=lse_err))
        del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    # d = 40: padded to 64 for both kernels, the zero columns' gradients
    # dropped
    B, nq, nk, h, d = F32_BWD_PADDED
    leaves = [rand((B, n, h, d), g, torch.float32).requires_grad_()
              for n in (nq, nk, nk)]
    do = rand((B, nq, h, d), g, torch.float32)
    kernels.reset_launches()
    att.multi_head_attention(*leaves).backward(do)
    padded = {k: v for k, v in kernels.launches.items() if v}
    plain = [x.detach().clone().requires_grad_() for x in leaves]
    att.attention_plain(*plain, d ** -0.5).backward(do)
    errs = []
    for a, b, name in zip(leaves, plain, "qkv"):
        err = (a.grad - b.grad).abs().max().item()
        lim = 1e-4 * b.grad.abs().max().item()
        print(f"[f32 bwd] d = 40 through the padding, d{name}: max_abs_err "
              f"{err:.3e} (limit {lim:.3e})")
        check(a.grad.shape == b.grad.shape and err <= lim,
              f"[f32 bwd] padded d{name}: err {err}")
        errs.append(err)
    check(padded == {"flash_attn_f32": 1, "flash_attn_f32_bwd": 1},
          f"[f32 bwd] padded call launches {padded}")
    return rows, {"rows": [dict(shape=f"{B}x{nq}x{h}x{d}",
                                max_abs_err=max(errs))], "launches": 1}


def gsm_tiny_scene(dev, seed=0):
    """A small scene for card-against-CPU checks: ground, a wall and 1,200
    points in a 0.5 m grid, two cameras at 32x48 looking +x, the top rows
    sky, a depth prior on part of the frame."""
    from infinicube_tpu_torch.grid.build import grid_from_points
    rng = np.random.default_rng(seed)
    h, w = 32, 48
    ground = np.stack([rng.uniform(1, 15, 800), rng.uniform(-6, 6, 800),
                       rng.uniform(0, 0.3, 800)], -1)
    wall = np.stack([np.full(400, 12.0), rng.uniform(-6, 6, 400),
                     rng.uniform(0, 4, 400)], -1)
    pts = torch.tensor(np.concatenate([ground, wall])[None],
                       dtype=torch.float32, device=dev)
    grid = grid_from_points(pts, torch.ones((1, 1200), dtype=torch.bool,
                                            device=dev), 0.5, 0.25,
                            capacity=2048)
    T = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    T[:, :3, 0], T[:, :3, 1], T[:, :3, 2] = [0, -1, 0], [0, 0, -1], [1, 0, 0]
    T[0, :3, 3], T[1, :3, 3] = [0, 0, 1.5], [1.0, 0.5, 1.5]
    K = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]], np.float32)
    masks = np.ones((2, h, w, 4), np.float32)
    masks[:, :8, :, 0] = 0.0
    depth = np.zeros((2, h, w, 1), np.float32)
    depth[:, 16:, 10:30] = rng.uniform(2, 12, (2, 16, 20, 1))
    masks[..., 3] = depth[..., 0] > 0
    arrays = dict(images=rng.uniform(size=(2, h, w, 3)), masks=masks,
                  Ks=np.stack([K, K]), cam_to_worlds=T, depth_prior=depth)
    return {"grid": grid, **{k: torch.tensor(np.asarray(a),
                                             dtype=torch.float32, device=dev)
                             for k, a in arrays.items()}}


def gsm_grad_check(kernels, gsm):
    """Phase 33 (c): the tiny GSM's ``gsm_loss`` and every parameter's
    gradient, card (K4, K4-dgrad, K6, ``flash_attn_f32`` and its backward)
    against the CPU (plain versions), one random init: both branches on
    the depth-prior scene, and the voxel branch off (there the pixel branch
    and its attention carry the gradient). Each gradient within 2e-3 of its
    largest CPU value, with a floor of 1e-3 of the largest gradient for the
    tensors whose gradient is zero or rounding noise."""
    from infinicube_tpu_torch.models.gsm.encoders import UnifiedEncoderConfig
    from infinicube_tpu_torch.models.gsm.loss import GSMLossConfig, gsm_loss
    from infinicube_tpu_torch.models.gsm.pixel_branch import \
        PixelBranchConfig
    from infinicube_tpu_torch.models.gsm.sky import SkyConfig
    from infinicube_tpu_torch.models.gsm.voxel_branch import \
        VoxelBranchConfig
    from infinicube_tpu_torch.weights.from_jax import gsm_from_jax
    base = dict(
        encoder=UnifiedEncoderConfig(conv_width=16),
        voxel=VoxelBranchConfig(f_maps=16, levels=2, gaussians_per_voxel=2),
        pixel=PixelBranchConfig(width=8, dims=(1, 2), gs_per_pixel=1),
        sky=SkyConfig(embed_dim=32, num_layers=1, num_heads=2, patch=8),
        dense_dims=(40, 32, 16), dense_ijk_min=(0, -16, -2),
        render_tile_capacity=64)
    for kind, kw in (("joint", {}), ("pixel", dict(use_voxel_branch=False))):
        cfg = gsm.GSMConfig(**base, **kw)
        grads, losses = {}, {}
        for dev in ("cpu", "cuda"):
            model = gsm.GSM(cfg, device=dev)
            model.load_state_dict(gsm_from_jax(random_gsm_tree(model, 41)))
            batch = gsm_tiny_scene(dev)
            kernels.reset_launches()
            out = model(batch)
            valid = batch["masks"][..., 0] * batch["masks"][..., 2] > 0
            loss, _ = gsm_loss(GSMLossConfig(), out["render"],
                               batch["images"], valid, out["sky_mask"],
                               gaussians=out["gaussians"])
            loss.backward()
            losses[dev] = loss.item()
            grads[dev] = {k: torch.zeros_like(p) if p.grad is None
                          else p.grad for k, p in model.named_parameters()}
            launches = {k: v for k, v in kernels.launches.items() if v}
        floor = 1e-3 * max(g.abs().max().item() for g in grads["cpu"].values())
        worst, carried = 0.0, 0
        for name, ref in grads["cpu"].items():
            got = grads["cuda"][name].cpu()
            scale = max(ref.abs().max().item(), floor)
            carried += ref.abs().max().item() > floor
            worst = max(worst, (got - ref).abs().max().item() / scale)
        print(f"[gsm grad] {kind}: loss card {losses['cuda']:.6f} cpu "
              f"{losses['cpu']:.6f}; {len(grads['cpu'])} gradients, "
              f"{carried} above the floor, worst max-abs "
              f"{worst:.3e} of its scale (limit 2e-3); card launches "
              f"{launches}")
        check(abs(losses["cuda"] - losses["cpu"]) <=
              2e-3 * abs(losses["cpu"]), f"[gsm grad] {kind}: losses")
        check(worst <= 2e-3, f"[gsm grad] {kind}: worst {worst}")
        want = ({"sparse_conv_f32", "sparse_conv_f32_dgrad",
                 "sparse_conv_f32_wgrad"} if kind == "joint" else set()) | \
            {"flash_attn_f32", "flash_attn_f32_bwd"}
        check(set(launches) == want, f"[gsm grad] {kind}: launches "
              f"{launches}")


def gsm_train_main_path(kernels):
    """Phase 33 (a): ``train.main`` on ``configs/train_gsm.yaml`` with the
    random LPIPS, 3 steps: finite losses, no skipped step, exact launches
    per step, no plain version called, the JSONL log, the final checkpoint
    read back. Returns the path's launches."""
    from infinicube_tpu_torch import train as train_cli
    from infinicube_tpu_torch.models.gsm.model import GSMConfig
    from infinicube_tpu_torch.ops import attention as att
    from infinicube_tpu_torch.ops import window_conv as ws
    from infinicube_tpu_torch.training import loop
    from infinicube_tpu_torch.training.checkpoint import CheckpointManager
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gsm_")
    per_step, undo = counting_steps(kernels, loop)
    plain_calls = []
    plains = (ws.sparse_conv_plain, ws.sparse_conv_bwd_plain,
              att.attention_plain, att.attention_bwd_plain)

    def no_plain(*a, **kw):
        plain_calls.append(1)
        raise RuntimeError("a plain version was called on the card")

    ws.sparse_conv_plain = ws.sparse_conv_bwd_plain = no_plain
    att.attention_plain = att.attention_bwd_plain = no_plain
    want = gsm_step_launches(kernels, GSMConfig(), 2)
    try:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train_cli.main(
            [os.path.join(ROOT, "configs", "train_gsm.yaml"), "--name",
             "smoke", "--logdir", tmp, "--exec",
             f"max_steps={GSM_TRAIN_STEPS}", "log_every=1",
             f"ckpt_dir={tmp}/ck", "lpips_checkpoint=random"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_params = sum(p.numel() for p in state.params.values())
        logs = [json.loads(line) for line in
                open(os.path.join(tmp, "smoke.jsonl"))]
        print(f"[gsm train] {n_params:,} parameters (the release GSMConfig, "
              f"f32), {GSM_TRAIN_STEPS} steps on the CLI's synthetic scene "
              f"(2 views of 64x96, LPIPS random) through train.main in "
              f"{wall:.1f} s (model build, batches, steps and the final "
              f"checkpoint), peak {peak:.2f} GiB")
        check(n_params == 18_880_213, f"{n_params} parameters")
        check([r["step"] for r in logs] == list(range(1, GSM_TRAIN_STEPS + 1)),
              f"JSONL log {logs}")
        for r, delta in zip(logs, per_step):
            print(f"[gsm train] step {r['step']}: loss {r['loss']:.4f} "
                  f"(rgb l1 {r['rgb_l1']:.4f}, ssim {r['ssim']:.4f}, alpha l1 "
                  f"{r['alpha_l1']:.4f}, lpips {r['perceptual']:.4f}), psnr "
                  f"{r['psnr']:.3f}, grad_finite {r['grad_finite']:.0f}, "
                  f"{r['steps_per_sec']:.3f} steps/s; launches "
                  f"{ {k: v for k, v in delta.items() if v} }")
            check(math.isfinite(r["loss"]) and r["grad_finite"] == 1.0,
                  f"step {r['step']}: {r}")
            check(delta == want, f"step {r['step']} launches {delta}, want "
                  f"{want}")
        check(len(per_step) == GSM_TRAIN_STEPS, f"{len(per_step)} steps")
        check(not plain_calls, "a plain version ran on the card")
        check(state.step == GSM_TRAIN_STEPS and state.num_nan_skips == 0,
              f"step {state.step}, {state.num_nan_skips} skipped")
        moved = [k for k, p in state.params.items()
                 if not torch.equal(p.detach(), state.ema.params[k])]
        print(f"[gsm train] {len(moved)} of {len(state.params)} parameter "
              f"tensors moved in {GSM_TRAIN_STEPS} steps (the pixel "
              f"branch's and the sky's gradients are zero on this scene: "
              f"its masks make no pixel midground and none sky)")
        check(any(k.startswith("voxel_branch.") for k in moved) and
              any(k.startswith("encoder.") for k in moved),
              f"moved {sorted(moved)[:5]}")
        mgr = CheckpointManager(os.path.join(tmp, "ck"))
        sd = mgr.restore()
        same = all(torch.equal(sd["params"][k], p.detach())
                   for k, p in state.params.items())
        print(f"[gsm train] final checkpoint: "
              f"{os.path.getsize(mgr._path(GSM_TRAIN_STEPS)) / 1e6:.1f} MB, "
              f"parameters read back {'identical' if same else 'DIFFER'}")
        check(same and sd["step"] == GSM_TRAIN_STEPS, "checkpoint differs")
    finally:
        undo()
        ws.sparse_conv_plain, ws.sparse_conv_bwd_plain, \
            att.attention_plain, att.attention_bwd_plain = plains
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[gsm train] main path launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def gsm_train_scene(dev):
    """benchmarks/bench_gsm_train.py's scene, built with the port: 200,000
    points (road, two walls, objects) in a 65,536-slot grid at 0.4 m, 3
    views of 480x704 looking +x from 1.8 m up, 2 m apart."""
    from infinicube_tpu_torch.grid.build import grid_from_points
    rng = np.random.default_rng(0)
    n = 200_000
    road = np.stack([rng.uniform(0, 80, n // 2), rng.uniform(-20, 20, n // 2),
                     rng.normal(0, 0.1, n // 2)], -1)
    walls = np.stack([rng.uniform(0, 80, n // 4),
                      np.sign(rng.normal(size=n // 4)) *
                      rng.normal(16, 0.3, n // 4),
                      rng.uniform(0, 10, n // 4)], -1)
    objs = rng.normal(0, 1.0, (n // 4, 3)) + \
        np.stack([rng.uniform(5, 70, n // 4), rng.uniform(-12, 12, n // 4),
                  np.full(n // 4, 1.0)], -1)
    pts = np.concatenate([road, walls, objs]).astype(np.float32)
    V, (h, w) = GSM_TRAIN_VIEWS, GSM_TRAIN_HW
    K = np.array([[420.0, 0, w / 2], [0, 420, h / 2], [0, 0, 1]], np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    T[:, :3, 0], T[:, :3, 1], T[:, :3, 2] = [0, -1, 0], [0, 0, -1], [1, 0, 0]
    for i in range(V):
        T[i, :3, 3] = [2.0 * i, 0, 1.8]
    grid = grid_from_points(torch.from_numpy(pts)[None].to(dev),
                            torch.ones((1, n), dtype=torch.bool, device=dev),
                            0.4, 0.2, capacity=1 << 16)
    images = rng.uniform(size=(V, h, w, 3)).astype(np.float32)
    return {"grid": grid, "images": torch.from_numpy(images).to(dev),
            "masks": torch.ones((V, h, w, 4), device=dev),
            "Ks": torch.from_numpy(np.stack([K] * V)).to(dev),
            "cam_to_worlds": torch.from_numpy(T).to(dev),
            "depth_prior": torch.zeros((V, h, w, 1), device=dev)}


def gsm_train_time(kernels, bf16=False):
    """Phase 33 (b), and with ``bf16`` phase 35: the release-scale step of
    bench_gsm_train.py's scene in f32, or in ``gsm_bf16_config`` as the
    bench runs it (its dense-lookup bounds, LPIPS random at the 224 crop,
    EMA on): one warm-up, then 3 steps each split into batch (the scene's
    grid and tensors), forward (model and loss), backward and optimizer +
    EMA, with exact launches; steps/s, peak memory; one step under the
    profiler. In f32 then one XUnet view chunk (the 3 views) forward and
    backward with PyTorch's own convolutions (the port's), with cuDNN's own
    choice throughout, and with cuDNN in the backward only (a context
    around the forward alone). Returns the times and the 3 steps'
    launches."""
    from torch.func import functional_call

    from infinicube_tpu_torch.models.gsm import pixel_branch as pb
    from infinicube_tpu_torch.models.gsm.loss import GSMLossConfig, gsm_loss
    from infinicube_tpu_torch.models.gsm.lpips import load_lpips
    from infinicube_tpu_torch.models.gsm.model import (GSM, GSMConfig,
                                                       gsm_bf16_config)
    from infinicube_tpu_torch.training.state import (TrainConfig, TrainState,
                                                     grads_finite)
    cfg = gsm_bf16_config() if bf16 else GSMConfig()
    cfg = dataclasses.replace(cfg, voxel=dataclasses.replace(
        cfg.voxel, dense_lookup_bounds=GSM_TRAIN_BOUNDS))
    tag = "[gsm bf16 train time]" if bf16 else "[gsm train time]"
    model = GSM(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model.init_params(gen)
    lpips = load_lpips("random", "cuda")
    tcfg = TrainConfig()
    state = TrainState.create(tcfg, dict(model.named_parameters()))
    params = state.params
    lcfg = GSMLossConfig()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def forward(b):
        out = functional_call(model, params, (b,))
        valid = b["masks"][..., 0] * b["masks"][..., 2] > 0
        return out, gsm_loss(lcfg, out["render"], b["images"], valid,
                             out["sky_mask"], gaussians=out["gaussians"],
                             lpips=lpips, generator=gen)

    def optimize():
        finite = grads_finite([p.grad for p in params.values()
                               if p.grad is not None])
        torch.nn.utils.clip_grad_value_(list(params.values()),
                                        tcfg.grad_clip_value)
        state.opt.step()
        state.ema.update(params, tcfg.ema_decay, apply=finite)
        return finite

    def step():
        for p in params.values():
            p.grad = None
        b, t_batch = timed(lambda: gsm_train_scene("cuda"))
        (out, (loss, m)), t_fwd = timed(lambda: forward(b))
        _, t_bwd = timed(loss.backward)
        finite, t_opt = timed(optimize)
        return dict(batch=t_batch, forward=t_fwd, backward=t_bwd,
                    optimizer=t_opt), loss.item(), finite, out, m

    want = gsm_step_launches(kernels, cfg, GSM_TRAIN_VIEWS)
    split, loss, finite, out, _ = step()               # warm-up
    g = out["gaussians"]
    print(f"{tag} release scene: {int(out['render']['rgb'].shape[0])}"
          f" views of {GSM_TRAIN_HW[0]}x{GSM_TRAIN_HW[1]}, "
          f"{int(g['valid'].sum()):,} valid gaussians of {len(g['valid']):,};"
          f" warm-up step {sum(split.values()):.1f} ms, loss {loss:.4f}")
    check(all(g[k].dtype == torch.float32 for k in
              ("means", "scales", "quats", "opacities", "colors")),
          f"gaussians' dtypes {[(k, v.dtype) for k, v in g.items()]}")
    del out, g
    torch.cuda.reset_peak_memory_stats()
    walls, path = [], {k: 0 for k in kernels.launches}
    for i in range(GSM_TRAIN_STEPS):
        kernels.reset_launches()
        t0 = time.perf_counter()
        split, loss, finite, out, m = step()
        walls.append((time.perf_counter() - t0) * 1e3)
        counts = dict(kernels.launches)
        del out
        print(f"{tag} step {i}: {walls[-1]:.1f} ms (" +
              ", ".join(f"{k} {v:.1f}" for k, v in split.items()) +
              f"), loss {loss:.4f} (lpips {float(m['perceptual']):.4f}), "
              f"finite {finite}; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        check(math.isfinite(loss) and finite, f"step {i}: loss {loss}")
        check(counts == want, f"step {i} launches {counts}, want {want}")
        path = {k: path[k] + v for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    mean = sum(walls) / len(walls)
    print(f"{tag} {mean:.1f} ms a step ({1e3 / mean:.3f} "
          f"steps/s), peak {peak:.2f} GiB")
    profile(step, "GSM train step (release scene"
            f"{', gsm_bf16_config' if bf16 else ''})",
            {"sparse_conv_bf16 (forward and dx)":
             ("sparse_conv_kernel<(anonymous namespace)::Bf16",)}
            if bf16 else {"flash_attn_f32_bwd": ("f32_bwd_",)})
    if bf16:
        del model, state, params, lpips
        torch.cuda.empty_cache()
        return dict(step_ms=mean, peak_gib=peak), path
    # one XUnet view chunk (the 3 views), forward and backward
    unet = model.pixel_branch.unet
    x = torch.rand((GSM_TRAIN_VIEWS, *GSM_TRAIN_HW, 5), device="cuda")

    def fwd_bwd(backward_only_cudnn=False):
        ctx = pb.without_cudnn() if backward_only_cudnn else \
            contextlib.nullcontext()
        with ctx:
            y = unet(x)
        y.square().mean().backward()

    for p in unet.parameters():
        p.grad = None
    own = cuda_ms(fwd_bwd, 1, 3)
    with pb.xunet_cudnn():
        lib = cuda_ms(fwd_bwd, 1, 3)
        mixed = cuda_ms(lambda: fwd_bwd(True), 1, 3)
    print(f"[gsm train time] one XUnet view chunk ({GSM_TRAIN_VIEWS} x "
          f"{GSM_TRAIN_HW[0]}x{GSM_TRAIN_HW[1]}) forward + backward: "
          f"{own:.1f} ms with PyTorch's own convolutions throughout (the "
          f"port), {lib:.1f} ms with cuDNN's own choice throughout, "
          f"{mixed:.1f} ms with cuDNN in the backward only (TF32 off)")
    del model, state, params, lpips, unet, x
    torch.cuda.empty_cache()
    return dict(step_ms=mean, peak_gib=peak, xunet_own_ms=own,
                xunet_cudnn_ms=lib, xunet_cudnn_backward_ms=mixed), path


def gsm_train(kernels, att):
    """Phases 32-33. Returns the summary entry of ``flash_attn_f32_bwd``,
    its padded call's launches and the GSM trainer path's launches."""
    from infinicube_tpu_torch.models.gsm import model as gsm
    t0 = time.perf_counter()
    # ---- 32. the f32 attention backward against its plain version ------
    rows, padded = f32_bwd_checks(kernels, att)
    print(f"[gsm train] phase 32 done at {time.perf_counter() - t0:.1f} s")
    # ---- 33. the GSM trainer ------------------------------------------
    launches = gsm_train_main_path(kernels)
    gsm_train_time(kernels)
    gsm_grad_check(kernels, gsm)
    print(f"[gsm train] phase 33 done at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return entry("flash_attn_f32_bwd",
                 "infinicube_tpu_torch/csrc/flash_attention_f32_bwd.cu",
                 "infinicube_tpu/ops/attention.py:72", rows, 0), padded, \
        launches


# ---------------------------------------------------------------------------
# training the GSM in gsm_bf16_config
# ---------------------------------------------------------------------------

# the voxel branch's sparse convs in gsm_bf16_config on bench_gsm_train.py's
# grid, (F, Fo, level): its ten convs at seven shapes (the decoder's
# concatenations 384 -> 128 and 192 -> 64 among them); 30 -> 62 through the
# padding
BF16_CONV_SHAPES = ((64, 64, 0), (64, 128, 1), (128, 128, 1), (128, 256, 2),
                    (256, 256, 2), (384, 128, 1), (192, 64, 0))
# how many of the ten convs of a train step run at each shape (enc0 and
# dec0's second convs at 64 -> 64, enc1 and dec1's at 128 -> 128)
BF16_CONV_STEP_COUNTS = (3, 1, 2, 1, 1, 1, 1)
BF16_CONV_PADDED = (30, 62, 0)
# the pixel branch's bottleneck in training: 3 views of 480x704 at 60 x 88
# tokens, 4 heads of 64
GSM_BF16_ATTN = (3, 60 * 88, 4, 64)


def bf16_ulp_gate(got, ref, label):
    """``got`` within one bf16 ulp of ``ref`` element by element (the ulp of
    the larger of the two), with a floor of 2^-16 of max|ref|: both sum in
    f32 in their own orders, and where an element's terms cancel the order
    alone moves it by more than its own ulp. NaN where ``ref`` is NaN.
    Returns (max-abs error, the share of elements bit-equal)."""
    got, ref = got.float(), ref.float()
    nan = torch.isnan(ref)
    check(torch.equal(torch.isnan(got), nan), f"{label}: NaN where not")
    got, ref = got[~nan], ref[~nan]
    d = (got - ref).abs()
    a = torch.maximum(got.abs(), ref.abs()).clamp_min(2.0 ** -126)
    tol = torch.exp2(torch.floor(torch.log2(a)) - 7) + \
        2.0 ** -16 * ref.abs().max()
    over = int((d > tol).sum())
    equal = (got == ref).float().mean().item()
    err = d.max().item()
    print(f"{label}: bit-equal {100 * equal:.3f} %, max_abs_err {err:.3e} "
          f"(max|ref| {ref.abs().max().item():.3e}), beyond one ulp {over}")
    check(over == 0 and torch.isfinite(got).all().item(),
          f"{label}: {over} elements beyond one bf16 ulp")
    return err, equal


def gsm_bf16_levels():
    """bench_gsm_train.py's scene grid and its two coarser levels (the
    GSM's pyramid) with their conv plans over the bench's dense-lookup
    bounds."""
    from infinicube_tpu_torch.grid.build import coarsened_grid
    from infinicube_tpu_torch.models.gsm.voxel_branch import \
        VoxelBranchConfig
    from infinicube_tpu_torch.nn.sparse import conv_plan
    vcfg = VoxelBranchConfig(dense_lookup_bounds=GSM_TRAIN_BOUNDS)
    grids = [gsm_train_scene("cuda")["grid"]]
    for _ in range(2):
        grids.append(coarsened_grid(grids[-1], vcfg.pooling_factor,
                                    capacity=grids[-1].capacity))
    return [(g, conv_plan(g, dense_bounds=vcfg.level_dense_bounds(level)))
            for level, g in enumerate(grids)]


def bf16_sparse_checks(kernels, ws, levels):
    """Phase 34 (a): ``sparse_conv_bf16`` (forward; as the input gradient
    with the reversed pack, counted as dgrad) and
    ``sparse_conv_bf16_wgrad`` (dW rounded to bf16, as the backward hands
    it on) against ``sparse_conv_plain`` and ``sparse_conv_bwd_plain`` at
    the voxel branch's seven shapes (``bf16_ulp_gate``), each twice,
    bit-identical; timed beside the plain versions and their bounds (2 *
    present (row, tap) pairs * F * Fo bf16 operations at 989 TFLOP/s
    against ``sparse_conv_bytes``); then 30 -> 62 through ``window_sparse_conv``'s
    padding with a gradient, and a poisoned batch element. Returns the
    forward, dx and dW rows and the padded call's rows."""
    g = torch.Generator(device="cuda").manual_seed(34)
    bf = torch.bfloat16
    rows = {"fwd": [], "dx": [], "dw": []}

    def data(grid, F, Fo):
        C, m = grid.capacity, grid.mask[..., None]
        x = torch.where(m, torch.randn((1, C, F), generator=g,
                                       device="cuda"), 0.0).to(bf)
        w = (torch.randn((27, F, Fo), generator=g, device="cuda") /
             math.sqrt(27 * F)).to(bf)
        cot = torch.where(m, torch.randn((1, C, Fo), generator=g,
                                         device="cuda"), 0.0).to(bf)
        return x, w, cot

    for F, Fo, level in BF16_CONV_SHAPES:
        grid, plan = levels[level]
        check(int(plan.violations.sum()) == 0, f"level {level} violations")
        x, w, cot = data(grid, F, Fo)
        pack, dpack = ws.pack_sparse_weight(w), ws.pack_sparse_weight(w, True)
        zero = torch.zeros_like(plan.violations)
        shape = f"L{level} {grid.capacity} x ({F}->{Fo})"

        def fwd():
            return kernels.sparse_conv_bf16(x, plan.nbr, pack,
                                            plan.violations)

        def dgrad():
            return kernels.sparse_conv_bf16(cot, plan.nbr, dpack, zero,
                                            dgrad=True)

        def wgrad():
            return kernels.sparse_conv_bf16_wgrad(x, plan.nbr, cot)

        got = [(fwd(), dgrad(), wgrad().to(bf)) for _ in range(2)]
        check(all(torch.equal(a, b) for a, b in zip(*got)),
              f"[bf16 conv] {shape}: two runs differ")
        ref = (ws.sparse_conv_plain(plan, x, w),
               *ws.sparse_conv_bwd_plain(plan, x, w, cot))
        pairs = int((plan.nbr >= 0).sum())
        flops = 2.0 * pairs * F * Fo
        stages, _ = kernels.sparse_conv_schedule(
            plan.nbr, plan.violations, F, Fo, bf)
        active = int((stages > 0).sum())
        print(f"[bf16 conv] {shape} fwd: {active} of {stages.numel()} work "
              f"items have a stage, {int(stages.clamp_min(0).sum())} stages")
        bounds = [bound_ms([(flops, PEAK_BF16)], sparse_conv_bytes(
            kind, int(grid.mask.sum()), grid.capacity, F, Fo, 2, pack))
            for kind, pack in (("fwd", 2 * 27 * F * Fo),
                               ("dx", 2 * 27 * F * Fo),
                               ("dw", 4 * 27 * F * Fo))]
        plain_fwd = cuda_ms(lambda: ws.sparse_conv_plain(plan, x, w), 1, 2)
        # the plain version computes both gradients in one pass over the
        # taps: its time stands beside each kernel
        plain_bwd = cuda_ms(lambda: ws.sparse_conv_bwd_plain(plan, x, w,
                                                             cot), 1, 2)
        for key, fn, out, want, (b_ms, b_by), plain in zip(
                ("fwd", "dx", "dw"), (fwd, dgrad, wgrad), got[0], ref,
                bounds, (plain_fwd, plain_bwd, plain_bwd)):
            err, equal = bf16_ulp_gate(out, want, f"[bf16 conv] {shape} "
                                       f"{key}")
            ms = cuda_ms(fn, 2, 5)
            print(f"[bf16 conv] {shape} {key}: kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * b_ms / ms:.1f} % "
                  f"of its bound {b_ms:.4f} ms, {b_by}), plain {plain:.3f} "
                  f"ms; {pairs} pairs; no single library call")
            row = dict(shape=shape, max_abs_err=err, bit_equal=equal, ms=ms,
                       plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, pairs=pairs)
            if key == "dw":
                dev = queued_ms(fn)
                wp = kernels.sparse_wgrad_plan(plan.nbr, F, Fo)
                print(f"[bf16 conv] {shape} dw: device alone {dev:.4f} ms, "
                      f"{100 * b_ms / dev:.1f} % of its bound; tile "
                      f"({wp.mt}, {wp.bn}), {wp.stages} stages of "
                      f"{kernels.WGRAD_PAIRS} pairs in {wp.ranges} ranges of "
                      f"{wp.length}, {len(wp.pieces)} pieces")
                row["device_ms"] = dev
            rows[key].append(row)
        del x, w, cot, pack, dpack, got, ref
    # 30 -> 62 through the padding, with a gradient
    F, Fo, level = BF16_CONV_PADDED
    grid, plan = levels[level]
    x, w, cot = data(grid, F, Fo)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    kernels.reset_launches()
    out = ws.window_sparse_conv(plan, xr, wr)
    out.backward(cot)
    torch.cuda.synchronize()
    padded_launches = {k: v for k, v in kernels.launches.items() if v}
    check(padded_launches == {"sparse_conv_bf16": 1,
                              "sparse_conv_bf16_dgrad": 1,
                              "sparse_conv_bf16_wgrad": 1},
          f"padded launches {padded_launches}")
    ref_dx, ref_dw = ws.sparse_conv_bwd_plain(plan, x, w, cot)
    shape = f"L{level} {grid.capacity} x ({F}->{Fo}), padded to (32->64)"
    padded = [dict(shape=shape, max_abs_err=bf16_ulp_gate(
        got, want, f"[bf16 conv] {shape} {key}")[0], output=key)
        for key, got, want in (("fwd", out, ws.sparse_conv_plain(plan, x, w)),
                               ("dx", xr.grad, ref_dx),
                               ("dw", wr.grad, ref_dw))]
    # a poisoned batch element: level 0 twice, the second flagged
    nbr = plan.nbr.expand(2, -1, -1).contiguous()
    poison = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    x2 = torch.cat([x, x.flip(1)]).to(bf)
    x2 = ws.pad_width(x2, -1)
    w2 = ws.pad_width(w, 1, 2)
    got = kernels.sparse_conv_bf16(x2, nbr, ws.pack_sparse_weight(w2), poison)
    ref = ws.sparse_conv_plain(ws.ConvPlan(nbr, poison), x2, w2)
    bf16_ulp_gate(got, ref, "[bf16 conv] poisoned batch element 1")
    check(torch.isnan(got[1]).all().item() and
          torch.isfinite(got[0]).all().item(), "poisoned element")
    print("[bf16 conv] poisoned batch element: row 1 all NaN, row 0 within "
          "the gate")
    torch.cuda.empty_cache()
    return rows, padded


def bf16_wgrad_cases(kernels, ws):
    """Phase 34 (b): ``sparse_conv_bf16_wgrad`` on tables that its walk over
    the present (row, tap) pairs meets, each against
    ``sparse_conv_bwd_plain`` within one bf16 ulp and twice bit-identical:
    3,712 voxels at the front of 65,536 slots (the bench grid's level-2
    fill) at the seven shapes, two batch elements of 15,000 and 2,000 of
    20,000 slots, taps no row has (their dW exactly 0) and a table with no
    voxel (dW all 0). Returns the largest error."""
    g = torch.Generator(device="cuda").manual_seed(341)

    def front(C, active, seed):
        gg = torch.Generator(device="cuda").manual_seed(seed)
        nbr = torch.full((1, C, 27), -1, dtype=torch.int32, device="cuda")
        pick = torch.randint(0, active, (active, 27), generator=gg,
                             device="cuda")
        on = torch.rand((active, 27), generator=gg, device="cuda") < 0.7
        nbr[0, :active] = torch.where(on, pick, -1).int()
        return nbr

    def hold(nbr, F, Fo, label):
        B, C, _ = nbr.shape
        x = torch.randn((B, C, F), generator=g, device="cuda").bfloat16()
        cot = torch.randn((B, C, Fo), generator=g, device="cuda").bfloat16()
        runs = [kernels.sparse_conv_bf16_wgrad(x, nbr, cot) for _ in range(2)]
        torch.cuda.synchronize()
        check(torch.equal(runs[0], runs[1]), f"[bf16 dw] {label}: two runs "
              "differ")
        w = torch.zeros((27, F, Fo), dtype=torch.bfloat16, device="cuda")
        ref = ws.sparse_conv_bwd_plain(ws.ConvPlan(nbr, torch.zeros(
            B, dtype=torch.int32, device="cuda")), x, w, cot)[1]
        if not (ref != 0).any():
            check(not (runs[0] != 0).any(), f"[bf16 dw] {label}: not 0")
            print(f"[bf16 dw] {label}: all 0, twice bit-identical")
            return runs[0], 0.0
        err, _ = bf16_ulp_gate(runs[0].bfloat16(), ref, f"[bf16 dw] {label}")
        return runs[0], err

    worst = 0.0
    nbr = front(1 << 16, 3712, 1)
    for F, Fo, _ in BF16_CONV_SHAPES:
        worst = max(worst, hold(nbr, F, Fo, f"3,712 of 65,536 ({F}->{Fo})")[1])
    two = torch.cat([front(20_000, 15_000, 2), front(20_000, 2_000, 3)])
    worst = max(worst, hold(two, 64, 128, "B = 2 of 15,000 and 2,000")[1])
    nbr[..., 5] = -1
    nbr[..., 26] = -1
    dw, err = hold(nbr, 128, 128, "taps 5 and 26 absent")
    check(not (dw[5] != 0).any() and not (dw[26] != 0).any(),
          "[bf16 dw] an absent tap's dW is not 0")
    worst = max(worst, err)
    hold(torch.full((2, 5000, 27), -1, dtype=torch.int32, device="cuda"), 64,
         64, "no voxel")
    return worst


def attn_train_rows(kernels, att, g, B, nq, nk, h, d, tag):
    """K2 with its lse store and K5 in bf16 at a training shape (B batches,
    Nq queries, Nk keys, h heads of d), against ``attention_plain`` and
    ``attention_bwd_plain`` in f32 on the same inputs (K2's gate
    ``k2_gate`` and the lse within 1e-3, K5's ``gate``, each kernel's two
    runs bit-identical), timed beside the plain versions, their bounds and
    ``scaled_dot_product_attention``'s forward and pinned backward.
    Returns K2's and K5's rows."""
    q, k, v, do = (rand((B, n, h, d), g) for n in (nq, nk, nk, nq))
    scale = d ** -0.5
    shape = f"B={B} Nq={nq} Nk={nk} h={h} d={d}"
    o, lse = kernels.flash_attn_bf16(q, k, v, scale, return_lse=True)
    again = kernels.flash_attn_bf16(q, k, v, scale, return_lse=True)
    check(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
          f"{tag} {shape}: K2 two runs differ")
    ref_o, ref_lse = att.attention_plain(q.float(), k.float(), v.float(),
                                         scale, return_lse=True)
    o_err = k2_gate(o, ref_o, f"{tag} {shape} K2 o")
    lse_err = (lse - ref_lse).abs().max().item()
    print(f"{tag} {shape} K2 lse: max_abs_err {lse_err:.3e} "
          f"(limit 1.000e-03)")
    check(lse.shape == (B, h, nq) and lse_err <= 1e-3,
          f"{tag} K2 lse {tuple(lse.shape)} err {lse_err}")
    delta = att.attention_delta(ref_o, do)
    got = kernels.flash_attn_bf16_bwd(q, k, v, do, ref_lse, delta, scale)
    again = kernels.flash_attn_bf16_bwd(q, k, v, do, ref_lse, delta, scale)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{tag} {shape}: K5 two runs differ")
    ref = att.attention_bwd_plain(q.float(), k.float(), v.float(), ref_o,
                                  do.float(), ref_lse, scale)
    err = max(gate(a, b, f"{tag} {shape} K5 d{name}")
              for a, b, name in zip(got, ref, "qkv"))
    del ref_o, ref_lse, ref, got, again
    fwd_ms = cuda_ms(lambda: kernels.flash_attn_bf16(q, k, v, scale,
                                                     return_lse=True))
    delta = att.attention_delta(o, do)
    bwd_ms = cuda_ms(lambda: kernels.flash_attn_bf16_bwd(q, k, v, do, lse,
                                                         delta, scale))
    plain_fwd = cuda_ms(lambda: att.attention_plain(q, k, v, scale), 1, 3)
    plain_bwd = cuda_ms(lambda: att.attention_bwd_plain(q, k, v, o, do, lse,
                                                        scale), 1, 3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_fwd = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt))
    lib_bwd, backend = sdpa_backward_ms(q, k, v, do)
    flops = 4.0 * nq * nk * d * h * B
    f_ms, f_by = bound_ms([(flops, PEAK_BF16)], 2 * 2 * B * h * d *
                          (nq + nk) + 4 * B * h * nq)
    b_ms, b_by = bound_ms([(2.5 * flops, PEAK_BF16)],
                          2 * B * d * h * (3 * nq + 4 * nk) +
                          2 * 4 * B * h * nq)
    print(f"{tag} {shape}: K2 with the lse store {fwd_ms:.4f} ms "
          f"({100 * f_ms / fwd_ms:.1f} % of its bound {f_ms:.4f} ms, {f_by}),"
          f" plain {plain_fwd:.3f} ms, sdpa {lib_fwd:.4f} ms; K5 "
          f"{bwd_ms:.4f} ms ({100 * b_ms / bwd_ms:.1f} % of its bound "
          f"{b_ms:.4f} ms, {b_by}), plain {plain_bwd:.3f} ms, sdpa backward "
          f"({backend}, pinned) {lib_bwd:.4f} ms")
    return (dict(shape=shape, max_abs_err=o_err, lse_max_abs_err=lse_err,
                 ms=fwd_ms, plain_ms=plain_fwd, bound_ms=f_ms, bound_by=f_by,
                 library_ms=lib_fwd),
            dict(shape=shape, max_abs_err=err, ms=bwd_ms, plain_ms=plain_bwd,
                 bound_ms=b_ms, bound_by=b_by, library_ms=lib_bwd,
                 library_backend=backend))


def bf16_attn_checks(kernels, att):
    """Phase 34 (b): K2 and K5 in bf16 at the pixel branch's training
    bottleneck [3, 5,280, 4, 64] (``attn_train_rows``). Returns K2's and
    K5's rows."""
    g = torch.Generator(device="cuda").manual_seed(35)
    B, n, h, d = GSM_BF16_ATTN
    return attn_train_rows(kernels, att, g, B, n, n, h, d, "[gsm bf16 attn]")


def gsm_bf16_grad_check(kernels, gsm):
    """Phase 35 (b): a tiny GSM in ``gsm_bf16_config``, one random init,
    ``gsm_loss`` and every gradient of one train step, card (the bf16
    sparse-conv kernels, K2 and K5) against the CPU (plain versions): both
    branches on the depth-prior scene, and the voxel branch off (there the
    pixel branch and its attention carry the gradient). Gate: each
    parameter group's (encoder, voxel branch, pixel branch, sky) gradient
    at cosine >= 0.999 card against CPU, over the groups whose CPU gradient
    is above 1e-3 of the largest; the worst tensor's cosine printed
    beside."""
    from infinicube_tpu_torch.models.gsm.encoders import UnifiedEncoderConfig
    from infinicube_tpu_torch.models.gsm.loss import GSMLossConfig, gsm_loss
    from infinicube_tpu_torch.models.gsm.pixel_branch import \
        PixelBranchConfig
    from infinicube_tpu_torch.models.gsm.sky import SkyConfig
    from infinicube_tpu_torch.models.gsm.voxel_branch import \
        VoxelBranchConfig
    from infinicube_tpu_torch.weights.from_jax import gsm_from_jax
    base = dict(
        encoder=UnifiedEncoderConfig(conv_width=16),
        voxel=VoxelBranchConfig(f_maps=16, levels=2, gaussians_per_voxel=2),
        pixel=PixelBranchConfig(width=8, dims=(1, 2), gs_per_pixel=1),
        sky=SkyConfig(embed_dim=32, num_layers=1, num_heads=2, patch=8),
        dense_dims=(40, 32, 16), dense_ijk_min=(0, -16, -2),
        render_tile_capacity=64)
    conv, attn = "sparse_conv_bf16", "flash_attn_bf16"
    for kind, kw in (("joint", {}), ("pixel", dict(use_voxel_branch=False))):
        cfg = gsm.gsm_bf16_config(gsm.GSMConfig(**base, **kw))
        grads, losses = {}, {}
        for dev in ("cpu", "cuda"):
            model = gsm.GSM(cfg, device=dev)
            model.load_state_dict(gsm_from_jax(random_gsm_tree(model, 41)))
            batch = gsm_tiny_scene(dev)
            kernels.reset_launches()
            out = model(batch)
            valid = batch["masks"][..., 0] * batch["masks"][..., 2] > 0
            loss, _ = gsm_loss(GSMLossConfig(), out["render"],
                               batch["images"], valid, out["sky_mask"],
                               gaussians=out["gaussians"])
            loss.backward()
            losses[dev] = loss.item()
            grads[dev] = {k: (torch.zeros_like(p) if p.grad is None
                              else p.grad).cpu() for k, p in
                          model.named_parameters()}
            launches = {k: v for k, v in kernels.launches.items() if v}
        top = max(g.abs().max().item() for g in grads["cpu"].values())
        groups, worst_tensor = {}, (1.0, "")
        for name, ref in grads["cpu"].items():
            got = grads["cuda"][name]
            groups.setdefault(name.split(".")[0], []).append((got, ref))
            if ref.abs().max().item() > 1e-3 * top:
                worst_tensor = min(worst_tensor, (cos(got, ref), name))
        coss = {}
        for group, pairs in groups.items():
            got = torch.cat([a.reshape(-1) for a, _ in pairs])
            ref = torch.cat([b.reshape(-1) for _, b in pairs])
            if ref.abs().max().item() > 1e-3 * top:
                coss[group] = cos(got, ref)
        print(f"[gsm bf16 grad] {kind}: loss card {losses['cuda']:.6f} cpu "
              f"{losses['cpu']:.6f}; cosine card against CPU by group "
              f"{ {k: round(v, 6) for k, v in coss.items()} } (limit "
              f"0.999), worst tensor {worst_tensor[1]} at "
              f"{worst_tensor[0]:.6f}; card launches {launches}")
        check(coss and min(coss.values()) >= 0.999,
              f"[gsm bf16 grad] {kind}: cosines {coss}")
        check(abs(losses["cuda"] - losses["cpu"]) <=
              1e-3 * abs(losses["cpu"]), f"[gsm bf16 grad] {kind}: losses")
        want = ({conv, conv + "_dgrad", conv + "_wgrad"}
                if kind == "joint" else set()) | {attn, attn + "_bwd"}
        check(set(launches) == want, f"[gsm bf16 grad] {kind}: launches "
              f"{launches}")
    return coss


def gsm_bf16_train(kernels, att):
    """Phases 34-35. Returns the summary entries of the bf16 sparse-conv
    kernels, their padded call's rows, K2's and K5's rows at the GSM's
    bf16 training shape, and the bf16 trainer path's launches."""
    from infinicube_tpu_torch.models.gsm import model as gsm
    from infinicube_tpu_torch.ops import window_conv as ws
    t0 = time.perf_counter()
    # ---- 34. the bf16 kernels against their plain versions ------------
    levels = gsm_bf16_levels()
    rows, padded = bf16_sparse_checks(kernels, ws, levels)
    del levels
    cases_err = bf16_wgrad_cases(kernels, ws)
    print(f"[gsm bf16] the weight gradient's walk cases: max_abs_err "
          f"{cases_err:.3e}")
    k2_row, k5_row = bf16_attn_checks(kernels, att)
    print(f"[gsm bf16] phase 34 done at {time.perf_counter() - t0:.1f} s")
    # ---- 35. the GSM trainer in gsm_bf16_config --------------------------
    _, launches = gsm_train_time(kernels, bf16=True)
    gsm_bf16_grad_check(kernels, gsm)
    print(f"[gsm bf16] phase 35 done at {time.perf_counter() - t0:.1f} s")
    print(f"[gsm bf16] main path launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    torch.cuda.empty_cache()
    src = "infinicube_tpu_torch/csrc/"
    entries = {
        "sparse_conv_bf16": entry(
            "sparse_conv_bf16", src + "sparse_conv.cu",
            "infinicube_tpu/ops/window_conv.py:222", rows["fwd"], 0),
        "sparse_conv_bf16_dgrad": entry(
            "sparse_conv_bf16_dgrad", src + "sparse_conv.cu",
            "infinicube_tpu/ops/window_conv.py:320", rows["dx"], 0),
        "sparse_conv_bf16_wgrad": entry(
            "sparse_conv_bf16_wgrad", src + "sparse_conv_bwd.cu",
            "infinicube_tpu/ops/window_conv.py:252", rows["dw"], 0)}
    return entries, padded, k2_row, k5_row, launches


# ---------------------------------------------------------------------------
# the video stage's leftovers: the Wan VAE's routed convs on K3, its streaming
# decode, and the DiT's flow-matching train step
# ---------------------------------------------------------------------------

# the routed convs of one release decode tile (24 latent frames of 32 x 32,
# pipeline.generate's tile), frames counted with the 2 history frames:
# (D, H, W, C, O)
VAE_DECODE_SHAPES = ((26, 32, 32, 384, 384), (49, 64, 64, 192, 384),
                     (49, 64, 64, 384, 384), (95, 128, 128, 192, 192),
                     (95, 256, 256, 96, 96))
# the whole-frame latent level of a 93-frame decode, and one routed conv of
# each level of a 93-frame encode tile of 480 x 256 pixels
VAE_FRAME_SHAPE = (26, 60, 104, 384, 384)
VAE_ENCODE_SHAPES = ((95, 480, 256, 96, 96), (95, 240, 128, 192, 192),
                     (49, 120, 64, 384, 384), (26, 60, 32, 384, 384))


def vae_conv_row(kernels, dc, g, shape, dtype=torch.bfloat16):
    """One conv of the VAE's routed set through the card's kernel for
    ``dtype`` (K3 for bf16, ``conv3x3x3_f32`` for f32) against
    ``conv3x3x3_plain`` on the same inputs, at its gate (bf16: cosine >=
    0.9999 and max-abs <= 2e-2 * max|ref|; f32: max-abs <= 1e-4 *
    max|ref|); timed beside the plain version, its bound (2*V*27*C*O at the
    dtype's peak, 3 TF32 products for f32) and cuDNN's conv3d on the same
    padded input (channels_last_3d, so that it reads the layout K3 reads).
    The shape's D counts the 2 history frames, whose 2 outputs the route
    drops; the causal bound counts only the D - 2 frames the VAE keeps
    (2*(D-2)*H*W*27*C*O, the same input read, D - 2 frames written)."""
    D_, H_, W_, C, O = shape
    x = torch.randn((1, D_, H_, W_, C), generator=g, device="cuda").to(dtype)
    w = (torch.randn((O, C, 3, 3, 3), generator=g, device="cuda") /
         math.sqrt(27 * C)).to(dtype)
    b = 0.1 * torch.randn(O, generator=g, device="cuda")
    wp = dc.pack_conv_weight(w, dtype)
    run = kernels.conv3x3x3_bf16 if dtype == torch.bfloat16 else \
        kernels.conv3x3x3_f32
    got = run(x, wp, b).float()
    ref = dc.conv3x3x3_plain(x, w, b).float()
    c, err = cos(got, ref), (got - ref).abs().max().item()
    f32 = dtype == torch.float32
    lim = (1e-4 if f32 else 2e-2) * ref.abs().max().item()
    label = f"[vae k3{' f32' if f32 else ''}] [1,{D_},{H_},{W_},{C}]->{O}"
    print(f"{label}: cosine {c:.7f} max_abs_err {err:.3e} (limit {lim:.3e})")
    check(err <= lim and (f32 or c >= 0.9999),
          f"{label}: cos {c} err {err}")
    del got, ref
    ms = cuda_ms(lambda: run(x, wp, b), 2, 5)
    plain = cuda_ms(lambda: dc.conv3x3x3_plain(x, w, b), 1, 2)
    xl = x.permute(0, 4, 1, 2, 3)
    wl = w.contiguous(memory_format=torch.channels_last_3d)
    bb = b.to(dtype)
    lib = cuda_ms(lambda: torch.nn.functional.conv3d(xl, wl, bb, padding=1),
                  2, 5)
    elt = 4 if f32 else 2

    def bound(d_out):
        V, Vo = D_ * H_ * W_, d_out * H_ * W_
        flops = 2.0 * Vo * 27 * C * O
        return bound_ms([(3 * flops, PEAK_TF32)] if f32 else
                        [(flops, PEAK_BF16)],
                        elt * (V * C + 27 * C * O + Vo * O) + 4 * O)

    (b_ms, b_by), (c_ms, c_by) = bound(D_), bound(D_ - 2)
    flops = 2.0 * D_ * H_ * W_ * 27 * C * O
    print(f"{label}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
          f"{100 * b_ms / ms:.1f} % of its bound, {100 * c_ms / ms:.1f} % of "
          f"the causal bound), plain {plain:.3f} ms, cudnn {lib:.3f} ms, "
          f"bound {b_ms:.3f} ms ({b_by}), causal bound {c_ms:.3f} ms "
          f"({c_by})")
    del x, w, wp, xl, wl
    return dict(shape=f"[1,{D_},{H_},{W_},{C}]->{O}", max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                causal_bound_ms=c_ms, causal_bound_by=c_by)


def vae_k3_checks(kernels, dc):
    """Phase 36: K3 at the VAE's routed shapes (decode tile, whole-frame
    latent, one per encode level), and the f32 conv at the decode tile's
    latent shape. Returns (bf16 rows, f32 rows)."""
    g = torch.Generator(device="cuda").manual_seed(36)
    rows = [vae_conv_row(kernels, dc, g, s) for s in
            VAE_DECODE_SHAPES + (VAE_FRAME_SHAPE,) + VAE_ENCODE_SHAPES]
    f32_rows = [vae_conv_row(kernels, dc, g, VAE_DECODE_SHAPES[0],
                             torch.float32)]
    torch.cuda.empty_cache()
    return rows, f32_rows


def timed_ms(fn):
    """fn() between two synchronizes: (its result, host ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def vae_routed_counts(vae3d, cfg):
    """The routed convs of one decode and one encode call, derived from
    ``decoder_schedule`` / ``encoder_schedule`` with the port's rule
    (``vae3d.routes``: a ResidualBlock conv whose widths are both >= 64),
    printed term by term. Returns (decode, encode)."""
    impl = cfg.conv_impl

    def block(cin, feat):
        return int(vae3d.routes(impl, (3, 3, 3), cin, feat)) + \
            int(vae3d.routes(impl, (3, 3, 3), feat, feat))

    def walk(schedule, cin, label):
        terms = []
        for idx, kind, feat in schedule:
            if kind == "res":
                terms.append((f"{label}_{idx}", block(cin, feat)))
                cin = feat
            elif kind.startswith("up"):
                cin //= 2
        return terms, cin

    top = cfg.base_channels * cfg.channel_mult[-1]
    dec, _ = walk(vae3d.decoder_schedule(cfg), top, "upsamples")
    dec = [("middle_0", block(top, top)), ("middle_2", block(top, top))] + dec
    enc, c = walk(vae3d.encoder_schedule(cfg), cfg.base_channels,
                  "downsamples")
    enc += [("middle_0", block(c, c)), ("middle_2", block(c, c))]
    for name, terms in (("decode", dec), ("encode", enc)):
        print(f"[vae] routed convs per {name} call: " +
              " + ".join(f"{k} {n}" for k, n in terms) +
              f" = {sum(n for _, n in terms)}")
    return sum(n for _, n in dec), sum(n for _, n in enc)


def frames_gate(got, ref, label, min_cos, max_err=None, frames=True):
    """Frames (or latents) of two runs: cosine, max-abs and, for frames, the
    share of the reference's values strictly inside (-1, 1) (the decoder
    clips there)."""
    got, ref = got.float().cpu(), ref.float().cpu()
    c, err = cos(got, ref), (got - ref).abs().max().item()
    inside = (ref.abs() < 1).float().mean().item()
    print(f"{label}: cosine {c:.7f} max_abs_err {err:.3e} (gates: cosine >= "
          f"{min_cos}" + ("" if max_err is None else
                          f", max-abs <= {max_err}") + ")" +
          (f"; {100 * inside:.1f} % of the reference inside (-1, 1)"
           if frames else ""))
    check(c >= min_cos and (max_err is None or err <= max_err),
          f"{label}: cos {c} err {err}")
    return c, err


def vae_routes(kernels, vae3d):
    """Phase 37: the release VAE (``VideoVAEConfig.wan21``, full width,
    random weights) with ``conv_impl="auto"`` and its ``"xla"`` twin on the
    same weights: one decode tile and one encode tile card against card
    with exact K3 launches, the routed card decode against the CPU's plain
    routed decode (f32) on a cut clip; then the video stage's VAE work on
    each route (the tiled decode of 24 latent frames at 60 x 104, the two
    tiled buffer encodes of 93 frames at 480 x 832), timed, with peak
    memory; the routed run is the main path. Returns (the routed VAE, its
    path's launches, the times by route, the K3 launches a decode call)."""
    cfg = vae3d.VideoVAEConfig.wan21(conv_impl="auto")
    n_dec, n_enc = vae_routed_counts(vae3d, cfg)
    g = torch.Generator(device="cuda").manual_seed(37)
    routed = vae3d.VideoVAE(cfg, device="cuda").eval().requires_grad_(False)
    routed.init_params(g)
    xla = vae3d.VideoVAE(dataclasses.replace(cfg, conv_impl="xla"),
                         device="cuda").eval().requires_grad_(False)
    xla.load_state_dict(routed.state_dict())
    vaes = {"auto": routed, "xla": xla}
    z = torch.randn((1, 24, 32, 32, 16), generator=g, device="cuda")
    video = torch.rand((1, 93, 480, 256, 3), generator=g,
                       device="cuda") * 2 - 1
    out = {}
    with torch.no_grad():
        for impl, vae in vaes.items():
            kernels.reset_launches()
            dec = vae.decode(z)
            n_d = kernels.launches["conv3x3x3_bf16"]
            lat = vae.encode(video)
            n_e = kernels.launches["conv3x3x3_bf16"] - n_d
            want = (n_dec, n_enc) if impl == "auto" else (0, 0)
            print(f"[vae] {impl}: decode tile {tuple(z.shape)} -> "
                  f"{tuple(dec.shape)}, encode tile {tuple(video.shape)} -> "
                  f"{tuple(lat.shape)}; K3 launches {n_d} + {n_e} (want "
                  f"{want[0]} + {want[1]})")
            check((n_d, n_e) == want, f"{impl} K3 launches {n_d}, {n_e}")
            out[impl] = (dec, lat)
        frames_gate(out["auto"][0], out["xla"][0],
                    "[vae] decode tile, routed vs xla (card)", 0.999)
        frames_gate(out["auto"][1], out["xla"][1],
                    "[vae] encode tile latents, routed vs xla (card)", 0.999,
                    frames=False)
        del out, dec, lat, video
        # the routed card decode against the CPU's plain routed decode (f32)
        cpu = vae3d.VideoVAE(dataclasses.replace(cfg, dtype=torch.float32),
                             device="cpu").eval().requires_grad_(False)
        cpu.load_state_dict({k: v.cpu() for k, v in
                             routed.state_dict().items()})
        zc = z[:, :2, :8, :8]
        t0 = time.perf_counter()
        ref = cpu.decode(zc.cpu())
        cpu_s = time.perf_counter() - t0
        frames_gate(routed.decode(zc), ref,
                    f"[vae] cut decode {tuple(zc.shape)} -> "
                    f"{tuple(ref.shape)}, routed card (bf16) vs cpu (f32, "
                    f"plain, {cpu_s:.1f} s)", 0.999)
        del cpu, ref
        # where a decode tile's time goes on each route
        for impl, vae in vaes.items():
            profile(lambda: vae.decode(z), f"decode tile {tuple(z.shape)}, "
                    f"{impl}")
    torch.cuda.empty_cache()

    # the video stage's VAE work on each route
    T, Hl, Wl = 24, 60, 104
    zf = torch.randn((1, T, Hl, Wl, 16), generator=g, device="cuda")
    sem, coo = (torch.rand((1, 93, 480, 832, 3), generator=g,
                           device="cuda") * 2 - 1 for _ in range(2))
    times, path = {}, None
    for impl in ("auto", "xla"):
        vae = vaes[impl]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        frames, dec_ms = timed_ms(lambda: vae3d.decode_tiled_host(
            vae, zf, tile=(32, 32), to_uint8=True))
        (zs, zo), enc_ms = timed_ms(lambda: (
            vae3d.encode_tiled_host(vae, sem),
            vae3d.encode_tiled_host(vae, coo)))
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = dict(kernels.launches)
        want = 8 * n_dec + 2 * 4 * n_enc if impl == "auto" else 0
        print(f"[vae] {impl}: tiled decode of {T} latent frames at "
              f"{Hl}x{Wl} (8 tiles) {dec_ms:.1f} ms -> {frames.shape}; two "
              f"tiled encodes of 93 frames at 480x832 (4 tiles each) "
              f"{enc_ms:.1f} ms -> {tuple(zs.shape)}; peak {peak:.2f} GiB; "
              f"K3 {launches['conv3x3x3_bf16']} launches (want {want})")
        check(launches["conv3x3x3_bf16"] == want and
              sum(launches.values()) == want, f"{impl} launches {launches}")
        check(frames.shape == (1, 93, 480, 832, 3) and
              frames.min() != frames.max() and
              bool(torch.isfinite(zs).all() and torch.isfinite(zo).all()),
              f"{impl} outputs")
        times[impl] = dict(decode_ms=dec_ms, encode_ms=enc_ms,
                           peak_gib=peak)
        if impl == "auto":
            path = launches
        del frames, zs, zo
    print(f"[vae] video-stage VAE work, routed / xla: decode "
          f"{times['auto']['decode_ms']:.1f} / {times['xla']['decode_ms']:.1f}"
          f" ms, encodes {times['auto']['encode_ms']:.1f} / "
          f"{times['xla']['encode_ms']:.1f} ms, peak "
          f"{times['auto']['peak_gib']:.2f} / {times['xla']['peak_gib']:.2f} "
          f"GiB")
    del xla, vaes, zf, sem, coo
    torch.cuda.empty_cache()
    return routed, path, times, n_dec


def vae_streaming(kernels, vae3d, routed, n_dec, tiled):
    """Phase 38: ``decode_streaming_host`` at chunks of 1, 2 and 3 latent
    frames against the whole-clip decode at 480 x 832 with 9 latent frames,
    on both routes (bf16 runs the same convs in another chunking: gates
    cosine >= 0.9999 and max-abs <= 0.05, about 6 bf16 ulps at 1); then the
    routed streaming decode of 24 latent frames at chunk 2, whole frame,
    timed with peak memory beside the tiled decode, exactly ``n_dec`` K3
    launches a chunk (the main path). Returns its launches."""
    xla = vae3d.VideoVAE(dataclasses.replace(routed.cfg, conv_impl="xla"),
                         device="cuda").eval().requires_grad_(False)
    xla.load_state_dict(routed.state_dict())
    g = torch.Generator(device="cuda").manual_seed(38)
    z = torch.randn((1, 9, 60, 104, 16), generator=g, device="cuda")
    for impl, vae in (("auto", routed), ("xla", xla)):
        with torch.no_grad():
            whole = vae.decode(z).cpu()
        for chunk in (1, 2, 3):
            kernels.reset_launches()
            got = torch.from_numpy(vae3d.decode_streaming_host(vae, z, chunk))
            n_chunks = -(-9 // chunk)
            want = n_chunks * n_dec if impl == "auto" else 0
            check(kernels.launches["conv3x3x3_bf16"] == want,
                  f"streaming {impl} chunk {chunk}: "
                  f"{kernels.launches['conv3x3x3_bf16']} K3 launches, want "
                  f"{want}")
            frames_gate(got, whole, f"[stream] {impl} chunk {chunk} "
                        f"({n_chunks} chunks, K3 {want}) vs whole clip "
                        f"{tuple(whole.shape)}", 0.9999, 0.05)
        del whole, got
    del xla
    torch.cuda.empty_cache()
    zf = torch.randn((1, 24, 60, 104, 16), generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    frames, ms = timed_ms(lambda: vae3d.decode_streaming_host(routed, zf, 2))
    peak = torch.cuda.max_memory_allocated() / 2**30
    path = dict(kernels.launches)
    print(f"[stream] routed streaming decode of 24 latent frames at 60x104, "
          f"chunk 2: {ms:.1f} ms, peak {peak:.2f} GiB -> {frames.shape}; "
          f"the tiled decode {tiled['decode_ms']:.1f} ms, peak "
          f"{tiled['peak_gib']:.2f} GiB (with the encodes); K3 "
          f"{path['conv3x3x3_bf16']} launches (want {12 * n_dec})")
    check(path["conv3x3x3_bf16"] == 12 * n_dec and
          sum(path.values()) == 12 * n_dec, f"streaming launches {path}")
    check(frames.shape == (1, 93, 480, 832, 3) and
          bool(np.isfinite(frames).all()), "streaming frames")
    del frames, zf
    torch.cuda.empty_cache()
    return path


def dit_train_grad_check(WanVideoGenerator, WanPipelineConfig, T5Config):
    """Phase 39, first: a 2-layer full-width DiT (dim 1536, 12 heads of
    128), ``train_loss`` and every parameter's gradient on the card (bf16
    compute over f32 parameters, K2 / K5) against the CPU (f32, plain
    versions), same weights (zero-init layers filled) and injected draws;
    the worst per-tensor cosine gated at 0.99 as phase 11 gates the UNet's.
    The frozen towers are cut to tiny: ``train_loss`` takes the text
    embedding and the buffer latents as inputs."""
    base = WanPipelineConfig()
    small = dict(t5=T5Config.tiny(), vae=dataclasses.replace(
        base.vae, base_channels=8, channel_mult=(1, 2), num_res_blocks=1))
    dit = dataclasses.replace(base.dit, num_layers=2)
    gens = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        gens[dev] = WanVideoGenerator(WanPipelineConfig(
            dit=dataclasses.replace(dit, dtype=dtype), **small), device=dev)
    g = torch.Generator().manual_seed(39)
    gens["cpu"].init_params(g)
    fill_zero_init(gens["cpu"].dit, g)
    gens["cuda"].dit.load_state_dict(gens["cpu"].dit.state_dict())
    rng = np.random.default_rng(39)
    lat, buf, txt, noise = (torch.from_numpy(rng.standard_normal(
        s, dtype=np.float32)) for s in ((1, 3, 16, 32, 16),
                                        (1, 3, 16, 32, 32),
                                        (1, TEXT_LEN, 4096),
                                        (1, 3, 16, 32, 16)))
    draws = dict(u=torch.tensor([0.3]), noise=noise,
                 drop=torch.tensor([False]))
    losses, grads = {}, {}
    for dev, gen in gens.items():
        gen.dit.requires_grad_(True)
        t0 = time.perf_counter()
        loss, _ = gen.train_loss(*(x.to(dev) for x in (lat, txt, buf)),
                                 **{k: v.to(dev) for k, v in draws.items()})
        loss.backward()
        losses[dev] = (loss.item(), time.perf_counter() - t0)
        grads[dev] = {k: p.grad for k, p in gen.dit.named_parameters()}
    g_max = max(gr.abs().max().item() for gr in grads["cpu"].values())
    cosines, zero, bad = {}, {}, []
    for k, gr in grads["cuda"].items():
        ref = grads["cpu"][k]
        if gr is None or not torch.isfinite(gr).all():
            bad.append(k)
        elif ref.abs().max().item() < 1e-6 * g_max:
            zero[k] = gr.abs().max().item()
        elif not gr.any():
            bad.append(k)
        else:
            cosines[k] = cos(gr.cpu(), ref)
    check(not bad, f"DiT parameters without a finite, non-zero gradient: "
          f"{bad}")
    order = sorted(cosines, key=cosines.get)
    vals = np.array([cosines[k] for k in order])
    print(f"[dit train] 2-layer dim-1536 DiT, N = {3 * 8 * 16}, text "
          f"{TEXT_LEN}: loss card {losses['cuda'][0]:.6f} vs cpu "
          f"{losses['cpu'][0]:.6f} (cpu {losses['cpu'][1]:.1f} s); "
          f"{len(cosines)} gradient tensors, {len(zero)} zero by construction"
          f" {sorted(zero)}; cosine card vs cpu: median "
          f"{np.median(vals):.6f}, worst {vals[0]:.6f}")
    for k in order[:4]:
        print(f"[dit train]   cosine {cosines[k]:.6f}  {k}")
    check(abs(losses["cuda"][0] - losses["cpu"][0]) <=
          2e-2 * abs(losses["cpu"][0]), f"loss {losses}")
    check(vals[0] >= 0.99, f"worst gradient cosine {vals[0]} ({order[0]})")


def dit_train(kernels, att, T5Config):
    """Phase 39: ``WanVideoGenerator.train_loss`` on the 30-layer 1.3B DiT
    (``WanPipelineConfig().dit``: bf16 compute, f32 residual stream and
    parameters) at 17 frames @ 480x832 (latents [1, 5, 60, 104, 16],
    buffer latents [1, 5, 60, 104, 32], text [1, 512, 4096], seeded), the
    draws from a generator on the card; AdamW from ``training/state.py``
    (EMA off), a warm-up step, then 3 steps split into forward, backward and
    optimizer with exactly K2 60 and K5 60 launches a step (the main path),
    finite losses, parameters that moved; peak memory; one step under the
    profiler. Before the model is built, K2 with its lse store and K5 are
    held to their plain versions at the step's two attention shapes
    (``attn_train_rows``: self-attention N = 7,800 and cross-attention
    7,800 x 512, 12 heads of 128). Returns the path's launches and K2's and
    K5's rows at those shapes."""
    from infinicube_tpu_torch.models.wan.pipeline import (WanPipelineConfig,
                                                          WanVideoGenerator)
    from infinicube_tpu_torch.training.state import (TrainConfig, TrainState,
                                                     grads_finite,
                                                     learning_rate_at)
    base = WanPipelineConfig()
    T, Hl, Wl = dataclasses.replace(base, num_frames=17).latent_thw
    n = T * Hl * Wl // 4
    g = torch.Generator(device="cuda").manual_seed(39)
    rows = [attn_train_rows(kernels, att, g, 1, n, nk, H, D, "[dit attn]")
            for nk in (n, TEXT_LEN)]
    torch.cuda.empty_cache()
    dit_train_grad_check(WanVideoGenerator, WanPipelineConfig, T5Config)
    gen = WanVideoGenerator(WanPipelineConfig(t5=T5Config.tiny(),
                                              vae=dataclasses.replace(
                                                  base.vae, base_channels=8,
                                                  channel_mult=(1, 2),
                                                  num_res_blocks=1)),
                            device="cuda")
    g = torch.Generator(device="cuda").manual_seed(40)
    gen.init_params(g)
    fill_zero_init(gen.dit, g)
    gen.dit.requires_grad_(True)
    params = dict(gen.dit.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    tcfg = TrainConfig(use_ema=False)
    state = TrainState.create(tcfg, params)
    lat = torch.randn((1, T, Hl, Wl, 16), generator=g, device="cuda")
    buf = torch.randn((1, T, Hl, Wl, 32), generator=g, device="cuda")
    txt = torch.randn((1, TEXT_LEN, 4096), generator=g, device="cuda")

    def optimize():
        finite = grads_finite([p.grad for p in params.values()
                               if p.grad is not None])
        if finite:
            torch.nn.utils.clip_grad_value_(list(params.values()),
                                            tcfg.grad_clip_value)
            for group in state.opt.param_groups:
                group["lr"] = learning_rate_at(tcfg, state.opt_count)
            state.opt.step()
        else:
            state.num_nan_skips += 1
        state.step += 1
        return finite

    def step():
        for p in params.values():
            p.grad = None
        (loss, _), t_fwd = timed_ms(lambda: gen.train_loss(lat, txt, buf,
                                                           generator=g))
        _, t_bwd = timed_ms(loss.backward)
        finite, t_opt = timed_ms(optimize)
        return dict(forward=t_fwd, backward=t_bwd, optimizer=t_opt), \
            loss.item(), finite

    split, loss, finite = step()                       # warm-up
    print(f"[dit train] 1.3B DiT ({n_params:,} parameters, f32) at 17 "
          f"frames @ 480x832 (N = {T * Hl * Wl // 4:,}): warm-up step "
          f"{sum(split.values()):.1f} ms, loss {loss:.5f}")
    watch = {k: params[k].detach().clone() for k in
             ("blocks.0.self_attn.qkv.weight", "blocks.29.ffn_out.weight",
              "head.weight")}
    torch.cuda.reset_peak_memory_stats()
    path = {k: 0 for k in kernels.launches}
    splits, losses = [], []
    for i in range(3):
        kernels.reset_launches()
        split, loss, finite = step()
        delta = dict(kernels.launches)
        for k, v in delta.items():
            path[k] += v
        splits.append(split)
        losses.append(loss)
        print(f"[dit train] step {i}: loss {loss:.5f}, finite {finite}, "
              + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
              + f" ms; launches { {k: v for k, v in delta.items() if v} }")
        check(finite and math.isfinite(loss), f"step {i} loss {loss}")
        check(delta["flash_attn_bf16"] == 60 and
              delta["flash_attn_bf16_bwd"] == 60 and
              sum(delta.values()) == 120, f"step {i} launches {delta}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = {k: (params[k] - v).abs().max().item() for k, v in watch.items()}
    check(all(m > 0 for m in moved.values()), f"parameters moved {moved}")
    mean = {k: float(np.mean([s[k] for s in splits])) for k in splits[0]}
    total = sum(mean.values())
    print(f"[dit train] 3 steps: {total:.1f} ms a step (" +
          ", ".join(f"{k} {v:.1f}" for k, v in mean.items()) +
          f"), {1e3 / total:.3f} steps/s, peak {peak:.2f} GiB; parameters "
          f"moved (max |change|) {moved}")
    profile(lambda: step(), "DiT train step (1.3B, 17f@480p)")
    del gen, params, state, watch
    torch.cuda.empty_cache()
    return path, [r[0] for r in rows], [r[1] for r in rows]


def video_leftovers(kernels, att, dense_conv):
    """Phases 36-39. Returns K3's and the f32 conv's rows at the VAE's
    shapes, K2's and K5's at the DiT train step's attention shapes, and the
    launches of the three main paths (the video stage's VAE work on the
    routed convs, the streaming decode, the DiT's train steps)."""
    from infinicube_tpu_torch.models.wan import vae3d
    from infinicube_tpu_torch.models.wan.t5 import T5Config
    t0 = time.perf_counter()
    # ---- 36. K3 at the VAE's shapes ----------------------------------------
    k3_rows, f32_rows = vae_k3_checks(kernels, dense_conv)
    print(f"[video] phase 36 done at {time.perf_counter() - t0:.1f} s")
    # ---- 37. the release VAE on both routes ---------------------------------
    routed, vae_path, times, n_dec = vae_routes(kernels, vae3d)
    print(f"[video] phase 37 done at {time.perf_counter() - t0:.1f} s")
    # ---- 38. the streaming decode -------------------------------------------
    stream_path = vae_streaming(kernels, vae3d, routed, n_dec,
                                times["auto"])
    del routed
    torch.cuda.empty_cache()
    print(f"[video] phase 38 done at {time.perf_counter() - t0:.1f} s")
    # ---- 39. the DiT's flow-matching train step -----------------------------
    train_path, k2_rows, k5_rows = dit_train(kernels, att, T5Config)
    print(f"[video] phase 39 done at {time.perf_counter() - t0:.1f} s")
    return k3_rows, f32_rows, k2_rows, k5_rows, {"wan_vae": vae_path,
                               "wan_vae_stream": stream_path,
                               "wan_train": train_path}


# ---------------------------------------------------------------------------
# the chained pipeline (phase 40) and stage 3's frozen towers (phase 41)
# ---------------------------------------------------------------------------

# the e2e release profile cut as phases 4 and 8 cut it: DDIM-2 chunks, the
# video at 17 frames and 4 steps; stage 3 on 16 of the 17 frames
E2E_DDIM, E2E_FRAMES, E2E_STEPS = 2, 17, 4
K1_PER_REQUEST = 30 * 2 * E2E_STEPS      # layers x sequential CFG x steps
SKY_TIE = 1e-4                           # top-two logit gap of a near tie


def e2e_want(chunks, gsm_cfg, views, dyn):
    """Exact launches of the chain and the resume: per stage-1 chunk 48 K3
    and 10 K2 a DDIM step and the VAE decode's 12 K4; the video request's
    K1 and K2 (30 layers x 2 CFG passes x 4 steps, the VAE on
    ``F.conv3d``); two stage-3 reconstructions (the chain's and the
    resume's), each with its dynamic pass where the views hold dynamic
    instances."""
    want = {k: 0 for k in ("conv3x3x3_bf16", "flash_attn_bf16",
                           "sparse_conv_f32", "flash_attn_int8qk",
                           "flash_attn_f32")}
    want["conv3x3x3_bf16"] = chunks * 48 * E2E_DDIM
    want["flash_attn_bf16"] = chunks * 10 * E2E_DDIM + K1_PER_REQUEST
    want["sparse_conv_f32"] = chunks * 12
    want["flash_attn_int8qk"] = K1_PER_REQUEST
    for k, v in gsm_launches(gsm_cfg, views, 1 + dyn).items():
        want[k] += 2 * v
    return want


def e2e_chain(kernels):
    """Phase 40: ``examples.e2e_pipeline.run_pipeline`` at the release
    profile on the card (the release UNet with the sparse VAE's structure
    decode at DDIM-2, 17 buffer frames at 480x832, the serving video stage
    at 4 steps, the release GSM on 16 views), then
    ``e2e_stage3_resume.resume`` on the artifacts it wrote; each stage's
    seconds and peak memory, the artifact set, the outputs' shapes and
    finiteness, the resume's gaussians against the chain's where it read
    the chain's frames, exact launches. Returns the path's launches."""
    from infinicube_tpu_torch.examples import e2e_pipeline as e2e
    from infinicube_tpu_torch.examples.e2e_stage3_resume import resume
    from infinicube_tpu_torch.inference import scene_gaussian_generation as sg
    from infinicube_tpu_torch.models.wan.pipeline import WanPipelineConfig
    dcfg, vcfg, gsm_cfg, _ = e2e.profile_configs("release")
    wan_cfg = WanPipelineConfig.serving(num_frames=E2E_FRAMES,
                                        num_steps=E2E_STEPS)
    views = e2e.Stage3Views(16, 1, 16)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_e2e_")
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = e2e.run_pipeline(tmp, dcfg, vcfg, gsm_cfg, wan_cfg, views,
                               frames=E2E_FRAMES, hw=(480, 832),
                               ddim_steps=E2E_DDIM, device="cuda")
        chain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = resume(tmp, gsm_cfg, views, device="cuda")
        resume_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        files = sorted(os.listdir(tmp))
        bufs = sorted(os.listdir(os.path.join(tmp, "buffers")))
        inst = sg.load_buffer_folder(os.path.join(tmp, "buffers"),
                                     views.num_frames)["instance"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for label, rec in list(res["seconds"].items()) + list(
            again["seconds"].items()):
        print(f"[e2e] {label}: {rec['cold_s']:.3f} s, peak "
              f"{rec['peak_gib']:.2f} GiB")
    print(f"[e2e] the chain {chain_s:.2f} s, the resume {resume_s:.2f} s; "
          f"{res['chunks']} stage-1 chunks, {res['world'].num_voxels} voxels,"
          f" {len(res['static_gs']['means'])} static gaussians; outputs "
          f"{files}, buffers/ {bufs}")
    for name in ("world.npz", "decoded_gs_static.pkl",
                 "decoded_gs_static.splat", "render0.png", "buffers"):
        check(name in files, f"e2e wrote no {name}: {files}")
    check("video.mp4" in files or "video" in files, f"no video: {files}")
    for name in ("depth.tar", "instance.tar", "semantic.tar", "pose.tar",
                 "intrinsic.tar", "dynamic_object_info.tar", "world.npz"):
        check(name in bufs, f"buffers/ has no {name}: {bufs}")
    check(any(b.startswith("semantic") for b in bufs if not
              b.endswith(".tar")), f"no previews: {bufs}")
    v = res["video"]
    check(v.shape == (E2E_FRAMES, 480, 832, 3) and np.isfinite(v).all()
          and v.min() != v.max(), f"e2e video {v.shape}")
    for label, out in (("chain", res), ("resume", again)):
        gs = out["static_gs"]
        rgb = out["out"]["render"]["rgb"]
        check(len(gs["means"]) > 0 and all(np.isfinite(a).all()
                                            for a in gs.values()),
              f"{label} gaussians")
        check(tuple(rgb.shape) == (16, 480, 832, 3) and
              torch.isfinite(rgb).all().item(), f"{label} renders")
    if again["video"]:
        # the resume read the chain's frames back: the same scene, each
        # field within 1e-3 of its scale
        a, b = res["static_gs"], again["static_gs"]
        check(len(a["means"]) == len(b["means"]),
              "the resume's gaussian count differs from the chain's")
        err = {k: float(np.abs(a[k] - b[k]).max() /
                        max(np.abs(a[k]).max(), 1e-30)) for k in a}
        print(f"[e2e] the resume read the video/ frames back: its gaussians "
              f"against the chain's, max |diff| / max |value| {err}")
        check(max(err.values()) <= 1e-3, f"resume against chain {err}")
    else:
        print("[e2e] the chain wrote video.mp4: the resume took random "
              "frames, as the reference's")
    dyn = bool((inst >= sg.DYNAMIC_ID_BASE).any())
    want = e2e_want(res["chunks"], gsm_cfg, views.max_views, dyn)
    got = {k: launches[k] for k in want}
    others = {k: n for k, n in launches.items() if n and k not in want}
    print(f"[e2e] launches {got} (want {want})")
    check(got == want and not others,
          f"e2e launches {got}, want {want}; others {others}")
    torch.cuda.empty_cache()
    return launches


def sky_logit_shift(model, frames):
    """The sky class's bias raised so that it wins on about a third of the
    pixels of ``frames`` (random weights make it win nowhere)."""
    from infinicube_tpu_torch.models.gsm import segformer as seg
    x = (frames - frames.new_tensor(seg.IMAGENET_MEAN)) / frames.new_tensor(
        seg.IMAGENET_STD)
    with torch.inference_mode():
        logits = model(x)
    sky = seg.CITYSCAPES_SKY_ID
    others = torch.cat([logits[..., :sky], logits[..., sky + 1:]], -1)
    gap = (others.amax(-1) - logits[..., sky]).flatten().float()
    with torch.no_grad():
        model.classifier.bias[sky] += torch.quantile(gap[::97], 0.33)


def frozen_towers(kernels, data):
    """Phase 41, on phase 30's 16 views of 480x832: a release-width GSM
    with ``encoders=("conv", "dav2")`` (``DAv2Config.vits()``, target
    252x336) timed with exact launches and its peak, the DAv2 refiner's
    output card against CPU on one view (cosine >= 0.9999); then SegFormer
    b0 over the 16 frames, card against CPU: masks equal except at pixels
    whose top two logits lie within 1e-4, those counted, both timed."""
    from infinicube_tpu_torch.inference import scene_gaussian_generation as sg
    from infinicube_tpu_torch.models.gsm import model as gsm
    from infinicube_tpu_torch.models.gsm import segformer as seg
    from infinicube_tpu_torch.models.gsm.dav2 import DAv2Config
    from infinicube_tpu_torch.models.gsm.encoders import (
        DAV2FeatureEncoder, UnifiedEncoderConfig, nchw, resize)
    cfg = gsm.GSMConfig(encoder=UnifiedEncoderConfig(
        encoders=("conv", "dav2"), dav2_config=DAv2Config.vits()),
        **STAGE3_CROP)
    model = gsm.GSM(cfg, device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(41))
    batch = stage3_batch(sg, data, "cuda", STAGE3_VIEWS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        model(batch)                                   # warm-up
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = model(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = dict(model.last_phase_seconds)
    want = gsm_launches(cfg, STAGE3_VIEWS, 1)
    got = {k: kernels.launches[k] for k in want}
    g = out["gaussians"]
    print(f"[towers] release GSM with the DAv2 encoder, {STAGE3_VIEWS} views "
          f"of 480x832: {wall:.3f} s (" + ", ".join(
              f"{k} {v:.3f}" for k, v in split.items()) + f"), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"{int(g['valid'].sum())} valid gaussians, launches {got}")
    check(got == want, f"DAv2 GSM launches {got}, want {want}")
    check(all(torch.isfinite(v[g["valid"]]).all().item() for k, v in
              g.items() if k != "valid" and v.dtype.is_floating_point),
          "DAv2 GSM gaussians not finite")
    enc = model.encoder.dav2
    images = batch["images"]
    with torch.inference_mode():
        t0 = time.perf_counter()
        feats = enc(images)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        cpu = DAV2FeatureEncoder(cfg.encoder.dav2_width,
                                 cfg.encoder.dav2_target_hw,
                                 DAv2Config.vits(), device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in enc.state_dict().items()})
        t0 = time.perf_counter()
        ref = cpu(images[:1].cpu())
        cpu_s = time.perf_counter() - t0
    c = cos(feats[:1].cpu(), ref)
    print(f"[towers] the DAv2 encoder alone on {STAGE3_VIEWS} views: "
          f"{enc_s:.3f} s; its output on view 0 card vs CPU cosine "
          f"{c:.7f} (CPU {cpu_s:.2f} s), |out| max "
          f"{ref.abs().max().item():.3f}")
    check(c >= 0.9999, f"DAv2 encoder card vs CPU cosine {c}")
    del model, out, g, batch, feats
    torch.cuda.empty_cache()

    frames = torch.as_tensor(data["video"][:STAGE3_VIEWS])
    hw = tuple(frames.shape[1:3])
    card = seg.Segformer(seg.SegformerConfig.b0(), device="cuda")
    card.init_params(torch.Generator(device="cuda").manual_seed(41))
    sky_logit_shift(card, frames[:2].cuda())
    cpu = seg.Segformer(seg.SegformerConfig.b0(), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    segment = seg.make_segformer_sky_segmenter(
        card.state_dict(), seg.SegformerConfig.b0(), device="cuda")
    segment.batch(frames[:1].numpy())                   # warm-up
    t0 = time.perf_counter()
    masks = segment.batch(frames.numpy())
    card_s = time.perf_counter() - t0
    x = (frames - frames.new_tensor(seg.IMAGENET_MEAN)) / frames.new_tensor(
        seg.IMAGENET_STD)
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits = torch.cat([cpu(x[i:i + 4]) for i in range(0, len(x), 4)])
        cpu_s = time.perf_counter() - t0
        up = resize(nchw(logits), hw, "bilinear")
    ref = (up.argmax(1) == seg.CITYSCAPES_SKY_ID).to(torch.uint8).numpy()
    top2 = up.topk(2, dim=1).values
    ties = ((top2[:, 0] - top2[:, 1]) <= SKY_TIE).numpy()
    differ = masks != ref
    print(f"[towers] SegFormer b0 sky masks of {len(frames)} frames at "
          f"{hw[0]}x{hw[1]}: card {card_s:.3f} s, CPU {cpu_s:.2f} s; sky "
          f"share {ref.mean():.3f}; {int(differ.sum())} pixels differ, all "
          f"among the {int(ties.sum())} near ties: "
          f"{not (differ & ~ties).any()}")
    check(masks.shape == ref.shape and masks.dtype == np.uint8,
          f"sky masks {masks.shape} {masks.dtype}")
    check(not (differ & ~ties).any(), "sky masks differ off the near ties")
    check(0.05 < ref.mean() < 0.95, f"sky share {ref.mean()}")
    del card, cpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# stage 1's leftovers: the alternative conditioning (phase 42) and the sparse
# side (phase 43)
# ---------------------------------------------------------------------------

# every alternative condition on, at the release width: the extra cube
# (semantic 8 + single scan 8 + LSS 8 channels: in_conv takes 16 + 24 = 40),
# an adm class one-hot of 10 and a text-like context of 77 x 768
ALT_CFG = dict(use_semantic_cond=True, use_single_scan_cond=True,
               use_image_cond="lss", num_classes=10, context_dim=768)
ALT_VIEWS, ALT_HW, ALT_SCAN, ALT_CTX = 3, (480, 832), 20_000, 77
# the plain versions that a CUDA tensor must never reach
PLAIN_FUNCS = (("ops.dense_conv", "conv3x3x3_plain"),
               ("ops.dense_conv", "conv3x3x3_int8_plain"),
               ("ops.attention", "attention_plain"),
               ("ops.attention", "attention_bwd_plain"),
               ("ops.window_conv", "sparse_conv_plain"),
               ("ops.window_conv", "sparse_conv_bwd_plain"),
               ("nn.sparse", "_attention_plain"))


@contextlib.contextmanager
def no_plain_versions():
    """Every kernel's plain version (and the sparse attention's einsum)
    raises while the block runs: the main path's proof that no CUDA tensor
    took one."""
    import importlib
    saved = []

    def refuse(name):
        def fn(*a, **kw):
            raise RuntimeError(f"{name}: a plain version ran on the card")
        return fn

    for mod, name in PLAIN_FUNCS:
        m = importlib.import_module(f"infinicube_tpu_torch.{mod}")
        saved.append((m, name, getattr(m, name)))
        setattr(m, name, refuse(name))
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def alt_views(B=1):
    """3 views at 480x832 looking along +x, -y and +y from the cube's
    centre (axis-permutation rotations: the lifted world points are exact
    on every device), with the release camera's intrinsics."""
    K = np.array([[600.0, 0, 416.3], [0, 600.0, 240.7], [0, 0, 1]],
                 np.float32)
    fwd = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    turn = {"+x": np.eye(3, dtype=np.float32),
            "-y": np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float32),
            "+y": np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)}
    T = np.tile(np.eye(4, dtype=np.float32), (ALT_VIEWS, 1, 1))
    for i, r in enumerate(turn.values()):
        T[i, :3, :3] = r @ fwd
        T[i, :3, 3] = [0.3, -0.2, 1.7]
    return (np.broadcast_to(K, (B, ALT_VIEWS, 3, 3)).copy(),
            np.broadcast_to(T, (B, ALT_VIEWS, 4, 4)).copy())


def alt_raw(cfg, seed, B=1):
    """Raw alternative conditions (CPU tensors): a semantic cube, a
    20,000-point scan, 3 views at 480x832."""
    rng = np.random.default_rng(seed)
    D, H, W = cfg.cube_dims
    half = np.array(cfg.cube_dims) * np.array(cfg.latent_voxel_size) / 2
    Ks, Ts = alt_views(B)
    raw = dict(
        semantics=rng.integers(0, 23, (B, D, H, W)).astype(np.int32),
        scan_points=rng.uniform(-half, half, (B, ALT_SCAN, 3)).astype(
            np.float32),
        scan_mask=rng.random((B, ALT_SCAN)) < 0.95,
        images=rng.uniform(size=(B, ALT_VIEWS) + ALT_HW + (3,)).astype(
            np.float32),
        Ks=Ks, cam_to_worlds=Ts)
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def alt_cond(mods, cfg, extra, seed, B=1):
    """A full condition: random map and box cubes, the extra cube, a class
    one-hot and a 77-token context."""
    rng = np.random.default_rng(seed)
    D, H, W = cfg.cube_dims

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32))

    dev = extra.device
    return mods.CondCubes(
        (arr(B, D, H, W, cfg.num_map_types) > 1.0).float().to(dev),
        (arr(B, D, H, W, 2) > 1.5).float().to(dev), extra_cube=extra,
        class_oh=torch.eye(cfg.num_classes)[
            rng.integers(0, cfg.num_classes, B)].to(dev),
        context=arr(B, ALT_CTX, cfg.context_dim).to(dev))


def alt_encoder_checks(mods):
    """The condition encoders' extra cube on the release 64^3 cube from 3
    views at 480x832, card against CPU in f32, for the LSS config and a
    lift3d one."""
    for image in ("lss", "lift3d"):
        cfg = mods.DiffusionConfig(**dict(ALT_CFG, use_image_cond=image))
        cpu = mods.CondEncoders(cfg, device="cpu")
        mods.init_alt(cpu, torch.Generator().manual_seed(42))
        card = mods.CondEncoders(cfg, device="cuda")
        card.load_state_dict(cpu.state_dict())
        raw = alt_raw(cfg, 42)
        with torch.no_grad():
            t0 = time.perf_counter()
            ref = cpu(**raw)
            cpu_s = time.perf_counter() - t0
            got = card(**raw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = card(**raw).cpu()
            card_s = time.perf_counter() - t0
        gate(got, ref, f"[alt] CondEncoders ({image}) extra cube "
             f"{tuple(ref.shape)} card vs cpu (card {card_s * 1e3:.1f} ms, "
             f"cpu {cpu_s:.1f} s)")
        check((ref[..., -cfg.image_cond_dim:] != 0).float().mean() > 0.01,
              f"{image}: the image lift reached no cell")


def alt_unet_checks(mods):
    """The release-width UNet on a 16^3 cube with every condition on
    (in_conv 40 wide, cross-attention on a 77 x 768 context, 10 classes):
    card (bf16; K3, K2) against the CPU (f32, plain versions) at phase 7's
    gate, and the int8 serving twin (K7) against the CPU's (bf16, the plain
    versions) and the card's bf16 forward at phase 19's."""
    base = mods.DiffusionConfig(cube_dims=(16, 16, 16), serve_quant=True,
                                **ALT_CFG)
    card = mods.VoxelDiffusion(base, device="cuda")
    card.init_params(torch.Generator(device="cuda").manual_seed(43),
                     zero_init_layers=False)
    cpu = mods.VoxelDiffusion(dataclasses.replace(base, dtype=torch.float32),
                              device="cpu")
    cpu8 = mods.VoxelDiffusion(base, device="cpu")
    for m in (cpu, cpu8):
        m.load_params(card.named_parameters())
    rng = np.random.default_rng(43)
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, 16, 8),
                                             dtype=np.float32))
    extra = torch.from_numpy(rng.standard_normal(
        (1, 16, 16, 16, base.extra_cond_channels), dtype=np.float32))
    cond = alt_cond(mods, base, extra, 43)
    t = torch.tensor([500])
    card_cond = mods.CondCubes(*(None if v is None else v.cuda()
                                 for v in dataclasses.astuple(cond)))
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = cpu.denoise(x, t, cond)
        ref8 = cpu8.denoise(x, t, cond, serve=True)
        cpu_s = time.perf_counter() - t0
        got = card.denoise(x.cuda(), t.cuda(), card_cond).cpu()
        got8 = card.denoise(x.cuda(), t.cuda(), card_cond, serve=True).cpu()
    c, c8, c_full = cos(got, ref), cos(got8, ref8), cos(got8, got)
    print(f"[alt] release-width UNet with every condition on 16^3 "
          f"(in_conv {base.latent_channels + base.cond_channels} wide, "
          f"context {ALT_CTX} x {base.context_dim}, {base.num_classes} "
          f"classes): card vs cpu cosine {c:.6f} (gate 0.999), |out| max "
          f"{ref.abs().max().item():.3f}; int8 twin card vs cpu {c8:.7f} "
          f"(gate 0.9995), int8 vs bf16 on the card {c_full:.6f} (gate "
          f"0.999) (cpu {cpu_s:.1f} s)")
    check(torch.isfinite(got).all().item() and
          torch.isfinite(got8).all().item(), "alt UNet not finite")
    check(c >= 0.999 and c8 >= 0.9995 and c_full >= 0.999,
          f"alt UNet cosines {c}, {c8}, {c_full}")
    del cpu, cpu8, card


ALT_CONVS = {"stage1_alt": {"conv3x3x3_int8": 0, "conv3x3x3_bf16": 48},
             "stage1_alt_int8": {"conv3x3x3_int8": 23,
                                 "conv3x3x3_bf16": 25}}


def alt_call_launches(diffusion):
    """Exact launches of one UNet call of the serving twin at CFG batch 2,
    derived with the port's rule: hooks on its 3x3x3 convs record whether
    each quantizes and ``int8_conv_applies`` holds for its input (K7), else
    K3; every SelfAttention3D block is one K2."""
    from infinicube_tpu_torch.ops.dense_conv import (Conv3x3x3,
                                                     int8_conv_applies)
    cfg = diffusion.cfg
    net = diffusion.unet_serve
    seen = []

    def hook(m, args):
        x = args[0]
        seen.append(m.quant and int8_conv_applies(x.shape[:4], x.shape[-1],
                                                  m.weight.shape[0]))
    hooks = [m.register_forward_pre_hook(hook) for m in net.modules()
             if isinstance(m, Conv3x3x3)]
    D, H, W = cfg.cube_dims
    try:
        with torch.no_grad():
            net(torch.zeros((2, D, H, W, cfg.latent_channels +
                             cfg.cond_channels), device="cuda"),
                torch.tensor([500, 500], device="cuda"),
                context=torch.zeros((2, ALT_CTX, cfg.context_dim),
                                    device="cuda"),
                y_emb=torch.zeros((2, cfg.num_classes), device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    n_int8 = sum(seen)
    return {"conv3x3x3_int8": n_int8, **{k: n_int8 for k in INT8_PROLOGUE},
            "conv3x3x3_bf16": len(seen) - n_int8,
            "flash_attn_bf16": net._counts[1]}


def alt_serve(kernels, mods):
    """Phase 42's serving: ``VoxelDiffusion.sample`` on the release 64^3
    cube with every condition on, CFG 2.0 as the doubled batch, DDIM-10,
    bf16 and then through the int8 serving twin; the conditions encoded
    once by ``encode_extra``. Seconds a step, peak memory, exact launches a
    step, no plain version called. Returns the launches of each path."""
    cfg = mods.DiffusionConfig(**ALT_CFG)
    t0 = time.perf_counter()
    diffusion = mods.VoxelDiffusion(cfg, device="cuda")
    diffusion.init_params(torch.Generator(device="cuda").manual_seed(44),
                          zero_init_layers=False)
    n_unet = sum(p.numel() for p in diffusion.unet.parameters())
    n_enc = sum(p.numel() for p in diffusion.cond_enc.parameters())
    torch.cuda.synchronize()
    print(f"[alt serve] UNet {n_unet:,} parameters (the release 750,431,048 "
          f"with in_conv 40 wide, the 12 blocks' cross-attention and "
          f"y_proj) and condition encoders {n_enc:,}, built in "
          f"{time.perf_counter() - t0:.1f} s")
    check(n_unet > 750_431_048, f"{n_unet} UNet parameters")
    raw = alt_raw(cfg, 44)
    paths = {}
    for label, twin in (("stage1_alt", None), ("stage1_alt_int8", True)):
        if twin:
            diffusion.unet_serve = diffusion.unet.serving_twin()
        want1 = alt_call_launches(diffusion)
        # the reference's plan predicate at these shapes: 23 of the 48
        # convs int8 on the twin, in_conv (40 wide) among the 25 bf16 ones
        # (tests/test_torch_dense_conv_int8.py holds the rule against it)
        convs = {k: want1[k] for k in ALT_CONVS[label]}
        check(convs == ALT_CONVS[label],
              f"{label} convs a call {convs}, want {ALT_CONVS[label]}")
        want = {k: v * STAGE1_DDIM for k, v in want1.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with no_plain_versions():
            t0 = time.perf_counter()
            extra = diffusion.encode_extra(**raw)
            torch.cuda.synchronize()
            enc_s = time.perf_counter() - t0
            cond = alt_cond(mods, cfg, extra, 45)
            g = torch.Generator(device="cuda").manual_seed(45)
            t0 = time.perf_counter()
            lat = diffusion.sample(cond, num_steps=STAGE1_DDIM,
                                   guidance_scale=GUIDANCE, generator=g)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = {k: launches[k] for k in want}
        others = {k: n for k, n in launches.items() if n and k not in want}
        print(f"[alt serve] {label}: encode_extra (semantic cube, "
              f"{ALT_SCAN:,}-point scan, {ALT_VIEWS} views of "
              f"{ALT_HW[0]}x{ALT_HW[1]} through LSS) {enc_s:.3f} s, then "
              f"DDIM-{STAGE1_DDIM} with CFG {GUIDANCE} at batch 2: "
              f"{wall:.2f} s ({wall / STAGE1_DDIM * 1e3:.1f} ms a step), "
              f"peak {peak:.2f} GiB; launches a step {want1}, in all {got}")
        check(lat.shape == (1, 64, 64, 64, 8) and
              torch.isfinite(lat).all().item(), f"{label} latents")
        check(got == want and not others,
              f"{label} launches {got}, want {want}; others {others}")
        paths[label] = launches
    del diffusion
    torch.cuda.empty_cache()
    return paths


def alt_train(kernels):
    """Phase 42's training: ``train.main`` on configs/train_diffusion.yaml
    with the same ``diffusion.*`` keys, batch 1, 3 steps: finite losses,
    exact launches a step, the UNet moved, the condition encoders not (the
    synthetic stream's conditions are the null ones), the checkpoint read
    back. Returns the path's launches."""
    from infinicube_tpu_torch import train as train_cli
    from infinicube_tpu_torch.training import loop
    from infinicube_tpu_torch.training.checkpoint import CheckpointManager
    keys = [f"diffusion.{k}={str(v).lower() if isinstance(v, bool) else v}"
            for k, v in ALT_CFG.items()]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_alt_")
    per_step, undo = counting_steps(kernels, loop)
    try:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with no_plain_versions():
            state = train_cli.main(
                [os.path.join(ROOT, "configs", "train_diffusion.yaml"),
                 "--name", "alt", "--logdir", tmp, "--exec", "batch_size=1",
                 f"max_steps={TRAIN_STEPS}", "log_every=1",
                 f"ckpt_dir={tmp}/ck", *keys])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        logs = [json.loads(line) for line in
                open(os.path.join(tmp, "alt.jsonl"))]
        print(f"[alt train] {sum(p.numel() for p in state.params.values()):,}"
              f" parameters, {TRAIN_STEPS} steps at batch 1 through "
              f"train.main with {keys} in {wall:.1f} s (model build, steps "
              f"and the final checkpoint), peak {peak:.1f} GiB")
        for r, delta in zip(logs, per_step):
            print(f"[alt train] step {r['step']}: loss {r['loss']:.6f}, "
                  f"{r['steps_per_sec']:.3f} steps/s; launches "
                  f"{ {k: v for k, v in delta.items() if v} }")
            check(math.isfinite(r["loss"]) and r["grad_finite"] == 1.0,
                  f"step {r['step']}: {r}")
            check(delta == STEP_LAUNCHES,
                  f"step {r['step']} launches {delta}, want {STEP_LAUNCHES}")
        check(len(per_step) == len(logs) == TRAIN_STEPS,
              f"{len(per_step)} steps counted, {len(logs)} logged")
        moved = {k for k, p in state.params.items()
                 if not torch.equal(p.detach(), state.ema.params[k])}
        stepped = {k for k, p in state.params.items()
                   if state.opt.state.get(p)}
        enc = {k for k in state.params if k.startswith("cond_enc.")}
        print(f"[alt train] {len(moved)} of {len(state.params)} parameter "
              f"tensors moved; the optimizer never stepped the {len(enc)} "
              f"condition-encoder tensors (no gradient on the null "
              f"conditions, as in JAX): {not stepped & enc}")
        check("unet.out_conv.weight" in moved and
              "unet.middle_transformer.blocks.0.cross_o.weight" in moved and
              not stepped & enc, f"moved: {sorted(moved)[:5]}")
        mgr = CheckpointManager(os.path.join(tmp, "ck"))
        # the parameters read back through a memory map (the moments and
        # the EMA shadow are held read back by phase 12)
        sd = torch.load(mgr._path(mgr.latest_step()), map_location="cpu",
                        mmap=True, weights_only=True)
        same = all(torch.equal(sd["params"][k], p.detach().cpu())
                   for k, p in state.params.items())
        print(f"[alt train] final checkpoint "
              f"{os.path.getsize(mgr._path(TRAIN_STEPS)) / 1e9:.2f} GB, its "
              f"parameters read back {'identical' if same else 'DIFFER'}")
        check(same and sd["step"] == TRAIN_STEPS, "checkpoint differs")
        del sd, state
    finally:
        undo()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def alt_conditioning(kernels):
    """Phase 42. Returns the launches of its three paths."""
    from infinicube_tpu_torch.models.diffusion import alt_encoders
    from infinicube_tpu_torch.models.diffusion.model import (CondCubes,
                                                             CondEncoders,
                                                             DiffusionConfig,
                                                             VoxelDiffusion)
    mods = types.SimpleNamespace(
        CondCubes=CondCubes, CondEncoders=CondEncoders,
        DiffusionConfig=DiffusionConfig, VoxelDiffusion=VoxelDiffusion,
        init_alt=alt_encoders.init_params)
    t0 = time.perf_counter()
    alt_encoder_checks(mods)
    alt_unet_checks(mods)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    paths = alt_serve(kernels, mods)
    t2 = time.perf_counter()
    paths["stage1_alt_train"] = alt_train(kernels)
    print(f"[alt] checks {t1 - t0:.1f} s, serving {t2 - t1:.1f} s, training "
          f"{time.perf_counter() - t2:.1f} s")
    return paths


# the VAE's attention level and heads, as phase 43 trains them
VAE_ATTN = dict(attention_levels=(2,), use_normal_head=True,
                use_color_head=True)
VAE_ATTN_STEP = {**VAE_STEP_LAUNCHES, "flash_attn_f32": 2,
                 "flash_attn_f32_bwd": 2}
# SparseUNetConfig() a forward: 5 res blocks of two convs, 2 attentions
SPARSE_UNET_CALL = {"sparse_conv_f32": 10, "flash_attn_f32": 2}


def sparse_attention_checks():
    """``sparse_attention``'s card route against its plain version on the
    CPU at the VAE's level-2 width (256, 4 heads of 64) over 4,096 slots,
    three samples, the middle one without an active row: f32 at
    ``flash_attn_f32``'s gate (max |err| <= 1e-4 max |ref|), bf16 no
    further from the f32 result than twice the plain bf16 one."""
    from infinicube_tpu_torch.nn import sparse
    from infinicube_tpu_torch.nn.layers import Dense
    g = torch.Generator().manual_seed(46)
    C, F = 4096, 256
    mask = torch.zeros((3, C), dtype=torch.bool)
    mask[0, :2500] = True
    mask[2, 300:4000] = True
    feats = torch.where(mask[..., None], torch.randn((3, C, F), generator=g),
                        torch.zeros(()))
    qkv, proj = Dense(F, 3 * F, compute_dtype=None), \
        Dense(F, F, compute_dtype=None)
    for m in (qkv, proj):
        torch.nn.init.normal_(m.weight, 0.0, 1.0 / math.sqrt(F),
                              generator=g)
    qkv_c, proj_c = (copy.deepcopy(m).cuda() for m in (qkv, proj))
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for m in (qkv, proj, qkv_c, proj_c):
            m.compute_dtype = dt              # bf16 q, k, v: K2's route
        x = feats.to(dt)
        with torch.no_grad():
            t0 = time.perf_counter()
            ref = sparse.sparse_attention(x, mask, 4, qkv, proj).float()
            cpu_s = time.perf_counter() - t0
            got = sparse.sparse_attention(x.cuda(), mask.cuda(), 4, qkv_c,
                                          proj_c).float().cpu()
        out[dt] = (got, ref, cpu_s)
    got, ref, cpu_s = out[torch.float32]
    err = (got - ref).abs().max().item()
    lim = 1e-4 * ref.abs().max().item()
    print(f"[sparse attn] f32, [3, {C}, {F}] with 2500, 0 and 3700 active "
          f"rows: card vs plain max_abs_err {err:.3e} (limit {lim:.3e}; "
          f"plain {cpu_s:.1f} s); the empty sample "
          f"{'zero' if not got[1].any() else 'NOT ZERO'}")
    check(err <= lim and not got[1].any(), "f32 sparse attention")
    b16, b16_ref, _ = out[torch.bfloat16]
    d_card, d_plain = (b16 - ref).norm().item(), (b16_ref - ref).norm().item()
    print(f"[sparse attn] bf16: distance to the f32 result card {d_card:.3e}"
          f", plain {d_plain:.3e} (bound twice the plain's)")
    check(d_card <= 2 * d_plain + 1e-6 * ref.norm().item(),
          "bf16 sparse attention")


def vae_attn_grad_check(mods):
    """The release-width VAE with the attention level and heads on phase
    15's small scene: ``vae_loss`` and every gradient, card (K4, K4-dgrad,
    K6, ``flash_attn_f32`` and its backward) against the CPU (plain
    versions), the attention's zero-init ``proj`` filled so that every
    tensor but the heads (outputs only) gets a gradient."""
    def fill(model):
        g = torch.Generator().manual_seed(47)
        with torch.no_grad():
            for side in ("enc", "dec"):
                w = getattr(model, f"attn2_{side}_proj").weight
                w.copy_(torch.randn(w.shape, generator=g) /
                        math.sqrt(w.shape[1]))
    vae_grad_check(mods, VAE_ATTN, prepare=fill,
                   outputs_only=("normal_head.", "color_head."))


def vae_attn_train_main_path(kernels):
    """``train.main`` on configs/train_vae.yaml with 200,000 points per
    sample and the attention level and heads, 3 steps: exact launches a
    step, no plain version called, peak memory far below the 17 GB of one
    sample's dense [h, C, C] logits at level 2. Returns the launches."""
    from infinicube_tpu_torch import train as train_cli
    from infinicube_tpu_torch.training import loop
    keys = ["vae.attention_levels=(2,)", "vae.use_normal_head=true",
            "vae.use_color_head=true"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vae_attn_")
    per_step, undo = counting_steps(kernels, loop)
    try:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with no_plain_versions():
            state = train_cli.main(
                [os.path.join(ROOT, "configs", "train_vae.yaml"), "--name",
                 "attn", "--logdir", tmp, "--exec",
                 f"max_steps={TRAIN_STEPS}", f"points_per_sample={VAE_POINTS}",
                 "log_every=1", "ckpt_every=1000", f"ckpt_dir={tmp}/ck",
                 *keys])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        logs = [json.loads(line) for line in
                open(os.path.join(tmp, "attn.jsonl"))]
        dense = 4 * 32768 ** 2 * 4 / 1e9
        print(f"[vae attn train] {TRAIN_STEPS} steps at batch 1, "
              f"{VAE_POINTS:,} points, {keys}, through train.main in "
              f"{wall:.1f} s, peak {peak:.2f} GiB (one sample's dense f32 "
              f"logits at level 2 would take {dense:.1f} GB)")
        for r, delta in zip(logs, per_step):
            vox = [int(r[f"voxels{l}"]) for l in range(3)]
            print(f"[vae attn train] step {r['step']}: loss "
                  f"{r['loss']:.4f}, {r['steps_per_sec']:.3f} steps/s, "
                  f"active voxels {vox}; launches "
                  f"{ {k: v for k, v in delta.items() if v} }")
            check(math.isfinite(r["loss"]) and r["grad_finite"] == 1.0,
                  f"step {r['step']}: {r}")
            check(delta == VAE_ATTN_STEP,
                  f"step {r['step']} launches {delta}, want {VAE_ATTN_STEP}")
        check(len(per_step) == len(logs) == TRAIN_STEPS, "steps counted")
        # the einsum route would hold the dense logits on top of all this
        check(peak * 2**30 / 1e9 < dense, f"peak {peak} GiB")
        moved = {k for k, p in state.params.items()
                 if not torch.equal(p.detach(), state.ema.params[k])}
        still = sorted(k for k, p in state.params.items()
                       if not state.opt.state.get(p))
        print(f"[vae attn train] {len(moved)} of {len(state.params)} "
              f"parameter tensors moved; never stepped (no gradient): "
              f"{still}")
        check(all(k.startswith(("normal_head.", "color_head.")) for k in
                  still) and "attn2_enc_qkv.weight" in moved,
              f"parameters that did not move: {still}")
        del state
    finally:
        undo()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def sparse_unet_checks(mods):
    """``SparseUNet(SparseUNetConfig())`` on a small two-level scene, card
    (K4, ``flash_attn_f32``) against the CPU, without and with a 7-token
    context: max |err| within 1e-3 of the largest output."""
    rng = np.random.default_rng(48)
    pts = torch.from_numpy(rng.uniform(-6, 6, (2, 3000, 3)).astype(
        np.float32))
    mask = torch.ones((2, 3000), dtype=torch.bool)
    mask[1, 1200:] = False
    x = torch.from_numpy(rng.standard_normal((2, 4096, 8), dtype=np.float32))
    t = torch.tensor([10, 600])
    ctx = torch.from_numpy(rng.standard_normal((2, 7, 64), dtype=np.float32))
    for context in (None, ctx):
        cpu = mods.SparseUNet(mods.SparseUNetConfig(), device="cpu",
                              context_dim=None if context is None else 64)
        cpu.init_params(torch.Generator().manual_seed(48))
        with torch.no_grad():       # the zero-init output layers filled
            for name, p in cpu.named_parameters():
                if name.startswith(("out.", "xo.")) or ".proj." in name:
                    p.normal_(0.0, 0.05)
        card = mods.SparseUNet(mods.SparseUNetConfig(), device="cuda",
                               context_dim=None if context is None else 64)
        card.load_state_dict(cpu.state_dict())
        outs = []
        for dev in ("cpu", "cuda"):
            g0 = mods.grid_from_points(pts.to(dev), mask.to(dev), 0.4, 0.2,
                                       capacity=4096)
            grids = [g0, mods.coarsened_grid(g0, 2, capacity=2048)]
            model = cpu if dev == "cpu" else card
            with torch.no_grad():
                outs.append(model(grids, x.to(dev), t.to(dev), None
                                  if context is None else context.to(dev)
                                  ).cpu())
        ref, got = outs
        err = (got - ref).abs().max().item()
        lim = 1e-3 * ref.abs().max().item()
        print(f"[sparse unet] SparseUNetConfig() on 4,096 / 2,048 slots "
              f"({int(mask.sum())} points), context "
              f"{None if context is None else tuple(context.shape)}: card "
              f"vs cpu max_abs_err {err:.3e} (limit {lim:.3e})")
        check(torch.isfinite(got).all().item() and err <= lim,
              "SparseUNet card vs cpu")


def sparse_unet_main_path(kernels, mods):
    """``SparseUNet`` on a 200,000-point scene's hash-tree levels 1-2
    (65,536 and 32,768 slots, 8 latent channels): a warm-up, then a timed
    forward with exact launches and no plain version. Returns the
    launches."""
    vcfg = mods.SparseVAEConfig()
    pts, _ = vae_points(49)
    grids = mods.build_hash_tree(vcfg, pts.cuda(),
                                 torch.ones(pts.shape[:2], dtype=torch.bool,
                                            device="cuda"))[1:]
    model = mods.SparseUNet(mods.SparseUNetConfig(), device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(49))
    x = torch.randn((1, grids[0].capacity, 8), device="cuda")
    t = torch.tensor([300], device="cuda")
    with torch.no_grad(), no_plain_versions():
        model(grids, x, t)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = model(grids, x, t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    got = {k: launches[k] for k in SPARSE_UNET_CALL}
    others = {k: n for k, n in launches.items()
              if n and k not in SPARSE_UNET_CALL}
    print(f"[sparse unet] on the levels 1-2 of a {VAE_POINTS:,}-point scene "
          f"({[int(g.mask.sum()) for g in grids]} active of "
          f"{[g.capacity for g in grids]}): {wall * 1e3:.1f} ms a forward; "
          f"launches {got}")
    check(out.shape == x.shape and torch.isfinite(out).all().item(),
          "SparseUNet output")
    check(got == SPARSE_UNET_CALL and not others,
          f"SparseUNet launches {got}, others {others}")
    return launches


def brick_check(mods):
    """One teacher-forced forward of phase 15's small-scene VAE with
    ``conv_backend="brick"`` against the same weights on the ``ConvPlan``:
    its semantic logits within 1e-3 of their largest value."""
    base = mods.SparseVAEConfig(
        neck_dims=(8, 8, 16), neck_ijk_min=(-4, -4, -8),
        capacities=(8192, 4096, 1024), dense_lookup_ijk_min=(-18, -18, -18),
        dense_lookup_dims=(36, 36, 36))
    outs = []
    rng = np.random.default_rng(50)
    pts = torch.from_numpy(rng.uniform(-3, 3, (1, 3000, 3)).astype(
        np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 23, (1, 3000)).astype(
        np.int32)).cuda()
    noise = torch.randn((1, 8, 8, 16, 8), device="cuda")
    mask = torch.ones((1, 3000), dtype=torch.bool, device="cuda")
    state = None
    for backend in ("auto", "brick"):
        model = mods.SparseStructureVAE(dataclasses.replace(
            base, conv_backend=backend), device="cuda")
        if state is None:
            model.init_params(torch.Generator(device="cuda").manual_seed(50))
            state = model.state_dict()
        model.load_state_dict(state)
        grids = mods.build_hash_tree(model.cfg, pts, mask)
        sem = mods.majority_label(grids[0], pts, labels, mask, 23)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(grids, sem, noise=noise)
            torch.cuda.synchronize()
            outs.append((out["semantic_logits"][grids[0].mask],
                         time.perf_counter() - t0))
    (ref, ref_s), (got, got_s) = outs
    err = (got - ref).abs().max().item()
    lim = 1e-3 * ref.abs().max().item()
    print(f"[brick] VAE forward with conv_backend='brick' ({got_s * 1e3:.1f}"
          f" ms) against the ConvPlan one ({ref_s * 1e3:.1f} ms): semantic "
          f"logits max_abs_err {err:.3e} (limit {lim:.3e})")
    check(err <= lim, "brick VAE forward")


def sparse_leftovers(kernels):
    """Phase 43. Returns the launches of its two paths."""
    from infinicube_tpu_torch.grid.build import (coarsened_grid,
                                                 grid_from_points)
    from infinicube_tpu_torch.grid.ops import majority_label
    from infinicube_tpu_torch.models.diffusion.unet_sparse import (
        SparseUNet, SparseUNetConfig)
    from infinicube_tpu_torch.models.vae.loss import VAELossConfig, vae_loss
    from infinicube_tpu_torch.models.vae.sunet import (SparseStructureVAE,
                                                       SparseVAEConfig,
                                                       build_hash_tree)
    mods = types.SimpleNamespace(
        SparseStructureVAE=SparseStructureVAE,
        SparseVAEConfig=SparseVAEConfig, build_hash_tree=build_hash_tree,
        majority_label=majority_label, VAELossConfig=VAELossConfig,
        vae_loss=vae_loss, SparseUNet=SparseUNet,
        SparseUNetConfig=SparseUNetConfig, grid_from_points=grid_from_points,
        coarsened_grid=coarsened_grid)
    t0 = time.perf_counter()
    sparse_attention_checks()
    vae_attn_grad_check(mods)
    sparse_unet_checks(mods)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    paths = {"vae_attn_train": vae_attn_train_main_path(kernels),
             "sparse_unet": sparse_unet_main_path(kernels, mods)}
    t2 = time.perf_counter()
    brick_check(mods)
    torch.cuda.empty_cache()
    print(f"[sparse] checks {t1 - t0:.1f} s, main paths {t2 - t1:.1f} s, "
          f"brick {time.perf_counter() - t2:.1f} s")
    return paths



# ---- phase 44: training on real clips ----------------------------------------
REAL_FRAMES, REAL_POINTS = 8, 200_000
REAL_VIEWS = ("front", "front_left", "front_right")
REAL_SAMPLES = 4                  # samples_per_shard of the one clip
REAL_STEPS = 3                    # timed, after a warm-up step
REAL_KNN_QUERIES, REAL_KNN_CPU, REAL_KNN_K = 65_536, 4_096, 8
# the release VAE's encode: two sparse convs in each of its 6 encoder
# SparseResBlocks, K4 12 (counted through the plain version on the CPU)
VAE_ENCODE_K4 = 12
# Waymo semantics of the synthetic clip (utils/semantic.WAYMO_CATEGORY_NAMES)
ROAD, SIDEWALK, BUILDING, VEGETATION, CAR = 18, 22, 14, 15, 1


def real_box_points(rng, n, lwh, pose):
    """n points on the surface of a box of extent lwh at pose."""
    p = rng.uniform(-0.5, 0.5, (n, 3))
    face = rng.integers(0, 3, n)
    p[np.arange(n), face] = np.sign(p[np.arange(n), face]) * 0.5
    p = p * lwh
    return p @ pose[:3, :3].T + pose[:3, 3]


def real_frames(FrameRecord, seed=44, n_frames=REAL_FRAMES, n_points=REAL_POINTS,
                hw=GSM_TRAIN_HW):
    """A Waymo-scale clip from a seeded numpy frame source: the ego drives
    along +x at 12 m/s (10 Hz); per frame about ``n_points`` LiDAR returns
    within 75 m, denser near the ego (road and sidewalk, building walls at
    y = +-15 m, tree crowns, the cars' surfaces) in scan order (shuffled);
    6 cars, 2 of them driving; the lane, road-edge and road-line
    polylines; the three front cameras at ``hw``."""
    rng = np.random.default_rng(seed)
    h, w = hw
    K = np.array([[520.0, 0, w / 2], [0, 520.0, h / 2], [0, 0, 1]],
                 np.float32)
    cars = {f"parked{i}": (x, y, 0.0) for i, (x, y) in enumerate(
        ((12.0, -5.5), (27.0, 5.5), (41.0, -5.5), (58.0, 5.5)))}
    cars.update(driving0=(5.0, -2.0, 0.8), driving1=(-10.0, 2.0, 1.4))
    lwh = np.array([4.5, 1.9, 1.6])
    polylines = {
        "lane": [np.stack([np.linspace(-60, 160, 45), np.full(45, y),
                           np.zeros(45)], -1) for y in (-2.0, 2.0)],
        "road_edge": [np.stack([np.linspace(-60, 160, 45), np.full(45, y),
                                np.zeros(45)], -1) for y in (-7.0, 7.0)],
        "road_line": [np.stack([np.linspace(-60, 160, 45), np.zeros(45),
                                np.zeros(45)], -1)],
    }
    n_walls, n_trees, n_car = n_points * 9 // 40, n_points // 10, 2500
    out = []
    for f in range(n_frames):
        ego = np.array([1.2 * f, 0.0, 0.0])
        r = 2.5 + 72.5 * rng.uniform(size=n_points) ** 2
        a = rng.uniform(-np.pi, np.pi, n_points)
        n_ground = n_points - n_walls - n_trees - 6 * n_car
        ground = np.stack([ego[0] + r[:n_ground] * np.cos(a[:n_ground]),
                           r[:n_ground] * np.sin(a[:n_ground]),
                           rng.normal(0, 0.02, n_ground)], -1)
        ground_sem = np.where(np.abs(ground[:, 1]) < 7.0, ROAD, SIDEWALK)
        side = rng.choice([-15.0, 15.0], n_walls)
        walls = np.stack([ego[0] + rng.uniform(-70, 70, n_walls),
                          side + rng.normal(0, 0.05, n_walls),
                          rng.uniform(0, 12, n_walls)], -1)
        crowns = np.stack([np.arange(-60, 160, 11.0),
                           np.tile([-11.0, 11.0], 10), np.full(20, 5.0)], -1)
        near = crowns[np.abs(crowns[:, 0] - ego[0]) < 70]
        d = rng.normal(size=(n_trees, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        trees = near[rng.integers(0, len(near), n_trees)] + \
            d * rng.uniform(1.5, 2.5, (n_trees, 1))
        objects, car_pts = {}, []
        for gid, (x, y, v) in cars.items():
            pose = np.eye(4)
            pose[:3, 3] = [x + v * f, y, 0.8]
            objects[gid] = {"pose": pose, "lwh": lwh, "type": "vehicle"}
            car_pts.append(real_box_points(rng, n_car, lwh, pose))
        pts = np.concatenate([ground, walls, trees, *car_pts])
        sem = np.concatenate([ground_sem, np.full(n_walls, BUILDING),
                              np.full(n_trees, VEGETATION),
                              np.full(6 * n_car, CAR)]).astype(np.int32)
        order = rng.permutation(len(pts))
        pts, sem = pts[order].astype(np.float32), sem[order]
        cams = {}
        for view, yaw in zip(REAL_VIEWS, (0.0, 0.8, -0.8)):
            c, s_ = np.cos(yaw), np.sin(yaw)
            T = np.eye(4)
            # OpenCV camera (x right, y down, z forward) turned by yaw
            T[:3, :3] = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1.0]]) @ \
                np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
            T[:3, 3] = ego + [1.5, 0.0, 1.6]
            img = np.empty((h, w, 3), np.uint8)
            img[: h // 3] = (150, 190, 230)                    # sky
            img[h // 3:] = rng.integers(40, 200, (h - h // 3, w, 3))
            cams[view] = {"pose": T.astype(np.float32), "intrinsic": K,
                          "image": img}
        road = ground[np.abs(ground[:, 1]) < 7.0]
        out.append(FrameRecord(
            index=f, cam_to_world_opencv=cams["front"]["pose"], intrinsic=K,
            image=cams["front"]["image"], points=pts, point_semantics=sem,
            objects=objects,
            map_points={"road_edge": np.concatenate(
                polylines["road_edge"]).astype(np.float32),
                "road_line": polylines["road_line"][0].astype(np.float32),
                "road_surface": road[:20_000].astype(np.float32)},
            map_polylines=polylines if f == 0 else None, cameras=cams))
    return out


def real_clip(root):
    """Phase 44's clip, converted and processed on the card; the seconds of
    each step. Returns the frames."""
    from pathlib import Path
    from infinicube_tpu_torch.data_process import \
        generate_additional_attributes as gaa
    from infinicube_tpu_torch.data_process import waymo2shards as w2s

    class Source(w2s.FrameSource):
        def __init__(self, frames):
            self._frames = frames

        def clips(self):
            return ["clip0"]

        def frames(self, clip_id):
            return iter(self._frames)

    t0 = time.perf_counter()
    frames = real_frames(w2s.FrameRecord)
    t1 = time.perf_counter()
    w2s.convert_clip(Source(frames), "clip0", Path(root))
    t2 = time.perf_counter()
    gaa.process_clip(Path(root), "clip0", write_buffers=False)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    gaa.generate_voxel_buffers(
        Path(root), "clip0", np.stack([f.cam_to_world_opencv
                                       for f in frames[:2]]),
        frames[0].intrinsic, GSM_TRAIN_HW,
        np.concatenate([f.points for f in frames]),
        np.concatenate([f.point_semantics for f in frames]))
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs)
    tars = sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)
    print(f"[real] clip of {len(frames)} frames, "
          f"{sum(len(f.points) for f in frames):,} LiDAR points, 3 views of "
          f"{GSM_TRAIN_HW[0]}x{GSM_TRAIN_HW[1]}: frames made in "
          f"{t1 - t0:.2f} s, convert_clip {t2 - t1:.2f} s, process_clip "
          f"(no voxel buffers) {t3 - t2:.2f} s, generate_voxel_buffers for 2 "
          f"frames {t4 - t3:.2f} s; {len(tars)} tars, {size / 1e6:.1f} MB")
    check(len(tars) == 18 + 3, f"tars {tars}")
    return frames


def real_dataset_check(root):
    """The clip's samples through ``WaymoClipDataset``: the exact count, and
    what one holds."""
    from infinicube_tpu_torch.data.specs import DatasetSpec as DS
    from infinicube_tpu_torch.data.waymo_dataset import (WaymoClipDataset,
                                                         WaymoDatasetConfig)
    t0 = time.perf_counter()
    samples = list(WaymoClipDataset(WaymoDatasetConfig(
        root=root, frame_end=REAL_FRAMES, samples_per_shard=REAL_SAMPLES,
        views=REAL_VIEWS)))
    dt = time.perf_counter() - t0
    check(len(samples) == REAL_SAMPLES,
          f"{len(samples)} samples, want {REAL_SAMPLES}")
    s = samples[0]
    n_pts = [len(x[DS.INPUT_PC]) for x in samples]
    boxes = [len(x.get(DS.BOXES_3D, {}).get("poses", ())) for x in samples]
    print(f"[real] WaymoClipDataset: {len(samples)} samples in {dt:.2f} s "
          f"({dt / len(samples) * 1e3:.0f} ms a sample), crop points "
          f"{n_pts}, boxes {boxes}, images "
          f"{tuple(s[DS.IMAGES_INPUT].shape)}")
    check(all(n > 65_536 for n in n_pts) and all(b >= 4 for b in boxes) and
          s[DS.IMAGES_INPUT].shape == (3,) + GSM_TRAIN_HW + (3,),
          f"samples: points {n_pts}, boxes {boxes}")


def real_knn_checks(frames):
    """``knn_bruteforce`` card against CPU on one frame's points, then
    ``sdf_from_points`` and ``gt_surface_loss`` with their gradients."""
    from infinicube_tpu_torch.models.vae import nksr_loss as nl
    from infinicube_tpu_torch.ops.knn import knn_bruteforce
    rng = np.random.default_rng(45)
    ref = torch.from_numpy(frames[0].points)
    q = torch.from_numpy(frames[1].points[:REAL_KNN_QUERIES] + rng.normal(
        0, 0.05, (REAL_KNN_QUERIES, 3)).astype(np.float32))
    refc, qc = ref.cuda(), q.cuda()
    knn_bruteforce(qc[:4096], refc, k=REAL_KNN_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d, i = knn_bruteforce(qc, refc, k=REAL_KNN_K)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    n = REAL_KNN_CPU
    t0 = time.perf_counter()
    dr, ir = knn_bruteforce(q[:n], ref, k=REAL_KNN_K)
    cpu_s = time.perf_counter() - t0
    d, i = d[:n].cpu(), i[:n].cpu()
    err = (d - dr).abs()
    rel = (err / dr.abs().clamp_min(1e-12)).max().item()
    # the rounding of the two terms that cancel, |q|^2 + |r|^2, in f32
    scale = (q[:n, None, :] ** 2).sum(-1) + (ref[ir.long()] ** 2).sum(-1)
    floor = 2 * torch.finfo(torch.float32).eps * scale
    tie = (dr[:, 1] - dr[:, 0]) <= 1e-6
    same_idx = (i[:, 0] == ir[:, 0]) | tie
    print(f"[real] knn_bruteforce k={REAL_KNN_K}: {REAL_KNN_QUERIES:,} "
          f"queries against {len(ref):,} points in {card_s * 1e3:.1f} ms on "
          f"the card; {n:,} of them on the CPU in {cpu_s:.2f} s: distances "
          f"bit-equal {(err == 0).float().mean().item():.6f}, max relative "
          f"{rel:.3e}, max |err| {err.max().item():.3e}; nearest equal "
          f"{(i[:, 0] == ir[:, 0]).float().mean().item():.6f} "
          f"({int(tie.sum())} rows at a top-two tie within 1e-6)")
    check(bool((err <= 1e-5 * dr.abs() + floor).all()),
          f"knn distances: max relative {rel:.3e}")
    check(bool(same_idx.all()), f"knn nearest index differs on "
          f"{int((~same_idx).sum())} rows without a tie")

    # the IMLS distance and the surface loss, card against CPU, with
    # gradients: a small field's parameters, the same draws on both
    nrm = rng.normal(size=(len(ref), 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    params = {"w1": rng.normal(0, 0.1, (3, 32)), "b1": rng.normal(0, 0.1, 32),
              "w2": rng.normal(0, 0.1, 32), "b2": np.array(0.01)}
    u = torch.from_numpy(rng.uniform(size=4096).astype(np.float32))
    cfg = nl.NKSRLossConfig(voxel_size=0.2, surface_subsample=4096)
    out = {}
    for dev in ("cuda", "cpu"):
        p = {k: torch.tensor(v, dtype=torch.float32, device=dev,
                             requires_grad=True) for k, v in params.items()}

        def field(x):
            return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

        x = q[:4096].to(dev).requires_grad_(True)
        r, nr = ref.to(dev), torch.from_numpy(nrm).to(dev)
        sdf = nl.sdf_from_points(x, r, nr, k=cfg.sdf_knn, stdv=cfg.sdf_stdv)
        gx, = torch.autograd.grad(sdf.sum(), x)
        v, nloss = nl.gt_surface_loss(cfg, field, r, nr, u_slot=u.to(dev))
        grads = torch.autograd.grad(v + nloss, list(p.values()))
        out[dev] = (sdf.detach().cpu(), gx.cpu(), (v + nloss).item(),
                    torch.cat([g.flatten() for g in grads]).cpu())
    (s1, g1, l1, pg1), (s2, g2, l2, pg2) = out["cuda"], out["cpu"]
    cs = [cos(s1, s2), cos(g1, g2), cos(pg1, pg2)]
    print(f"[real] sdf_from_points on 4,096 queries: cosine {cs[0]:.7f}, "
          f"its query gradient {cs[1]:.7f}; gt_surface_loss {l1:.6f} card, "
          f"{l2:.6f} CPU, its parameter gradient {cs[2]:.7f}")
    check(min(cs) >= 0.9999 and abs(l1 - l2) <= 1e-4 * abs(l2),
          f"sdf / surface loss card against CPU: {cs}, {l1} vs {l2}")


@contextlib.contextmanager
def fenced_trainer(kernels, kind):
    """While the block runs, every batch the ``kind`` builder's stream makes
    and every train step are fenced by ``torch.cuda.synchronize`` and
    recorded as (seconds, launches). Yields the two lists."""
    from infinicube_tpu_torch import train as train_cli
    from infinicube_tpu_torch.training import loop
    made, stepped = [], []
    build, make_step = train_cli.BUILDERS[kind], loop.make_train_step

    def fenced(fn, out):
        torch.cuda.synchronize()
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0,
                    {k: v - before[k] for k, v in kernels.launches.items()}))
        return res

    def fenced_build(cfg, device):
        params, loss_fn, stream = build(cfg, device)

        def batches():
            it = iter(stream)
            while True:
                yield fenced(lambda: next(it), made)
        return params, loss_fn, batches()

    def fenced_make_step(*args):
        step = make_step(*args)
        return lambda *a: fenced(lambda: step(*a), stepped)

    train_cli.BUILDERS[kind] = fenced_build
    loop.make_train_step = fenced_make_step
    try:
        yield made, stepped
    finally:
        train_cli.BUILDERS[kind] = build
        loop.make_train_step = make_step


def real_train_run(kernels, kind, config, name, tmp, extra, want):
    """``train.main`` on ``config`` with ``data.root`` on the clip for a
    warm-up step and REAL_STEPS more, no plain version allowed: exact
    launches a step (batch making and step), ms a step split, steps/s as
    logged, peak GiB. Returns the run's launches and its state."""
    from infinicube_tpu_torch import train as train_cli
    steps = REAL_STEPS + 1
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with fenced_trainer(kernels, kind) as (made, stepped), \
            no_plain_versions():
        state = train_cli.main(
            [os.path.join(ROOT, "configs", config), "--name", name,
             "--logdir", tmp, "--exec", f"max_steps={steps}", "log_every=1",
             f"ckpt_dir={tmp}/{name}", *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    logs = [json.loads(line) for line in
            open(os.path.join(tmp, f"{name}.jsonl"))]
    check(len(made) == len(stepped) == len(logs) == steps,
          f"{len(made)} batches, {len(stepped)} steps, {len(logs)} logged")
    for (mt, ml), (st, sl), r in zip(made, stepped, logs):
        per = {k: ml[k] + sl[k] for k in sl}
        print(f"[real {kind}] step {r['step']}: loss {r['loss']:.5f}, "
              f"batch {mt * 1e3:.1f} ms, step {st * 1e3:.1f} ms, "
              f"{r['steps_per_sec']:.3f} steps/s; launches "
              f"{ {k: v for k, v in per.items() if v} }")
        check(math.isfinite(r["loss"]) and r["grad_finite"] == 1.0,
              f"{kind} step {r['step']}: {r}")
        check(per == want, f"{kind} step {r['step']} launches {per}, want "
              f"{ {k: v for k, v in want.items() if v} }")
    check(state.step == steps and state.num_nan_skips == 0,
          f"{kind}: step {state.step}, {state.num_nan_skips} skipped")
    bm = [m[0] * 1e3 for m in made[1:]]
    sm = [s[0] * 1e3 for s in stepped[1:]]
    sps = [r["steps_per_sec"] for r in logs[1:]]
    print(f"[real {kind}] {sum(p.numel() for p in state.params.values()):,} "
          f"parameters, {steps} steps through train.main in {wall:.1f} s "
          f"(build, steps, final checkpoint); after the warm-up a step "
          f"{np.mean(bm) + np.mean(sm):.1f} ms: batch making (host and its "
          f"device work) {min(bm):.1f}-{max(bm):.1f} ms, the rest "
          f"{min(sm):.1f}-{max(sm):.1f} ms; {min(sps):.3f}-{max(sps):.3f} "
          f"steps/s logged; peak {peak:.2f} GiB")
    return launches, state


def real_trainers(kernels, root):
    """The three trainers on the clip. Returns the launches of the path."""
    from infinicube_tpu_torch.models.gsm.model import GSMConfig
    from infinicube_tpu_torch.training import data_glue
    tmp = tempfile.mkdtemp(prefix="chip_smoke_real_train_")
    data = [f"data.root={root}", f"data.frame_end={REAL_FRAMES}"]
    total = {k: 0 for k in kernels.launches}
    try:
        vae_l, state = real_train_run(kernels, "vae", "train_vae.yaml", "vae",
                                      tmp, data, VAE_STEP_LAUNCHES)
        del state
        torch.cuda.empty_cache()
        # the frozen VAE's first latents, before scale_by_std scales them
        first, batches = [], data_glue.diffusion_batches

        def recording(*a, **kw):
            for latents, cond in batches(*a, **kw):
                if not first:
                    first.append(latents.clone())
                yield latents, cond

        data_glue.diffusion_batches = recording
        try:
            diff_l, state = real_train_run(
                kernels, "diffusion", "train_diffusion.yaml", "diff", tmp,
                [*data, "batch_size=1", f"vae_checkpoint={tmp}/vae"],
                {**STEP_LAUNCHES, "sparse_conv_f32": VAE_ENCODE_K4})
        finally:
            data_glue.diffusion_batches = batches
        del state
        torch.cuda.empty_cache()
        sf = json.loads(open(os.path.join(tmp, "diff",
                                          "scale_factor.json")).read())
        # held against numpy's float64 population std of the same latents
        lat = first[0].float().cpu().numpy().astype(np.float64)
        want_sf = 1.0 / max(float(np.std(lat)), 1e-6)
        rel = abs(sf["scale_factor"] - want_sf) / want_sf
        print(f"[real diffusion] scale_factor.json {sf['scale_factor']:.6f}"
              f", 1 / the float64 std of the first batch's latents "
              f"{want_sf:.6f}: {rel:.2e} relative (gate 1e-4; latents "
              f"{tuple(first[0].shape)})")
        check(rel <= 1e-4, f"scale factor {sf} vs {want_sf}")
        gsm_l, state = real_train_run(
            kernels, "gsm", "train_gsm.yaml", "gsm", tmp,
            [*data, f"data.views={REAL_VIEWS}", "lpips_checkpoint=random"],
            gsm_step_launches(kernels, GSMConfig(), len(REAL_VIEWS)))
        del state
        for run in (vae_l, diff_l, gsm_l):
            for k, v in run.items():
                total[k] += v
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return total


def real_data(kernels):
    """Phase 44. Returns the launches of its path."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_real_")
    try:
        root = os.path.join(tmp, "waymo")
        t0 = time.perf_counter()
        frames = real_clip(root)
        real_dataset_check(root)
        t1 = time.perf_counter()
        real_knn_checks(frames)
        del frames
        t2 = time.perf_counter()
        launches = real_trainers(kernels, root)
        print(f"[real] clip and dataset {t1 - t0:.1f} s, knn and loss checks "
              f"{t2 - t1:.1f} s, trainers {time.perf_counter() - t2:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# the released-weights path
# ---------------------------------------------------------------------------

# the published Wan2.1-T2V-1.3B widths, with the buffer embedder
RELEASE_DIT = dict(dim=1536, ffn_dim=8960, num_layers=30, num_heads=12,
                   in_dim=16, out_dim=16, text_dim=4096, freq_dim=256,
                   buffer_dim=32)
# umt5-xxl at full width (vocab, d_model, d_ff, blocks, heads, head dim),
# 2 of its 24 blocks: a depth cut only
RELEASE_UMT5 = (256384, 4096, 10240, 2, 64, 64)
WEIGHTS_STEPS = 2
# the loaded DiT against the mirror on one latent frame at 480p: (cosine,
# max-abs over max|ref|) at f32 (both sides f32, attention by 3xTF32) and
# with bf16 parameters and compute (K2)
WEIGHTS_F32_GATE = (0.99999, 1e-3)
WEIGHTS_BF16_GATE = (0.99, 0.1)
ST_NAMES = {torch.float32: "F32", torch.bfloat16: "BF16",
            torch.float16: "F16"}
# the conversion in a process of its own, for its peak host memory: the
# max RSS (which counts the mapped source files' resident pages) and the
# anonymous part, sampled every 50 ms (RssAnon, or statm's resident less
# shared pages where the kernel's status gives no RssAnon or 0)
CONVERT = """
import os, resource, sys, threading, time
t0 = time.perf_counter()
peak = [0, "not measured"]
def anon_kib():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("RssAnon:") and int(line.split()[1]):
                return int(line.split()[1]), "RssAnon"
    with open("/proc/self/statm") as f:
        _, res, shared = (int(v) for v in f.read().split()[:3])
    return (res - shared) * os.sysconf("SC_PAGE_SIZE") // 1024, "statm"
def sample():
    while True:
        kib, how = anon_kib()
        peak[:] = [max(peak[0], kib), how]
        time.sleep(0.05)
threading.Thread(target=sample, daemon=True).start()
from infinicube_tpu_torch.convert import main
t1 = time.perf_counter()
main(sys.argv[1:])
rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(f"[convert] imports {t1 - t0:.2f} s, main {time.perf_counter() - t1:.2f}"
      f" s; peak host memory: max RSS {rss / 2**20:.2f} GiB (mapped file "
      f"pages included), anonymous {peak[0] / 2**20:.2f} GiB ({peak[1]})")
"""


def write_safetensors(path, sd):
    """``sd`` in the safetensors format (8 bytes of little-endian header
    length, a JSON header of dtype, shape and data offsets, the raw bytes):
    the card's machine has no safetensors package."""
    names = sorted(sd)
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for k in names:
        n = sd[k].numel() * sd[k].element_size()
        header[k] = {"dtype": ST_NAMES[sd[k].dtype],
                     "shape": list(sd[k].shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    body = json.dumps(header).encode()
    body += b" " * (-len(body) % 8)
    with open(path, "wb") as f:
        f.write(len(body).to_bytes(8, "little"))
        f.write(body)
        for k in names:
            f.write(memoryview(sd[k].contiguous().view(torch.uint8).numpy()))


def released_files(tmp):
    """Random weights, seeded, in the released layouts and file formats:
    the DiT as one f32 ``diffusion_pytorch_model.safetensors``, the VAE as
    ``Wan2.1_VAE.pth``, umt5 (Wan's keys, bf16) as
    ``models_t5_umt5-xxl-enc-bf16.pth``. Returns the paths, the state dicts
    on the CPU and the DiT mirror on the card."""
    from torch_mirrors.umt5_keys import random_umt5, umt5_shapes
    from torch_mirrors.wan_dit_torch import WanModelMirror
    from torch_mirrors.wan_vae_torch import WanVAEMirror
    paths = {"dit": os.path.join(tmp, "diffusion_pytorch_model.safetensors"),
             "vae": os.path.join(tmp, "Wan2.1_VAE.pth"),
             "t5": os.path.join(tmp, "models_t5_umt5-xxl-enc-bf16.pth")}
    torch.manual_seed(45)
    t0 = time.perf_counter()
    with torch.device("cuda"):
        mirror = WanModelMirror(**RELEASE_DIT).eval().requires_grad_(False)
        vae = WanVAEMirror().eval()
    t5 = random_umt5(umt5_shapes(*RELEASE_UMT5),
                     torch.Generator(device="cuda").manual_seed(45),
                     dtype=torch.bfloat16, device="cuda")
    sds = {"dit": {k: v.cpu() for k, v in mirror.state_dict().items()},
           "vae": {k: v.cpu() for k, v in vae.state_dict().items()},
           "t5": {k: v.cpu() for k, v in t5.items()}}
    del vae, t5
    t1 = time.perf_counter()
    write_safetensors(paths["dit"], sds["dit"])
    torch.save(sds["vae"], paths["vae"])
    torch.save(sds["t5"], paths["t5"])
    t2 = time.perf_counter()
    sizes = {k: os.path.getsize(p) / 2**30 for k, p in paths.items()}
    print(f"[weights] released files made in {t1 - t0:.2f} s, written in "
          f"{t2 - t1:.2f} s: DiT {sizes['dit']:.2f} GiB f32 safetensors "
          f"({sum(v.numel() for v in sds['dit'].values()):,} parameters), "
          f"VAE {sizes['vae']:.3f} GiB, umt5 ({RELEASE_UMT5[3]} of 24 "
          f"blocks) {sizes['t5']:.2f} GiB bf16")
    return paths, sds, mirror


def convert_released(paths, out):
    """``python -m infinicube_tpu_torch.convert`` in a process of its own
    (its peak host memory is the conversion's alone)."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", CONVERT, "--wan-dit", paths["dit"],
         "--wan-vae", paths["vae"], "--umt5", paths["t5"],
         "--variant", "1.3b", "--out", out],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    for line in run.stdout.splitlines():
        print(line)
    check(run.returncode == 0, f"convert exited {run.returncode}: "
          f"{run.stderr[-2000:]}")
    print(f"[weights] the convert CLI took {time.perf_counter() - t0:.2f} s "
          "with its start-up")


def hold_loaded(gen, want):
    """Every tensor of the loaded towers equals the in-memory conversion
    (in the dtype the tower holds) bit for bit."""
    n = 0
    for tower, sd in want.items():
        got = getattr(gen, tower).state_dict()
        check(got.keys() == sd.keys(), f"{tower}: keys differ")
        for k, v in sd.items():
            check(torch.equal(got[k], v.to(got[k].device, got[k].dtype)),
                  f"{tower}.{k} differs from the in-memory conversion")
            n += 1
    print(f"[weights] all {n} loaded tensors equal the in-memory conversion "
          "bit for bit")


def dit_against_mirror(kernels, mirror, dit_sd):
    """The loaded DiT's weights in the port's f32 DiT and then in its bf16
    one, each against the mirror (f32) on one latent frame at 480p. Returns
    the gaps and the launches of the two forwards."""
    from infinicube_tpu_torch.models.wan.dit import WanDiT, WanDiTConfig
    T, Hl, Wl = 1, 60, 104
    g = torch.Generator(device="cuda").manual_seed(46)
    lat = torch.randn((1, 16, T, Hl, Wl), generator=g, device="cuda")
    buf = torch.randn((1, 32, T, Hl, Wl), generator=g, device="cuda")
    txt = torch.randn((1, TEXT_LEN, 4096), generator=g, device="cuda")
    t = torch.tensor([700.0], device="cuda")
    with torch.no_grad(), torch.device("cuda"):
        ref = mirror(lat, t, txt, buf).permute(0, 2, 3, 4, 1)
    torch.cuda.synchronize()

    def cl(x):
        return x.permute(0, 2, 3, 4, 1).contiguous()

    n_tok = T * Hl * Wl // 4
    rows, counts = {}, dict.fromkeys(kernels.launches, 0)
    for label, cfg, gate, kernel in (
            ("f32", WanDiTConfig(dtype=torch.float32), WEIGHTS_F32_GATE,
             "flash_attn_f32"),
            ("bf16", WanDiTConfig(), WEIGHTS_BF16_GATE, "flash_attn_bf16")):
        dit = WanDiT(cfg, device="cuda").eval().requires_grad_(False)
        dit.load_state_dict(dit_sd)
        if label == "bf16":
            dit.to(torch.bfloat16)
        kernels.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            got = dit(cl(lat), t, txt, cl(buf))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in kernels.launches.items() if v}
        c = cos(got, ref)
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        print(f"[weights] loaded 1.3B DiT ({label}) against the mirror (f32)"
              f" at N = {n_tok} with a {TEXT_LEN}-token text: cosine {c:.7f}"
              f", max-abs {err:.3e} of max|ref| {scale:.3f} ({err / scale:.2e}"
              f"; gate cosine >= {gate[0]}, <= {gate[1]}), {ms:.1f} ms cold, "
              f"launches {launches}")
        check(torch.isfinite(got).all().item(), f"{label} DiT not finite")
        check(c >= gate[0] and err <= gate[1] * scale,
              f"{label} DiT against the mirror: cosine {c}, max-abs {err}")
        check(launches == {kernel: 2 * 30},
              f"{label} DiT launches {launches}, want {kernel} 60")
        rows[label] = dict(cosine=c, max_abs_err=err, ref_max=scale)
        counts = {k: v + kernels.launches[k] for k, v in counts.items()}
        del dit, got
    return rows, counts


def weights_phase(kernels):
    """Phase 45. Returns the launches of its paths: the loaded DiT's two
    forwards and the request."""
    from infinicube_tpu_torch.models.wan.dit import WanDiTConfig
    from infinicube_tpu_torch.models.wan.pipeline import (WanPipelineConfig,
                                                          WanVideoGenerator)
    from infinicube_tpu_torch.models.wan.t5 import T5Config
    from infinicube_tpu_torch.weights.wan_convert import \
        wan_pipeline_state_dict
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_weights_")
    try:
        t_phase = time.perf_counter()
        paths, sds, mirror = released_files(tmp)
        out = os.path.join(tmp, "ckpt")
        convert_released(paths, out)

        serve = WanPipelineConfig.serving(
            t5=T5Config(num_layers=RELEASE_UMT5[3]))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = WanVideoGenerator.from_checkpoint(out, cfg=serve)
        torch.cuda.synchronize()
        print(f"[weights] from_checkpoint {time.perf_counter() - t0:.2f} s, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
        t0 = time.perf_counter()
        want = wan_pipeline_state_dict(dict(sds["dit"]), sds["vae"],
                                       dict(sds["t5"]),
                                       WanDiTConfig.wan_1_3b())
        print(f"[weights] the in-memory conversion "
              f"{time.perf_counter() - t0:.2f} s")
        hold_loaded(gen, want)
        del want, sds
        rows, dit_launches = dit_against_mirror(kernels, mirror,
                                                gen.dit.state_dict())
        del mirror
        torch.cuda.empty_cache()

        # ---- one request from the loaded checkpoint -------------------------
        gen.cast_params_bf16()
        rng = np.random.default_rng(45)
        sem = rng.integers(0, 256, (93, 480, 832, 3), dtype=np.uint8)
        coo = rng.integers(0, 256, (93, 480, 832, 3), dtype=np.uint8)
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        frames = gen.generate(sem, coo, "a realistic driving scene at dusk",
                              negative_prompt="blurry", seed=45,
                              num_steps=WEIGHTS_STEPS)
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        phases = " ".join(f"{k}={v:.2f}s"
                          for k, v in gen.last_phase_seconds.items())
        print(f"[weights] one request of 93 frames @ 480x832, "
              f"{WEIGHTS_STEPS} steps, from the checkpoint: {wall:.2f} s "
              f"({phases}), peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"launches { {k: v for k, v in launches.items() if v} }")
        want_k = 30 * 2 * WEIGHTS_STEPS
        check(isinstance(frames, np.ndarray) and frames.dtype == np.uint8
              and frames.shape == (93, 480, 832, 3),
              f"request frames {getattr(frames, 'shape', None)}")
        check(frames.min() != frames.max(), "request frames constant")
        check(launches["flash_attn_int8qk"] == launches["flash_attn_bf16"]
              == want_k and launches["conv3x3x3_bf16"] == 0,
              f"request launches {launches}, want {want_k} of K1 and K2")
        del gen, frames
        torch.cuda.empty_cache()
        print(f"[weights] phase 45 done in "
              f"{time.perf_counter() - t_phase:.1f} s; mirror gaps {rows}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"weights_dit": dit_launches, "weights": launches}


# ---------------------------------------------------------------------------
# sequence and data parallelism, the viewers (phase 46)
# ---------------------------------------------------------------------------

RING_WORLDS = (2, 4)
RING_SMALL_N = 4_096
# phase 46's diffusion trainer: the release config as it is (the 750M
# UNet at its batch of 2), 3 steps
DP_TRAIN = ("log_every=1", "max_steps=3")


def ring_share_ms(ring, q, k, v, do, world, scale):
    """Device ms of one rank's share of the ring, forward and backward: the
    module's ``ring_forward`` and ``ring_backward`` for ``world`` virtual
    ranks (the exchange a rotation of their blocks, no device work), timed
    on the card and divided by ``world``."""
    qs, ks, vs, dos = (list(x.chunk(world, dim=1)) for x in (q, k, v, do))

    def fwd():
        return ring.ring_forward(qs, ks, vs, scale, world,
                                 ring.virtual_exchange)

    res = fwd()
    outs, lses = [o for o, _ in res], [lse for _, lse in res]

    def bwd():
        return ring.ring_backward(qs, ks, vs, outs, dos, lses, scale, world,
                                  ring.virtual_exchange)

    return cuda_ms(fwd, 1, 3) / world, cuda_ms(bwd, 1, 3) / world


def ring_hold(label, got, ref, gate=(0.9999, 2e-2)):
    """cosine and max-abs over max|ref| of the ring's output or gradient
    against one call over the whole sequence."""
    got, ref = got.float(), ref.float()
    c, err = cos(got, ref), (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"[ring] {label}: cosine {c:.7f}, max-abs {err:.3e} of max|ref| "
          f"{scale:.3f} ({err / scale:.2e}; gates >= {gate[0]}, <= "
          f"{gate[1]})")
    check(torch.isfinite(got).all().item() and c >= gate[0] and
          err <= gate[1] * scale, f"{label}: cosine {c}, max-abs {err}")
    return err


def ring_checks(kernels, att):
    """Phase 46 (a): the ring of P = 2 and 4 virtual ranks on the card at the
    1.3B DiT's release shape [1, 37,440, 12, 128] in bf16, and
    ``ring_attention`` itself with no group (forward and autograd
    backward), output and gradients against one K2 and one K5 call over
    the whole sequence; at N = 4,096 in bf16 and f32 against the plain
    versions; a rank's share and the single calls timed. Returns the rows
    and the ring's launches."""
    from infinicube_tpu_torch.ops import ring_attention as ring
    g = torch.Generator(device="cuda").manual_seed(46)
    scale = D ** -0.5
    cases = []
    for n, dtype in ((N_RELEASE, torch.bfloat16),
                     (RING_SMALL_N, torch.bfloat16),
                     (RING_SMALL_N, torch.float32)):
        cases.append((n, dtype, [rand((1, n, H, D), g, dtype)
                                 for _ in range(4)]))
    # the ring's runs: the path; the references after, uncounted
    kernels.reset_launches()
    outs = {}
    for n, dtype, (q, k, v, do) in cases:
        for world in RING_WORLDS if dtype == torch.bfloat16 else (2,):
            outs[n, dtype, world] = ring.ring_attention_virtual(
                q, k, v, world, do=do)
    # the entry point with no group at the release shape: one block, its
    # backward through autograd
    q, k, v, do = cases[0][2]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = ring.ring_attention(*leaves)
    out.backward(do)
    outs[N_RELEASE, torch.bfloat16, 1] = (out.detach(),
                                          tuple(t.grad for t in leaves))
    del leaves, out
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    blocks = {torch.bfloat16: 2 * sum(w * w for w in RING_WORLDS) + 1,
              torch.float32: 4}
    want = {"flash_attn_bf16": blocks[torch.bfloat16],
            "flash_attn_bf16_bwd": blocks[torch.bfloat16],
            "flash_attn_f32": blocks[torch.float32],
            "flash_attn_f32_bwd": blocks[torch.float32]}
    print(f"[ring] launches {({k: v for k, v in launches.items() if v})}")
    check({k: v for k, v in launches.items() if v} == want,
          f"ring launches {launches}, want {want}")
    rows = []
    for n, dtype, (q, k, v, do) in cases:
        if n == N_RELEASE:
            o, lse = kernels.flash_attn_bf16(q, k, v, scale, return_lse=True)
            ref = (o, *kernels.flash_attn_bf16_bwd(
                q, k, v, do, lse, att.attention_delta(o, do), scale))
            what = "one K2 / K5 call"
        else:
            qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
            o, lse = att.attention_plain(qf, kf, vf, scale, return_lse=True)
            ref = (o, *att.attention_bwd_plain(qf, kf, vf, o, dof, lse,
                                               scale))
            what = "the plain versions"
        gate = (0.99999, 1e-4) if dtype == torch.float32 else (0.9999, 2e-2)
        worlds = RING_WORLDS if dtype == torch.bfloat16 else (2,)
        for world in (1, *worlds) if n == N_RELEASE else worlds:
            out, grads = outs[n, dtype, world]
            tag = f"P={world} N={n} {str(dtype)[6:]} against {what}"
            if world == 1:
                same = all(torch.equal(a, b) for a, b in zip((out, *grads),
                                                             ref))
                tag = (f"ring_attention with no group (one block) N={n} "
                       f"against {what}, bit-equal {same}")
            errs = [ring_hold(f"{name} {tag}", a, b, gate) for name, a, b in
                    zip(("out", "dq", "dk", "dv"), (out, *grads), ref)]
            row = dict(world=world, shape=[1, n, H, D], dtype=str(dtype)[6:],
                       against=what, max_abs_err=max(errs))
            if world == 1:
                row.update(entry="ring_attention", bit_equal=same)
            elif n == N_RELEASE:
                fwd_ms, bwd_ms = ring_share_ms(ring, q, k, v, do, world,
                                               scale)
                k2 = cuda_ms(lambda: kernels.flash_attn_bf16(
                    q, k, v, scale, return_lse=True), 1, 3)
                delta = att.attention_delta(o, do)
                k5 = cuda_ms(lambda: kernels.flash_attn_bf16_bwd(
                    q, k, v, do, lse, delta, scale), 1, 3)
                # a rank's share of the work: 1/P of the single call's
                b_fwd = bound_ms([(4.0 * n * n * D * H / world, PEAK_BF16)],
                                 8 * n * H * D / world)[0]
                b_bwd = bound_ms([(10.0 * n * n * D * H / world,
                                   PEAK_BF16)], 16 * n * H * D / world)[0]
                print(f"[ring] P={world} at N={n}: a rank's forward "
                      f"{fwd_ms:.3f} ms (bound {b_fwd:.3f}), backward "
                      f"{bwd_ms:.3f} ms (bound {b_bwd:.3f}); one K2 call "
                      f"over the whole sequence {k2:.3f} ms, one K5 "
                      f"{k5:.3f} ms (device time, CUDA events)")
                row.update(rank_fwd_ms=fwd_ms, rank_bwd_ms=bwd_ms,
                           rank_fwd_bound_ms=b_fwd, rank_bwd_bound_ms=b_bwd,
                           single_k2_ms=k2, single_k5_ms=k5)
            rows.append(row)
        del ref, o, lse
    del cases, outs
    torch.cuda.empty_cache()
    return rows, launches


def sp_dit_check(kernels, dist):
    """Phase 46 (b): the 1.3B DiT at release width, random weights, bf16,
    ``sp_axis="seq"`` over the world-1 NCCL group, one 93-frame forward,
    against the same DiT without ``sp_axis`` (``attn_quant`` None, K2
    without its lse store). Returns its launches."""
    from infinicube_tpu_torch.models.wan.dit import WanDiT, WanDiTConfig
    g = torch.Generator(device="cuda").manual_seed(47)
    cfg = WanDiTConfig()
    local = WanDiT(cfg, device="cuda").eval().requires_grad_(False)
    local.init_params(g)
    fill_zero_init(local, g)
    sp = WanDiT(dataclasses.replace(cfg, sp_axis="seq"), device="cuda",
                sp_group=dist.group.WORLD).eval().requires_grad_(False)
    sp.load_state_dict(local.state_dict())
    T, Hl, Wl = 24, 60, 104
    lat = rand((1, T, Hl, Wl, 16), g, torch.float32)
    buf = rand((1, T, Hl, Wl, 32), g, torch.float32)
    txt = rand((1, TEXT_LEN, 4096), g, torch.float32)
    t = torch.tensor([700.0], device="cuda")
    with torch.no_grad():
        ref = local(lat, t, txt, buf)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = sp(lat, t, txt, buf)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.launches)
    same = torch.equal(got, ref)
    c, err = cos(got, ref), (got - ref).abs().max().item()
    print(f"[sp_dit] 1.3B DiT, sp_axis over a world-1 NCCL group, 93 frames "
          f"(N = {N_RELEASE}): {ms:.1f} ms, bit-equal to the local path: "
          f"{same} (cosine {c:.7f}, max-abs {err:.3e}); launches "
          f"{({k: v for k, v in launches.items() if v})}")
    check(torch.isfinite(got).all().item(), "SP DiT output not finite")
    # one rank: each layer's ring is one K2 launch with its lse store, the
    # local path's the same kernel without it; the output's bits are the
    # same unless the store changes the kernel's arithmetic
    check(same or (c >= 0.99999 and err <= 1e-3 * ref.abs().max().item()),
          f"SP DiT against the local path: cosine {c}, max-abs {err}")
    check({k: v for k, v in launches.items() if v} ==
          {"flash_attn_bf16": 60}, f"SP DiT launches {launches}")
    del local, sp, lat, buf, txt, ref, got
    torch.cuda.empty_cache()
    return launches


def dp_train_run(kernels, tmp, name):
    """``train.main`` on configs/train_diffusion.yaml with ``DP_TRAIN``:
    the logged losses and the launches."""
    from infinicube_tpu_torch import train as train_cli
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state = train_cli.main(
        [os.path.join(ROOT, "configs", "train_diffusion.yaml"), "--name",
         name, "--logdir", tmp, "--exec", *DP_TRAIN,
         f"ckpt_dir={tmp}/{name}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    logs = [json.loads(line) for line in open(os.path.join(tmp,
                                                           f"{name}.jsonl"))]
    n_params = sum(p.numel() for p in state.params.values())
    check(state.step == 3 and len(logs) == 3 and n_params == 750_431_048,
          f"{name}: {n_params} parameters, {logs}")
    print(f"[ddp] {name}: {n_params:,} parameters, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # the 12 GB checkpoint is not read again
    shutil.rmtree(os.path.join(tmp, name), ignore_errors=True)
    return [r["loss"] for r in logs], dict(kernels.launches), wall


def viewers_check(kernels, tmp):
    """Phase 46 (d): ``render_gaussian_scene`` at 640x480 on 200,000 random
    gaussians, card against CPU (every pixel within one uint8 step on
    99.9 % of them, as phase 28's share gate: a last-bit difference can swap
    two gaussians of one depth), then ``vis_grid`` on a small world on the
    card. Returns the launches (the viewers launch no kernel)."""
    from infinicube_tpu_torch.data.codec import decode_png
    from infinicube_tpu_torch.inference.guidance_buffer_generation import \
        save_voxel_world
    from infinicube_tpu_torch.utils.world_grid import WorldGrid
    from infinicube_tpu_torch.visualize import cli, render
    rng = np.random.default_rng(46)
    n = RASTER_GAUSSIANS
    gd = {"means": rng.uniform(-10, 10, (n, 3)),
          "quats": rng.normal(size=(n, 4)),
          "scales": rng.uniform(0.02, 0.2, (n, 3)),
          "opacities": rng.uniform(0.1, 0.9, n),
          "colors": rng.uniform(size=(n, 3))}
    pose = render.orbit_poses(np.zeros(3), 16.0, 6.0, 4)[1]
    kernels.reset_launches()
    imgs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        imgs[dev] = render.render_gaussian_scene(gd, pose, device=dev)
        print(f"[viewers] render_gaussian_scene, {n} gaussians at 640x480 "
              f"on {dev}: {1e3 * (time.perf_counter() - t0):.1f} ms")
    a, b = (imgs[d].astype(int) for d in ("cuda", "cpu"))
    near = (np.abs(a - b) <= 1).all(-1).mean()
    print(f"[viewers] card against CPU: {100 * near:.3f} % of the pixels "
          f"within one step (gate 99.9 %), {(a != b).any(-1).mean():.2e} "
          f"differ; {100 * (a < 250).any(-1).mean():.1f} % covered")
    check(near >= 0.999 and (a < 250).any(-1).mean() > 0.3,
          f"viewer render card against CPU: {near}")
    w = WorldGrid(0.5)
    xs, ys = np.meshgrid(np.arange(0, 20, 0.5), np.arange(-5, 5, 0.5))
    w.merge_points(np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], -1),
                   np.full(xs.size, 18))
    save_voxel_world(os.path.join(tmp, "world.npz"), w)
    t0 = time.perf_counter()
    cli.main(["grid", os.path.join(tmp, "world.npz"), "--output",
              os.path.join(tmp, "v"), "--views", "2"])
    views = sorted(os.listdir(os.path.join(tmp, "v")))
    with open(os.path.join(tmp, "v", views[0]), "rb") as f:
        img = decode_png(f.read())
    print(f"[viewers] vis_grid on the card: {views} in "
          f"{time.perf_counter() - t0:.2f} s")
    check(views == ["view_00.png", "view_01.png"] and img.min() != img.max(),
          f"vis_grid wrote {views}")
    return dict(kernels.launches)


def parallel_phase(kernels, att):
    """Phase 46. Returns the ring's rows and the launches of its paths."""
    import torch.distributed as dist

    from infinicube_tpu_torch.parallel.mesh import init_distributed
    t_phase = time.perf_counter()
    rows, ring_launches = ring_checks(kernels, att)
    print(f"[ring] (a) done in {time.perf_counter() - t_phase:.1f} s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    try:
        # (c)'s reference first, with no group
        check(not dist.is_initialized() and "RANK" not in os.environ,
              "a process group is up before phase 46")
        alone, alone_launches, alone_s = dp_train_run(kernels, tmp, "alone")
        os.environ.update(env)
        t0 = time.perf_counter()
        dev = init_distributed("cuda", init_method=f"file://{tmp}/store")
        print(f"[parallel] world-1 NCCL group through a file store on {dev}"
              f" in {time.perf_counter() - t0:.2f} s")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"group {dist.get_backend()} of {dist.get_world_size()}")
        t0 = time.perf_counter()
        sp_launches = sp_dit_check(kernels, dist)
        print(f"[sp_dit] (b) done in {time.perf_counter() - t0:.1f} s")
        grouped, dp_launches, dp_s = dp_train_run(kernels, tmp, "grouped")
        print(f"[ddp] 3 release diffusion-trainer steps (batch 2) through "
              f"train.main in a world-1 NCCL group {dp_s:.1f} s, "
              f"without a group {alone_s:.1f} s; losses "
              f"{grouped} / {alone}; launches "
              f"{({k: v for k, v in dp_launches.items() if v})}")
        check(grouped == alone, f"losses {grouped} against {alone}")
        want = {k: TRAIN_STEPS * v for k, v in STEP_LAUNCHES.items() if v}
        check(dp_launches == alone_launches and
              {k: v for k, v in dp_launches.items() if v} == want,
              f"launches {dp_launches} against {alone_launches}, want "
              f"{want}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    try:
        t0 = time.perf_counter()
        viewer_launches = viewers_check(kernels, tmp)
        print(f"[viewers] (d) done in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[parallel] phase 46 done in {time.perf_counter() - t_phase:.1f} s")
    return rows, {"ring": ring_launches, "sp_dit": sp_launches,
                  "ddp_train": dp_launches, "viewers": viewer_launches}


def wan_serve(kernels, att, fa):
    """Phases 2-5. Returns the summary entries of K1 and K2 and the launch
    counts of the video-serving main path."""
    from infinicube_tpu_torch.models.wan.dit import WanDiT
    from infinicube_tpu_torch.models.wan.pipeline import (WanPipelineConfig,
                                                          WanVideoGenerator)
    # ---- 2. kernels against their plain versions ----------------------------
    report = kernel_checks(kernels, att, fa)

    # ---- 3. model check -------------------------------------------------------
    serve = WanPipelineConfig.serving()
    model_check(WanDiT, dataclasses.replace(serve.dit, num_layers=2))

    # ---- 4. serving: the main path -----------------------------------------
    t0 = time.perf_counter()
    gen = WanVideoGenerator(serve, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    gen.init_params(g)
    fill_zero_init(gen.dit, g)
    gen.cast_params_bf16()
    torch.cuda.synchronize()
    print(f"[serve] towers built, random init and bf16 cast in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB resident")
    rng = np.random.default_rng(0)
    sem = rng.integers(0, 256, (17, 480, 832, 3), dtype=np.uint8)
    coo = rng.integers(0, 256, (17, 480, 832, 3), dtype=np.uint8)
    prompts = ["a realistic driving scene on a wet city street",
               "a sunny suburban road with parked cars",
               "a realistic driving scene on a wet city street"]
    per_request = 30 * 2 * 4
    kernels.reset_launches()
    before = dict(kernels.launches)
    for i, prompt in enumerate(prompts):
        t0 = time.perf_counter()
        frames = gen.generate(sem, coo, prompt, negative_prompt="blurry",
                              seed=i, num_steps=4)
        wall = time.perf_counter() - t0
        now = dict(kernels.launches)
        delta = {k: now[k] - before[k] for k in now}
        before = now
        phases = " ".join(f"{k}={v:.2f}s"
                          for k, v in gen.last_phase_seconds.items())
        print(f"[serve] request {i}: {wall:.2f} s ({phases}); launches "
              f"{delta}")
        check(isinstance(frames, np.ndarray) and frames.dtype == np.uint8
              and frames.shape == (17, 480, 832, 3),
              f"request {i} frames {getattr(frames, 'shape', None)}")
        check(frames.min() != frames.max(), f"request {i} frames constant")
        check(delta["flash_attn_int8qk"] == delta["flash_attn_bf16"] ==
              per_request and delta["conv3x3x3_bf16"] ==
              delta["sparse_conv_f32"] == 0,
              f"request {i} launches {delta}, want {per_request} of K1/K2")
    serve_launches = dict(kernels.launches)
    print(f"[serve] main path launches {serve_launches}")

    # ---- 5. one denoise step at the release shape ----------------------------
    text = gen.encode_text(prompts[0])
    null = gen.encode_text("blurry")
    T, Hl, Wl = WanPipelineConfig(num_frames=93).latent_thw
    g2 = torch.Generator(device="cuda").manual_seed(3)
    buf = torch.randn((1, T, Hl, Wl, 32), generator=g2, device="cuda")
    noise = torch.randn((1, T, Hl, Wl, 16), generator=g2, device="cuda")
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = gen._denoise(text, null, buf, 1, 5.0, noise=noise)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    print(f"[release] one CFG denoise step at 93f@480p (N={N_RELEASE}): "
          f"{step_s:.2f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.1f}"
          f" GiB, launches {dict(kernels.launches)}")
    check(torch.isfinite(z).all().item(), "release step output not finite")
    check(kernels.launches["flash_attn_int8qk"] ==
          kernels.launches["flash_attn_bf16"] == 60,
          f"release step launches {kernels.launches}")

    # ---- where the time goes: one profiled step at each shape ---------------
    for frames in (17, 93):
        profile_step(gen, text, null, frames, seed=4)
    return report, serve_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from infinicube_tpu_torch import kernels
    from infinicube_tpu_torch.ops import attention as att
    from infinicube_tpu_torch.ops import dense_conv
    from infinicube_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"[setup] {smi}")
    t0 = time.perf_counter()
    nvcc_s = kernels.build()
    print(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {nvcc_s:.1f} s)")

    # each part frees its models when it returns; phase 8's world is
    # stage 2's input
    world_dir = tempfile.mkdtemp(prefix="chip_smoke_world_")
    world_path = os.path.join(world_dir, "world.npz")
    report, serve_launches = wan_serve(kernels, att, fa)
    torch.cuda.empty_cache()
    stage1_report, stage1_launches, dec_grids = stage1(kernels, att,
                                                       dense_conv, world_path)
    torch.cuda.empty_cache()
    train_report, train_launches = diffusion_train(kernels, att, dense_conv)
    torch.cuda.empty_cache()
    vae_report, vae_launches = vae_train(kernels, dec_grids)
    del dec_grids
    torch.cuda.empty_cache()
    int8_report, int8_paths = int8_serving(kernels, dense_conv, fa)
    torch.cuda.empty_cache()
    f32_report, f32_launches, padding = widths_and_f32(kernels, att,
                                                       dense_conv)
    torch.cuda.empty_cache()
    try:
        stage2_launches = stage2(kernels, world_path)
        gsm_attn, gsm_k4, stage3_launches, stage3_views = stage3(
            kernels, att, world_path)
    finally:
        shutil.rmtree(world_dir, ignore_errors=True)
    f32_bwd, f32_bwd_padded, gsm_train_launches = gsm_train(kernels, att)
    bf16_entries, bf16_padded, k2_gsm, k5_gsm, bf16_launches = \
        gsm_bf16_train(kernels, att)
    torch.cuda.empty_cache()
    vae_k3, vae_f32, k2_dit, k5_dit, video_paths = video_leftovers(
        kernels, att, dense_conv)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    e2e_launches = e2e_chain(kernels)
    print(f"[e2e] phase 40 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    frozen_towers(kernels, stage3_views)
    del stage3_views
    print(f"[towers] phase 41 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    alt_paths = alt_conditioning(kernels)
    print(f"[alt] phase 42 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sparse_paths = sparse_leftovers(kernels)
    print(f"[sparse] phase 43 done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    real_launches = real_data(kernels)
    print(f"[real] phase 44 done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    weights_paths = weights_phase(kernels)
    torch.cuda.empty_cache()
    ring_rows, parallel_paths = parallel_phase(kernels, att)

    # ---- summary ----------------------------------------------------------------
    report["flash_attn_bf16"]["d96"] = stage1_report.pop("flash_attn_bf16")
    report.update(stage1_report)
    report.update(train_report)
    report.update(vae_report)
    report.update(int8_report)
    report.update(f32_report)
    report["flash_attn_f32_bwd"] = f32_bwd
    padding["flash_attn_f32_bwd"] = f32_bwd_padded
    report.update(bf16_entries)
    for name, key in (("sparse_conv_bf16", "fwd"),
                      ("sparse_conv_bf16_dgrad", "dx"),
                      ("sparse_conv_bf16_wgrad", "dw")):
        padding[name] = {"rows": [r for r in bf16_padded
                                  if r["output"] == key], "launches": 1}
    # K2's and K5's numbers at the pixel branch's bf16 training shape
    for name, row in (("flash_attn_bf16", k2_gsm),
                      ("flash_attn_bf16_bwd", k5_gsm)):
        report[name]["gsm_bf16_shape"] = row
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                          row["max_abs_err"])
    # the GSM's shapes (phase 28), the Wan VAE's (phase 36) and the DiT
    # train step's (phase 39) beside each kernel's own
    for name, key, rows in (("flash_attn_f32", "gsm_shapes", gsm_attn),
                            ("sparse_conv_f32", "gsm_shapes", gsm_k4),
                            ("conv3x3x3_bf16", "vae_shapes", vae_k3),
                            ("conv3x3x3_f32", "vae_shapes", vae_f32),
                            ("flash_attn_bf16", "dit_train_shapes", k2_dit),
                            ("flash_attn_bf16_bwd", "dit_train_shapes",
                             k5_dit)):
        report[name][key] = rows
        report[name]["max_abs_err"] = max(
            [report[name]["max_abs_err"]] + [r["max_abs_err"] for r in rows])
    # the ring's rows (phase 46) beside K2's and K5's own
    report["flash_attn_bf16"]["ring"] = ring_rows
    report["flash_attn_bf16_bwd"]["ring"] = ring_rows
    paths = {"wan_serve": serve_launches, "stage1": stage1_launches,
             "diffusion_train": train_launches, "vae_train": vae_launches,
             **int8_paths, "stage1_f32": f32_launches,
             "stage2": stage2_launches, "stage3": stage3_launches,
             "gsm_train": gsm_train_launches,
             "gsm_train_bf16": bf16_launches, **video_paths,
             "e2e": e2e_launches, **alt_paths, **sparse_paths,
             "real_data": real_launches, **weights_paths,
             **parallel_paths}
    for name, e in report.items():
        e["paths"] = {p: launches[name] for p, launches in paths.items()}
        e["launches"] = sum(e["paths"].values())
        check(e["launches"] > 0, f"{name} never launched on a main path")
        if name in padding:
            e["padded_widths"] = padding[name]
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{**{k: e[k] for k in keys}, **{
        k: v for k, v in e.items() if k not in keys}}
        for e in report.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
