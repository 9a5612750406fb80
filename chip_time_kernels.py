"""Time K1 (int8-QK flash attention), K2 (bf16 flash attention) and K3
(dense 3x3x3 conv) of one checkout of the PyTorch port at shapes of
``chip_smoke.py``'s paths, with its CUDA-event timer, on one NVIDIA GPU.

    python3 chip_time_kernels.py <checkout>

Prints one line of milliseconds. To compare two checkouts, run it on each in
turns inside one job on one card (a, b, b, a): each run builds the kernels of
the checkout it is given and imports ``infinicube_tpu_torch`` from there."""

import math
import sys

import torch

from chip_smoke import (D, D96, H, H96, K3_SHAPES, N_RELEASE, N_SERVE,
                        TEXT_LEN, cuda_ms, rand)


def main(checkout: str) -> None:
    sys.path.insert(0, checkout)
    from infinicube_tpu_torch import kernels
    from infinicube_tpu_torch.ops import dense_conv
    from infinicube_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for n in (N_RELEASE, N_SERVE):
        block, npad = fa.quant_blocks(n)
        q8, sq = fa.block_quantize(fa.fold_heads(rand((1, n, H, D), g),
                                                 npad), block)
        k8, sk = fa.block_quantize(fa.fold_heads(rand((1, n, H, D), g),
                                                 npad), block)
        v = rand((1, n, H, D), g)
        ms = cuda_ms(lambda: kernels.flash_attn_int8qk(q8, k8, sq, sk, v,
                                                       block, D ** -0.5),
                     2, 5)
        out.append(f"k1 {n}: {ms:.3f}")
    for nq, nk, h, d in ((N_RELEASE, TEXT_LEN, H, D),
                         (N_SERVE, TEXT_LEN, H, D),
                         (4096, 4096, H96, D96), (512, 512, H96, D96)):
        q, k, v = (rand((1, n, h, d), g) for n in (nq, nk, nk))
        ms = cuda_ms(lambda: kernels.flash_attn_bf16(q, k, v, d ** -0.5),
                     3, 20)
        out.append(f"k2 {nq}x{nk} d{d}: {ms:.4f}")
    for n, C, O in K3_SHAPES[1::2]:
        x = rand((1, n, n, n, C), g)
        wp = dense_conv.pack_conv_weight(rand((O, C, 3, 3, 3), g) /
                                         math.sqrt(27 * C))
        b = torch.zeros(O, device="cuda")
        ms = cuda_ms(lambda: kernels.conv3x3x3_bf16(x, wp, b), 2, 10)
        out.append(f"k3 {n}^3 {C}->{O}: {ms:.4f}")
    print(checkout, "|", " | ".join(out))


if __name__ == "__main__":
    main(sys.argv[1])
