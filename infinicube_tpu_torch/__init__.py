"""PyTorch / CUDA port of infinicube_tpu, for one NVIDIA H100.

The package mirrors the module layout of ``infinicube_tpu`` (``ops/``,
``nn/``, ``models/``, ``weights/``) and imports neither JAX nor anything of
the JAX package. Kernel sources live in ``csrc/`` and are compiled at first
use into ``_build/`` (see ``kernels``). Entry points run on the card unless
the caller passes ``device="cpu"``; on CPU tensors every kernel is replaced
by its plain PyTorch version.

Ported so far: the Wan video stage (``models/wan``), stage 1 and its
trainers (``models/diffusion``, ``models/vae``, ``train.py``), stage 2, the
guidance buffers (``inference/guidance_buffer_generation.py``), stage 3
(``models/gsm``), the chained pipeline (``examples``) and the real-data
path (``data``, ``data_process``, ``training/data_glue.py``).
"""
