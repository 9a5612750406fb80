"""The config dataclasses of stage 1 have exactly the JAX package's fields,
in its order, with its defaults, read from the JAX sources by ``ast`` (so
nothing of the JAX package is imported here): ``DiffusionConfig``,
``SparseVAEConfig``, ``SparseUNetConfig`` and ``LssConfig``. A JAX dtype
default (``jnp.bfloat16``) stands for the torch dtype of the same name.
Then the trainer builds the alternative-conditioning config from the same
``diffusion.*`` keys the JAX CLI takes and trains it on the CPU at a cut
size: the condition encoders ride along untouched, as in JAX (the synthetic
stream's conditions are the null ones)."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from infinicube_tpu_torch.models.diffusion.alt_encoders import LssConfig
from infinicube_tpu_torch.models.diffusion.model import DiffusionConfig
from infinicube_tpu_torch.models.diffusion.unet_sparse import \
    SparseUNetConfig
from infinicube_tpu_torch.models.vae.sunet import SparseVAEConfig
from tests.test_torch_gsm import one_torch_thread  # noqa: F401
from tests.test_torch_training import TINY

JAX = Path(__file__).resolve().parent.parent / "infinicube_tpu"
CONFIGS = [
    (DiffusionConfig, "models/diffusion/model.py"),
    (SparseVAEConfig, "models/vae/sunet.py"),
    (SparseUNetConfig, "models/diffusion/unet_sparse.py"),
    (LssConfig, "models/diffusion/alt_encoders.py"),
]
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def jax_fields(path: str, name: str) -> list[tuple[str, object]]:
    """(field, default) of the dataclass ``name`` in a JAX source file."""
    tree = ast.parse((JAX / path).read_text())
    (cls,) = [n for n in tree.body
              if isinstance(n, ast.ClassDef) and n.name == name]
    out = []
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and node.value is not None:
            v = node.value
            if isinstance(v, ast.Attribute) and v.attr in _DTYPES:
                default = _DTYPES[v.attr]
            else:
                default = ast.literal_eval(v)
            out.append((node.target.id, default))
    return out


@pytest.mark.parametrize("cls,path", CONFIGS,
                         ids=[c.__name__ for c, _ in CONFIGS])
def test_fields_and_defaults_match_jax(cls, path):
    port = [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert port == jax_fields(path, cls.__name__)


def test_alt_conditioning_config_trains(tmp_path):
    """``train.main`` on configs/train_diffusion.yaml with every
    alternative condition on (the JAX CLI builds the same config from these
    keys): finite losses, the UNet moved, the optimizer never stepped the
    condition encoders (they get no gradient)."""
    from infinicube_tpu_torch.train import main
    alt = ["diffusion.use_semantic_cond=true",
           "diffusion.use_single_scan_cond=true",
           "diffusion.use_image_cond=lss", "diffusion.image_cond_dim=4",
           "diffusion.num_classes=3", "diffusion.context_dim=8"]
    state = main(["configs/train_diffusion.yaml", "--name", "alt",
                  "--logdir", str(tmp_path), "--exec", "batch_size=1",
                  "max_steps=2", f"ckpt_dir={tmp_path}/ck", *TINY, *alt],
                 device="cpu")
    assert state.step == 2 and state.num_nan_skips == 0
    names = set(state.params)
    assert {"unet.y_proj.weight", "cond_enc.lss.stem.weight",
            "cond_enc.semantic.Embed_0.weight",
            "unet.middle_transformer.blocks.0.cross_k.weight"} <= names
    moved = {k for k, p in state.params.items()
             if not torch.equal(p.detach(), state.ema.params[k])}
    stepped = {k for k, p in state.params.items() if state.opt.state.get(p)}
    assert "unet.out_conv.weight" in moved
    assert {k for k in names if k.startswith("unet.")} <= stepped
    assert not any(k.startswith("cond_enc.") for k in stepped)
