from infinicube_tpu_torch.models.vae.sunet import (  # noqa: F401
    SparseVAEConfig, SparseStructureVAE, build_hash_tree,
)
from infinicube_tpu_torch.models.vae.nksr_loss import (  # noqa: F401
    NKSRLossConfig, kitchen_sink_losses,
)
