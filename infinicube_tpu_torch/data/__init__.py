from infinicube_tpu_torch.data.specs import DatasetSpec, list_collate  # noqa: F401
from infinicube_tpu_torch.data.tario import TarReader, TarWriter  # noqa: F401
