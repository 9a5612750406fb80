from infinicube_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig, make_mesh, shard_batch, replicate, data_parallel_sharding,
)
