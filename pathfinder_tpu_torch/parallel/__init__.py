from pathfinder_tpu_torch.parallel.dim_sharding import dim_mesh, shard_dim
from pathfinder_tpu_torch.parallel.sharding import (
    make_path_executor,
    paths_dim_mesh,
    paths_mesh,
)

__all__ = [
    "make_path_executor",
    "paths_mesh",
    "paths_dim_mesh",
    "dim_mesh",
    "shard_dim",
]
