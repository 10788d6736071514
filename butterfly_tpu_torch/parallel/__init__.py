"""Multi-device layer: ranks on `torch.distributed` (`launch`), the mesh and
the placed butterfly (`sharding`), the explicit one-all-to-all schedule
(`shmap_butterfly`) and the GPipe pipeline (`pipeline`)."""

from butterfly_tpu_torch.parallel.sharding import (
    data_sharding,
    make_mesh,
    replicated,
    shard_butterfly,
    shard_table,
)

__all__ = [
    "data_sharding",
    "make_mesh",
    "replicated",
    "shard_butterfly",
    "shard_table",
]
