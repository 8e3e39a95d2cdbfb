"""Data and tensor parallelism on ``torch.distributed`` (the counterpart of
``rtvc_tpu/parallel``, with its nine exports)."""

from .mesh import (
    make_mesh,
    shard_batch,
    replicate,
    param_shardings,
    place_params,
    data_parallel_shardings,
)
from .multihost import (
    initialize_distributed,
    host_batch_slice,
    shard_host_local_batch,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "param_shardings",
    "place_params",
    "data_parallel_shardings",
    "initialize_distributed",
    "host_batch_slice",
    "shard_host_local_batch",
]
