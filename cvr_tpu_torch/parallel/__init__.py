"""The row-sharded paths over a mesh of shard devices: one process, or
one process a shard after initialize_distributed."""

from cvr_tpu_torch.parallel.dist import (
    DistSellMatrix,
    Mesh,
    dist_sell_pack,
    dist_spmv,
    initialize_distributed,
    make_mesh,
    shutdown_distributed,
)
from cvr_tpu_torch.parallel.dist_routed import (
    DistRoutedMatrix,
    dist_routed_pack,
    dist_spmv_routed,
)
from cvr_tpu_torch.parallel.partition import partition_rows_by_nnz

__all__ = [
    "partition_rows_by_nnz",
    "DistSellMatrix",
    "Mesh",
    "dist_sell_pack",
    "dist_spmv",
    "make_mesh",
    "initialize_distributed",
    "shutdown_distributed",
    "DistRoutedMatrix",
    "dist_routed_pack",
    "dist_spmv_routed",
]
