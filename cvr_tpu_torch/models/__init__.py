"""The payloads over the port's SpMVs and SpMMs: PageRank, the Krylov and
eigen solvers, and the GCN / GraphSAGE layers (the JAX package's
``cvr_tpu.models``, as Python loops over tensors)."""

from cvr_tpu_torch.models.pagerank import pagerank
from cvr_tpu_torch.models.gnn import (
    gcn_forward,
    gcn_layer,
    gcn_normalize,
    graphsage_layer,
)
from cvr_tpu_torch.models.solvers import (
    bicgstab,
    conjugate_gradient,
    jacobi,
    lanczos,
    power_iteration,
    subspace_iteration,
)

# the JAX package's names
__all__ = [
    "pagerank",
    "bicgstab",
    "conjugate_gradient",
    "gcn_forward",
    "gcn_layer",
    "gcn_normalize",
    "graphsage_layer",
    "jacobi",
    "lanczos",
    "power_iteration",
    "subspace_iteration",
]
