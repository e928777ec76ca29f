"""MatrixMarket ingest and the SuiteSparse cache loader (the JAX
package's ``cvr_tpu.io`` names)."""

from cvr_tpu_torch.io.mmio import read_matrix_market, write_matrix_market
from cvr_tpu_torch.io.suitesparse import load_suitesparse

__all__ = ["read_matrix_market", "write_matrix_market", "load_suitesparse"]
