"""MatrixMarket ingest (the JAX package's ``cvr_tpu.io`` names that are
ported; ``load_suitesparse`` is not yet)."""

from cvr_tpu_torch.io.mmio import read_matrix_market, write_matrix_market

__all__ = ["read_matrix_market", "write_matrix_market"]
