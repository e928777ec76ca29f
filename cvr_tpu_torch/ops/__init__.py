"""The device ops (the JAX package's ``cvr_tpu.ops`` names, with
``sell_spmv`` / ``sell_spmm`` for its ``sell_spmv_xla`` / ``sell_spmm_xla``
and ``spmv_csr_torch`` / ``spmv_coo_torch`` for its ``spmv_csr_jnp`` /
``spmv_coo_jnp``).  Importing it builds no kernel."""

from cvr_tpu_torch.ops.spmv import sell_spmm, sell_spmv, spmm, spmv
from cvr_tpu_torch.ops.spmv_ref import (
    spmv_coo_torch,
    spmv_csr_torch,
    spmv_golden_numpy,
    verify,
)

__all__ = [
    "spmv",
    "spmm",
    "sell_spmv",
    "sell_spmm",
    "spmv_csr_torch",
    "spmv_coo_torch",
    "spmv_golden_numpy",
    "verify",
]
