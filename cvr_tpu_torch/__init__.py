"""cvr_tpu_torch: the PyTorch/CUDA port of cvr_tpu for NVIDIA Hopper.

The SpMV and SpMM paths run here on an H100: the jax-free host layer
(MatrixMarket/synthetic ingest, CSR and the packed formats over the
shared native library) feeds CUDA kernels written for sm_90a
(cvr_tpu_torch/csrc/).  The JAX package ``cvr_tpu`` is the
reference each part is tested against; nothing here imports it or jax.
"""

__version__ = "0.1.0"

from cvr_tpu_torch.formats import pack_auto
from cvr_tpu_torch.formats.bell import BellInfeasible, BellMatrix, bell_pack
from cvr_tpu_torch.formats.bsr import BsrInfeasible, BsrMatrix, bsr_pack
from cvr_tpu_torch.formats.coo import COOMatrix
from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.formats.dia import DiaInfeasible, DiaMatrix, dia_pack
from cvr_tpu_torch.formats.sell import SellMatrix, sell_pack
from cvr_tpu_torch.formats.sell_routed import SellRouted, sell_pack_routed
from cvr_tpu_torch.formats.sell_window import (
    SellWindow,
    WindowInfeasible,
    sell_pack_window,
)
from cvr_tpu_torch.io.mmio import read_matrix_market, write_matrix_market
from cvr_tpu_torch.ops.spmm_lane import spmm_lane_pack
from cvr_tpu_torch.ops.spmv import spmm, spmv
from cvr_tpu_torch.ops.spmv_ref import spmv_csr_torch, spmv_golden_numpy

# the JAX package's names, with spmv_csr_torch for its spmv_csr_jnp
__all__ = [
    "BellInfeasible",
    "BellMatrix",
    "bell_pack",
    "BsrInfeasible",
    "BsrMatrix",
    "bsr_pack",
    "COOMatrix",
    "CSRMatrix",
    "DiaInfeasible",
    "DiaMatrix",
    "dia_pack",
    "SellMatrix",
    "sell_pack",
    "SellRouted",
    "sell_pack_routed",
    "SellWindow",
    "WindowInfeasible",
    "sell_pack_window",
    "pack_auto",
    "read_matrix_market",
    "write_matrix_market",
    "spmv",
    "spmm",
    "spmm_lane_pack",
    "spmv_csr_torch",
    "spmv_golden_numpy",
]
