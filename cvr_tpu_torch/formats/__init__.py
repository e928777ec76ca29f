"""Host-side sparse formats and ``pack_auto``, the format dispatch."""

from __future__ import annotations

import warnings

from cvr_tpu_torch.formats.bell import BellInfeasible, BellMatrix, bell_pack
from cvr_tpu_torch.formats.bsr import BsrInfeasible, BsrMatrix, bsr_pack
from cvr_tpu_torch.formats.coo import COOMatrix
from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.formats.dia import DiaInfeasible, DiaMatrix, dia_pack
from cvr_tpu_torch.formats.sell import SellMatrix, sell_pack, sell_unpack
from cvr_tpu_torch.formats.sell_window import (
    SellWindow,
    WindowInfeasible,
    sell_pack_window,
)

# the JAX package's names
__all__ = [
    "BellInfeasible",
    "BellMatrix",
    "bell_pack",
    "BsrInfeasible",
    "BsrMatrix",
    "bsr_pack",
    "DiaInfeasible",
    "DiaMatrix",
    "dia_pack",
    "COOMatrix",
    "CSRMatrix",
    "SellMatrix",
    "SellWindow",
    "WindowInfeasible",
    "sell_pack",
    "sell_pack_window",
    "sell_unpack",
    "pack_auto",
]

# The JAX package's routed path refuses a stream above this many route
# tiles (~100M stored nnz): its chunk-select kernel's block spans all
# T/1024 chunks in TPU VMEM.  The port's K2 has no such limit; pack_auto
# keeps the cap so that both packages pick the same format for a matrix.
ROUTED_T_CAP = 98304


def pack_auto(csr: CSRMatrix, max_window_fill: float = 2.0):
    """Pack ``csr`` in the format the JAX package's ``pack_auto`` picks,
    trying in order:

      * DIA, for matrices on few dense diagonals (banded, stencils);
      * BELL, for banded-sparse matrices (road networks, rgg graphs);
      * SELL-W, for matrices with column locality (FEM, engineering),
        unless its padding exceeds ``max_window_fill`` times the nnz
        (short rows of uneven length), where the routed path's
        length-sorted planes pay for their route compile; inf keeps the
        cheaper pack;
      * SELL-R, the routed path, for any structure;
      * plain SELL planes (C = 1024), with a warning, where the routed
        stream would exceed ROUTED_T_CAP tiles.
    """
    from cvr_tpu_torch.formats.sell_routed import sell_pack_routed

    try:
        return dia_pack(csr)
    except DiaInfeasible:
        pass
    try:
        return bell_pack(csr)
    except BellInfeasible:
        pass
    try:
        sw = sell_pack_window(csr)
    except WindowInfeasible:
        try:
            return sell_pack_routed(csr, max_T=ROUTED_T_CAP)
        except ValueError as e:
            warnings.warn(
                f"pack_auto: routed path infeasible ({e}); falling back to "
                "the plain SELL planes", stacklevel=2,
            )
            return sell_pack(csr, C=1024)
    if csr.nnz and sw.padded_nnz / csr.nnz > max_window_fill:
        try:
            return sell_pack_routed(csr, max_T=ROUTED_T_CAP)
        except ValueError:  # above the routed cap
            return sw
    return sw
