"""y = A @ x on the BELL artifact: one K9 pass, plus the routed spill.

K9 leaves y in natural row order (no route, no reduce, no y-route); the
spill, a few percent of the nnz packed as a row-compressed SELL-R matrix,
runs the routed SpMV (cvr_tpu_torch/ops/spmv_routed.py) and adds its rows
back through ``spill_map``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.formats.bell import BellMatrix
from cvr_tpu_torch.ops import bell_kernels as bk
from cvr_tpu_torch.ops.spmv_routed import (
    SellRoutedDevice,
    spmv_routed,
    to_device_routed,
)


@dataclass(frozen=True)
class BellDevice:
    li: torch.Tensor  # (k, R_sub, 128) int16
    vals: torch.Tensor  # (k, R_sub, 128) f32
    spill: SellRoutedDevice | None
    spill_map: torch.Tensor | None  # (n_spill_rows,) int64 natural rows
    shape: tuple[int, int]
    d: int
    pre: int
    TBb: int


def to_device_bell(bm: BellMatrix, device="cuda") -> BellDevice:
    """Upload the BELL artifact (and its spill) to ``device``."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return BellDevice(
        li=put(bm.li),
        vals=put(bm.vals),
        spill=(to_device_routed(bm.spill, device)
               if bm.spill is not None else None),
        spill_map=(put(np.asarray(bm.spill_map, dtype=np.int64))
                   if bm.spill_map is not None else None),
        shape=tuple(bm.shape),
        d=bm.d,
        pre=bm.pre,
        TBb=bm.TBb,
    )


def gather_args(sd: BellDevice, x: torch.Tensor) -> tuple:
    """K9's arguments for x (f32, contiguous)."""
    # the JAX package's x table holds x[:n_keep]; plane columns never
    # reach past it, and a wide matrix's columns beyond it are the spill's
    n_keep = min(sd.shape[1], (sd.li.shape[1] + sd.TBb * 8 - sd.pre) * 128)
    return sd.li, sd.vals, x, sd.d, sd.pre, n_keep


def spmv_bell(sd: BellDevice, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x; x (ncols,) on sd's device."""
    x = x.to(torch.float32).contiguous()
    y = bk.bell_gather_mac(*gather_args(sd, x)).reshape(-1)[: sd.shape[0]]
    if sd.spill is not None:
        y.index_add_(0, sd.spill_map, spmv_routed(sd.spill, x))
    return y


def spmm_bell(sd: BellDevice, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X (ncols, K): one SpMV per column (the JAX
    package vmaps the SpMV over the K columns)."""
    return torch.stack([spmv_bell(sd, X[:, k]) for k in range(X.shape[1])],
                       1)
