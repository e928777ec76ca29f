"""``spmv``, the dispatcher over the packed formats, and the plain SELL
path.

``spmv(A, x)`` takes any artifact ``pack_auto`` returns (DiaMatrix,
BellMatrix, SellWindow, SellRouted, SellMatrix), a CSRMatrix, or the
device form of one, and runs its SpMV.  The plain SELL planes (what
``pack_auto`` returns above the routed cap) run as torch ops, a gather,
``index_add_`` per slice and a combine, as the JAX package runs them in
XLA with no kernel of its own:

    contrib  = vals_plane * x[cols_plane]          [S, C]
    y_sorted = per-slice sums of contrib           [nslices, C]
    y        = y_sorted[row_rank], or a scatter-add over perm where long
               rows were split into segments
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.formats.bell import BellMatrix
from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.formats.dia import DiaMatrix
from cvr_tpu_torch.formats.sell import SellMatrix
from cvr_tpu_torch.formats.sell_routed import SellRouted
from cvr_tpu_torch.formats.sell_window import SellWindow
from cvr_tpu_torch.ops.spmv_bell import BellDevice, spmv_bell, to_device_bell
from cvr_tpu_torch.ops.spmv_dia import DiaDevice, spmv_dia, to_device_dia
from cvr_tpu_torch.ops.spmv_ref import spmv_csr_torch
from cvr_tpu_torch.ops.spmv_routed import (
    SellRoutedDevice,
    spmv_routed,
    to_device_routed,
)
from cvr_tpu_torch.ops.spmv_window import (
    SellWindowDevice,
    spmv_window,
    to_device_window,
)


@dataclass(frozen=True)
class SellDevice:
    """The SELL planes on a device."""

    vals_plane: torch.Tensor  # [S, C] f32
    cols_plane: torch.Tensor  # [S, C] int64
    slot_slice: torch.Tensor  # [S] int64
    perm: torch.Tensor  # [nslices * C] int64 (segment -> row, nrows = pad)
    row_rank: torch.Tensor  # [nrows] int64
    nslices: int
    has_splits: bool


def to_device(sm: SellMatrix, device="cuda") -> SellDevice:
    """Upload the SELL planes to ``device``."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    return SellDevice(
        vals_plane=put(sm.vals_plane, np.float32),
        cols_plane=put(sm.cols_plane, np.int64),
        slot_slice=put(sm.slot_slice, np.int64),
        perm=put(sm.perm, np.int64),
        row_rank=put(sm.row_rank, np.int64),
        nslices=sm.nslices,
        has_splits=sm.n_splits > 0,
    )


def sell_spmv(sd: SellDevice, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x on the SELL planes (torch ops; see the module doc)."""
    contrib = sd.vals_plane * x[sd.cols_plane]
    C = contrib.shape[1]
    y_sorted = torch.zeros((sd.nslices, C), dtype=contrib.dtype,
                           device=x.device)
    y_sorted.index_add_(0, sd.slot_slice, contrib)
    flat = y_sorted.reshape(-1)
    if not sd.has_splits:
        return flat[sd.row_rank]
    nrows = sd.row_rank.shape[0]
    y = torch.zeros(nrows + 1, dtype=flat.dtype, device=x.device)
    return y.index_add_(0, sd.perm, flat)[:nrows]


_UPLOAD = (
    (DiaMatrix, to_device_dia),
    (BellMatrix, to_device_bell),
    (SellWindow, to_device_window),
    (SellRouted, to_device_routed),
    (SellMatrix, to_device),
)
_SPMV = (
    (DiaDevice, spmv_dia),
    (BellDevice, spmv_bell),
    (SellWindowDevice, spmv_window),
    (SellRoutedDevice, spmv_routed),
    (SellDevice, sell_spmv),
)


def upload(A, device="cuda"):
    """The device form of a packed host artifact on ``device``; anything
    else is returned as it is."""
    for host, up in _UPLOAD:
        if isinstance(A, host):
            return up(A, device)
    return A


def spmv(A, x, device="cuda") -> torch.Tensor:
    """y = A @ x for a packed artifact, a CSRMatrix, or the device form of
    an artifact.  A host artifact is uploaded to ``device`` first (on each
    call: ``upload`` it once to reuse it); x (numpy or torch) goes to the
    artifact's device."""
    if isinstance(A, CSRMatrix):
        dev = torch.device(device)
        return spmv_csr_torch(
            torch.from_numpy(A.rowptr).to(dev),
            torch.from_numpy(A.cols.astype(np.int64)).to(dev),
            torch.from_numpy(A.vals.astype(np.float32)).to(dev),
            torch.as_tensor(x, dtype=torch.float32).to(dev),
            A.shape[0],
        )
    A = upload(A, device)
    for kind, run in _SPMV:
        if isinstance(A, kind):
            dev = next(v.device for v in vars(A).values()
                       if isinstance(v, torch.Tensor))
            return run(A, torch.as_tensor(x, dtype=torch.float32).to(dev))
    raise TypeError(f"unsupported matrix type {type(A)}")
