"""``spmv`` and ``spmm``, the dispatchers over the packed formats, and
the plain SELL path.

``spmv(A, x)`` takes any artifact ``pack_auto`` returns (DiaMatrix,
BellMatrix, SellWindow, SellRouted, SellMatrix), a CSRMatrix, or the
device form of one, and runs its SpMV.  ``spmm(A, X)`` takes those and
the SpMM artifacts (BsrMatrix, LanePlan, PmmPlan) and runs Y = A @ X.
The plain SELL planes (what ``pack_auto`` returns above the routed cap)
run as torch ops, a gather, ``index_add_`` per slice and a combine, as
the JAX package runs them in XLA with no kernel of its own:

    contrib  = vals_plane * x[cols_plane]          [S, C]     ([S, C, K])
    y_sorted = per-slice sums of contrib           [nslices, C]
    y        = y_sorted[row_rank], or a scatter-add over perm where long
               rows were split into segments
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.formats.bell import BellMatrix
from cvr_tpu_torch.formats.bsr import BsrMatrix
from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.formats.dia import DiaMatrix
from cvr_tpu_torch.formats.sell import SellMatrix
from cvr_tpu_torch.formats.sell_routed import SellRouted
from cvr_tpu_torch.formats.sell_window import SellWindow
from cvr_tpu_torch.ops.spmm_bsr import (
    BsrDevice,
    spmm_bsr,
    spmm_bsr_fused,
    to_device_bsr,
)
from cvr_tpu_torch.ops.spmm_lane import (
    LaneDevice,
    LanePlan,
    spmm_lane,
    to_device_lane,
)
from cvr_tpu_torch.ops.spmm_pmm import (
    PmmDevice,
    PmmPlan,
    spmm_pmm,
    to_device_pmm,
)
from cvr_tpu_torch.ops.spmv_bell import (
    BellDevice,
    spmm_bell,
    spmv_bell,
    to_device_bell,
)
from cvr_tpu_torch.ops.spmv_dia import (
    DiaDevice,
    spmm_dia,
    spmv_dia,
    to_device_dia,
)
from cvr_tpu_torch.ops.spmv_ref import spmv_csr_torch
from cvr_tpu_torch.ops.spmv_routed import (
    SellRoutedDevice,
    spmm_routed,
    spmv_routed,
    to_device_routed,
)
from cvr_tpu_torch.ops.spmv_window import (
    SellWindowDevice,
    spmm_window,
    spmv_window,
    to_device_window,
)
from cvr_tpu_torch.utils.profiling import span


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


def sell_spmm(sd: SellDevice, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X (ncols, K) on the SELL planes (torch ops; the
    JAX package's ``sell_spmm_xla``)."""
    contrib = sd.vals_plane[..., None] * X[sd.cols_plane]  # [S, C, K]
    S, C, K = contrib.shape
    y_sorted = torch.zeros((sd.nslices, C, K), dtype=contrib.dtype,
                           device=X.device)
    y_sorted.index_add_(0, sd.slot_slice, contrib)
    flat = y_sorted.reshape(-1, K)
    if not sd.has_splits:
        return flat[sd.row_rank]
    nrows = sd.row_rank.shape[0]
    y = torch.zeros((nrows + 1, K), dtype=flat.dtype, device=X.device)
    return y.index_add_(0, sd.perm, flat)[:nrows]


_UPLOAD = (
    (DiaMatrix, to_device_dia),
    (BellMatrix, to_device_bell),
    (SellWindow, to_device_window),
    (SellRouted, to_device_routed),
    (SellMatrix, to_device),
    (BsrMatrix, to_device_bsr),
    (LanePlan, to_device_lane),
    (PmmPlan, to_device_pmm),
)
_SPMV = (
    (DiaDevice, spmv_dia),
    (BellDevice, spmv_bell),
    (SellWindowDevice, spmv_window),
    (SellRoutedDevice, spmv_routed),
    (SellDevice, sell_spmv),
)


# in the JAX package's order of dispatch
_SPMM = (
    (PmmDevice, spmm_pmm),
    (LaneDevice, spmm_lane),
    (BellDevice, spmm_bell),
    (BsrDevice, spmm_bsr_fused),
    (DiaDevice, spmm_dia),
    (SellRoutedDevice, spmm_routed),
    (SellWindowDevice, spmm_window),
    (SellDevice, sell_spmm),
)


def _device_of(A) -> torch.device:
    return next(v.device for v in vars(A).values()
                if isinstance(v, torch.Tensor))


def upload(A, device="cuda"):
    """The device form of a packed host artifact on ``device``; anything
    else is returned as it is."""
    for host, up in _UPLOAD:
        if isinstance(A, host):
            with span("upload"):
                return up(A, device)
    return A


def _csr(A: CSRMatrix, x, device) -> torch.Tensor:
    dev = torch.device(device)
    return spmv_csr_torch(
        torch.from_numpy(A.rowptr).to(dev),
        torch.from_numpy(A.cols.astype(np.int64)).to(dev),
        torch.from_numpy(A.vals.astype(np.float32)).to(dev),
        torch.as_tensor(x, dtype=torch.float32).to(dev),
        A.shape[0],
    )


def spmv(A, x, device="cuda") -> torch.Tensor:
    """y = A @ x for a packed artifact, a CSRMatrix, or the device form of
    an artifact.  A host artifact is uploaded to ``device`` first (on each
    call: ``upload`` it once to reuse it); x (numpy or torch) goes to the
    artifact's device."""
    with span("spmv"):
        if isinstance(A, CSRMatrix):
            return _csr(A, x, device)
        A = upload(A, device)
        for kind, run in _SPMV:
            if isinstance(A, kind):
                x = torch.as_tensor(x, dtype=torch.float32).to(_device_of(A))
                return run(A, x)
    raise TypeError(f"unsupported matrix type {type(A)}")


def spmm(A, X, impl: str = "auto", device="cuda") -> torch.Tensor:
    """Y = A @ X for dense X (ncols, K), numpy or torch.  A is an artifact
    of ``spmv`` or an SpMM artifact (BsrMatrix, LanePlan, PmmPlan), or the
    device form of one; a host artifact is uploaded to ``device`` first
    (on each call: ``upload`` it once to reuse it), and X goes to the
    artifact's device.  BSR runs K12 unless ``impl="bsr-xla"`` asks for
    the torch-ops path (``spmm_bsr``); the routed, SELL-W and BELL
    artifacts run one SpMV per column."""
    with span("spmm"):
        if isinstance(A, CSRMatrix):
            return _csr(A, X, device)
        A = upload(A, device)
        for kind, run in _SPMM:
            if isinstance(A, kind):
                X = torch.as_tensor(X, dtype=torch.float32).to(_device_of(A))
                if kind is BsrDevice and impl == "bsr-xla":
                    return spmm_bsr(A, X)
                return run(A, X)
    raise TypeError(f"unsupported matrix type {type(A)}")
