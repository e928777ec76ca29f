"""y = A @ x and Y = A @ X on the DIA artifact: one K8 (SpMV) or K11
(SpMM) pass over the band planes.

The JAX package picks its Pallas kernels or an XLA shifted-slice form by
a VMEM size gate (SpMV) or a reach and diagonal-count gate (SpMM); on the
card K8 and K11 serve every size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.formats.dia import DiaMatrix
from cvr_tpu_torch.ops import dia_kernels as dk
from cvr_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class DiaDevice:
    bands: torch.Tensor  # (nd, nrows) f32
    offsets: torch.Tensor  # (nd,) int64
    shape: tuple[int, int]
    nnz: int


def to_device_dia(dm: DiaMatrix, device="cuda") -> DiaDevice:
    """Upload the DIA artifact's planes to ``device``, with K11's window
    plan of the offsets (kept on the offsets tensor; an ``upload.plan``
    span, detail ``dia``, while recording)."""
    offsets = torch.from_numpy(
        np.ascontiguousarray(dm.offsets, dtype=np.int64)).to(device)
    with span("upload.plan", "dia", sync=device):
        dk.window_plan(offsets, host=dm.offsets)
    return DiaDevice(
        bands=torch.from_numpy(np.ascontiguousarray(dm.bands)).to(device),
        offsets=offsets,
        shape=tuple(dm.shape),
        nnz=dm.nnz,
    )


def spmv_dia(sd: DiaDevice, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x; x (ncols,) on sd's device."""
    return dk.dia_spmv(sd.bands, sd.offsets, x.to(torch.float32).contiguous())


def spmm_dia(sd: DiaDevice, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X; X (ncols, K) on sd's device."""
    return dk.dia_spmm(sd.bands, sd.offsets, X.to(torch.float32).contiguous())
