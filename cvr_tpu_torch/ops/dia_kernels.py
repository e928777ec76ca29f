"""The DIA device passes: K8 ``dia_spmv``, K11 ``dia_spmm`` and their
plain versions.

As in cvr_tpu_torch/ops/route_kernels.py: each wrapper launches its CUDA
kernel of cvr_tpu_torch/csrc/dia_kernels.cu for CUDA tensors and counts
the launch in its ``launches`` attribute; given CPU tensors it runs the
plain version, and only then.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cvr_tpu_torch.ops.route_kernels import _check_dtype, _launch, _on_card, _p

SOURCE = "cvr_tpu_torch/csrc/dia_kernels.cu"

# K11's block (kTm, kKt in the source), and the shared memory one window of
# diagonals may take: at most 96 KB, so that two blocks share an SM
TM = 128
KT = 64
WINDOW_BYTES = 96 * 1024


def dia_spmv_plain(bands, offsets, x):
    """y (nrows,) = sum_k bands[k] * x[r + offsets[k]] (x read as 0
    outside [0, ncols)): the JAX package's shifted-slice form
    (``spmv_dia_xla``), diagonals added in pack order; the SpMM's plain
    version at one column."""
    return dia_spmm_plain(bands, offsets, x[:, None])[:, 0]


def dia_spmv(bands, offsets, x):
    """K8: the whole DIA SpMV, y (nrows,) from the band planes bands
    (nd, nrows) f32, the diagonal offsets (nd,) int64 and x (ncols,) f32;
    see dia_spmv_plain."""
    if not _on_card("dia_spmv", bands, offsets, x):
        return dia_spmv_plain(bands, offsets, x)
    for t, dt in ((bands, torch.float32), (offsets, torch.int64),
                  (x, torch.float32)):
        _check_dtype("dia_spmv", t, dt)
    nd, nrows = bands.shape
    if offsets.shape != (nd,):
        raise ValueError("dia_spmv: one offset per band")
    y = torch.empty(nrows, dtype=torch.float32, device=x.device)
    if nrows:
        _launch("cvr_dia_spmv", x.device, _p(bands), _p(offsets), _p(x),
                _p(y), nd, nrows, x.shape[0])
        dia_spmv.launches += 1
    return y


dia_spmv.launches = 0


def dia_spmm_plain(bands, offsets, X):
    """Y (nrows, K) = sum_k bands[k][:, None] * X[r + offsets[k], :] (X rows
    read as 0 outside [0, ncols)): the JAX package's ``spmm_dia_xla``,
    diagonals added in pack order."""
    nd, nrows = bands.shape
    offs = [int(o) for o in offsets.tolist()]
    lo, hi = min(offs + [0]), max(offs + [0])
    base = max(-lo, 0)
    Xp = F.pad(X, (0, 0, base, max(nrows + hi - X.shape[0], 0)))
    Y = torch.zeros((nrows, X.shape[1]), dtype=torch.float32, device=X.device)
    for k, off in enumerate(offs):
        Y = Y + bands[k][:, None] * Xp[base + off : base + off + nrows]
    return Y


def window_bytes(offs) -> int:
    """Shared memory of one K11 window over the diagonals at ``offs``: its
    X rows [r0 + min, r0 + TM + max) by the K tile and TM band values a
    diagonal, float32."""
    return ((TM + int(max(offs)) - int(min(offs))) * KT + len(offs) * TM) * 4


def dia_windows(offsets, budget: int = WINDOW_BYTES) -> np.ndarray:
    """K11's window plan: int32 (nwin + 1,) starts, window w holding the
    diagonals starts[w] .. starts[w + 1] - 1 in pack order.  A window takes
    the next diagonal while its window_bytes stays within ``budget``."""
    offs = [int(o) for o in np.asarray(offsets, dtype=np.int64).reshape(-1)]
    if window_bytes([0]) > budget:
        raise ValueError("dia_windows: one diagonal exceeds the budget")
    starts = []
    for d in range(len(offs)):
        if not starts or window_bytes(offs[starts[-1]:d + 1]) > budget:
            starts.append(d)
    return np.asarray(starts + [len(offs)], dtype=np.int32)


def window_plan(offsets: torch.Tensor, host=None):
    """(windows on offsets' device, window count, shared bytes of the
    largest window) for K11, made once per offsets tensor and kept on it
    (``host``: the offsets as a host array, where the caller has them, as
    the upload does).  Recomputed if the tensor was written since."""
    plan = getattr(offsets, "_dia_windows", None)
    if plan is None or plan[0] != offsets._version:
        offs = np.asarray(offsets.cpu() if host is None else host,
                          dtype=np.int64)
        starts = dia_windows(offs)
        smem = max((window_bytes(offs[a:b]) for a, b in
                    zip(starts[:-1], starts[1:])), default=0)
        plan = (offsets._version, torch.from_numpy(starts).to(offsets.device),
                len(starts) - 1, smem)
        offsets._dia_windows = plan
    return plan[1:]


def dia_spmm(bands, offsets, X):
    """K11: the whole DIA SpMM, Y (nrows, K) from the band planes bands
    (nd, nrows) f32, the diagonal offsets (nd,) int64 and X (ncols, K) f32
    row-major; see dia_spmm_plain.  The kernel walks the diagonals in the
    windows of window_plan(offsets)."""
    if not _on_card("dia_spmm", bands, offsets, X):
        return dia_spmm_plain(bands, offsets, X)
    for t, dt in ((bands, torch.float32), (offsets, torch.int64),
                  (X, torch.float32)):
        _check_dtype("dia_spmm", t, dt)
    nd, nrows = bands.shape
    if offsets.shape != (nd,) or X.dim() != 2:
        raise ValueError("dia_spmm: one offset per band, X (ncols, K)")
    K = X.shape[1]
    Y = torch.empty((nrows, K), dtype=torch.float32, device=X.device)
    if nrows and K:
        windows, nwin, smem = window_plan(offsets)
        _launch("cvr_dia_spmm", X.device, _p(bands), _p(offsets),
                _p(windows), nwin, smem, _p(X), _p(Y), nrows, X.shape[0], K)
        dia_spmm.launches += 1
    return Y


dia_spmm.launches = 0

# name -> (wrapper, plain version, TPU kernel it replaces)
KERNELS = {
    "dia_spmv": (dia_spmv, dia_spmv_plain, "cvr_tpu/ops/pallas_dia.py:39"),
    "dia_spmm": (dia_spmm, dia_spmm_plain, "cvr_tpu/ops/pallas_dia.py:137"),
}
