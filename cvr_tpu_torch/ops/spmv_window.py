"""y = A @ x on the SELL-W artifact: one K10 pass, then a D-fold.

    ys = window_reduce(li, vals, x, ...)     K10: all slices, one launch
    y  = fold the D lanes of each row, natural order is a reshape

The JAX package makes one kernel call per reduce group of YB slices;
here the host derives every slice's plane-row range once (the routed
reduce's ``reduce_table``), so one launch covers all groups.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.formats.sell_window import SellWindow
from cvr_tpu_torch.ops import window_kernels as wk
from cvr_tpu_torch.ops.spmv_routed import reduce_table


@dataclass(frozen=True)
class SellWindowDevice:
    li: torch.Tensor  # (8, S_pad, 128) int16
    vals_ss: torch.Tensor  # (8, S_pad, 128) f32
    w10: torch.Tensor  # (S_pad,) int32
    seg_blk: torch.Tensor  # (S_pad // CH,) int32
    # the reduce's slice table: slice k sums plane rows [row0, row1)
    # into ys slice out
    row0: torch.Tensor  # (n_items,) int32
    row1: torch.Tensor
    out: torch.Tensor
    shape: tuple[int, int]
    D: int
    G: int
    nslices: int
    segw: int
    wrl: int


def to_device_window(sw: SellWindow, device="cuda") -> SellWindowDevice:
    """Upload the SELL-W artifact's planes and its slice table to
    ``device``."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    row0, row1, out, _ = reduce_table(sw.emit, sw.ycall_rows,
                                      np.zeros((0, 5), dtype=np.int64),
                                      sw.nslices)
    return SellWindowDevice(
        li=put(sw.li), vals_ss=put(sw.vals_ss), w10=put(sw.w10),
        seg_blk=put(sw.seg_blk), row0=put(row0), row1=put(row1),
        out=put(out), shape=tuple(sw.shape), D=sw.D, G=sw.G,
        nslices=sw.nslices, segw=sw.segw, wrl=sw.wrl,
    )


def reduce_args(sd: SellWindowDevice, x: torch.Tensor) -> tuple:
    """K10's arguments for x (f32, contiguous)."""
    return (sd.li, sd.vals_ss, sd.w10, sd.seg_blk, x, sd.row0, sd.row1,
            sd.out, sd.nslices, sd.segw, sd.G, sd.wrl)


def spmv_window(sd: SellWindowDevice, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x; x (ncols,) on sd's device."""
    ys = wk.window_reduce(*reduce_args(sd, x.to(torch.float32).contiguous()))
    # ys[h, i, l] = lane h*128 + l of slice i; lane p belongs to row
    # i*(1024/D) + p//D
    flat = ys.permute(1, 0, 2).reshape(sd.nslices, 1024)
    if sd.D > 1:
        flat = flat.reshape(sd.nslices, 1024 // sd.D, sd.D).sum(dim=2)
    return flat.reshape(-1)[: sd.shape[0]]


def spmm_window(sd: SellWindowDevice, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X (ncols, K): one SpMV per column (the JAX
    package vmaps the SpMV over the K columns)."""
    return torch.stack([spmv_window(sd, X[:, k]) for k in range(X.shape[1])],
                       1)
