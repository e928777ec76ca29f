"""The SELL-W SpMV's device pass: K10 ``window_reduce`` and its plain
version.

As in cvr_tpu_torch/ops/route_kernels.py: the wrapper launches the CUDA
kernel of cvr_tpu_torch/csrc/window_kernels.cu for CUDA tensors and
counts the launch in ``window_reduce.launches``; given CPU tensors it
runs the plain version, and only then.
"""

from __future__ import annotations

import torch

from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import route_planes as rp
from cvr_tpu_torch.ops.route_kernels import _check_dtype, _launch, _on_card, _p

SOURCE = "cvr_tpu_torch/csrc/window_kernels.cu"


def window_products_plain(li, vals, w10, seg_blk, x, rows, segw: int, G: int,
                          wrl: int):
    """P (8, len(rows), 128): the products of plane rows ``rows`` (int64).

    For row R and idx = li[i, R, l]: hi = idx >> 7, (g, rr) =
    divmod(w10[R]*8 + hi, 8*(segw + 2)), x row = seg_blk[R // CH]*segw*8 +
    g*(8 // G) + rr, and P = vals[i, R, l] * x[128*(x row) + (idx & 127)],
    0 where hi >= wrl or the column is past x: the x table of the JAX
    package's window kernel (``_x_table``), indexed in place."""
    n = x.shape[0]
    idx = li[:, rows, :].long()
    hi = idx >> 7
    w = w10[rows].long().view(1, -1, 1)
    seg = seg_blk[rows // rp.CH].long().view(1, -1, 1)
    t = w * 8 + hi
    g, rr = t // (8 * (segw + 2)), t % (8 * (segw + 2))
    col = (seg * segw * 8 + g * (8 // G) + rr) * 128 + (idx & 127)
    valid = (hi < wrl) & (col < n)
    return vals[:, rows, :] * torch.where(valid, x[col.clamp(max=n - 1)], 0.0)


def window_reduce_plain(li, vals, w10, seg_blk, x, row0, row1, out, nys: int,
                        segw: int, G: int, wrl: int):
    """ys (8, nys, 128): ys[:, out[k], :] = sum over plane rows
    [row0[k], row1[k]) of the products (window_products_plain); slices no
    item names stay zero."""
    item, rows = rk.slice_rows(row0, row1)
    P = window_products_plain(li, vals, w10, seg_blk, x, rows, segw, G, wrl)
    return rk.slice_sums(P, item, out, nys)


def window_reduce(li, vals, w10, seg_blk, x, row0, row1, out, nys: int,
                  segw: int, G: int, wrl: int):
    """K10: per-slice lane sums ys (8, nys, 128) of the SELL-W planes li
    (8, S_pad, 128) int16 and vals (8, S_pad, 128) f32, gathered from x
    (ncols,) f32 through each plane row's window (w10 (S_pad,) int32, its
    x segment seg_blk (S_pad // CH,) int32).  Slice k sums plane rows
    [row0[k], row1[k]) into ys[:, out[k]]; the tables are int32.  See
    window_reduce_plain."""
    if not _on_card("window_reduce", li, vals, w10, seg_blk, x, row0, row1,
                    out):
        return window_reduce_plain(li, vals, w10, seg_blk, x, row0, row1, out,
                                   nys, segw, G, wrl)
    for t, dt in ((li, torch.int16), (vals, torch.float32),
                  (w10, torch.int32), (seg_blk, torch.int32),
                  (x, torch.float32), (row0, torch.int32),
                  (row1, torch.int32), (out, torch.int32)):
        _check_dtype("window_reduce", t, dt)
    S = vals.shape[1]
    if vals.shape != (8, S, 128) or li.shape != vals.shape or (
        w10.shape != (S,) or seg_blk.shape != (S // rp.CH,) or 8 % G
    ):
        raise ValueError("window_reduce: planes (8, S_pad, 128), w10 "
                         "(S_pad,), seg_blk (S_pad // CH,), G divides 8")
    ys = torch.zeros((8, nys, 128), dtype=torch.float32, device=x.device)
    n = row0.shape[0]
    if n:
        _launch("cvr_window_reduce", x.device, _p(li), _p(vals), _p(w10),
                _p(seg_blk), _p(x), _p(row0), _p(row1), _p(out), _p(ys), n,
                S, nys, x.shape[0], segw, G, wrl, rp.CH)
        window_reduce.launches += 1
    return ys


window_reduce.launches = 0

# name -> (wrapper, plain version, TPU kernel it replaces)
KERNELS = {
    "window_reduce": (
        window_reduce, window_reduce_plain,
        "cvr_tpu/ops/pallas_window.py:61 (+ pallas_route.py:86)",
    ),
}
