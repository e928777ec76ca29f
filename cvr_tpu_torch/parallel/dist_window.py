"""The row-sharded SELL-W SpMV: K10 on each nnz-balanced row shard.

Rows are partitioned by nnz balance and each shard is SELL-W packed on
its own under one (D, W) geometry, the first of ``_CANDIDATES`` that fits
every shard (``sell_pack_window(..., force_dw=)``).  Each shard's plane
rows are then spliced to one set of per-reduce-group row counts, the
largest shard's, with zero rows whose ``emit`` is -1, as the JAX package
splices them for its one shard_map program; the port keeps the spliced
planes on the host, so that they are the JAX package's array for array,
and uploads each shard's own rows of them: in each reduce group the rows
up to its last emission (an ``emit = -1`` row closes no slice, and rows
after a group's last emission are read by no slice).  x is replicated,
or row-sharded and all-gathered; each shard runs the port's single-card
SELL-W SpMV (K10 ``window_reduce`` over the slice table
``spmv_routed.reduce_table`` derives from its ``emit``) and the fold of
each row's D lanes; the shards' y slices are put back in row order on
the mesh's first device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.formats.sell_window import (
    SEGW_WIN,
    SellWindow,
    WindowInfeasible,
    sell_pack_window,
)
from cvr_tpu_torch.ops import route_planes as rp
from cvr_tpu_torch.ops.spmv_window import (
    SellWindowDevice,
    spmv_window,
    to_device_window,
)
from cvr_tpu_torch.parallel.dist import (
    Mesh,
    concat_rows,
    local_csrs,
    on_shards,
    replicate_or_gather,
)
from cvr_tpu_torch.parallel.partition import (
    partition_balance,
    partition_rows_by_nnz,
)

# the JAX package's candidate order (its single-card pack's cost order)
_CANDIDATES = [(1, 1024), (2, 1024), (4, 1024), (1, 2048), (2, 2048),
               (4, 2048)]

PLANES = ("vals_ss", "li", "w10", "emit", "seg_blk")


@dataclass
class DistWindowMatrix:
    """Row-sharded, spliced SELL-W planes, each shard's on its device."""

    planes: tuple[dict, ...]  # per shard: name -> host array (JAX's names)
    shards: tuple[SellWindowDevice | None, ...]  # the held ones
    bounds: np.ndarray  # [D + 1] global row bounds
    ycall_rows: tuple  # shared (start, rows) per reduce group
    shape: tuple[int, int]
    nnz: int
    W: int
    D: int
    G: int
    segw: int
    n_segs: int
    nslices_u: int
    rows_max: int
    wrl: int
    mesh: Mesh
    balance: dict | None = None  # partition_balance diagnostics

    @property
    def n_shards(self) -> int:
        return int(self.bounds.shape[0] - 1)


def _splice_uniform(shards: list[SellWindow]):
    """Pad every shard's per-reduce-group row count to the largest
    shard's, so that all shards share one geometry.  Returns per-shard
    plane dicts, the shared ycall_rows and the shared slice count."""
    YB, CH = rp.YB, rp.CH
    nslices_u = max(s.nslices for s in shards)
    n_ycalls = max(1, -(-nslices_u // YB))
    rows_max = np.zeros(n_ycalls, dtype=np.int64)
    for s in shards:
        n = min(n_ycalls, s.ycall_rows.shape[0])
        rows_max[:n] = np.maximum(rows_max[:n], s.ycall_rows[:n, 1])
    starts = np.zeros(n_ycalls, dtype=np.int64)
    np.cumsum(rows_max[:-1], out=starts[1:])
    ycall_rows = tuple((int(a), int(b)) for a, b in zip(starts, rows_max))
    S_u = int(rows_max.sum())
    out = []
    for s in shards:
        pl = {
            "vals_ss": np.zeros((8, S_u, 128), dtype=np.float32),
            "li": np.zeros((8, S_u, 128), dtype=np.int16),
            "w10": np.zeros(S_u, dtype=np.int32),
            "emit": np.full(S_u, -1, dtype=np.int32),
            "seg_blk": np.zeros(S_u // CH, dtype=np.int32),
        }
        for j in range(min(n_ycalls, s.ycall_rows.shape[0])):
            r0, nr = (int(v) for v in s.ycall_rows[j])
            d0 = int(starts[j])
            pl["vals_ss"][:, d0 : d0 + nr] = s.vals_ss[:, r0 : r0 + nr]
            pl["li"][:, d0 : d0 + nr] = s.li[:, r0 : r0 + nr]
            pl["w10"][d0 : d0 + nr] = s.w10[r0 : r0 + nr]
            pl["emit"][d0 : d0 + nr] = s.emit[r0 : r0 + nr]
            pl["seg_blk"][d0 // CH : (d0 + nr) // CH] = s.seg_blk[
                r0 // CH : (r0 + nr) // CH]
        out.append(pl)
    return out, ycall_rows, nslices_u


def _own_rows(pl: dict, ycall_rows):
    """A shard's spliced planes cut back to its own rows: in each reduce
    group the rows up to its last emission, rounded up to CH (the
    splice's padding rows after it are read by no slice).  Returns the
    planes and the shard's own (start, rows) per reduce group."""
    CH = rp.CH
    emit = pl["emit"]
    keep, own, start = [], [], 0
    for r0, nr in ycall_rows:
        e = np.flatnonzero(emit[r0 : r0 + nr] >= 0)
        n = -(-(int(e[-1]) + 1) // CH) * CH if e.size else 0
        keep.append(np.arange(r0, r0 + n, dtype=np.int64))
        own.append((start, n))
        start += n
    rows = np.concatenate(keep)
    planes = {
        "vals_ss": pl["vals_ss"][:, rows], "li": pl["li"][:, rows],
        "w10": pl["w10"][rows], "emit": emit[rows],
        "seg_blk": pl["seg_blk"][rows[::CH] // CH],
    }
    return planes, np.asarray(own, dtype=np.int64).reshape(-1, 2)


def _shard_window(pl: dict, meta: dict, nrows: int, ncols: int) -> SellWindow:
    """One shard's SELL-W artifact of ``nrows`` rows from its own rows of
    the spliced planes and the shared geometry."""
    own, ycall_rows = _own_rows(pl, meta["ycall_rows"])
    S = int(own["emit"].shape[0])
    return SellWindow(
        vals_ss=own["vals_ss"], li=own["li"], w10=own["w10"],
        seg_blk=own["seg_blk"], emit=own["emit"], ycall_rows=ycall_rows,
        shape=(nrows, ncols), nnz=0, W=meta["W"],
        D=meta["D"], G=meta["G"], S=S, S_pad=S,
        nslices=meta["nslices_u"], segw=meta["segw"],
        n_segs=meta["n_segs"], wrl=meta["wrl"],
    )


def _assemble(planes, meta, bounds, shape, nnz, mesh: Mesh,
              balance) -> DistWindowMatrix:
    """Upload each shard's own rows of its spliced planes and its slice
    table to its device (the shards this process holds)."""
    D = mesh.size
    if len(planes) != D:
        raise ValueError(f"{len(planes)} shards on a mesh of {D} devices")
    bounds = np.asarray(bounds, dtype=np.int64)
    rows = np.diff(bounds)
    shards = tuple(on_shards(mesh, lambda i: to_device_window(
        _shard_window(planes[i], meta, int(rows[i]), int(shape[1])),
        mesh.devices[i])))
    return DistWindowMatrix(
        planes=tuple(planes), shards=shards, bounds=bounds,
        ycall_rows=tuple(meta["ycall_rows"]), shape=tuple(shape),
        nnz=int(nnz), W=meta["W"], D=meta["D"], G=meta["G"],
        segw=meta["segw"], n_segs=meta["n_segs"],
        nslices_u=meta["nslices_u"], rows_max=int(rows.max()),
        wrl=meta["wrl"],
        mesh=mesh, balance=balance,
    )


def dist_window_pack(csr: CSRMatrix, mesh: Mesh,
                     segw: int = SEGW_WIN) -> DistWindowMatrix:
    """Partition rows by nnz, SELL-W-pack each shard under the first
    (D, W) of _CANDIDATES that fits every shard, splice the shards to one
    geometry and upload each to its device.

    Raises WindowInfeasible when no geometry fits every shard (then shard
    the routed format)."""
    bounds = partition_rows_by_nnz(csr.rowptr, mesh.size)
    locals_ = local_csrs(csr, bounds)
    shards = None
    for cand in _CANDIDATES:
        try:
            shards = [sell_pack_window(lc, segw=segw, force_dw=cand)
                      for lc in locals_]
            break
        except WindowInfeasible:
            continue
    if shards is None:
        raise WindowInfeasible(
            "no window geometry fits every row shard — use the routed "
            "format or the XLA dist path"
        )
    planes, ycall_rows, nslices_u = _splice_uniform(shards)
    s0 = shards[0]
    meta = {
        "ycall_rows": ycall_rows, "W": s0.W, "D": s0.D, "G": s0.G,
        "segw": s0.segw, "n_segs": s0.n_segs, "nslices_u": nslices_u,
        # one window class for every shard: the largest (each shard's
        # offsets stay within its own)
        "wrl": max(sh.wrl or (sh.W // 128) for sh in shards),
    }
    return _assemble(planes, meta, bounds, csr.shape, csr.nnz, mesh,
                     partition_balance(csr.rowptr, bounds))


def from_reference(jdm, mesh: Mesh) -> DistWindowMatrix:
    """The port's artifact from the JAX package's ``DistWindowMatrix``:
    its stacked, spliced planes (read as numpy arrays; nothing of the JAX
    package is imported; its group-emission plane ``gemit`` is not
    needed), geometry, bounds and shape, uploaded shard by shard."""
    stacked = {k: np.asarray(jdm.planes[k]) for k in PLANES}
    D = int(np.asarray(jdm.bounds).shape[0] - 1)
    planes = [{k: np.array(v[i]) for k, v in stacked.items()}
              for i in range(D)]
    meta = {"ycall_rows": tuple(tuple(int(v) for v in r)
                                for r in jdm.ycall_rows),
            "W": int(jdm.W), "D": int(jdm.D), "G": int(jdm.G),
            "segw": int(jdm.segw), "n_segs": int(jdm.n_segs),
            "nslices_u": int(jdm.nslices_u), "wrl": int(jdm.wrl)}
    return _assemble(planes, meta, jdm.bounds, jdm.shape, jdm.nnz, mesh,
                     jdm.balance)


def dist_spmv_window(dm: DistWindowMatrix, x: torch.Tensor,
                     x_sharded: bool = False) -> torch.Tensor:
    """y = A @ x across the mesh, K10 on each shard; y whole on the mesh's
    home device.  x_sharded=True all-gathers a row-sharded x first."""
    xs = replicate_or_gather(x.to(torch.float32), dm.mesh, dm.shape[1],
                             x_sharded)
    return concat_rows(dm.mesh, on_shards(dm.mesh, lambda i: spmv_window(
        dm.shards[i], xs[i])), dm.bounds)


def dist_spmv_window_jit(dm: DistWindowMatrix, x_sharded: bool = False):
    """A closure over the matrix for iteration-heavy callers (the JAX
    package jits it; torch runs eagerly)."""
    return functools.partial(dist_spmv_window, dm, x_sharded=x_sharded)
