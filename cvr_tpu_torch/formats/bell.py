"""BELL: banded-ELL planes in natural row order, plus a routed spill.

For banded-sparse matrices (the road domain: ~2.5 nnz per row, all near
the diagonal, no dense diagonals for DIA).  Rows keep their natural
order, which is the x locality: the k nearest-first entries of each row
fill k (offset, value) planes that one gather-multiply pass consumes
(cvr_tpu_torch/ops/bell_kernels.py), with no row sort, route or y-route.
Rows deeper than k, and entries farther than REACH_CAP from the diagonal,
spill to a small routed residual over the spill's rows only.

Plane geometry (same arrays as the JAX package's pack): row r sits at
(q, l) = (r >> 7, r & 127) of the (k, R_sub, 128) planes; its entry at
column c stores li = c - 1024*(r >> 10) + 128*cr (cr = ceil(reach/128)),
an int16 offset into the 1024-column window of its 1024-row tile, widened
by cr 128-column blocks on the left.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.utils.profiling import load_npz

# Largest |col - row| a plane entry may have: li stays below 2048 (a
# window of 16 x 128 columns).
REACH_CAP = 448


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def ncand_of(reach: int) -> int:
    """128-column blocks a tile's window spans (max li = 128*cr + 1023 +
    reach; 16 at the REACH_CAP)."""
    cr = -(-reach // 128)
    return (128 * cr + 1023 + reach) // 128 + 1


def bell_tbb0(k: int) -> int:
    """Base tiles per block: the pack rounds R_sub to TBb*8 sublane rows.
    The JAX package sizes it for VMEM; kept so both packs agree."""
    return 64 if k > 8 else 128


def bell_tbb(k: int, R_sub: int) -> int:
    """Tiles per block: bell_tbb0, halved until it divides R_sub."""
    TBb = bell_tbb0(k)
    while R_sub % (TBb * 8):
        TBb //= 2
        if TBb < 8:
            raise ValueError("BELL rows must pad to an 8192-row multiple")
    return TBb


class BellInfeasible(ValueError):
    """Matrix not banded-sparse enough for BELL (see bell_pack's gate)."""


@dataclasses.dataclass
class BellMatrix:
    """Host-side BELL artifact (see ops/spmv_bell.to_device_bell)."""

    li: np.ndarray  # (k, R_sub, 128) int16 window offsets
    vals: np.ndarray  # (k, R_sub, 128) f32
    spill: object  # SellRouted | None: residual entries, row-compressed
    spill_map: np.ndarray | None  # natural rows of the compressed spill
    shape: tuple
    nnz: int
    reach: int
    k: int
    d: int  # window phase: tile t's base row is 8t + d in x-table rows
    pre: int  # zero 128-column rows before x in the x table
    ncand: int
    TBb: int
    convert_time: float = 0.0
    convert_phases: dict | None = None
    # the spill as raw (rows, cols, vals) triples, where the pack was asked
    # not to pack it (pack_spill=False: the sharded packer packs them)
    spill_raw: tuple | None = None

    @property
    def R_sub(self) -> int:
        return self.li.shape[1]

    @property
    def padded_nnz(self) -> int:
        """Stored plane elements plus the spill's routed stream."""
        spill = self.spill.T * 1024 if self.spill is not None else 0
        return self.k * self.R_sub * 128 + spill


def bell_pack(
    csr: CSRMatrix,
    k: int | None = None,
    max_spill: float = 0.02,
    max_k: int = 12,
    reach_force: int | None = None,
    R_sub_min: int = 0,
    pack_spill: bool = True,
) -> BellMatrix:
    """Pack a banded-sparse CSR into BELL planes and a routed spill.

    Gate: at least (1 - max_spill) of the nnz lie within REACH_CAP
    columns of the diagonal and within the first k such entries of their
    row, for some k <= max_k (the smallest is taken unless ``k`` is
    given); otherwise BellInfeasible.  The native passes run when the
    library loads, the numpy path otherwise.

    ``reach_force`` and ``R_sub_min`` pin the window geometry, so that row
    shards packed one by one share it (cvr_tpu_torch/parallel/dist_bell.py);
    ``pack_spill=False`` leaves the spill as raw (rows, cols, vals)
    triples in ``spill_raw``.  Columns may be negative down to
    -128*ceil(reach/128): a row shard's band reaches left of its first
    row, into the x table's ``pre`` rows.
    """
    from cvr_tpu_torch import _native

    t0 = time.perf_counter()
    nrows, ncols = csr.shape
    nnz = csr.nnz
    if nnz == 0:
        raise BellInfeasible("empty matrix")
    use_native = _native.available()
    if use_native:
        near_lens, reach = _native.bell_stats_native(csr.rowptr, csr.cols,
                                                     REACH_CAP)
        near_lens = near_lens.astype(np.int64)
    else:
        lens = csr.row_lengths
        rows = np.repeat(np.arange(nrows, dtype=np.int64), lens)
        aoff = np.abs(csr.cols.astype(np.int64) - rows)
        near = aoff <= REACH_CAP
        reach = int(aoff[near].max()) if near.any() else 0
        cum0 = np.concatenate(([0], np.cumsum(near.astype(np.int64))))
        near_lens = cum0[csr.rowptr[1:]] - cum0[csr.rowptr[:-1]]
    if k is None:
        k = 1
        while k <= max_k:
            if nnz - int(np.minimum(near_lens, k).sum()) <= max_spill * nnz:
                break
            k += 1
    spilled = nnz - int(np.minimum(near_lens, k).sum())
    if k > max_k or spilled > max_spill * nnz:
        raise BellInfeasible(
            f"spill {spilled / nnz:.1%} at k={min(k, max_k)} over the "
            f"{max_spill:.0%} gate"
        )
    if reach_force is not None:
        if reach_force < reach:
            raise ValueError("reach_force below the measured reach")
        reach = reach_force
    cr = -(-reach // 128)
    TBb = bell_tbb0(k)
    R_sub = _round_up(max(-(-max(nrows, 1) // 128), R_sub_min), TBb * 8)

    if use_native:
        li, vals, sp_rows, sp_cols, sp_vals = _native.bell_fill_native(
            csr.rowptr, csr.cols, csr.vals, k, REACH_CAP, cr, R_sub * 128,
            spilled,
        )
    else:
        cum = np.cumsum(near.astype(np.int64))
        row_base = np.concatenate(([0], cum))[csr.rowptr[:-1]]
        rank = cum - 1 - np.repeat(row_base, lens)
        in_plane = near & (rank < k)
        li = np.zeros((k, R_sub * 128), dtype=np.int16)
        vals = np.zeros((k, R_sub * 128), dtype=np.float32)
        r_in = rows[in_plane]
        li_v = csr.cols.astype(np.int64)[in_plane] - ((r_in >> 10) << 10)
        li[rank[in_plane], r_in] = (li_v + 128 * cr).astype(np.int16)
        vals[rank[in_plane], r_in] = csr.vals[in_plane]
        sp = ~in_plane
        sp_rows = rows[sp].astype(np.int32)
        sp_cols = csr.cols[sp]
        sp_vals = csr.vals[sp]
    pre = _round_up(cr, 8)

    spill = spill_map = spill_raw = None
    if sp_rows.size and not pack_spill:
        spill_raw = (sp_rows, sp_cols, sp_vals)
    elif sp_rows.size:
        from cvr_tpu_torch.formats.sell_routed import sell_pack_routed

        # compress the spill to its occupied rows, so that its pack and
        # y-route scale with the spill, not with nrows; the SpMV adds the
        # compressed y back through spill_map.  Spill entries are in CSR
        # order (row, then column) already.
        spill_map, sp_rows_c = np.unique(sp_rows, return_inverse=True)
        sp_rowptr = np.zeros(spill_map.size + 1, dtype=np.int64)
        np.cumsum(np.bincount(sp_rows_c, minlength=spill_map.size),
                  out=sp_rowptr[1:])
        spill = sell_pack_routed(CSRMatrix(
            rowptr=sp_rowptr, cols=sp_cols, vals=sp_vals,
            shape=(int(spill_map.size), ncols),
        ))
    dt = time.perf_counter() - t0
    phases = {"bell": dt}
    if spill is not None:
        phases.update({f"spill_{p}": v
                       for p, v in (spill.convert_phases or {}).items()})
    return BellMatrix(
        li=li.reshape(k, R_sub, 128),
        vals=vals.reshape(k, R_sub, 128),
        spill=spill,
        spill_map=spill_map,
        shape=(nrows, ncols),
        nnz=nnz,
        reach=reach,
        k=k,
        d=pre - cr,
        pre=pre,
        ncand=ncand_of(reach),
        TBb=bell_tbb(k, R_sub),
        convert_time=dt,
        convert_phases=phases,
        spill_raw=spill_raw,
    )


def save_bell(bm: BellMatrix, path) -> None:
    """Write the BELL artifact as the JAX package's ``.npz`` layout, the
    routed spill embedded as the bytes of its own save_routed file."""
    import io

    from cvr_tpu_torch.formats.sell_routed import save_routed

    spill = b""
    if bm.spill is not None:
        buf = io.BytesIO()
        save_routed(bm.spill, buf)
        spill = buf.getvalue()
    np.savez_compressed(
        path,
        bell_li=bm.li,
        bell_vals=bm.vals,
        bell_meta=np.asarray([bm.shape[0], bm.shape[1], bm.nnz, bm.reach,
                              bm.k, bm.d, bm.pre, bm.ncand, bm.TBb],
                             dtype=np.int64),
        bell_spill=np.frombuffer(spill, dtype=np.uint8),
        bell_spill_map=(bm.spill_map if bm.spill_map is not None
                        else np.zeros(0, dtype=np.int64)),
    )


def load_bell(path) -> BellMatrix:
    """Read a BELL artifact that either package saved."""
    import io

    from cvr_tpu_torch.formats.sell_routed import load_routed

    z = load_npz(path)
    m = [int(v) for v in z["bell_meta"]]
    raw = z["bell_spill"]
    smap = z["bell_spill_map"]
    return BellMatrix(
        li=z["bell_li"], vals=z["bell_vals"],
        spill=load_routed(io.BytesIO(raw.tobytes())) if raw.size else None,
        spill_map=smap if smap.size else None,
        shape=(m[0], m[1]), nnz=m[2], reach=m[3], k=m[4], d=m[5], pre=m[6],
        ncand=m[7], TBb=m[8],
    )
