"""SELL-pack: the lane-packed sparse format under the routed path.

Rows are sorted by length (globally, or inside windows of ``sigma``
rows) and grouped into slices of ``C = 1024`` rows, so every lane of a
slice carries a near-identical nnz count; values and columns are
transposed into slot-major planes ``[n_slots, C]``.  Rows longer than
``split_len`` are cut into segments that pack as independent virtual
rows; their partial sums are combined by a scatter-add at the end.

Layout, for G segments and ``P = ceil(G / C) * C`` padded positions:

  perm[P]            row id of the segment at each sorted position
                     (sentinel ``nrows`` for padding positions)
  seg_offset[P]      starting nnz index of the segment within its row
  row_rank[nrows]    inverse of perm, valid only when n_splits == 0
  lane_lengths[P]    nnz count of the segment at each sorted position
  slice_offsets[n+1] first slot of each slice; width_i = off[i+1] - off[i]
  vals_plane[S, C]   slot s of slice i, lane c: nnz (s - off[i]) of
                     segment perm[i*C + c]; padding is 0.0
  cols_plane[S, C]   matching column ids; padding slots point at column 0
  slot_slice[S]      slice id of each slot
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.utils.timing import PhaseTimer

DEFAULT_C = 1024
DEFAULT_SIGMA = 0  # 0 => global sort


@dataclass
class SellMatrix:
    vals_plane: np.ndarray  # [S, C] float
    cols_plane: np.ndarray  # [S, C] int32
    slice_offsets: np.ndarray  # [nslices + 1] int32
    slot_slice: np.ndarray  # [S] int32
    perm: np.ndarray  # [nslices * C] int32 (sentinel nrows = padding)
    seg_offset: np.ndarray  # [nslices * C] int32
    row_rank: np.ndarray  # [nrows] int32 (valid iff n_splits == 0)
    lane_lengths: np.ndarray  # [nslices * C] int32
    shape: tuple[int, int]
    nnz: int
    C: int = DEFAULT_C
    sigma: int = DEFAULT_SIGMA
    split_len: int = 0
    n_splits: int = 0
    convert_time: float = 0.0
    convert_phases: dict = field(default_factory=dict)

    @property
    def nslices(self) -> int:
        return int(self.slice_offsets.shape[0] - 1)

    @property
    def n_slots(self) -> int:
        return int(self.vals_plane.shape[0])

    @property
    def padded_nnz(self) -> int:
        return self.n_slots * self.C

    @property
    def fill_ratio(self) -> float:
        return self.padded_nnz / max(self.nnz, 1)

    def save(self, path) -> None:
        """Write the artifact as the JAX package's ``.npz`` layout, so
        that a later run loads it in place of the conversion."""
        np.savez_compressed(
            path,
            vals_plane=self.vals_plane,
            cols_plane=self.cols_plane,
            slice_offsets=self.slice_offsets,
            slot_slice=self.slot_slice,
            perm=self.perm,
            seg_offset=self.seg_offset,
            row_rank=self.row_rank,
            lane_lengths=self.lane_lengths,
            shape=np.asarray(self.shape, dtype=np.int64),
            nnz=np.int64(self.nnz),
            C=np.int64(self.C),
            sigma=np.int64(self.sigma),
            split_len=np.int64(self.split_len),
            n_splits=np.int64(self.n_splits),
        )

    @staticmethod
    def load(path) -> "SellMatrix":
        z = np.load(path)
        return SellMatrix(
            **{k: z[k] for k in ("vals_plane", "cols_plane",
                                 "slice_offsets", "slot_slice", "perm",
                                 "seg_offset", "row_rank", "lane_lengths")},
            shape=tuple(int(v) for v in z["shape"]),
            **{k: int(z[k]) for k in ("nnz", "C", "sigma", "split_len",
                                      "n_splits")},
        )


def _sigma_sort(lengths: np.ndarray, sigma: int) -> np.ndarray:
    """Order rows by descending length, stably, within windows of sigma
    rows (sigma == 0 sorts globally)."""
    nrows = lengths.shape[0]
    if sigma <= 0 or sigma >= nrows:
        return np.argsort(-lengths, kind="stable").astype(np.int32)
    order = np.empty(nrows, dtype=np.int32)
    for start in range(0, nrows, sigma):
        stop = min(start + sigma, nrows)
        window = np.argsort(-lengths[start:stop], kind="stable")
        order[start:stop] = window.astype(np.int32) + start
    return order


def sell_pack(
    csr: CSRMatrix,
    C: int = DEFAULT_C,
    sigma: int = DEFAULT_SIGMA,
    split_len: int | None = None,
    use_native: bool | None = None,
) -> SellMatrix:
    """CSR -> SELL-pack converter (O(nnz)); the native C++/OpenMP module
    when available, the NumPy path otherwise.

    split_len: maximum segment length (rows longer than this split into
    several segments); None picks ``max(16, 4 * mean_row_length)``,
    0 disables splitting.
    """
    from cvr_tpu_torch import _native

    if split_len is None:
        mean_len = -(-max(csr.nnz, 1) // max(csr.shape[0], 1))
        split_len = max(16, 4 * mean_len)
    if use_native is None:
        use_native = sigma == 0 and csr.vals.dtype == np.float32
    if use_native and _native.available():
        return _sell_pack_native(csr, C, split_len)
    return _sell_pack_numpy(csr, C, sigma, split_len)


def _sell_pack_native(csr: CSRMatrix, C: int, split_len: int) -> SellMatrix:
    from cvr_tpu_torch import _native

    pt = PhaseTimer()
    nrows = csr.shape[0]
    with pt.phase("native_pack"):
        (
            vals_plane,
            cols_plane,
            slice_offsets,
            slot_slice,
            perm,
            seg_offset,
            lane_lengths,
            n_splits,
        ) = _native.sell_pack_native(
            csr.rowptr, csr.cols, csr.vals, C, split_len
        )
    with pt.phase("rank"):
        G = perm.shape[0] - int((perm == nrows).sum())
        row_rank = np.zeros(nrows, dtype=np.int32)
        if n_splits == 0:
            row_rank[perm[:G].astype(np.int64)] = np.arange(G, dtype=np.int32)
    return SellMatrix(
        vals_plane=vals_plane,
        cols_plane=cols_plane,
        slice_offsets=slice_offsets,
        slot_slice=slot_slice,
        perm=perm,
        seg_offset=seg_offset,
        row_rank=row_rank,
        lane_lengths=lane_lengths,
        shape=csr.shape,
        nnz=csr.nnz,
        C=C,
        sigma=0,
        split_len=split_len,
        n_splits=int(n_splits),
        convert_time=pt.total,
        convert_phases=dict(pt.phases),
    )


def _sell_pack_numpy(
    csr: CSRMatrix, C: int, sigma: int, split_len: int
) -> SellMatrix:
    pt = PhaseTimer()
    nrows, _ = csr.shape
    lengths = csr.row_lengths.astype(np.int64)

    with pt.phase("split"):
        if split_len > 0:
            nseg_per_row = np.maximum(-(-lengths // split_len), 1)
        else:
            nseg_per_row = np.ones(nrows, dtype=np.int64)
        G = int(nseg_per_row.sum())
        seg_row = np.repeat(np.arange(nrows, dtype=np.int64), nseg_per_row)
        first_seg = np.zeros(nrows, dtype=np.int64)
        np.cumsum(nseg_per_row[:-1], out=first_seg[1:])
        seg_k = np.arange(G, dtype=np.int64) - first_seg[seg_row]
        seg_off = seg_k * max(split_len, 1)
        seg_len = np.minimum(lengths[seg_row] - seg_off, max(split_len, 1))
        if split_len <= 0:
            seg_off = np.zeros(G, dtype=np.int64)
            seg_len = lengths.copy()
        n_splits = G - nrows

    with pt.phase("sort"):
        order = _sigma_sort(seg_len, sigma)  # [G] segment ids, desc length

    with pt.phase("layout"):
        nslices = max(1, -(-G // C))
        P = nslices * C
        perm = np.full(P, nrows, dtype=np.int32)  # sentinel = padding
        perm[:G] = seg_row[order].astype(np.int32)
        seg_offset = np.zeros(P, dtype=np.int32)
        seg_offset[:G] = seg_off[order].astype(np.int32)
        row_rank = np.zeros(nrows, dtype=np.int32)
        if n_splits == 0:
            row_rank[perm[:G].astype(np.int64)] = np.arange(
                G, dtype=np.int32
            )
        sorted_len = np.zeros(P, dtype=np.int64)
        sorted_len[:G] = seg_len[order]
        widths = sorted_len.reshape(nslices, C).max(axis=1)
        slice_offsets = np.zeros(nslices + 1, dtype=np.int32)
        np.cumsum(widths, out=slice_offsets[1:])
        S = int(slice_offsets[-1])
        slot_slice = np.repeat(np.arange(nslices, dtype=np.int32), widths)

    with pt.phase("pack"):
        vals_plane = np.zeros((S, C), dtype=csr.vals.dtype)
        cols_plane = np.zeros((S, C), dtype=np.int32)
        if csr.nnz:
            # nnz j of the segment at sorted position p = i*C + c lands
            # at flat index (slice_offsets[i] + j) * C + c
            pos_len = sorted_len[:G]
            pos_of_nnz = np.repeat(np.arange(G, dtype=np.int64), pos_len)
            starts = np.zeros(G, dtype=np.int64)
            np.cumsum(pos_len[:-1], out=starts[1:])
            j = np.arange(csr.nnz, dtype=np.int64) - starts[pos_of_nnz]
            lane = pos_of_nnz % C
            base = slice_offsets[(pos_of_nnz // C)].astype(np.int64)
            dest = (base + j) * C + lane
            src_start = (
                csr.rowptr[perm[:G].astype(np.int64)]
                + seg_offset[:G].astype(np.int64)
            )
            src = np.repeat(src_start - starts, pos_len) + np.arange(
                csr.nnz, dtype=np.int64
            )
            vals_plane.reshape(-1)[dest] = csr.vals[src]
            cols_plane.reshape(-1)[dest] = csr.cols[src]

    return SellMatrix(
        vals_plane=vals_plane,
        cols_plane=cols_plane,
        slice_offsets=slice_offsets,
        slot_slice=slot_slice,
        perm=perm,
        seg_offset=seg_offset,
        row_rank=row_rank,
        lane_lengths=sorted_len.astype(np.int32),
        shape=csr.shape,
        nnz=csr.nnz,
        C=C,
        sigma=sigma,
        split_len=split_len,
        n_splits=n_splits,
        convert_time=pt.total,
        convert_phases=dict(pt.phases),
    )


def sell_unpack(sm: SellMatrix) -> CSRMatrix:
    """The exact inverse of sell_pack: the CSR it packed, each row's
    entries in their order."""
    nrows = sm.shape[0]
    C = sm.C
    P = sm.perm.shape[0]
    pos_len = sm.lane_lengths.astype(np.int64)
    nnz = int(pos_len.sum())
    if nnz != sm.nnz:
        raise ValueError("corrupt SellMatrix: lane_lengths sum != nnz")
    lengths = np.zeros(nrows + 1, dtype=np.int64)
    np.add.at(lengths, sm.perm.astype(np.int64), pos_len)
    rowptr = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(lengths[:nrows], out=rowptr[1:])
    if nnz == 0:
        return CSRMatrix(rowptr=rowptr, cols=np.empty(0, dtype=np.int32),
                         vals=np.empty(0, dtype=sm.vals_plane.dtype),
                         shape=sm.shape)
    # each nnz, in sorted-position order: its flat index in the planes
    # (src) and its place in CSR order (dst)
    pos_of_nnz = np.repeat(np.arange(P, dtype=np.int64), pos_len)
    starts = np.zeros(P, dtype=np.int64)
    np.cumsum(pos_len[:-1], out=starts[1:])
    j = np.arange(nnz, dtype=np.int64) - starts[pos_of_nnz]
    base = sm.slice_offsets[pos_of_nnz // C].astype(np.int64)
    src = (base + j) * C + pos_of_nnz % C
    row = sm.perm[pos_of_nnz].astype(np.int64)
    dst = rowptr[row] + sm.seg_offset[pos_of_nnz].astype(np.int64) + j
    cols = np.empty(nnz, dtype=np.int32)
    vals = np.empty(nnz, dtype=sm.vals_plane.dtype)
    cols[dst] = sm.cols_plane.reshape(-1)[src]
    vals[dst] = sm.vals_plane.reshape(-1)[src]
    return CSRMatrix(rowptr=rowptr, cols=cols, vals=vals, shape=sm.shape)
