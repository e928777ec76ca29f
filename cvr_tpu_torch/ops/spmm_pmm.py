"""PMM SpMM: hub-concentrated matrices at small K, by row tile.

The JAX package gathers K-wide X windows with one-hot matrix products on
the TPU's matrix unit (exact by a 3-way bf16 split of X) and reduces with
a second one-hot product per 128-element chunk; one product per distinct
128-column window a chunk touches, so it pays only where that fan-in is
small (fsm-class automata).  Its plan and its dispatch gate are ported
here unchanged, array for array, so that both packages pick PMM for the
same matrices.

Plan layout: elements grouped by row tile (row >> 7), column-sorted
within the group, padded per group to a 128 multiple ("chunks"); each
chunk emits one pair per distinct window, with the element slots of that
window in ``lc`` (LC_SENTINEL elsewhere).  On the card the one-hot
products become direct indexing: ``to_device_pmm`` derives each element
slot's column (``win * 128 + lc``) once, drops the pad slots and reorders
the rest stably by row (``pmm_entries``: each row's entries in column
order, 8 B an entry), and K14 sums each row from its entries and the work
plan ``pmm_kernels.pmm_work`` made at upload (no pairs, no chunks).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.ops import pmm_kernels
from cvr_tpu_torch.ops.route_kernels import INT32_MAX

LC_SENTINEL = 128  # local-col value that matches no source lane

# The JAX package's time model of its TPU v5e kernel, kept unchanged so
# that both packages take the same dispatch decisions; they are TPU
# numbers and say nothing about the H100.  ns per pair step by K (padded),
# extra ns per chunk, a fixed cost per call, and the two rivals' slopes:
# the vmapped routed SpMM per (element * column) and the lane path per
# element.
NS_PAIR = {16: 30.0, 32: 30.0, 64: 40.0, 128: 48.0}
NS_CHUNK_EXTRA = {16: 18.0, 32: 18.0, 64: 24.0, 128: 29.0}
FIXED_US = 60.0
NS_ROUTED_PER_ELEM = 0.149
NS_LANE_PER_ELEM = 15.6


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class PmmPlan:
    """Host-side PMM plan: pair/chunk streams + planes (see module doc)."""

    win: np.ndarray  # (npairs,) int32 aligned column-window id
    rt: np.ndarray  # (npairs,) int32 output row-tile per pair
    ch: np.ndarray  # (npairs,) int32 chunk id per pair (nondecreasing)
    lc: np.ndarray  # (npairs, 128) int32 local col or LC_SENTINEL
    val: np.ndarray  # (nchunks, 128) f32 element values (pads 0)
    rl: np.ndarray  # (nchunks, 128) int32 local row (pads 127)
    shape: tuple
    nnz: int
    nchunks: int
    npairs: int
    ncb: int  # column blocks (windows)
    nrt: int  # row tiles = output blocks
    convert_time: float = 0.0

    @property
    def c_mean(self) -> float:
        """Mean distinct windows per chunk (the fan-in gate input)."""
        return self.npairs / max(self.nchunks, 1)


_FIELDS = ("win", "rt", "ch", "lc", "val", "rl", "shape", "nnz", "nchunks",
           "npairs", "ncb", "nrt", "convert_time")


def from_reference(plan) -> PmmPlan:
    """The port's plan from the JAX package's ``PmmPlan`` (its numpy
    attributes only)."""
    return PmmPlan(**{k: getattr(plan, k) for k in _FIELDS})


def save_pmm(plan: PmmPlan, path) -> None:
    """Write the PMM plan as the JAX package's ``.npz`` layout: the host
    plan, from which the upload makes the entries and the work plan."""
    np.savez_compressed(
        path,
        pmm_win=plan.win,
        pmm_rt=plan.rt,
        pmm_ch=plan.ch,
        pmm_lc=plan.lc,
        pmm_val=plan.val,
        pmm_rl=plan.rl,
        pmm_meta=np.asarray([plan.shape[0], plan.shape[1], plan.nnz,
                             plan.nchunks, plan.npairs, plan.ncb, plan.nrt],
                            dtype=np.int64),
    )


def load_pmm(path) -> PmmPlan:
    """Read a PMM plan that either package saved."""
    z = np.load(path)
    m = [int(v) for v in z["pmm_meta"]]
    return PmmPlan(
        win=z["pmm_win"], rt=z["pmm_rt"], ch=z["pmm_ch"], lc=z["pmm_lc"],
        val=z["pmm_val"], rl=z["pmm_rl"], shape=(m[0], m[1]), nnz=m[2],
        nchunks=m[3], npairs=m[4], ncb=m[5], nrt=m[6],
    )


def pmm_plan(rows, cols, vals, shape) -> PmmPlan:
    """Build the PMM plan from COO arrays (vectorized host passes).

    Grouping is by row-tile with columns sorted inside each group, so
    chunks never span row-tiles and windows are nondecreasing within a
    chunk; pad slots repeat the group's last column (adding no pair)
    with the LC sentinel and val 0.  Empty row-tiles get one all-pad
    chunk so every output block is visited.
    """
    t0 = time.perf_counter()
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    nrows, ncols = int(shape[0]), int(shape[1])
    nnz = rows.shape[0]
    nrt = max(_round_up(nrows, 128) // 128, 1)
    ncb = max(_round_up(ncols, 128) // 128, 1)

    rt_e = rows >> 7
    order = np.lexsort((cols, rt_e))
    r = rows[order]
    c = cols[order]
    v = vals[order]

    counts = np.bincount(rt_e, minlength=nrt)
    pk = np.maximum((counts + 127) // 128, 1) * 128
    offs_p = np.concatenate([[0], np.cumsum(pk)])
    total_p = int(offs_p[-1])
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    within = np.arange(nnz, dtype=np.int64) - np.repeat(starts, counts)
    dstpos = np.repeat(offs_p[:-1], counts) + within

    # pad columns repeat the group's last real column (no extra pair)
    lastcol = np.zeros(nrt, dtype=np.int64)
    nz = counts > 0
    lastcol[nz] = c[starts[nz] + counts[nz] - 1]
    colp = np.repeat(lastcol, pk)
    colp[dstpos] = c
    valp = np.zeros(total_p, dtype=np.float32)
    valp[dstpos] = v
    rlp = np.full(total_p, 127, dtype=np.int32)
    rlp[dstpos] = (r & 127).astype(np.int32)
    lcp = np.full(total_p, LC_SENTINEL, dtype=np.int32)
    lcp[dstpos] = (c & 127).astype(np.int32)

    w_p = (colp >> 7).astype(np.int32)
    pos = np.arange(total_p, dtype=np.int64)
    runstart = np.empty(total_p, dtype=bool)
    runstart[0] = True
    runstart[1:] = w_p[1:] != w_p[:-1]
    runstart |= (pos & 127) == 0
    pair_of = np.cumsum(runstart) - 1
    npairs = int(pair_of[-1]) + 1
    nchunks = total_p // 128

    win = w_p[runstart]
    ch = (pos[runstart] >> 7).astype(np.int32)
    chunk_rt = np.repeat(
        np.arange(nrt, dtype=np.int32), (pk // 128).astype(np.int64)
    )
    rt = chunk_rt[ch]

    lc = np.full((npairs, 128), LC_SENTINEL, dtype=np.int32)
    lc[pair_of, (pos & 127)] = lcp

    return PmmPlan(
        win=win.astype(np.int32),
        rt=rt,
        ch=ch,
        lc=lc,
        val=valp.reshape(nchunks, 128),
        rl=rlp.reshape(nchunks, 128),
        shape=(nrows, ncols),
        nnz=nnz,
        nchunks=nchunks,
        npairs=npairs,
        ncb=ncb,
        nrt=nrt,
        convert_time=time.perf_counter() - t0,
    )


def _ns_pair(K: int) -> tuple[float, float]:
    Kp = min(_round_up(max(min(K, 128), 16), 16), 128)
    key = min((k for k in NS_PAIR if k >= Kp), default=128)
    return NS_PAIR[key], NS_CHUNK_EXTRA[key]


def pmm_projected_ms(plan_or_est, K: int) -> float:
    """The reference's time model of one PMM SpMM at width K (TPU v5e
    constants), from a PmmPlan or the (npairs, nchunks) estimate of
    ``pmm_estimate``."""
    if isinstance(plan_or_est, PmmPlan):
        npairs, nchunks = plan_or_est.npairs, plan_or_est.nchunks
    else:
        npairs, nchunks = plan_or_est
    nk = -(-K // 128)
    ns_p, ns_c = _ns_pair(K)
    return nk * (npairs * ns_p + nchunks * ns_c) / 1e6 + FIXED_US / 1e3


def pmm_estimate(rows, cols, shape, sample: int = 256, seed: int = 0):
    """Cheap sampled (npairs, nchunks) estimate for the dispatch gate.

    Sorts only ``sample`` row-tile buckets, drawn as the JAX package draws
    them, measures their exact chunk and pair counts, and extrapolates by
    the sampled fraction of row tiles.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    nrt = max(_round_up(int(shape[0]), 128) // 128, 1)
    rt_e = rows >> 7
    if nrt <= sample:
        picked = np.ones(rows.shape[0], dtype=bool)
        frac = 1.0
    else:
        rng = np.random.default_rng(seed)
        sel = np.zeros(nrt, dtype=bool)
        sel[rng.choice(nrt, size=sample, replace=False)] = True
        picked = sel[rt_e]
        frac = sample / nrt
    r = rt_e[picked]
    c = cols[picked]
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    counts = np.bincount(r)
    counts = counts[counts > 0]
    nchunks_s = int(np.sum((counts + 127) // 128))
    # windows per chunk, the plan's own walk
    w = c >> 7
    ends = np.cumsum(counts)
    pos = np.arange(r.shape[0], dtype=np.int64)
    off = pos - np.repeat(ends - counts, counts)
    bnd = np.empty(r.shape[0], dtype=bool)
    bnd[0] = True
    bnd[1:] = (w[1:] != w[:-1]) | (r[1:] != r[:-1])
    bnd |= (off & 127) == 0
    npairs_s = int(bnd.sum())
    return (
        max(int(npairs_s / frac), 1),
        max(int(nchunks_s / frac), 1),
    )


@dataclass(frozen=True)
class PmmDevice:
    col: torch.Tensor  # (nnz,) int32 entry column, row order, columns sorted
    val: torch.Tensor  # (nnz,) f32 entry value
    rowptr: torch.Tensor  # (nrows + 1,) int32: row r's entries
    work: pmm_kernels.PmmWork  # K14's segments, units and combine table
    shape: tuple
    nnz: int
    nchunks: int
    npairs: int
    nrt: int


def pmm_entries(plan: PmmPlan):
    """(col, val, rowptr) numpy: the plan's element slots as the entries
    of each row.  A slot's column comes from the one pair whose lc names
    it (win * 128 + lc); pad slots (no pair names them) are dropped; the
    slots, column-sorted within each row tile, are reordered stably by
    row, so that each row's entries stay in column order."""
    p, e = np.nonzero(plan.lc != LC_SENTINEL)
    col = np.full(plan.nchunks * 128, -1, dtype=np.int32)
    col[plan.ch[p].astype(np.int64) * 128 + e] = (
        plan.win[p].astype(np.int64) * 128 + plan.lc[p, e]
    )
    slot = np.flatnonzero(col >= 0)
    chunk_rt = np.zeros(plan.nchunks, dtype=np.int64)
    chunk_rt[plan.ch] = plan.rt
    row = chunk_rt[slot >> 7] * 128 + plan.rl.reshape(-1)[slot]
    by_row = np.argsort(row, kind="stable")
    nrows = int(plan.shape[0])
    rowptr = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(np.bincount(row, minlength=nrows), out=rowptr[1:])
    slot = slot[by_row]
    return col[slot], plan.val.reshape(-1)[slot], rowptr


def to_device_pmm(plan: PmmPlan, device="cuda") -> PmmDevice:
    """Upload the plan as the entries of each row (pmm_entries) and K14's
    work plan of them (pmm_kernels.pmm_work)."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    col, val, rowptr = pmm_entries(plan)
    if col.shape[0] > INT32_MAX:
        raise ValueError(f"to_device_pmm: {col.shape[0]} entries exceed the "
                         "int32 row offsets")
    return PmmDevice(
        col=put(col, np.int32),
        val=put(val, np.float32),
        rowptr=put(rowptr, np.int32),
        work=pmm_kernels.pmm_work(rowptr, device=device),
        shape=tuple(plan.shape),
        nnz=plan.nnz,
        nchunks=plan.nchunks,
        npairs=plan.npairs,
        nrt=plan.nrt,
    )


def kernel_args(dev: PmmDevice, X: torch.Tensor) -> tuple:
    """K14's arguments for X (f32, contiguous)."""
    return dev.col, dev.val, dev.rowptr, X, dev.work


def spmm_pmm(dev: PmmDevice, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X (ncols, K) on dev's device; any K."""
    X = X.to(torch.float32).contiguous()
    return pmm_kernels.pmm_spmm(*kernel_args(dev, X))
