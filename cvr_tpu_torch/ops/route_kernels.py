"""The routed SpMV's, the routed SpMM's and the route library's device
passes: thirteen wrappers over the Hopper kernels of route_kernels.cu
(K1's kernel also runs the ring steps of K15 and K5's the brute middle
K17; K2 has two bodies, its split one of two passes; K3, K3w and K18 add
a second pass for their split slices).

Each pass has three parts side by side:

  * a wrapper (``expand``, ``route_middle``, ``reduce_slices``,
    ``route_small``, ``tileperm``, ``route_m3``, ``reduce_hot``,
    ``expand_ring``, ``route_flat``, ``groupperm``, ``reduce_stream``,
    ``reduce_slices_cols``, ``route_small_cols``)
    that launches the CUDA kernel of
    cvr_tpu_torch/csrc/route_kernels.cu for CUDA tensors and counts the
    launch in its ``launches`` attribute.  A wrapper given CPU tensors
    runs the plain version instead, and only then: on a CUDA tensor it
    launches or raises;
  * the plain PyTorch version (``*_plain``) of the same function, written
    with advanced indexing and int16 planes widened to int64: the CPU path
    and the reference each kernel is held against on the card;
  * an entry in KERNELS naming the TPU kernels it replaces (none for K3w
    and K4w, which the JAX package's vmapped SpMV stands in for).

Layouts: see cvr_tpu_torch/ops/route_planes.py.  The stream<->mstream,
stream<->middle and flat<->stream relayouts are plain tensor permutes.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from cvr_tpu_torch.ops import route_planes as rp
from cvr_tpu_torch.utils.profiling import span

SOURCE = "cvr_tpu_torch/csrc/route_kernels.cu"


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def flat_to_stream(v: torch.Tensor, T: int) -> torch.Tensor:
    """(T*1024,) -> (8, T, 128) stream layout."""
    return v.reshape(T, 8, 128).permute(1, 0, 2)


def stream_to_flat(g: torch.Tensor) -> torch.Tensor:
    """(8, T, 128) -> (T*1024,)."""
    return g.permute(1, 0, 2).reshape(-1)


def stream_to_mstream(g: torch.Tensor, Tk: int) -> torch.Tensor:
    """(8,T,128) [qh, a, ql] -> (8, Tk*1024, 128) [pH, ca*1024+q, pL]
    where a = ca*1024 + p (p = within-chunk position)."""
    h = g.reshape(8, Tk, 8, 128, 128)  # [qh, ca, pH, pL, ql]
    return h.permute(2, 1, 0, 4, 3).reshape(8, Tk * 1024, 128)


def mstream_to_stream(m: torch.Tensor, Tk: int) -> torch.Tensor:
    """(8, Tk*1024, 128) [fH, cd*1024+q, fL] -> (8,T,128) [qh, d, ql]
    where d = cd*1024 + f."""
    h = m.reshape(8, Tk, 8, 128, 128)  # [fH, cd, qh, ql, fL]
    return h.permute(2, 1, 0, 4, 3).reshape(8, Tk * 1024, 128)


def stream_to_middle(g: torch.Tensor) -> torch.Tensor:
    """(8, T, 128) [qh, a, ql] -> (K, 1024, 128) [k, q, l], T = K*128,
    a = k*128 + l, q = qh*128 + ql."""
    K = g.shape[1] // 128
    return g.reshape(8, K, 128, 128).permute(1, 0, 3, 2).reshape(K, 1024, 128)


def middle_to_stream(m: torch.Tensor) -> torch.Tensor:
    """(K, 1024, 128) [k, q, l] -> (8, K*128, 128) [qh, a, ql]."""
    K = m.shape[0]
    return m.reshape(K, 8, 128, 128).permute(1, 0, 3, 2).reshape(8, K * 128, 128)


def source_index(gather, shape, device) -> torch.Tensor:
    """For each output of ``gather``, a plain version that only moves
    values of its one data input (of ``shape``) or writes 0: the flat
    position in that input of the value it moves there, or -1 where it
    writes 0 (int64, the output's shape).  ``gather`` runs once on data
    that holds its own 1-based flat positions in float64 (exact below
    2**53), on ``device``."""
    n = int(np.prod(shape))
    pos = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    return gather(pos.view(shape)).long() - 1


def expand_x_table(x: torch.Tensor, segw: int, n_segs: int) -> torch.Tensor:
    """The TPU expand kernel's x table: per-segment row ranges of x as
    (rows, 128), each with an 8-row halo (segw*8 + 8 rows per segment)."""
    segw8 = segw * 8
    xp = F.pad(x, (0, (n_segs * segw8 + 8) * 128 - x.shape[0])).reshape(-1, 128)
    if n_segs == 1:
        return xp
    return torch.cat(
        [xp[s * segw8 : s * segw8 + segw8 + 8] for s in range(n_segs)]
    )


# ---------------------------------------------------------------------------
# launching
# ---------------------------------------------------------------------------


def _on_card(name: str, *tensors: torch.Tensor, planes=(),
             views=()) -> bool:
    """True when the pass gets CUDA tensors (launch the kernel), False for
    CPU tensors (run the plain version); raise on anything else.
    ``planes``: (P, rows, 128) tensors that may be row slices of larger
    planes (their rows contiguous, read in place) where ``tensors`` must
    be contiguous; ``views``: tensors whose layout the caller checks."""
    devs = {t.device for t in (*tensors, *planes, *views)}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: tensors on mixed devices {sorted(map(str, devs))}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for t in planes:
        if t.stride()[1:] != (128, 1):
            raise ValueError(f"{name}: plane rows must be contiguous")
    return True


def _check_dtype(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless each tensor's data starts on a 16 B boundary (the
    kernel moves it in 16 B pieces)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: a tensor is not 16 B aligned")


INT32_MAX = 2**31 - 1
# shared memory a block may take on the H100 (227 KB, dynamic, opted in)
SMEM_MAX = 232_448


def expand_blocks(T: int, n: int, xlen: int) -> int:
    """K1's and K15's launch geometry: the blocks (of 128 threads, one
    per tile) over the n tiles launched, in a stream of T tiles read from
    an x of xlen elements.  The kernel's index arithmetic is 32-bit, so it
    raises when 8*T*128 or xlen exceeds 2**31 - 1 (pack_auto's routed cap,
    T 98304, is far below), and when n is not in [0, T]."""
    if 8 * T * 128 > INT32_MAX or xlen > INT32_MAX:
        raise ValueError(f"expand: 8*T*128 = {8 * T * 128} or xlen {xlen} "
                         "exceeds the kernel's 32-bit indices")
    if not 0 <= n <= T:
        raise ValueError(f"expand: {n} tiles of the stream's {T}")
    return n


def _launch(fn: str, device: torch.device, *args) -> None:
    from cvr_tpu_torch.ops import _build

    lib = _build.load()
    with span("launch", fn), torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# K1 expand: windowed x gather with route stage 1 fused
# ---------------------------------------------------------------------------


def expand_plain(w8, gcls, seg_blk, li, x, segw: int, n_segs: int):
    """g1 (8, T, 128): for idx = li[i,t,l], the x value at column
    128*(seg*segw*8 + w8[t] + (idx>>7)) + (idx&127) of tile t's segment,
    or 0 where idx>>7 is not below the tile group's class gcls[t>>3]."""
    T = w8.shape[0]
    x2 = expand_x_table(x, segw, n_segs)
    idx = li.long()
    hi, lo = idx >> 7, idx & 127
    row = (seg_blk.long() * (segw * 8 + 8)).repeat_interleave(rp.TB)[:T]
    row = (row + w8.long()).view(1, T, 1)
    ncand = gcls.long().repeat_interleave(8).view(1, T, 1)
    return torch.where(hi < ncand, x2[row + hi, lo], 0.0)


def expand(w8, gcls, seg_blk, li, x, segw: int, n_segs: int):
    """K1: the expanded x stream g1 (8, T, 128); see expand_plain.

    w8 (T,) int32 segment-relative sublane bases; gcls (T//8,) int32
    gather classes; seg_blk (T//TB,) int32 x segments; li (8, T, 128)
    int16 in-window offsets in [0, 1024) (stage 1 composed), 16 B
    aligned; x (ncols,) f32, at any offset.
    """
    if not _on_card("expand", w8, gcls, seg_blk, li, x):
        return expand_plain(w8, gcls, seg_blk, li, x, segw, n_segs)
    for t, dt in ((w8, torch.int32), (gcls, torch.int32),
                  (seg_blk, torch.int32), (li, torch.int16),
                  (x, torch.float32)):
        _check_dtype("expand", t, dt)
    T = w8.shape[0]
    if T % rp.TB or li.shape != (8, T, 128):
        raise ValueError("expand: tiles must be padded to TB, li (8, T, 128)")
    expand_blocks(T, T, x.shape[0])
    _check_aligned("expand", li)
    g1 = torch.empty((8, T, 128), dtype=torch.float32, device=x.device)
    if T:
        _launch("cvr_expand", x.device, _p(li), _p(w8), _p(gcls),
                _p(seg_blk), _p(x), _p(g1), T, 0, T, 0, segw * 8,
                x.shape[0], rp.TB)
        expand.launches += 1
    return g1


expand.launches = 0


# ---------------------------------------------------------------------------
# K15 expand_ring: one ring step of the overlapped expand (row-sharded path)
# ---------------------------------------------------------------------------


def expand_ring_plain(w8_s, gcls_s, seg_s, li, xg, off: int, k_lo: int,
                      segw: int):
    """(8, cnt*TB, 128): expand_plain's function over the tile blocks
    [off, off+cnt) of li (8, T, 128), cnt = len(seg_s), reading x from the
    gathered-x buffer xg (rows, 128) at the ring step's table base k_lo:
    block b's segment is k_lo + seg_s[b], and a row past xg reads 0."""
    n = seg_s.shape[0] * rp.TB
    segw8 = segw * 8
    idx = li[:, off * rp.TB : off * rp.TB + n, :].long()
    hi, lo = idx >> 7, idx & 127
    row = ((k_lo + seg_s.long()) * segw8).repeat_interleave(rp.TB)
    row = (row + w8_s.long()).view(1, n, 1) + hi
    ncand = gcls_s.long().repeat_interleave(8).view(1, n, 1)
    ok = (hi < ncand) & (row < xg.shape[0])
    return torch.where(ok, xg[row.clamp(max=xg.shape[0] - 1), lo], 0.0)


def expand_ring(w8_s, gcls_s, seg_s, li, xg, off: int, k_lo: int,
                segw: int, g1):
    """K15 (K1's kernel over the step's blocks, counted apart): one ring
    step's expand into g1 (8, T, 128) f32, columns
    [off*TB, (off+cnt)*TB); returns that view.  w8_s (cnt*TB,), gcls_s
    (cnt*TB//8,) and seg_s (cnt,) int32 are the step's slices of the
    shard's w8, gcls and seg_ring; li (8, T, 128) int16 is whole; xg
    (rows, 128) f32 is the shard's gathered-x buffer.  See
    expand_ring_plain."""
    cnt = seg_s.shape[0]
    step = g1[:, off * rp.TB : (off + cnt) * rp.TB]
    if not _on_card("expand_ring", w8_s, gcls_s, seg_s, li, xg, g1):
        step.copy_(expand_ring_plain(w8_s, gcls_s, seg_s, li, xg, off,
                                     k_lo, segw))
        return step
    for t, dt in ((w8_s, torch.int32), (gcls_s, torch.int32),
                  (seg_s, torch.int32), (li, torch.int16),
                  (xg, torch.float32), (g1, torch.float32)):
        _check_dtype("expand_ring", t, dt)
    T = li.shape[1]
    n = cnt * rp.TB
    if (li.shape != (8, T, 128) or g1.shape != li.shape
            or xg.dim() != 2 or xg.shape[1] != 128
            or w8_s.shape != (n,) or gcls_s.shape != (n // 8,)
            or not 0 <= off <= off + cnt <= T // rp.TB):
        raise ValueError("expand_ring: the step's slices must cover blocks "
                         "[off, off+cnt) of li and g1 (8, T, 128)")
    expand_blocks(T, n, xg.numel())
    _check_aligned("expand_ring", li, g1)
    if cnt:
        _launch("cvr_expand", xg.device, _p(li), _p(w8_s), _p(gcls_s),
                _p(seg_s), _p(xg), _p(g1), T, off * rp.TB, n, k_lo,
                segw * 8, xg.numel(), rp.TB)
        expand_ring.launches += 1
    return step


expand_ring.launches = 0


# ---------------------------------------------------------------------------
# K2 route_middle: M1 (relayout + within-chunk perm) + M2 (chunk select)
# ---------------------------------------------------------------------------


def route_middle_plain(g1, m1, csel):
    """mstream (8, T, 128): mid[i, cd*1024+Q, l] =
    g1[Q>>7, ca*1024 + m1[i, ca*1024+Q, l], Q&127], ca = csel[i, cd*1024+Q, l]
    (0 where ca is not a chunk)."""
    T = g1.shape[1]
    Tk = T // 1024
    ca = csel.long()
    valid = (ca >= 0) & (ca < Tk)
    ca = ca.clamp(0, Tk - 1)
    Q = (torch.arange(T, device=g1.device) % 1024).view(1, T, 1)
    m = torch.gather(m1.long(), 1, ca * 1024 + Q)
    return torch.where(valid, g1[Q >> 7, ca * 1024 + m, Q & 127], 0.0)


# K2's bodies (route_kernels.cu) and the launches each takes
ROUTE_MIDDLE_LAUNCHES = {"staged": 1, "split": 2}


def route_middle_geometry(T: int, body: str | None = None) -> str:
    """K2's body for a middle of T = Tk*1024 rows: "staged" (one launch)
    where the strip of g1 it stages, 8 lanes of T rows in columns padded
    by 4 rows (8*(T+4)*4 B), fits a block's shared memory (SMEM_MAX: T up
    to 7168, Tk 7), else "split" (M1 per chunk, then the chunk select: two
    launches, any Tk).  ``body`` names one instead (the benchmarks time
    both).  Raise where the kernels' 32-bit indices cannot reach 8*T*128
    elements (T past 2,097,151) or a staged strip does not fit."""
    if 8 * T * 128 > INT32_MAX:
        raise ValueError(f"route_middle: planes of {T} rows exceed the "
                         "kernel's 32-bit indices")
    smem = 8 * (T + 4) * 4
    if body is None:
        body = "staged" if smem <= SMEM_MAX else "split"
    if body not in ROUTE_MIDDLE_LAUNCHES:
        raise ValueError(f"route_middle: no body {body!r}")
    if body == "staged" and smem > SMEM_MAX:
        raise ValueError(f"route_middle: a strip of {T} rows takes {smem} B "
                         f"of shared memory, a block at most {SMEM_MAX}")
    return body


def route_middle(g1, m1, csel, body: str | None = None):
    """K2: the recursive route middle's M1 and chunk-select stages on
    g1 (8, Tk*1024, 128) f32 with planes m1, csel (8, Tk*1024, 128) int16,
    16 B aligned, any Tk; see route_middle_plain (m1 holds a permutation
    of each chunk's rows: the kernels read m & 1023).  The body is
    route_middle_geometry's (``body`` forces one): one launch staged, two
    split.  M3 is fused into reduce_slices."""
    if not _on_card("route_middle", g1, m1, csel):
        return route_middle_plain(g1, m1, csel)
    _check_dtype("route_middle", g1, torch.float32)
    _check_dtype("route_middle", m1, torch.int16)
    _check_dtype("route_middle", csel, torch.int16)
    T = g1.shape[1]
    if T % 1024 or g1.shape != (8, T, 128) or m1.shape != g1.shape or (
        csel.shape != g1.shape
    ):
        raise ValueError("route_middle: planes must be (8, Tk*1024, 128)")
    body = route_middle_geometry(T, body)
    _check_aligned("route_middle", g1, m1, csel)
    out = torch.empty_like(g1)
    if not T:
        return out
    if body == "staged":
        _launch("cvr_route_middle", g1.device, _p(g1), _p(m1), _p(csel),
                _p(out), T, T // 1024)
        route_middle.launches += 1
        return out
    m1out = torch.empty_like(g1)
    _launch("cvr_route_middle_m1", g1.device, _p(g1), _p(m1), _p(m1out), T)
    route_middle.launches += 1
    _launch("cvr_route_middle_select", g1.device, _p(m1out), _p(csel),
            _p(out), T, T // 1024)
    route_middle.launches += 1
    return out


route_middle.launches = 0


# ---------------------------------------------------------------------------
# K3 reduce_slices: route middle + M3 + relayout + stage 3 + x vals + sums,
# one gather from g1 by the index composed at upload
# ---------------------------------------------------------------------------


def reduce_products_plain(m, m3, vals, p3, rows, fast):
    """P (8, len(rows), 128): the products of plane rows ``rows`` (int64)
    as the TPU stages them, from the mstream m (the route middle's output)
    with stage 3 aligned (``fast``, bool per row) on zone-A rows: the
    chain reduce_index and reduce_plan compose into K3's index.

    For row R: c = R>>7, fL = R&127, base = (c>>3)*1024,
    idx = p3[i,R,l], hi = i if fast else idx>>7, q = base + (hi<<7 | idx&127),
    i3 = m3[c&7, q, fL], P = vals[i,R,l] * m[i3>>7, q, i3&127]."""
    c = (rows >> 7).view(1, -1, 1)
    fL = (rows & 127).view(1, -1, 1)
    idx = p3[:, rows, :].long()
    sub = torch.arange(8, device=m.device).view(8, 1, 1)
    hi = torch.where(fast.view(1, -1, 1), sub, idx >> 7)
    q = ((c >> 3) << 10) + ((hi << 7) | (idx & 127))
    i3 = m3[c & 7, q, fL].long()
    return vals[:, rows, :] * m[i3 >> 7, q, i3 & 127]


def slice_rows(row0, row1):
    """(item, rows) int64 over every slice item's plane rows [row0[k],
    row1[k]): plane row rows[j] belongs to item item[j]."""
    row0, row1 = row0.long(), row1.long()
    counts = row1 - row0
    item = torch.repeat_interleave(
        torch.arange(row0.shape[0], device=row0.device), counts
    )
    first = torch.cumsum(counts, 0) - counts
    rows = row0[item] + torch.arange(item.shape[0], device=row0.device) - first[item]
    return item, rows


def slice_sums(P, item, out, nys: int):
    """ys (8, nys, 128, ...): ys[:, out[k]] = the sum of the products P
    (8, len(item), 128, ...) of item k, in item order; slices no item
    names stay zero."""
    rest = tuple(P.shape[2:])
    sums = torch.zeros((8, out.shape[0], *rest), dtype=P.dtype,
                       device=P.device)
    sums.index_add_(1, item, P)
    ys = torch.zeros((8, nys, *rest), dtype=P.dtype, device=P.device)
    ys[:, out.long()] = sums
    return ys


def gather_or_zero(data, idx):
    """data's flat elements at the int index idx, 0.0 where idx is not in
    [0, data.numel()) (-1 in the composed indices, and a column at or past
    x's end in K3's x plan)."""
    flat = data.reshape(-1)
    ix = idx.long()
    ok = (ix >= 0) & (ix < flat.shape[0])
    return torch.where(ok, flat[ix.clamp(0, flat.shape[0] - 1)], 0.0)


def reduce_index(m3, p3, row0, row1, fast):
    """(8, S, 128) int32: the staged chain's index into the mstream.  For
    each element of a plane row that slice k names, the flat position in
    the mstream m (8, TM, 128) of the element it multiplies
    (reduce_products_plain's m[i3>>7, q, i3&127]: stage 3 by p3, aligned
    on zone-A slices, then the M3 plane m3); 0 on the rows no slice
    names, which are never read."""
    TM = m3.shape[1]
    if 8 * TM * 128 > INT32_MAX:
        raise ValueError(f"reduce_slices: an mstream of {TM} rows exceeds "
                         "the kernel's 32-bit indices")
    item, rows = slice_rows(row0, row1)
    c = (rows >> 7).view(1, -1, 1)
    fL = (rows & 127).view(1, -1, 1)
    idx = p3[:, rows, :].long()
    sub = torch.arange(8, device=p3.device).view(8, 1, 1)
    hi = torch.where(fast.bool()[item].view(1, -1, 1), sub, idx >> 7)
    q = ((c >> 3) << 10) + ((hi << 7) | (idx & 127))
    i3 = m3[c & 7, q, fL].long()
    out = torch.zeros(p3.shape, dtype=torch.int32, device=p3.device)
    out[:, rows, :] = (((i3 >> 7) * TM + q) * 128 + (i3 & 127)).int()
    return out


@dataclass(frozen=True)
class Split:
    """A reduce's items cut into pieces of at most ``rows`` rows
    (split_rows), on the kernel's device.  pieces (npieces, 3) int32: a
    piece's first row, end row and destination (the item's output >= 0
    when the item is one piece, else -1 - the piece's partial); combine
    (nsplit, 3) int32: a split item's first partial, end partial and
    output.  The partials of an item are consecutive, in row order."""

    pieces: torch.Tensor
    combine: torch.Tensor
    npart: int
    rows: int


def split_rows(row0, row1, out, rows: int):
    """(pieces, combine) int32 numpy arrays of Split: item k's row range
    [row0[k], row1[k]) cut into ceil(n/rows) pieces (one if it is empty)
    whose sizes differ by at most 1, in row order."""
    if rows < 1:
        raise ValueError(f"split_rows: pieces of {rows} rows")
    row0 = np.asarray(row0, dtype=np.int64)
    out = np.asarray(out, dtype=np.int64)
    n = np.asarray(row1, dtype=np.int64) - row0
    if (n < 0).any():
        raise ValueError("split_rows: a row range ends before it starts")
    npc = np.maximum(1, -(-n // rows))
    item = np.repeat(np.arange(n.shape[0]), npc)
    first = np.cumsum(npc) - npc  # each item's first piece
    j = np.arange(item.shape[0]) - first[item]
    p0 = row0[item] + j * n[item] // npc[item]
    p1 = row0[item] + (j + 1) * n[item] // npc[item]
    split = npc[item] > 1
    part = np.cumsum(split) - 1  # partial of each split item's piece
    pieces = np.stack([p0, p1, np.where(split, -1 - part, out[item])], 1)
    multi = np.flatnonzero(npc > 1)
    c0 = part[first[multi]]
    combine = np.stack([c0, c0 + npc[multi], out[multi]], 1)
    return (np.ascontiguousarray(pieces, dtype=np.int32).reshape(-1, 3),
            np.ascontiguousarray(combine, dtype=np.int32).reshape(-1, 3))


def make_split(row0, row1, out, rows: int, device) -> Split:
    """split_rows of the tables (tensors on any device), on ``device``."""
    pieces, combine = split_rows(*(t.cpu().numpy() for t in (row0, row1, out)),
                                 rows)
    return Split(pieces=torch.from_numpy(pieces).to(device),
                 combine=torch.from_numpy(combine).to(device),
                 npart=int((pieces[:, 2] < 0).sum()), rows=rows)


# plane rows a K3 piece sums at most (a slice of more rows is split)
REDUCE_PIECE_ROWS = 16


@dataclass(frozen=True)
class ReducePlan:
    """What K3 reads in place of the route middle's planes, p3, the M3
    plane and the slice table, made at upload (reduce_plan, then
    reduce_plan_x): the composed index into its source and the pieces;
    the table (row0, row1, out: slice k sums plane rows [row0[k],
    row1[k]) into ys[:, out[k]]), which the plain version reads.

    ``source`` names what idx indexes, and the wrapper refuses the other:
    "g1", the flat positions of the expanded stream g1 (8, T, 128) that
    K1 or the ring's K15 write; "x", the columns of x itself, K1's window
    map composed in as well, so that no g1 is written."""

    idx: torch.Tensor  # (8, S, 128) int32 into the source, -1: a 0 factor
    split: Split
    T: int  # the rows of the stream g1 the index was composed through
    row0: torch.Tensor  # (n_items,) int32
    row1: torch.Tensor
    out: torch.Tensor
    source: str = "g1"


def reduce_plan(src, m3, p3, row0, row1, out, fast) -> ReducePlan:
    """K3's plan for the slice table (row0, row1, out, fast) over the
    planes p3 and m3, on their device: the staged chain's index into the
    mstream (reduce_index) pushed through ``src``, the route middle's map
    from the mstream to g1 (source_index of route_middle_plain or of the
    flat kind's relayout: -1 where the middle writes 0), so that K3
    gathers from g1 itself; pieces of at most REDUCE_PIECE_ROWS rows."""
    if src.shape != m3.shape:
        raise ValueError("reduce_plan: the middle's map must cover the "
                         "mstream")
    idx = src.reshape(-1)[reduce_index(m3, p3, row0, row1, fast).long()]
    return ReducePlan(idx=idx.int(),
                      split=make_split(row0, row1, out, REDUCE_PIECE_ROWS,
                                       p3.device),
                      T=m3.shape[1], row0=row0, row1=row1, out=out)


def expand_source(w8, gcls, seg_blk, li, segw: int) -> torch.Tensor:
    """K1's map, (8, T, 128) int64 on the planes' device: for each element
    of g1, the column of x that K1 copies there,
    128*(seg_blk[t/TB]*segw*8 + w8[t]) + li[i,t,l], or -1 where K1 writes 0
    by the tile group's gather class (li not in [0, 128*gcls[t>>3]), the
    class taken in [0, 8] as the kernel takes it).  Not cut at ncols: K1
    reads x as 0 at and past its length, and so does K3 by the x plan."""
    T = w8.shape[0]
    idx = li.long()
    base = seg_blk.long().repeat_interleave(rp.TB)[:T] * (segw * 8)
    base = (base + w8.long()).view(1, T, 1)
    lim = 128 * gcls.long().clamp(0, 8).repeat_interleave(8).view(1, T, 1)
    return torch.where((idx >= 0) & (idx < lim), 128 * base + idx, -1)


def reduce_plan_x(plan: ReducePlan, col) -> ReducePlan:
    """The g1 plan ``plan`` pushed through K1's map ``col``
    (expand_source): the same pieces and table, the index naming the
    column of x each factor comes from (-1 stays -1), so that K3 gathers x
    itself and K1 is not launched.  Raise where a column is past the
    kernel's 32-bit indices."""
    if plan.source != "g1" or col.shape != (8, plan.T, 128):
        raise ValueError("reduce_plan_x: a g1 plan and K1's map over its g1")
    g = plan.idx.long()
    xi = torch.where(g >= 0, col.reshape(-1)[g.clamp(min=0)], -1)
    top = int(xi.max()) if xi.numel() else -1
    if top > INT32_MAX:
        raise ValueError(f"reduce_slices: column {top} of x exceeds the "
                         "kernel's 32-bit indices")
    return dataclasses.replace(plan, idx=xi.int(), source="x")


def reduce_geometry(S: int, T: int, nys: int, npart: int) -> None:
    """Raise where K3's 32-bit index arithmetic cannot reach: planes of S
    rows, a stream g1 of T rows, ys of nys slices or npart partial rows
    (8 x rows x 128 elements each)."""
    for what, rows in (("planes", S), ("g1", T), ("ys", nys),
                       ("partials", npart)):
        if 8 * rows * 128 > INT32_MAX:
            raise ValueError(f"reduce_slices: {what} of {rows} rows exceed "
                             "the kernel's 32-bit indices")


def reduce_slices_plain(src, vals, plan: ReducePlan, nys: int):
    """ys (8, nys, 128): ys[:, out[k], :] = sum over the plane rows
    [row0[k], row1[k]) of the plan's table of vals times the element of
    src (x or g1, as plan.source says) that the composed index names (0
    where it names none: -1, or a column at or past x's end).  Bit for
    bit the staged chain's sums (reduce_products_plain on the route
    middle's output), since K1 and the middle only move x's values."""
    item, rows = slice_rows(plan.row0, plan.row1)
    P = vals[:, rows, :] * gather_or_zero(src, plan.idx[:, rows, :])
    return slice_sums(P, item, plan.out, nys)


def _check_source(src, plan: ReducePlan) -> None:
    """Raise unless src is what plan.idx indexes: x (ncols,) for an x
    plan, g1 (8, plan.T, 128) for a g1 plan."""
    if plan.source == "x":
        ok = src.dim() == 1
    elif plan.source == "g1":
        ok = src.shape == (8, plan.T, 128)
    else:
        raise ValueError(f"reduce_slices: no source {plan.source!r}")
    if not ok:
        raise ValueError(f"reduce_slices: the plan indexes {plan.source}, "
                         f"given a tensor of shape {tuple(src.shape)}")


def reduce_slices(src, vals, plan: ReducePlan, nys: int):
    """K3: per-slice lane sums ys (8, nys, 128) from the plan's source
    (x (ncols,) f32 for an x plan, the expanded stream g1 (8, T, 128) f32
    for a g1 plan) and the value planes vals (8, S_pad, 128) f32, by the
    plan made at upload (reduce_plan: the index composed through the
    route middle, M3 and stage 3, and for x through K1's window map too,
    reduce_plan_x; the slices cut into pieces); see reduce_slices_plain.
    On the card: two launches, the second adding the split slices'
    partials."""
    _check_source(src, plan)
    split = plan.split
    if not _on_card("reduce_slices", src, vals, plan.idx, split.pieces,
                    split.combine):
        return reduce_slices_plain(src, vals, plan, nys)
    for t, dt in ((src, torch.float32), (vals, torch.float32),
                  (plan.idx, torch.int32), (split.pieces, torch.int32),
                  (split.combine, torch.int32)):
        _check_dtype("reduce_slices", t, dt)
    S = vals.shape[1]
    if vals.shape != (8, S, 128) or plan.idx.shape != vals.shape:
        raise ValueError("reduce_slices: plane shapes disagree with the plan")
    if src.numel() > INT32_MAX:
        raise ValueError(f"reduce_slices: a source of {src.numel()} "
                         "elements exceeds the kernel's 32-bit indices")
    reduce_geometry(S, plan.T if plan.source == "g1" else 0, nys,
                    split.npart)
    _check_aligned("reduce_slices", vals, plan.idx)
    ys = torch.zeros((8, nys, 128), dtype=torch.float32, device=src.device)
    part = torch.empty((8, split.npart, 128), dtype=torch.float32,
                       device=src.device)
    n = split.pieces.shape[0]
    if n:
        _launch("cvr_reduce_slices", src.device, _p(src), src.numel(),
                _p(plan.idx), _p(vals), _p(split.pieces), _p(ys), _p(part),
                n, S, nys, split.npart)
        reduce_slices.launches += 1
    if split.combine.shape[0]:
        _launch("cvr_reduce_slices_combine", src.device, _p(part),
                _p(split.combine), _p(ys), split.combine.shape[0], nys,
                split.npart)
        reduce_slices.launches += 1
    return ys


reduce_slices.launches = 0


# ---------------------------------------------------------------------------
# K4 route_small: a whole route (stage 1 + middle + stage 3) in one gather
# by the index composed at upload
# ---------------------------------------------------------------------------


def route_small_chain(ysp, s1, mid, s3, n: int):
    """y (n,) = the route of the stream ysp (8, 1024, 128) by its stage
    planes s1, mid (flat middle) and s3, flattened to natural order: the
    three-stage chain the TPU runs for a flat route, written as three
    gathers."""
    r = torch.arange(1024, device=ysp.device).view(1, 1024, 1)
    s1l = s1.long()
    g = ysp[s1l >> 7, r, s1l & 127]  # stage 1, [q>>7, a, q&127]
    g = g[r >> 7, mid.long(), r & 127]  # middle, [d>>7, q, d&127]
    y = g[r >> 7, s3.long(), r & 127]  # stage 3, [o>>7, d, o&127]
    return stream_to_flat(y)[:n]


def route_small_plain(ysp, src, n: int):
    """y (n,) = ysp's flat elements at src, 0 where src is -1: the staged
    route's function (stage 1, middle, stage 3) for src composed from the
    same planes (spmv_routed.compose_route)."""
    return gather_or_zero(ysp, src)


def route_small_geometry(Tp: int, n: int) -> None:
    """Raise unless K4 takes a stream of Tp tiles (8*Tp*128 elements,
    reached by 32-bit indices) and n outputs, at most one per element."""
    if 8 * Tp * 128 > INT32_MAX:
        raise ValueError(f"route_small: a y stream of {Tp} tiles exceeds the "
                         "kernel's 32-bit indices")
    if not 0 <= n <= Tp * 1024:
        raise ValueError(f"route_small: {n} outputs of a {Tp}-tile route")


def route_small(ysp, src, n: int):
    """K4: y (n,) from ysp (8, Tp, 128) f32, any Tp, by the int32 index
    src (n,) into its flat elements (-1: y is 0 there), 16 B aligned: a
    route's stages composed at upload (RouteDevice.src); see
    route_small_plain."""
    if not _on_card("route_small", ysp, src):
        return route_small_plain(ysp, src, n)
    _check_dtype("route_small", ysp, torch.float32)
    _check_dtype("route_small", src, torch.int32)
    Tp = ysp.shape[1]
    if ysp.shape != (8, Tp, 128) or src.shape != (n,):
        raise ValueError("route_small: the stream is (8, Tp, 128) with one "
                         "index per output")
    route_small_geometry(Tp, n)
    _check_aligned("route_small", src)
    y = torch.empty(n, dtype=torch.float32, device=ysp.device)
    if n:
        _launch("cvr_route_small", ysp.device, _p(ysp), _p(src), _p(y), n)
        route_small.launches += 1
    return y


route_small.launches = 0


# ---------------------------------------------------------------------------
# K3w reduce_slices_cols and K4w route_small_cols: K3 and K4 over a tile of
# up to COLS_TILE columns of X, the routed SpMM's passes
# ---------------------------------------------------------------------------

# columns of X a tile holds at most (one 32 B sector of a float32 row)
COLS_TILE = 8


def gather_rows_or_zero(data, idx):
    """(*idx.shape, KT): the rows of data (n, KT) at the int index idx,
    zero rows where idx is not in [0, n) (gather_or_zero a column at a
    time)."""
    ix = idx.long()
    n = data.shape[0]
    ok = (ix >= 0) & (ix < n)
    return torch.where(ok[..., None], data[ix.clamp(0, max(n - 1, 0))], 0.0)


def reduce_slices_cols_plain(X, vals, plan: ReducePlan, nys: int):
    """ys (8, nys, 128, KT): column c is reduce_slices_plain of X[:, c] by
    the x plan ``plan``, bit for bit (the same products, summed in the
    same item order)."""
    item, rows = slice_rows(plan.row0, plan.row1)
    P = vals[:, rows, :, None] * gather_rows_or_zero(X, plan.idx[:, rows, :])
    return slice_sums(P, item, plan.out, nys)


def _check_cols(name: str, t: torch.Tensor, what: str) -> tuple[int, int]:
    """(rows, row stride) of a float32 tile t (rows, KT), 1 <= KT <=
    COLS_TILE, its columns side by side (unit column stride); raise where
    its last element lies past the kernels' 32-bit indices."""
    _check_dtype(name, t, torch.float32)
    if t.dim() != 2 or not 1 <= t.shape[1] <= COLS_TILE:
        raise ValueError(f"{name}: {what} is (rows, KT) with 1 <= KT <= "
                         f"{COLS_TILE}, given {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: {what}'s columns must lie side by side")
    ld = t.stride(0) if t.shape[0] > 1 else t.shape[1]
    if ld < t.shape[1]:
        raise ValueError(f"{name}: {what}'s rows overlap")
    end = (t.shape[0] - 1) * ld + t.shape[1] if t.shape[0] else 0
    if end > INT32_MAX:
        raise ValueError(f"{name}: {what} of {end} elements exceeds the "
                         "kernel's 32-bit indices")
    return t.shape[0], ld


def reduce_slices_cols(X, vals, plan: ReducePlan, nys: int):
    """K3w: per-slice lane sums ys (8, nys, 128, KT) of the tile X (ncols,
    KT) f32, KT <= COLS_TILE, read in place (a view of a wider X with its
    columns side by side), by K3's x plan; see reduce_slices_cols_plain.
    Column c equals reduce_slices(X[:, c], vals, plan, nys) bit for bit on
    the card too.  On the card: two launches, the second adding the split
    slices' partials."""
    name = "reduce_slices_cols"
    if plan.source != "x":
        raise ValueError(f"{name}: the plan indexes {plan.source}, not the "
                         "columns of x")
    nx, ldx = _check_cols(name, X, "X")
    split = plan.split
    for t, dt in ((vals, torch.float32), (plan.idx, torch.int32),
                  (split.pieces, torch.int32), (split.combine, torch.int32)):
        _check_dtype(name, t, dt)
    KT, S = X.shape[1], vals.shape[1]
    if vals.shape != (8, S, 128) or plan.idx.shape != vals.shape:
        raise ValueError(f"{name}: plane shapes disagree with the plan")
    reduce_geometry(S, 0, nys * KT, split.npart * KT)
    if not _on_card(name, vals, plan.idx, split.pieces, split.combine,
                    views=(X,)):
        return reduce_slices_cols_plain(X, vals, plan, nys)
    ys = torch.zeros((8, nys, 128, KT), dtype=torch.float32, device=X.device)
    part = torch.empty((8, split.npart, 128, KT), dtype=torch.float32,
                       device=X.device)
    n = split.pieces.shape[0]
    if n:
        _launch("cvr_reduce_slices_cols", X.device, _p(X), nx, ldx, KT,
                _p(plan.idx), _p(vals), _p(split.pieces), _p(ys), _p(part),
                n, S, nys, split.npart)
        reduce_slices_cols.launches += 1
    if split.combine.shape[0]:
        _launch("cvr_reduce_slices_cols_combine", X.device, _p(part),
                _p(split.combine), _p(ys), split.combine.shape[0], nys,
                split.npart, KT)
        reduce_slices_cols.launches += 1
    return ys


reduce_slices_cols.launches = 0


def route_small_cols_plain(ysp, src, n: int, out=None):
    """Y (n, KT): row e is the row of ysp (8, Tp, 128, KT) at its flat
    position src[e], zero where src is -1 (route_small_plain a column at a
    time); written into ``out`` where given."""
    y = gather_rows_or_zero(ysp.reshape(-1, ysp.shape[-1]), src)
    if out is None:
        return y
    return out.copy_(y)


def route_small_cols(ysp, src, n: int, out=None):
    """K4w: Y (n, KT) from ysp (8, Tp, 128, KT) f32 by K4's int32 index src
    (n,) (RouteDevice.src); written in place into ``out``,
    an (n, KT) tile of a wider Y with its columns side by side, where
    given.  See route_small_cols_plain."""
    name = "route_small_cols"
    _check_dtype(name, ysp, torch.float32)
    _check_dtype(name, src, torch.int32)
    if (ysp.dim() != 4 or (ysp.shape[0], ysp.shape[2]) != (8, 128)
            or src.shape != (n,)):
        raise ValueError(f"{name}: the stream is (8, Tp, 128, KT) with one "
                         "index per output")
    Tp, KT = ysp.shape[1], ysp.shape[3]
    route_small_geometry(Tp, n)
    if 8 * Tp * 128 * KT > INT32_MAX:
        raise ValueError(f"{name}: a y stream of {Tp} tiles of {KT} columns "
                         "exceeds the kernel's 32-bit indices")
    if out is not None:
        if out.shape != (n, KT):
            raise ValueError(f"{name}: out is {tuple(out.shape)}, the route "
                             f"gives {(n, KT)}")
        _check_cols(name, out, "out")
    if not _on_card(name, ysp, src, views=() if out is None else (out,)):
        return route_small_cols_plain(ysp, src, n, out)
    if out is None:
        out = torch.empty((n, KT), dtype=torch.float32, device=ysp.device)
    _, ldy = _check_cols(name, out, "out")
    if n:
        _launch("cvr_route_small_cols", ysp.device, _p(ysp), _p(src),
                _p(out), n, KT, ldy)
        route_small_cols.launches += 1
    return out


route_small_cols.launches = 0


# ---------------------------------------------------------------------------
# K5 tileperm: a within-tile permutation of a stream (route stages 1 and 3)
# ---------------------------------------------------------------------------


def tileperm_plain(data, idx):
    """out (P, T, 128): out[i,a,l] = data[v>>7, a, v&127] for
    v = idx[i,a,l], 0 where v is not in [0, P*128) (P 8 for a stream)."""
    P, T = data.shape[:2]
    v = idx.long()
    valid = (v >= 0) & (v < P * 128)
    v = v.clamp(0, P * 128 - 1)
    a = torch.arange(T, device=data.device).view(1, T, 1)
    return torch.where(valid, data[v >> 7, a, v & 127], 0.0)


def tileperm_geometry(P: int, R: int) -> int:
    """K5's and K17's launch geometry (one block per row of R, over P
    planes): the dynamic shared memory of a block, which stages its row's
    P plane rows of data (512 B each) and of index (256 B each).  Raise
    where the kernel's 32-bit indices cannot reach P*R*128 elements (K5:
    T past 2,097,151) or the row exceeds a block's shared memory (P past
    302; K17's int16 index reaches K 256, 192 KB)."""
    if P * R * 128 > INT32_MAX:
        raise ValueError(f"tileperm: {P} planes of {R} rows exceed the "
                         "kernel's 32-bit indices")
    smem = P * (128 * 4 + 128 * 2)
    if smem > SMEM_MAX:
        raise ValueError(f"tileperm: a row of {P} planes takes {smem} B of "
                         f"shared memory, a block at most {SMEM_MAX}")
    return smem


def tileperm(data, idx):
    """K5: route stage 1 or 3 of a y-route above 1024 tiles, on data
    (8, T, 128) f32 with the int16 plane idx (8, T, 128), both 16 B
    aligned; see tileperm_plain."""
    if not _on_card("tileperm", data, idx):
        return tileperm_plain(data, idx)
    _check_dtype("tileperm", data, torch.float32)
    _check_dtype("tileperm", idx, torch.int16)
    T = data.shape[1]
    if data.shape != (8, T, 128) or idx.shape != data.shape:
        raise ValueError("tileperm: data and idx must be (8, T, 128)")
    tileperm_geometry(8, T)
    _check_aligned("tileperm", data, idx)
    out = torch.empty_like(data)
    if T:
        _launch("cvr_tileperm", data.device, _p(data), _p(idx), _p(out), T,
                8, 0)
        tileperm.launches += 1
    return out


tileperm.launches = 0


# ---------------------------------------------------------------------------
# K6 route_m3: M3 (within-slab gather) + the mstream -> stream relayout
# ---------------------------------------------------------------------------


def route_m3_plain(m, m3):
    """(8, T, 128) stream: mstream_to_stream(gather_slabs(m, m3), Tk),
    where gather_slabs(m, m3)[i, r, l] = m[v>>7, r, v&127] for
    v = m3[i, r, l] is a tileperm over the mstream's rows."""
    return mstream_to_stream(tileperm_plain(m, m3), m.shape[1] // 1024)


def route_m3(m, m3):
    """K6: the recursive route middle's last stage on the mstream m
    (8, Tk*1024, 128) f32 with its int16 plane m3, relayout to a stream;
    see route_m3_plain."""
    if not _on_card("route_m3", m, m3):
        return route_m3_plain(m, m3)
    _check_dtype("route_m3", m, torch.float32)
    _check_dtype("route_m3", m3, torch.int16)
    T = m.shape[1]
    if T % 1024 or m.shape != (8, T, 128) or m3.shape != m.shape:
        raise ValueError("route_m3: planes must be (8, Tk*1024, 128)")
    out = torch.empty_like(m)
    if T:
        _launch("cvr_route_m3", m.device, _p(m), _p(m3), _p(out), T)
        route_m3.launches += 1
    return out


route_m3.launches = 0


# ---------------------------------------------------------------------------
# K7 reduce_hot: the hub-column hybrid's per-slice sums
# ---------------------------------------------------------------------------


def reduce_hot_plain(xh, hidx, hvals, row0, row1, out, nys: int):
    """ys (8, nys, 128): ys[:, out[k], :] = sum over plane rows
    [row0[k], row1[k]) of xh[hidx] * hvals (xh read as 0 past its end);
    slices no item names stay zero."""
    item, rows = slice_rows(row0, row1)
    v = hidx[:, rows, :].long()
    valid = (v >= 0) & (v < xh.shape[0])
    P = torch.where(valid, xh[v.clamp(0, xh.shape[0] - 1)], 0.0)
    return slice_sums(P * hvals[:, rows, :], item, out, nys)


def reduce_hot(xh, hidx, hvals, row0, row1, out, nys: int):
    """K7: per-slice sums ys (8, nys, 128) of the captured hot elements:
    the hot table xh (NH,) f32 = x[hot_ids], the rank plane hidx
    (8, S_hp, 128) int16 and the value plane hvals (8, S_hp, 128) f32.
    Slice k sums plane rows [row0[k], row1[k]) into ys[:, out[k]]; the
    tables are int32.  See reduce_hot_plain."""
    if not _on_card("reduce_hot", xh, hidx, hvals, row0, row1, out):
        return reduce_hot_plain(xh, hidx, hvals, row0, row1, out, nys)
    for t, dt in ((xh, torch.float32), (hidx, torch.int16),
                  (hvals, torch.float32), (row0, torch.int32),
                  (row1, torch.int32), (out, torch.int32)):
        _check_dtype("reduce_hot", t, dt)
    S = hvals.shape[1]
    if hvals.shape != (8, S, 128) or hidx.shape != hvals.shape:
        raise ValueError("reduce_hot: hidx and hvals must be (8, S, 128)")
    ys = torch.zeros((8, nys, 128), dtype=torch.float32, device=xh.device)
    n = row0.shape[0]
    if n:
        _launch("cvr_reduce_hot", xh.device, _p(xh), _p(hidx), _p(hvals),
                _p(row0), _p(row1), _p(out), _p(ys), n, xh.shape[0], S,
                nys)
        reduce_hot.launches += 1
    return ys


reduce_hot.launches = 0


# ---------------------------------------------------------------------------
# K16 route_flat: the flat route middle (T == 1024) in one pass on the
# stream
# ---------------------------------------------------------------------------


def route_flat_plain(g1, mid):
    """(8, 1024, 128) stream: mstream_to_stream(tileperm(
    stream_to_mstream(g1, 1), mid), 1), which is
    out[qh, f, ql] = g1[qh, v, ql] for v = mid[f>>7, qh*128+ql, f&127]
    (0 where v is not in [0, 1024))."""
    return route_m3_plain(stream_to_mstream(g1, 1), mid)


def route_flat(g1, mid):
    """K16: the flat middle of a 1024-tile route on the stream g1
    (8, 1024, 128) f32 with its int16 plane mid (8, 1024, 128), both 16 B
    aligned; returns a stream.  See route_flat_plain."""
    if not _on_card("route_flat", g1, mid):
        return route_flat_plain(g1, mid)
    _check_dtype("route_flat", g1, torch.float32)
    _check_dtype("route_flat", mid, torch.int16)
    if g1.shape != (8, 1024, 128) or mid.shape != g1.shape:
        raise ValueError("route_flat: a flat middle is (8, 1024, 128)")
    _check_aligned("route_flat", g1, mid)
    out = torch.empty_like(g1)
    _launch("cvr_route_flat", g1.device, _p(g1), _p(mid), _p(out))
    route_flat.launches += 1
    return out


route_flat.launches = 0


# ---------------------------------------------------------------------------
# K17 groupperm: the brute route middle (any T = K*128) on the middle
# layout, by K5's kernel over K planes of 1024 rows
# ---------------------------------------------------------------------------

# out (K, 1024, 128): out[k,q,l] = data[v>>7, q, v&127] for v = idx[k,q,l],
# 0 where v is not in [0, K*128)
groupperm_plain = tileperm_plain


def groupperm(data, idx):
    """K17: the brute middle's within-row permutation over K*128 tiles on
    data (K, 1024, 128) f32 with the int16 plane idx (K, 1024, 128),
    K <= 256, both 16 B aligned.  It launches tileperm_kernel<true> (K5's
    body over K planes of 1024 rows); see tileperm_plain."""
    if not _on_card("groupperm", data, idx):
        return groupperm_plain(data, idx)
    _check_dtype("groupperm", data, torch.float32)
    _check_dtype("groupperm", idx, torch.int16)
    K = data.shape[0]
    if data.shape != (K, 1024, 128) or idx.shape != data.shape or K > 256:
        raise ValueError("groupperm: data and idx must be (K, 1024, 128), "
                         "K <= 256")
    tileperm_geometry(K, 1024)
    _check_aligned("groupperm", data, idx)
    out = torch.empty_like(data)
    if K:
        _launch("cvr_tileperm", data.device, _p(data), _p(idx), _p(out),
                1024, K, 1)
        groupperm.launches += 1
    return out


groupperm.launches = 0


# ---------------------------------------------------------------------------
# K18 reduce_stream: the unfused reduce (stage 3 + x vals + slice sums)
# ---------------------------------------------------------------------------


def emit_starts(emit):
    """(S,) int32: for each plane row, the first row of the slice it
    would close: the row after the previous emission (emit >= 0), or 0."""
    rows = torch.arange(emit.shape[0], device=emit.device)
    last = torch.where(emit >= 0, rows, -1).cummax(0).values
    return torch.cat([last.new_zeros(1), last[:-1] + 1])[: rows.shape[0]].int()


def reduce_stream_table(emit, nslices: int):
    """(row0, row1, out) int32 of the emission sweep over ``emit`` (plane
    rows, -1 or the slice id the row ends): each emission row e closes the
    slice begun after the previous emission (or at row 0); an emission
    id not below ``nslices`` is dropped, as are the rows after the last
    emission."""
    e = torch.nonzero((emit >= 0) & (emit < nslices)).flatten()
    return emit_starts(emit)[e], (e + 1).int(), emit[e].int()


# plane rows a K18 piece sums at most (a slice of more rows is split)
STREAM_PIECE_ROWS = 8


@dataclass(frozen=True)
class StreamPlan:
    """What K18 reads in place of a reduce group's emissions, made once
    (reduce_stream_plan; spmv_routed.to_device_routed makes one per
    reduce group at upload): the slice table cut into pieces of at most
    STREAM_PIECE_ROWS plane rows, for S plane rows and nslices slices."""

    split: Split
    S: int
    nslices: int


def reduce_stream_plan(emit, nslices: int, device=None) -> StreamPlan:
    """K18's plan for the emissions ``emit`` (S,) (a tensor or an array)
    of one reduce group and its ``nslices`` slices: reduce_stream_table
    cut by make_split, on ``device`` (emit's where it is a tensor and
    ``device`` is None).  It reads emit on the host once."""
    if not isinstance(emit, torch.Tensor):
        emit = torch.from_numpy(np.ascontiguousarray(emit, dtype=np.int32))
    device = emit.device if device is None else device
    row0, row1, out = reduce_stream_table(emit.cpu(), nslices)
    return StreamPlan(split=make_split(row0, row1, out, STREAM_PIECE_ROWS,
                                       device),
                      S=emit.shape[0], nslices=nslices)


def reduce_stream_geometry(rows: tuple[int, ...], nys: int,
                           npart: int) -> None:
    """Raise where K18's 32-bit index arithmetic cannot reach: the whole
    planes a group's rows are read from (vals, gx, p3, of ``rows`` rows
    each), ys of nys slices or npart partial rows (8 x rows x 128
    elements each)."""
    for what, n in (*(("planes", r) for r in rows), ("ys", nys),
                    ("partials", npart)):
        if 8 * n * 128 > INT32_MAX:
            raise ValueError(f"reduce_stream: {what} of {n} rows exceed "
                             "the kernel's 32-bit indices")


def reduce_stream_plain(emit, gemit, vals, gx, p3, nslices: int, plan=None):
    """ys (8, nslices, 128): ys[:, s, :] sums, over the plane rows R of
    slice s (reduce_stream_table), P[i,R,l] = gx[v>>7, R, v&127] *
    vals[i,R,l] for v = p3[i,R,l] (0 where v is not in [0, 1024)); slices
    no emission names stay zero.  Neither gemit nor the plan is read."""
    row0, row1, out = reduce_stream_table(emit, nslices)
    item, rows = slice_rows(row0, row1)
    v = p3[:, rows, :].long()
    valid = (v >= 0) & (v < 1024)
    v = v.clamp(0, 1023)
    g = torch.where(valid, gx[v >> 7, rows.view(1, -1, 1), v & 127], 0.0)
    return slice_sums(g * vals[:, rows, :], item, out, nslices)


def reduce_stream(emit, gemit, vals, gx, p3, nslices: int,
                  plan: StreamPlan | None = None):
    """K18: the unfused reduce of one reduce group, the counterpart of
    cvr_tpu/ops/pallas_route.py:604 reduce_slices.  emit (S,) int32 group
    -local slice ids on the rows that end a slice, else -1; gemit (S//8,)
    int32 (group_emit_encode; kept for the reference's signature, not
    read); vals (8, S, 128) f32, the stream-layout middle output gx
    (8, S, 128) f32 and the stage-3 plane p3 (8, S, 128) int16 over the
    group's rows, which may be row slices of the whole planes (read in
    place, 16 B aligned).  Returns ys (8, nslices, 128).  On the card the
    kernel reads the plan (reduce_stream_plan of the same emit and
    nslices) in place of emit; without one the wrapper makes it, which
    reads emit on the host.  Two launches where a slice is split, the
    second adding its pieces' partials.  The emission ids must be
    distinct, as the pack makes them.  See reduce_stream_plain."""
    S = emit.shape[0]
    if (vals.shape != (8, S, 128) or gx.shape != vals.shape
            or p3.shape != vals.shape or gemit.shape != (S // 8,)
            or S % rp.CH):
        raise ValueError("reduce_stream: planes must be (8, S, 128) over "
                         "the S rows of emit, S a multiple of CH")
    if not _on_card("reduce_stream", emit, gemit, planes=(vals, gx, p3)):
        return reduce_stream_plain(emit, gemit, vals, gx, p3, nslices)
    for t, dt in ((emit, torch.int32), (gemit, torch.int32),
                  (vals, torch.float32), (gx, torch.float32),
                  (p3, torch.int16)):
        _check_dtype("reduce_stream", t, dt)
    if plan is None:
        plan = reduce_stream_plan(emit, nslices)
    split = plan.split
    if plan.S != S or plan.nslices != nslices:
        raise ValueError("reduce_stream: the plan is not this group's")
    _on_card("reduce_stream", emit, split.pieces, split.combine)
    strides = tuple(t.stride(0) // 128 for t in (vals, gx, p3))
    reduce_stream_geometry(strides, nslices, split.npart)
    _check_aligned("reduce_stream", vals, gx, p3)
    ys = torch.zeros((8, nslices, 128), dtype=torch.float32, device=gx.device)
    part = torch.empty((8, split.npart, 128), dtype=torch.float32,
                       device=gx.device)
    n = split.pieces.shape[0]
    if S and n:
        _launch("cvr_reduce_stream", gx.device, _p(vals), _p(gx), _p(p3),
                _p(split.pieces), _p(ys), _p(part), n, *strides, nslices,
                split.npart)
        reduce_stream.launches += 1
    if S and split.combine.shape[0]:
        _launch("cvr_reduce_stream_combine", gx.device, _p(part),
                _p(split.combine), _p(ys), split.combine.shape[0], nslices,
                split.npart)
        reduce_stream.launches += 1
    return ys


reduce_stream.launches = 0


# name -> (wrapper, plain version, TPU kernels it replaces)
KERNELS = {
    "expand": (
        expand, expand_plain,
        "cvr_tpu/ops/pallas_route.py:343",
    ),
    "route_middle": (
        route_middle, route_middle_plain,
        "cvr_tpu/ops/pallas_route.py:1203 + :1094",
    ),
    "reduce_slices": (
        reduce_slices, reduce_slices_plain,
        "cvr_tpu/ops/pallas_route.py:641 + :752 (+ :86)",
    ),
    "route_small": (
        route_small, route_small_plain,
        "cvr_tpu/ops/pallas_route.py:1278 + :1298",
    ),
    "tileperm": (
        tileperm, tileperm_plain,
        "cvr_tpu/ops/pallas_route.py:205",
    ),
    "route_m3": (
        route_m3, route_m3_plain,
        "cvr_tpu/ops/pallas_route.py:1210",
    ),
    "reduce_hot": (
        reduce_hot, reduce_hot_plain,
        "cvr_tpu/ops/pallas_route.py:942 + :1022 (+ :899, :86)",
    ),
    "expand_ring": (
        expand_ring, expand_ring_plain,
        "cvr_tpu/ops/pallas_route.py:343 via _expand_ring_call :477",
    ),
    "route_flat": (
        route_flat, route_flat_plain,
        "cvr_tpu/ops/pallas_route.py:1217",
    ),
    "groupperm": (
        groupperm, groupperm_plain,
        "cvr_tpu/ops/pallas_route.py:267",
    ),
    "reduce_stream": (
        reduce_stream, reduce_stream_plain,
        "cvr_tpu/ops/pallas_route.py:537",
    ),
    "reduce_slices_cols": (
        reduce_slices_cols, reduce_slices_cols_plain,
        "none: the JAX package vmaps the SpMV (K3's kernels) over the "
        "columns, cvr_tpu/ops/spmv.py:314 -> "
        "spmv_routed._jitted_spmm_routed",
    ),
    "route_small_cols": (
        route_small_cols, route_small_cols_plain,
        "none: the JAX package vmaps the SpMV (K4's kernels) over the "
        "columns, cvr_tpu/ops/spmv.py:314 -> "
        "spmv_routed._jitted_spmm_routed",
    ),
}

