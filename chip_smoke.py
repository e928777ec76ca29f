#!/usr/bin/env python3
"""Drive the port's SpMV and SpMM paths once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed on its own lines:

  0. the card: torch's device name, and nvidia-smi's name and power limit;
  1. build native/libcvr_native.so and the Hopper kernels from the
     sources in this checkout (print the build time and ptxas' report);
  2. the main path: web-Google-like (R-MAT scale 20, ~6.2M nnz) -> CSR ->
     sell_pack_routed (the default hot="auto": its gate declines, no hot
     planes) -> upload -> spmv; check that each kernel of the path
     launched as often as the pack says, verify against the float64
     golden at rtol 1e-6 (row-scaled), time 100 iterations with CUDA
     events, and time cuSPARSE's CSR SpMV on the same matrix beside it
     (torch.sparse_csr_tensor @ x: a yardstick, never on the path);
  3. each of its kernels (K1, K3, K4) against its plain PyTorch version at
     the main path's own tensors: expand and route_small bit for bit,
     reduce_slices within 1e-6 of the row scale (it sums in another
     order) and against a second launch bit for bit (its split slices'
     partials are added in a fixed order); K3's index, composed at upload
     through the route middle, against the staged middle (K2's mstream on
     a recursive middle): the products bit for bit, and K3's sums against
     K3 run on that mstream by the staged index, bit for bit; K4's
     uploaded index against compose_route of its planes on the CPU, and
     K4 bit for bit against the staged y-route: the three-plane chain
     (route_small_chain) of a flat route, K5, K2, K6, K5 (each launch
     against its plain version) above 1024 tiles, wherever a routed
     SpMV runs (here, [5], the spill of [6], the looped SpMMs of [7],
     shard 0 of each mode of [8] and [9c]); kernel
     time beside plain time, by CUDA events and as device time from a
     torch.profiler trace (alone, and inside the SpMV's trace of [2]),
     with the bound and, where one PyTorch call computes the same
     function, that call's time by CUDA events and as device time;
  4. smaller packs, each built to reach one branch (flat and recursive
     middles, several reduce groups, a w=16 regular region, two x
     segments, split-row extras, a row mask, wiki-Talk-like at full size
     with a y-route of 2048 tiles, hot planes with 4 gather windows, hot
     planes over several reduce groups, hot regular regions):
     spmv_routed on the card against the float64 golden and against its
     own CPU plain path;
  5. fsm-like at full size (2,097,152 rows, ~16.5M nnz): the hub-column
     hybrid (NH 256) and the y-route of 2048 tiles (one K4 gather) as in
     [2]; then every kernel launch of that path (K1, K3, K7, K4) against
     its plain version at its own tensors as in [3], K4 also against the
     staged y-route (K5, K2, K6, K5); then the same matrix packed with
     hot="off", its SpMV timed beside the hybrid's;
  6. pack_auto's other formats at full size, each through pack_auto ->
     upload -> spmv as in [2], with the geometry pack_auto must reach:
     banded-2M (2,097,152 rows, 27 diagonals) -> DIA (K8), road-usa-like
     (8,388,608 rows, ~20.8M nnz) -> BELL (K9) with a routed spill (K1,
     K3, K4), fem-like (1,048,576 rows, ~51.9M nnz) -> SELL-W (K10);
     the same matrix through run_spmv_benchmark(impl="auto"), and a
     smaller one of its generator through `cli spmv` (--format auto),
     each printing its verified three-line report; then every kernel
     launch of each path against its plain version as in [3];
  7. SpMM at full size, each case through the entry point a user calls
     (``cli spmv --rhs K`` with --format auto, or ``spmm`` on pack_auto's
     artifact) with the format it must pick: banded-2M at K 64 -> BSR
     (K12) through the CLI and DIA (K11) through spmm, fem-like at K 64 ->
     BSR (K12), fsm-like at K 32 -> PMM (K14), web-Google-like at K 128
     -> lane (K13) and at K 8 -> the routed SpMV once per column (K1, K3,
     K4, 8 launches each), road-usa-like at K 8 -> BELL once per column
     (K9 and the spill's K1, K3, K4, 8 launches each); launch counts, 8
     columns of
     Y against the float64 golden, the SpMM timed by CUDA events and as
     device time, cuSPARSE's CSR SpMM (torch.sparse_csr_tensor @ X) and
     for BSR also torch's BSR matmul on the same bricks as yardsticks;
     each SpMM kernel's launch against its plain version over all K
     columns, and a looped SpMM's launches at column 0; then ``cli spmv
     --rhs K`` on a smaller MatrixMarket file of each generator, verified;
     then K11-K14 on small matrices at K 17 and 130 and at K 64 with X
     at a 4 B offset, K13 and K14 also at K 132 (RAGGED: banded 3000 and
     2999 rows, a reach wider than one K11 window, BSR row blocks without
     bricks, a lane plan whose 1,024-row slot is split, a small fsm-like
     whose long rows K14 splits), each at the golden and against its
     plain version (K13 and K14 also against a second launch, bit for
     bit);
  8. the row-sharded routed SpMV (dist_routed_pack, dist_spmv_routed) on a
     mesh of 4 shards that all share this one card, so the all-gather and
     the ring's moves are copies inside it and the times are not scaling
     figures: web-Google-like with x replicated, x all-gathered
     (x_sharded) and x moved round the ring (overlap: K15 per ring step
     instead of K1), wiki-Talk-like (2,097,152 columns, two x segments:
     ring tables at segment 1) on the ring and all-gathered; each with its
     pack's phases and geometry, launch counts, the float64 golden, its
     time by CUDA events and as device time beside the one-card
     spmv_routed of the same matrix; every shard's uploaded K4 index
     against compose_route of its planes (wiki-Talk-like's shards: 2048
     tiles); then K15 on every ring step of every shard against its plain
     version, bit for bit, with its time alone, its bound and its
     torch.take, shard 0's K1, K3, K4 in each mode as in [3] (K4 also
     against the staged y-route), and K3 on every other shard as in [3]
     (each shard of a forced pack holds a slice of up to 1,024 plane rows),
     with its launches, time alone and bound summed over the shards;
  9. the route library's device API on [2]'s matrix, pack and tensors:
     (a) [2]'s y stream through K5, middle_pass on the y-route's flat
     planes (K16) and K5, bit for bit against K4's one pass; (b)
     apply_route of the permutation that sorts its 6,162,120 nonzeros by
     column (CSR -> CSC value order) compiled with tile_multiple 1 (T
     6018, the brute middle: K5, K17, K5) and 1024 (T 6144, the recursive
     middle: K5, K2, K6, K5), bit for bit against v[perm], with the route
     compile time and v[perm]'s time by torch indexing beside it; (c) the
     unfused SpMV (expand, middle_pass in full, K18 once per reduce group,
     the y-route): its ys within 1e-6 of the row scale of K3's, its y at
     the float64 golden, its time beside spmv_routed's; (d) K5 on 8
     planes of 1,001 tiles and K17 on 256 planes (192 KB of shared memory
     a block), on planes made from a seed whose index also reaches
     outside them; each phase with its launch counts, and every launch of
     each sub-path against its plain version as in [3] (the set checked
     equals the set launched);
 10. the digests: every routed y above (the SpMVs of [2], [4], [5], the
     road-usa-like of [6] and each mode of [8]) has its sha256 printed
     beside the one PARENT_Y_SHA256 records, taken with torch's
     deterministic algorithms (index_add_ adds the split-row extras by
     atomics otherwise); they must be equal (``--y-digests`` prints the
     digests of a checkout's package alone);
 11. a JSON line of the kernels of every path, then the last line
     {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero.  It needs a CUDA card
and the repository around it; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import scipy.sparse as sps
import torch

from cvr_tpu_torch import _native, cli
from cvr_tpu_torch.bench import synthetic as syn
from cvr_tpu_torch.bench.harness import run_spmv_benchmark, time_iterations
from cvr_tpu_torch.formats import pack_auto
from cvr_tpu_torch.formats.bell import BellMatrix
from cvr_tpu_torch.formats.bsr import bsr_pack
from cvr_tpu_torch.formats.coo import COOMatrix
from cvr_tpu_torch.formats.dia import DiaMatrix, dia_pack
from cvr_tpu_torch.formats.sell_routed import (
    RingSpec,
    SellRouted,
    ring_table_base,
    sell_pack_routed,
)
from cvr_tpu_torch.formats.sell_window import SellWindow
from cvr_tpu_torch.io.mmio import write_matrix_market
from cvr_tpu_torch.ops import _build, kernels
from cvr_tpu_torch.ops import dia_kernels as dk
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import route_planes as rp
from cvr_tpu_torch.ops import window_kernels as wk
from cvr_tpu_torch.ops import spmv_routed as sp
from cvr_tpu_torch.ops import spmm_bsr, spmm_lane, spmm_pmm
from cvr_tpu_torch.ops.spmm_bsr import BsrDevice
from cvr_tpu_torch.ops.spmm_lane import LaneDevice
from cvr_tpu_torch.ops.spmm_pmm import PmmDevice
from cvr_tpu_torch.ops.spmv import spmm, spmv, upload
from cvr_tpu_torch.ops.spmv_bell import BellDevice, gather_args
from cvr_tpu_torch.ops.spmv_dia import DiaDevice
from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify
from cvr_tpu_torch.ops.spmv_window import SellWindowDevice, reduce_args
from cvr_tpu_torch.parallel.dist import make_mesh
from cvr_tpu_torch.parallel.dist_routed import (
    dist_routed_pack,
    dist_spmv_routed,
)

ITERS = 100
KERNEL_ITERS = 20
EXACT = ("expand", "route_middle", "route_small", "tileperm", "route_m3",
         "route_flat", "groupperm")
# the pure gathers library_call computes by one torch.take (tileperm: by
# torch.gather where every index is in range): kernel -> the position of
# its data input among its arguments
GATHERS = {"expand": 4, "route_middle": 0, "route_small": 0, "tileperm": 0,
           "route_m3": 0, "route_flat": 0, "groupperm": 0, "expand_ring": 4}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, 80 GB HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM, TF32 on the tensor cores, dense
FORCE_HOT = {"CVR_HOT": "1"}

# name, matrix, split_len, YB (None: the default), hot, environment of the
# pack, the branch its pack must reach.
GEOMETRIES = (
    ("rmat11", lambda: syn.rmat_matrix(11, 8, seed=2), None, None, "off",
     {}, lambda sr: sr.mid["kind"] == "flat"),
    ("banded", lambda: syn.banded_matrix(3000, 9), None, None, "off", {},
     lambda sr: sr.nslA > 0),
    ("rmat_split16", lambda: syn.rmat_matrix(10, 12, seed=5), 16, None,
     "off", {}, lambda sr: sr.extra_src.shape[0] > 0),
    ("empty_rows_cols", syn.empty_rows_cols, 16, None, "off", {},
     lambda sr: sr.ymask.shape[0] > 0),
    ("uniform_w16", syn.uniform_rows, None, None, "off", {},
     lambda sr: (sr.regions[:, 3] == 16).any()),
    ("multisegment", syn.multisegment, None, None, "off", {},
     lambda sr: sr.n_segs == 2),
    ("rmat12_yb2", lambda: syn.rmat_matrix(12, 8, seed=4), None, 2, "off",
     {}, lambda sr: len(sr.ycall_rows) > 1),
    ("rmat14_yb4", lambda: syn.rmat_matrix(14, 16, seed=4), None, 4, "off",
     {}, lambda sr: len(sr.ycall_rows) > 1 and sr.mid["kind"] == "rec"),
    ("rmat17_T2048", lambda: syn.rmat_matrix(17, 8, seed=4), None, None,
     "off", {}, lambda sr: sr.T == 2048 and sr.mid["kind"] == "rec"),
    ("wiki_talk_like", syn.wiki_talk_like, None, None, "auto", {},
     lambda sr: (sr.y_ra["Tp"] == 2048 and sr.hot is None
                 and sr.y_ra["mid_planes"]["kind"] == "rec"
                 and sr.extra_src.shape[0] > 0)),
    ("rmat15_hot512", lambda: syn.rmat_matrix(15, 8, seed=5), None, None,
     "auto", {**FORCE_HOT, "CVR_HOT_NH": "512"},
     lambda sr: (sr.hot is not None and sr.hot.ncand == 4
                 and np.unique(sr.hot.hgcls).shape[0] > 1)),
    ("rmat13_hot_yb2", lambda: syn.rmat_matrix(13, 8, seed=4), None, 2,
     "auto", FORCE_HOT,
     lambda sr: sr.hot is not None and len(sr.hot.ycall_rows) > 1),
    ("fsm17_hot_regions", lambda: syn.fsm_like(n=1 << 17), None, None,
     "auto", FORCE_HOT,
     lambda sr: sr.hot is not None and sr.hot.regions.shape[0] > 0),
)


# Phase [6]: name, matrix, the format pack_auto must pick and the geometry
# it must reach, the kernel of the format, a smaller matrix of the same
# generator for the CLI (it reads a MatrixMarket file).
FORMATS = (
    ("banded_2m", lambda: syn.banded_matrix(1 << 21, 27),
     lambda A: isinstance(A, DiaMatrix) and A.nd == 27, "dia_spmv",
     lambda: syn.banded_matrix(1 << 16, 27)),
    ("road_usa_like", syn.road_usa_like,
     lambda A: (isinstance(A, BellMatrix)
                and (A.k, A.reach, A.ncand, A.TBb, A.R_sub)
                == (6, 64, 10, 128, 65536)
                and A.spill is not None and A.spill.nnz == 146396
                and A.spill_map.shape[0] == 106239 and A.spill.T == 9216),
     "bell_gather_mac", lambda: syn.road_usa_like(n=1 << 18)),
    ("fem_like", syn.fem_like,
     lambda A: (isinstance(A, SellWindow)
                and (A.D, A.W, A.wrl, A.G, A.n_segs, A.nslices,
                     len(A.ycall_rows), A.S_pad)
                == (2, 1024, 8, 4, 8, 2048, 4, 55936)),
     "window_reduce", lambda: syn.fem_like(n=1 << 15)),
)

# Phase [7]: name, matrix, the smaller matrix of its generator for the
# CLI, and its cases: (K, entry point, the format it must pick).  "cli"
# runs cli._spmm with --format auto, "spmm" runs spmm on pack_auto's
# artifact.
SPMM_CASES = (
    ("banded_2m", lambda: syn.banded_matrix(1 << 21, 27),
     lambda: syn.banded_matrix(1 << 16, 27),
     ((64, "cli", "bsr"), (64, "spmm", "dia"))),
    ("fem_like", syn.fem_like, lambda: syn.fem_like(n=1 << 15),
     ((64, "cli", "bsr"),)),
    ("fsm_like", syn.fsm_like, lambda: syn.fsm_like(n=1 << 17),
     ((32, "cli", "pmm"),)),
    ("web_google_like", syn.web_google_like,
     lambda: syn.rmat_matrix(14, 6, seed=42),
     ((128, "cli", "lane"), (8, "cli", "sell-routed"))),
    ("road_usa_like", syn.road_usa_like,
     lambda: syn.road_usa_like(n=1 << 18),
     ((8, "cli", "bell"),)),
)
SPMM_CHECK_COLS = 8  # columns of Y held against the float64 golden


def diagonals_matrix(nrows, ncols, offsets, seed=4) -> COOMatrix:
    """Dense diagonals at ``offsets``, standard normal values."""
    rows = [np.arange(max(0, -o), min(nrows, ncols - o)) for o in offsets]
    cols = [r + o for r, o in zip(rows, offsets)]
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.random.default_rng(seed).standard_normal(rows.shape[0])
    return COOMatrix(rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                     vals=vals.astype(np.float32), shape=(nrows, ncols))


def empty_row_blocks(seed=6) -> COOMatrix:
    """900 x 1000 with entries only in rows 128-639: BSR-128 row blocks
    0 and 5-7 hold no entry (the pack gives each a zero brick)."""
    rng = np.random.default_rng(seed)
    return COOMatrix(
        rows=rng.integers(128, 640, 3000).astype(np.int32),
        cols=rng.integers(0, 1000, 3000).astype(np.int32),
        vals=rng.standard_normal(3000).astype(np.float32),
        shape=(900, 1000)).sum_duplicates()


def fsm_long_rows(seed=8) -> COOMatrix:
    """A small fsm-like matrix (16,384 rows) with rows 5, 700 and 9000
    given 300, 1,000 and 5,000 entries at random columns: rows that K14
    cuts into pieces."""
    coo = syn.fsm_like(n=1 << 14)
    rng = np.random.default_rng(seed)
    rows, cols, vals = [coo.rows], [coo.cols], [coo.vals]
    for r, n in ((5, 300), (700, 1000), (9000, 5000)):
        rows.append(np.full(n, r, dtype=np.int32))
        cols.append(rng.choice(coo.shape[1], n, replace=False).astype(
            np.int32))
        vals.append(rng.standard_normal(n).astype(np.float32))
    return COOMatrix(rows=np.concatenate(rows), cols=np.concatenate(cols),
                     vals=np.concatenate(vals),
                     shape=coo.shape).sum_duplicates()


# Phase [7]'s small cases, where K11-K14 take the paths the full-size
# cases do not: a ragged K (the 4 B copies of X, a masked last K tile;
# K13's and K14's 4 B X reads), K 64 with X at a 4 B offset (4 B copies at
# K % 4 == 0; K13's and K14's 4 B X reads), an odd row count (K11's 4 B
# band copies), a reach wider than one window (K11's several windows), row
# blocks without bricks (K12 writes their zeros), and for K13 and K14 also
# K 132 (16 B X reads over several column tiles, the last one masked) on a
# lane plan whose 1,024-row slot is split into pieces and a PMM plan whose
# long rows are (K14's second pass).
RAGGED_K = (17, 130)
RAGGED_VEC_K = (132,)
RAGGED = (
    ("banded_3000_27", lambda: syn.banded_matrix(3000, 27), "dia"),
    ("banded_2999_27", lambda: syn.banded_matrix(2999, 27), "dia"),
    ("wide_reach", lambda: diagonals_matrix(4000, 4000,
                                            (-2500, -1, 0, 1, 1800)), "dia"),
    ("empty_row_blocks", empty_row_blocks, "bsr"),
    ("rmat14_lane", lambda: syn.rmat_matrix(14, 6, seed=42), "lane"),
    ("fsm14_long_rows", fsm_long_rows, "pmm"),
)

# Phase [8]: the row-sharded routed SpMV on DIST_SHARDS shards of the one
# card.  Per matrix: (mode, on the ring pack, check shard 0's kernels
# against their plain versions) for each mode it runs; each pack has one
# checked mode per expand (K1 or the ring's K15) and every ring mode
# checks its K15 launches.
DIST_SHARDS = 4
DIST_MODES = {
    "replicated": {},
    "x_sharded": {"x_sharded": True},
    "overlap": {"x_sharded": True, "overlap": True},
}
DIST_CASES = (
    ("web_google_like", syn.web_google_like,
     (("replicated", False, False), ("x_sharded", False, True),
      ("overlap", True, True))),
    # 2,097,152 columns: two x segments, ring tables at segment 1
    ("wiki_talk_like", syn.wiki_talk_like,
     (("overlap", True, True), ("x_sharded", True, True))),
)

# Phase [10]: the first 16 hex digits of the sha256 of each routed y of
# the phases, as the parent design gave them (the commit before the upload
# composed the route: K2 on the x side, K5, K2, K6, K5 above 1024 y
# tiles), printed by `python3 chip_smoke.py --y-digests` in a checkout of
# it on an H100 (PERF.md).  Every routed y must equal them: composing the
# route only moves values.  A change that sums in another order records
# its own.
PARENT_Y_SHA256 = {
    "[2] web_google_like": "c5d93c94cd5f18f0",
    "[4] rmat11": "651519c2bb2a2267",
    "[4] banded": "0bba64547acc00d5",
    "[4] rmat_split16": "41f666b61ed4bded",
    "[4] empty_rows_cols": "8c08c212d9aca5f8",
    "[4] uniform_w16": "bfbf4ba5499781db",
    "[4] multisegment": "9b828c5e885f057f",
    "[4] rmat12_yb2": "588f8089411b1b7f",
    "[4] rmat14_yb4": "04cd14b2b3cfce4e",
    "[4] rmat17_T2048": "97e38ef1e0741086",
    "[4] wiki_talk_like": "6a7fb532252dcdbd",
    "[4] rmat15_hot512": "b3779d0bfbb1b5b5",
    "[4] rmat13_hot_yb2": "df0c2f66bdb5cc13",
    "[4] fsm17_hot_regions": "8f7a5ebb5018f6e8",
    "[5] fsm_like": "d407ce5ff8b03692",
    "[6] road_usa_like": "1845a63d8ae6d087",
    "[8] web_google_like replicated": "d564a462ba3e6450",
    "[8] web_google_like x_sharded": "d564a462ba3e6450",
    "[8] web_google_like overlap": "d564a462ba3e6450",
    "[8] wiki_talk_like one-card": "ba551bf7f399659b",
    "[8] wiki_talk_like overlap": "8dc6e398c51d2065",
    "[8] wiki_talk_like x_sharded": "8dc6e398c51d2065",
}
Y_SHA256 = {}  # this run's, by label (record_y)


def y_digest(fn) -> str:
    """The first 16 hex digits of the sha256 of fn()'s output, which fn
    computes twice under torch's deterministic algorithms (index_add_
    adds the split-row extras by atomics, in any order, otherwise); it
    raises where the two differ."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got = [hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
               for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    if got[0] != got[1]:
        raise AssertionError(f"two runs give two outputs: {got}")
    return got[0]


def routed(sd) -> bool:
    """Whether the device artifact ``sd`` runs the routed SpMV (itself, or
    as BELL's spill)."""
    return isinstance(sd, sp.SellRoutedDevice) or (
        isinstance(sd, BellDevice) and sd.spill is not None)


def record_y(label, fn) -> str:
    """fn()'s y_digest beside the parent's (PARENT_Y_SHA256); raises
    where they differ or the parent's is not recorded."""
    got = Y_SHA256[label] = y_digest(fn)
    want = PARENT_Y_SHA256.get(label)
    print(f"{label} y sha256 {got}, the parent's {want}: "
          f"{'equal' if got == want else 'DIFFERENT'}")
    if got != want:
        raise AssertionError(f"{label}: y is not the parent's")
    return got


TRACES = 5  # traces device_ms takes at most to find one that holds every call
MARGIN_S = 0.02  # idle time around the kept calls of a trace


def device_ms(fn, iters: int, marker: str | None,
              per_call: int = 1) -> dict[str, float]:
    """Device time per call of ``fn``, by kernel name: the durations of the
    device events in a torch.profiler trace over ``iters`` calls (CUDA
    events around back-to-back calls also count the host, when enqueueing
    is the slower side).

    A trace can lose device events: those of its first calls, and now and
    then one or two calls' kernels in the middle.  So ``iters`` lead calls
    open the trace, only the events inside the range of the ``iters``
    calls after them count, and a trace counts only if it holds all of
    them: ``marker``, a kernel that one call launches ``per_call`` times,
    ``iters * per_call`` times (None where ``fn`` launches no kernel of
    ours), and every device event
    a multiple of ``iters`` times, since each call launches the same
    kernels.  The range opens and closes with MARGIN_S of idle time: the
    device's timestamps may stand off the host's by a fraction of a
    millisecond, and the kept calls of a short kernel take little more.
    Up to TRACES traces are taken; it raises when none holds every
    call."""
    faults = []
    for _ in range(TRACES):
        per, count = _trace(fn, iters)
        seen = sum(c for n, c in count.items()
                   if marker is None or marker in n)
        uneven = {n: c for n, c in count.items() if c % iters}
        if count and not uneven and (marker is None
                                     or seen == iters * per_call):
            if faults:
                print(f"    (trace {len(faults) + 1} holds every call; "
                      f"the earlier lost device events: {faults})")
            return per
        faults.append(f"{marker} seen {seen} times of {iters * per_call}, "
                      f"{len(uneven)} kernels seen a count not a multiple "
                      f"of {iters}")
    raise AssertionError(f"{TRACES} traces of {iters} calls each lost "
                         f"device events: {faults}")


def _trace(fn, iters: int):
    """One trace of ``iters`` lead calls, then ``iters`` kept calls: (ms
    per kept call by device event name, the count of each name)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    kept = "chip_smoke.kept_calls"
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(MARGIN_S)
        with record_function(kept):
            time.sleep(MARGIN_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(MARGIN_S)
    events = prof.events()
    dt = torch.autograd.DeviceType
    window = [e.time_range for e in events
              if e.name == kept and e.device_type == dt.CPU]
    if len(window) != 1:
        raise AssertionError(f"the trace holds {len(window)} ranges {kept}")
    t0, t1 = window[0].start, window[0].end
    per, count = {}, {}
    for e in events:
        # the range itself is also laid over the device timeline
        if (e.device_type == dt.CUDA and e.name != kept
                and t0 <= e.time_range.start <= t1):
            per[e.name] = per.get(e.name, 0.0) + e.device_time / iters / 1e3
            count[e.name] = count.get(e.name, 0) + 1
    return per, count


# kernels of ours that launch one instantiation of a template kernel (K5
# and K17 share tileperm_kernel): kernel -> its device events' name (the
# profiler demangles kernel names)
EVENTS = {"tileperm": "tileperm_kernel<false>",
          "groupperm": "tileperm_kernel<true>"}


# kernels of ours whose wrapper launches a second pass (adding a split
# item's partials): kernel -> the second pass's device events' name
SECOND = {"reduce_slices": "reduce_slices_combine_kernel",
          "lane_reduce": "lane_reduce_combine_kernel",
          "pmm_spmm": "pmm_spmm_combine_kernel"}
# kernels whose output must repeat bit for bit from launch to launch
# (sums in a fixed order, split sums added in a fixed order, no float
# atomics)
REPEAT = (*SECOND, "window_reduce")


def event_of(name: str) -> str:
    """The name (a part of it) of kernel ``name``'s device events (its
    first pass's, where it has two)."""
    return EVENTS.get(name, f"{name}_kernel")


def by_kernel(per) -> dict[str, float]:
    """Device ms by kernel of ours (both passes where it has two), from
    device_ms's ms by event name."""
    return {k: sum(v for n, v in per.items()
                   if event_of(k) in n or (k in SECOND and SECOND[k] in n))
            for k in kernels.KERNELS}


def device_split(per, ours) -> str:
    """A trace's device ms per call: the total, ours by kernel, the rest."""
    dev = sum(per.values())
    parts = [f"{k} {t:.4f}" for k, t in ours.items() if t]
    parts.append(f"other device work {dev - sum(ours.values()):.4f}")
    return f"{dev:.4f} ms ({', '.join(parts)})"


def hot_branches(hp) -> set[str]:
    """The row walks K7 takes on hot planes ``hp``: "regular" (regular
    regions) and "swept" (emissions outside every region)."""
    covered = np.zeros(hp.hemit.shape[0], dtype=bool)
    for _, r0, nr, _, _ in hp.regions:
        covered[r0 : r0 + nr] = True
    out = {"regular"} if len(hp.regions) else set()
    if ((hp.hemit >= 0) & ~covered).any():
        out.add("swept")
    return out


def geometry(sr) -> str:
    ya = sr.y_ra
    hp = sr.hot
    hot = "none" if hp is None else (
        f"NH {hp.NH} (ncand {hp.ncand}, classes "
        f"{sorted(set(hp.hgcls.tolist()))}), {hp.nslices} slices in "
        f"{len(hp.ycall_rows)} reduce groups, {len(hp.regions)} regular "
        f"regions, {hp.hemit.shape[0]} plane rows, K7 walks "
        f"{sorted(hot_branches(hp))}"
    )
    return (
        f"nnz {sr.nnz}, T {sr.T} tiles, middle {sr.mid['kind']!r} Tk "
        f"{sr.mid['Tk']}, y-route Tp {ya['Tp']} "
        f"{ya['mid_planes']['kind']!r}, {sr.nslices} slices in "
        f"{len(sr.ycall_rows)} reduce groups, {len(sr.regions)} regular "
        f"regions, zone A {sr.nslA} slices over {sr.zone_rows} plane rows, "
        f"{sr.n_segs} x segments, {sr.extra_src.shape[0]} split-row extras, "
        f"ymask {sr.ymask.shape[0]}, S_pad {sr.S_pad} plane rows; hot "
        f"planes: {hot}"
    )


def second_pass(split) -> int:
    """1 when a split plan (route_kernels.Split) has split items, whose
    partials its kernel's second pass adds, else 0."""
    return int(split.combine.shape[0] > 0)


def expected_launches(sd) -> dict[str, int]:
    """Launches of each kernel in one SpMV of the device artifact ``sd``
    on the card (K3's second pass counted as a launch)."""
    want = dict.fromkeys(kernels.KERNELS, 0)
    if isinstance(sd, DiaDevice):
        want["dia_spmv"] = 1
    elif isinstance(sd, SellWindowDevice):
        want["window_reduce"] = 1
    elif isinstance(sd, BellDevice):
        want["bell_gather_mac"] = 1
        if sd.spill is not None:
            for k, n in expected_launches(sd.spill).items():
                want[k] += n
    else:  # the route is composed into K3's and K4's indices
        want.update({
            "expand": 1,
            "reduce_slices": 1 + second_pass(sd.red_plan.split),
            "route_small": 1,
            "reduce_hot": int(sd.hot_nslices > 0),
        })
    return want


def spmm_kernel(sd) -> str | None:
    """The SpMM kernel of the device artifact ``sd``, None for a looped
    SpMM (one SpMV per column)."""
    one = {BsrDevice: "bsr_spmm", LaneDevice: "lane_reduce",
           PmmDevice: "pmm_spmm", DiaDevice: "dia_spmm"}
    return next((name for kind, name in one.items()
                 if isinstance(sd, kind)), None)


def expected_spmm_launches(sd, K: int) -> dict[str, int]:
    """Launches of each kernel in one SpMM of the device artifact ``sd``
    at width K: the SpMM kernel's (K13's and K14's second pass counted as
    a launch), or K SpMVs' worth."""
    name = spmm_kernel(sd)
    if name is None:
        return {k: n * K for k, n in expected_launches(sd).items()}
    plan = {"lane_reduce": "split", "pmm_spmm": "work"}.get(name)
    n = 1 + (second_pass(getattr(sd, plan)) if plan else 0)
    return {**dict.fromkeys(kernels.KERNELS, 0), name: n}


def describe(A) -> str:
    """The geometry of a packed artifact, in one line."""
    if isinstance(A, SellRouted):
        return geometry(A)
    if isinstance(A, DiaMatrix):
        return (f"DIA: nd {A.nd}, offsets {int(A.offsets.min())} .. "
                f"{int(A.offsets.max())}, {A.nnz} nnz")
    if isinstance(A, BellMatrix):
        spill = "none" if A.spill is None else (
            f"{A.spill.nnz} nnz on {A.spill_map.shape[0]} rows: "
            f"{geometry(A.spill)}")
        return (f"BELL: k {A.k}, reach {A.reach}, ncand {A.ncand}, TBb "
                f"{A.TBb}, R_sub {A.R_sub}, d {A.d}, pre {A.pre}, {A.nnz} "
                f"nnz; routed spill: {spill}")
    return (f"SELL-W: D {A.D}, W {A.W}, wrl {A.wrl}, G {A.G}, {A.n_segs} x "
            f"segments, {A.nslices} slices in {len(A.ycall_rows)} reduce "
            f"groups, S {A.S}, S_pad {A.S_pad}, {A.nnz} nnz")


def build() -> None:
    t0 = time.perf_counter()
    how = _native.build()
    if not _native.available():
        raise RuntimeError("native/libcvr_native.so did not load")
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.load()
    print(f"[1] build: native ({how}) {t_native:.2f} s, kernels "
          f"{time.perf_counter() - t0:.2f} s ({_build.library_path().name})")
    # per kernel: registers, static shared memory, stack and spills; K11's
    # dynamic shared memory is its window plan's, printed in [7]
    for line in (_build.build_log or "").splitlines():
        if "ptxas info" in line or "spill" in line:
            print(f"[1]   {line.strip()}")
    print(f"[1] bsr_spmm_kernel takes {_build.load().cvr_bsr_spmm_smem()} B "
          "of dynamic shared memory a block")


def cusparse_ms(tag, csr, xd, golden, scale, device) -> float:
    """cuSPARSE's CSR SpMV of the matrix (torch.sparse_csr_tensor @ x):
    the whole-SpMV yardstick, never on the port's path.  Checked against
    the golden, then timed by CUDA events."""
    dev = torch.device(device)
    A = torch.sparse_csr_tensor(
        torch.from_numpy(csr.rowptr).to(dev),
        torch.from_numpy(csr.cols.astype(np.int64)).to(dev),
        torch.from_numpy(csr.vals.astype(np.float32)).to(dev),
        size=csr.shape, check_invariants=False,
    )
    ok, _, maxrel = verify((A @ xd).cpu().numpy(), golden, rtol=1e-6,
                           row_scale=scale)
    if not ok:
        raise AssertionError(f"{tag} cuSPARSE's SpMV is not the same function")
    ms = time_iterations(lambda: A @ xd, ITERS, device) * 1e3
    print(f"{tag} cuSPARSE CSR SpMV (torch.sparse_csr_tensor @ x, "
          f"yardstick): {ms:.4f} ms/iter over {ITERS} iters, golden max rel "
          f"{maxrel:.3e}")
    return ms


def drive(tag, name, coo, device, reaches, pack=sell_pack_routed,
          marker="expand_kernel"):
    """Pack (sell_pack_routed with hot="auto", or ``pack``), check the
    branch, upload, one verified SpMV with the launch counts (and, where
    it is routed, y's digest against the parent's), the timed loop, its
    device time by kernel, and cuSPARSE's time beside it.
    Returns (packed artifact, device artifact, x on the device, launches,
    ms per SpMV, device ms per SpMV by kernel, cuSPARSE ms)."""
    csr = coo.to_csr()
    t0 = time.perf_counter()
    A = pack(csr)
    pack_s = time.perf_counter() - t0
    phases = ", ".join(f"{k} {v:.3f}" for k, v in A.convert_phases.items())
    print(f"{tag} pack {pack_s:.3f} s ({phases}): {describe(A)}")
    if not reaches(A):
        raise AssertionError(f"{tag} pack misses its branch")
    t0 = time.perf_counter()
    sd = upload(A, device)
    torch.cuda.synchronize()
    print(f"{tag} upload {time.perf_counter() - t0:.3f} s")
    x = np.random.default_rng(0).standard_normal(coo.shape[1]).astype(np.float32)
    xd = torch.from_numpy(x).to(device)

    kernels.reset_launches()
    y = spmv(sd, xd)
    torch.cuda.synchronize()
    launches = kernels.launches()

    yn = y.cpu().numpy()
    if yn.shape != (coo.shape[0],) or not np.isfinite(yn).all():
        raise AssertionError(f"bad output: shape {yn.shape}")
    golden, scale = spmv_golden_numpy(csr, x), spmv_row_scale(csr, x)
    ok, nbad, maxrel = verify(yn, golden, rtol=1e-6, row_scale=scale)
    print(f"{tag} verify vs float64 golden (rtol 1e-6, row-scaled): "
          f"{'PASS' if ok else 'FAIL'}, {nbad} bad rows, max rel {maxrel:.3e}")
    if not ok:
        raise AssertionError(f"{tag} disagrees with the golden")
    print(f"{tag} launches in this path's run: "
          f"{ {k: n for k, n in launches.items() if n} }")
    if launches != expected_launches(sd):
        raise AssertionError(f"{tag} launches {launches}, the pack needs "
                             f"{expected_launches(sd)}")
    if routed(sd):
        record_y(f"{tag} {name}", lambda: spmv(sd, xd))

    ms = time_iterations(lambda: spmv(sd, xd), ITERS, device) * 1e3
    print(f"{tag} spmv: {ms:.4f} ms/iter over {ITERS} iters, "
          f"{2 * A.nnz / ms / 1e6:.3f} GFLOPS (2*nnz), "
          f"{A.nnz / ms / 1e6:.3f} Gnnz/s")
    per = device_ms(lambda: spmv(sd, xd), KERNEL_ITERS, marker)
    dev = sum(per.values())
    ours = by_kernel(per)
    print(f"{tag} spmv device time {dev:.4f} ms/iter "
          f"(trace holds all {KERNEL_ITERS} calls; device busy "
          f"{100 * dev / ms:.1f}% of the timed loop); in the same trace: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ours.items() if v)
          + f", other device work {dev - sum(ours.values()):.4f} ms")
    lib_ms = cusparse_ms(tag, csr, xd, golden, scale, device)
    return A, sd, xd, launches, ms, ours, lib_ms


def main_path(coo, device):
    return drive(
        "[2]", "web_google_like", coo, device,
        lambda sr: (sr.mid["kind"] == "rec" and sr.y_ra["Tp"] == 1024
                    and sr.hot is None),
    )


def kernel_cases(tag, sd, xd):
    """Every kernel launch of one SpMV of ``sd``, in path order, as
    (kernel, which launch, its arguments at the path's own tensors); a
    flat y-route's K4 is also held against its three stage planes
    (check_small_route)."""
    if isinstance(sd, DiaDevice):
        if xd.dim() == 2:
            return [("dia_spmm", "", (sd.bands, sd.offsets, xd))]
        return [("dia_spmv", "", (sd.bands, sd.offsets, xd))]
    if isinstance(sd, BsrDevice):
        return [("bsr_spmm", "", spmm_bsr.kernel_args(sd, xd))]
    if isinstance(sd, LaneDevice):
        return [("lane_reduce", "", spmm_lane.kernel_args(sd, xd))]
    if isinstance(sd, PmmDevice):
        return [("pmm_spmm", "", spmm_pmm.kernel_args(sd, xd))]
    if isinstance(sd, SellWindowDevice):
        return [("window_reduce", "", reduce_args(sd, xd))]
    if isinstance(sd, BellDevice):
        cases = [("bell_gather_mac", "", gather_args(sd, xd))]
        if sd.spill is not None:
            cases += [(name, f"spill {which}".strip(), args)
                      for name, which, args in kernel_cases(
                          f"{tag} spill", sd.spill, xd)]
        return cases
    cases = []
    args = (sd.w8, sd.gcls, sd.seg_blk, sd.li, xd, sd.segw, sd.n_segs)
    cases.append(("expand", "", args))
    g1 = rk.expand(*args)
    check_fold(tag, sd, g1)
    cases.append(("reduce_slices", "", k3_args(sd, g1)))
    return cases + y_cases(tag, sd, sp.reduce(sd, g1), xd)


def k3_args(sd, g1):
    """K3's arguments at the path's tensors (sp.reduce's call)."""
    return (g1, sd.vals_ss, sd.red_plan, sd.nslices)


def check_fold(tag, sd, g1) -> None:
    """K3's index composed through the route middle against the staged
    chain on the card, bit for bit: the products of the plane rows the
    slices name (vals times g1 by the composed index, against
    reduce_products_plain on the route middle's mstream, K2's output on
    a recursive middle), and K3's sums against K3 run on that mstream by
    the staged index (the parent design's K3)."""
    m, m3 = sp.middle(sd, g1)
    item, rows = rk.slice_rows(sd.red_row0, sd.red_row1)
    plan = sd.red_plan
    got = sd.vals_ss[:, rows, :] * rk.gather_or_zero(g1, plan.idx[:, rows, :])
    want = rk.reduce_products_plain(m, m3, sd.vals_ss, sd.p3, rows,
                                    sd.red_fast.bool()[item])
    staged = dataclasses.replace(plan, T=m.shape[1], idx=rk.reduce_index(
        m3, sd.p3, sd.red_row0, sd.red_row1, sd.red_fast))
    ys, ys_staged = (rk.reduce_slices(g1, sd.vals_ss, plan, sd.nslices),
                     rk.reduce_slices(m, sd.vals_ss, staged, sd.nslices))
    zeros = int((plan.idx[:, rows, :] < 0).sum())
    same = torch.equal(got, want) and torch.equal(ys, ys_staged)
    print(f"{tag} reduce_slices on g1 (middle {sd.mid.kind!r}, {zeros} "
          f"elements read as 0): products and K3's sums "
          f"{'bit-exact with' if same else 'DIFFER from'} the staged "
          "middle's")
    if not same:
        raise AssertionError(f"{tag} K3's composed index is not the staged "
                             "chain")


def y_cases(tag, sd, ys, xd):
    """The kernel launches of sp.y_from_slices(sd, ys, xd), as
    kernel_cases gives them, K4's checked by check_small_route."""
    ysp = sp.y_stream(sd, ys)
    cases = []
    if sd.hot_nslices:
        args = (xd[sd.hot_ids], sd.hidx, sd.hvals, sd.hot_row0,
                sd.hot_row1, sd.hot_out, sd.hot_nslices)
        cases.append(("reduce_hot", "", args))
        ysp[:, : sd.hot_nslices] += rk.reduce_hot(*args)
    check_small_route(tag, sd.yroute, ysp)
    return cases + route_cases(sd.yroute, ysp, "y side")


def check_src(tag, ra) -> None:
    """A route's uploaded K4 index against compose_route of the same
    planes read back from the card, on the CPU."""
    cpu = sp.RouteMidDevice(kind=ra.mid.kind, Tk=ra.mid.Tk, **{
        k: getattr(ra.mid, k).cpu() for k in ("mid", "m1", "csel", "m3")
        if getattr(ra.mid, k) is not None})
    want = sp.compose_route(ra.s1.cpu(), cpu, ra.s3.cpu(), ra.Tp, ra.n)
    if ra.src.dtype != torch.int32 or not torch.equal(ra.src.cpu(), want):
        raise AssertionError(f"{tag} the uploaded K4 index is not "
                             "compose_route of its planes")


def check_small_route(tag, ra, g) -> None:
    """K4 by its composed index against the staged route on the stream g,
    bit for bit, after check_src: a flat route's three-plane chain
    (route_small_chain); a longer route's stages as the TPU runs them (K5,
    K2, K6, K5: sp.staged_route), each launch held against its plain
    version bit for bit, and their device time beside K4's."""
    check_src(tag, ra)
    got = rk.route_small(g, ra.src, ra.n)
    if ra.mid.kind == "flat":
        want = rk.route_small_chain(g, ra.s1, ra.mid.mid, ra.s3, ra.n)
        chain = "the three-plane chain"
    else:
        want = sp.staged_route(ra, g)
        chain = "the staged route (K5, K2, K6, K5)"
        for name, which, args in route_cases(ra, g, "", small=False):
            wrapper, plain, _ = kernels.KERNELS[name]
            if not torch.equal(wrapper(*args), plain(*args)):
                raise AssertionError(f"{tag} {name} ({which}) of the staged "
                                     "y-route differs from its plain version")
        dms = {label: sum(device_ms(fn, KERNEL_ITERS, None).values())
               for label, fn in (
                   ("K4", lambda: rk.route_small(g, ra.src, ra.n)),
                   ("staged", lambda: sp.staged_route(ra, g)))}
        chain += (f", each launch bit-exact with its plain version; device "
                  f"time K4 {dms['K4']:.4f} ms, staged {dms['staged']:.4f} ms")
    same = torch.equal(got, want)
    print(f"{tag} route_small (y side, Tp {ra.Tp}, n {ra.n}, "
          f"{int((ra.src < 0).sum())} outputs read as 0): uploaded index "
          f"equals compose_route of its planes; K4 "
          f"{'bit-exact with' if same else 'DIFFERS from'} {chain}")
    if not same:
        raise AssertionError(f"{tag} K4 differs from the staged route")


def route_cases(ra, g, side, small=True):
    """The kernel launches of sp.apply_route_stream(ra, g), as
    kernel_cases gives them; ``small=False``: a route through K5,
    middle_pass and K5 in place of K4's one pass."""
    if small and ra.src is not None:
        return [("route_small", side, (g, ra.src, ra.n))]
    g1 = rk.tileperm(g, ra.s1)
    return ([("tileperm", f"{side} stage 1".strip(), (g, ra.s1))]
            + middle_cases(g1, ra.mid, side)
            + [("tileperm", f"{side} stage 3".strip(),
                (sp.middle_pass(g1, ra.mid), ra.s3))])


def middle_cases(g1, planes, side):
    """The kernel launches of sp.middle_pass(g1, planes), as kernel_cases
    gives them."""
    if planes.kind == "flat":
        return [("route_flat", side, (g1, planes.mid))]
    if planes.kind == "rec":
        m = rk.route_middle(g1, planes.m1, planes.csel)
        return [("route_middle", side, (g1, planes.m1, planes.csel)),
                ("route_m3", side, (m, planes.m3))]
    return [("groupperm", side, (rk.stream_to_middle(g1).contiguous(),
                                 planes.mid))]


def row_scale_args(name, args):
    """The kernel's arguments with values and gathered data made
    nonnegative: the plain version then computes the row scale."""
    if name == "reduce_slices":
        g1, vals, *rest = args
        return (g1.abs(), vals.abs(), *rest)
    if name == "reduce_stream":
        emit, gemit, vals, gx, p3, nys = args
        return (emit, gemit, vals.abs(), gx.abs(), p3, nys)
    if name in ("dia_spmv", "dia_spmm"):
        bands, offsets, x = args
        return (bands.abs(), offsets, x.abs())
    if name == "bsr_spmm":
        vals, brow, bcol, row_start, X, nrows = args
        return (vals.abs(), brow, bcol, row_start, X.abs(), nrows)
    if name == "lane_reduce":
        cols, vals, row0, row1, X, *rest = args
        return (cols, vals.abs(), row0, row1, X.abs(), *rest)
    if name == "pmm_spmm":
        col, val, rowptr, X, *rest = args
        return (col, val.abs(), rowptr, X.abs(), *rest)
    if name == "bell_gather_mac":
        li, vals, x, *rest = args
        return (li, vals.abs(), x.abs(), *rest)
    if name == "window_reduce":
        li, vals, w10, seg_blk, x, *rest = args
        return (li, vals.abs(), w10, seg_blk, x.abs(), *rest)
    xh, hidx, hvals, *rest = args
    return (xh.abs(), hidx, hvals.abs(), *rest)


def bound(name, args, out) -> tuple[float, str]:
    """The least time (ms) the card could take for the kernel's work, and
    what sets it: each input byte read once and each output byte written
    once over the HBM rate, or the float32 operations over the card's
    rate outside the tensor cores (one multiply and one add per stored
    element, and per column of X for an SpMM kernel: BSR counts its dense
    bricks, lane the plane rows its slots sum, PMM its entries).  BSR's
    f32-grade product runs on the tensor cores as 3xTF32: three TF32
    passes over its bricks at the TF32 rate.  The
    reduces read only the plane rows their slice tables name (this run's
    data); K3 reads, per element of those rows, its value and its composed
    index (in place of the route middle's planes, p3 and the M3 plane),
    one g1 element at most per element (at most g1's size in all), and its
    piece tables; the unfused
    reduce reads emit, and per element of those rows its value, p3 entry
    and one gx element (its gemit is not read); K4 its index and the ysp
    elements it names (none for a -1); K14 its entries (8 B each), its work plan's tables
    (segment offsets, units, combine table: on the card they take the
    place of the row offsets, which it does not read) and X once."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    ops, rate = 0, F32_OPS_PER_S
    if name == "route_small":  # the ysp elements the index reaches
        ysp, src, _n = args
        nbytes = (int(torch.unique(src[src >= 0]).numel()) + src.numel()) * 4
    if name == "reduce_stream":
        emit, _gemit, vals, gx, p3, nys = args
        row0, row1, _ = rk.reduce_stream_table(emit, nys)
        used = int((row1.long() - row0.long()).sum()) * 8 * 128
        nbytes = emit.numel() * 4 + used * (4 + 2 + 4)
        ops = 2 * used
    if name == "reduce_slices":
        g1, _vals, plan, _nys = args
        used = int((plan.row1.long() - plan.row0.long()).sum()) * 8 * 128
        nbytes = (used * (4 + 4) + min(used, g1.numel()) * 4
                  + 4 * (plan.split.pieces.numel()
                         + plan.split.combine.numel()))
        ops = 2 * used
    # (row0, row1) index and the planes of each reduce
    reduces = {"reduce_hot": (3, 4, slice(1, 3)),
               "window_reduce": (5, 6, slice(0, 2))}
    if name in reduces:
        i0, i1, planes = reduces[name]
        used = int((args[i1].long() - args[i0].long()).sum()) * 8 * 128
        for t in args[planes]:
            if t.dim() == 3:  # read only the used plane elements
                nbytes -= t.numel() * t.element_size()
                nbytes += min(used, t.numel()) * t.element_size()
        ops = 2 * used
    elif name in ("dia_spmv", "bell_gather_mac"):
        ops = 2 * args[0].numel()
    elif name == "dia_spmm":
        ops = 2 * args[0].numel() * out.shape[1]
    elif name == "bsr_spmm":  # three TF32 passes
        ops, rate = 3 * 2 * args[0].numel() * out.shape[1], TF32_OPS_PER_S
    elif name == "lane_reduce":
        used = int((args[3].long() - args[2].long()).sum()) * 1024
        ops = 2 * used * out.shape[1]
    elif name == "pmm_spmm":
        col, val, rowptr, X, work = args
        nbytes = sum(t.numel() * t.element_size() for t in (
            col, val, X, work.segptr, work.units, work.combine))
        ops = 2 * col.numel() * out.shape[1]
    nbytes += out.numel() * out.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(name, args, want=None):
    """One PyTorch call computing the kernel's function on the same
    inputs, checked to give the kernel's output; None where no single
    call does.  tileperm: torch.gather over the flat (T, 1024) tile
    view where every index is in [0, 1024).  The pure gathers (GATHERS):
    torch.take of the flattened
    data input, with one 0 appended for the outputs the kernel sets to 0,
    by the composed flat index, which the plain version gives when the
    data input holds its own flat positions (1-based, in float64: exact).
    The index, the flat views and the appended 0 are made here, outside
    what is timed, and the call must give the kernel's output (``want``,
    where the wrapper needs more than ``args``: K15 writes into the
    shard's g1).  bell_gather_mac: cuSPARSE's CSR SpMV
    (torch.sparse_csr_tensor @ x) of the matrix its planes hold, the BELL
    part without the routed spill; reduce_slices: cuSPARSE's CSR SpMV of
    the entries its slices sum, times g1 flattened (reduce_csr_call);
    lane_reduce: cuSPARSE's CSR SpMM of the entries its slots sum, times X
    (lane_csr_call); window_reduce: cuSPARSE's CSR SpMV of the entries
    its slices sum, times x (window_csr_call); reduce_hot and
    reduce_stream: cuSPARSE's CSR SpMV of the entries their slices sum,
    times the hot table or the middle output flattened (hot_csr_call,
    stream_csr_call); each within 1e-6 of the row scale of the kernel's
    output (they sum in another order)."""
    if name == "tileperm" and bool(((args[1] >= 0) & (args[1] < 1024)).all()):
        data, idx = args
        T = data.shape[1]
        src = rk.stream_to_flat(data).view(T, 1024)
        ix = rk.stream_to_flat(idx).long().view(T, 1024)
        want = rk.stream_to_flat(rk.tileperm(data, idx)).view(T, 1024)
        call = functools.partial(torch.gather, src, 1, ix)
    elif name in GATHERS:
        wrapper, plain, _ = kernels.KERNELS[name]
        pos = GATHERS[name]
        data = args[pos]
        ix = rk.source_index(
            lambda d: plain(*args[:pos], d, *args[pos + 1:]), data.shape,
            data.device)
        ix[ix < 0] = data.numel()  # the appended 0
        src = torch.cat([data.reshape(-1), data.new_zeros(1)])
        want = wrapper(*args) if want is None else want
        call = functools.partial(torch.take, src, ix)
    elif name == "bell_gather_mac":
        return bell_csr_call(args)
    elif name == "reduce_slices":
        return reduce_csr_call(args)
    elif name == "lane_reduce":
        return lane_csr_call(args)
    elif name == "window_reduce":
        return window_csr_call(args)
    elif name == "reduce_hot":
        return hot_csr_call(args)
    elif name == "reduce_stream":
        return stream_csr_call(args)
    else:
        return None
    if not torch.equal(call(), want):
        raise AssertionError(f"the library call is not {name}'s function")
    return call


def bell_csr_call(args):
    """K9's library call (library_call): the CSR matrix of the entries
    its planes hold, at the rows and columns bell_gather_mac_plain reads,
    times x by cuSPARSE."""
    li, vals, x, d, pre, n_keep = args
    R_sub = li.shape[1]
    q = torch.arange(R_sub, device=x.device).view(1, R_sub, 1)
    lane = torch.arange(128, device=x.device).view(1, 1, 128)
    idx = li.long()
    col = (8 * (q >> 3) + d + (idx >> 7) - pre) * 128 + (idx & 127)
    keep = (col >= 0) & (col < n_keep) & (vals != 0)
    row = (q * 128 + lane).expand_as(col)
    return csr_call("bell_gather_mac", row[keep], col[keep], vals[keep],
                    (R_sub * 128, x.shape[0]), x, args,
                    lambda y: y.view(R_sub, 128))


def csr_call(name, rows, cols, vals, shape, data, args, view):
    """The CSR matrix of the entries (rows, cols, vals) times ``data`` by
    cuSPARSE (torch.matmul of torch.sparse_csr_tensor), built here, once
    (duplicate entries summed), and checked to give the kernel's output
    ``view(call())`` within 1e-6 of the row scale of its plain version."""
    wrapper, plain, _ = kernels.KERNELS[name]
    A = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                size=shape).coalesce().to_sparse_csr()
    call = functools.partial(torch.matmul, A, data)
    got, want = view(call()), wrapper(*args)
    scale = plain(*row_scale_args(name, args))
    if not bool(((got - want).abs() <= 1e-6 * scale + 1e-30).all()):
        raise AssertionError(f"the library call is not {name}'s function")
    return call


def slice_entry_rows(item, out, nys, n, device):
    """The CSR row of each element of the n plane rows that the slice
    items ``item`` sum: (sublane i, the item's output slice, lane), one
    per output element of ys (8, nys, 128)."""
    i = torch.arange(8, device=device).view(8, 1, 1)
    lane = torch.arange(128, device=device).view(1, 1, 128)
    return (i * nys + out.long()[item].view(1, n, 1)) * 128 + lane


def reduce_csr_call(args):
    """K3's library call (library_call): cuSPARSE's CSR SpMV of the
    entries its slices sum, one row per (sublane i, slice, lane), each
    entry a plane value at the column its composed index names in g1
    flattened (the elements it reads as 0 left out), times g1 flattened;
    its output is ys flattened."""
    g1, vals, plan, nys = args
    item, rows = rk.slice_rows(plan.row0, plan.row1)
    row = slice_entry_rows(item, plan.out, nys, rows.shape[0], g1.device)
    col = plan.idx[:, rows, :].long()
    keep = col >= 0
    return csr_call("reduce_slices", row.expand_as(col)[keep], col[keep],
                    vals[:, rows, :][keep], (8 * nys * 128, g1.numel()),
                    g1.reshape(-1), args, lambda y: y.view(8, nys, 128))


def lane_csr_call(args):
    """K13's library call (library_call): cuSPARSE's CSR SpMM of the
    entries its slots sum, one row per (slot, lane), each entry a plane
    value at the column the plane names, times X; its output is ys."""
    cols, vals, row0, row1, X, _split = args
    nslots = row0.shape[0]
    slot, rows = rk.slice_rows(row0, row1)
    lane = torch.arange(1024, device=X.device).view(1, 1024)
    row = slot.view(-1, 1) * 1024 + lane
    return csr_call("lane_reduce", row.reshape(-1),
                    cols.view(-1, 1024)[rows].long().reshape(-1),
                    vals[rows].reshape(-1), (nslots * 1024, X.shape[0]), X,
                    args, lambda y: y)


def window_csr_call(args):
    """K10's library call (library_call): cuSPARSE's CSR SpMV of the
    entries its slices sum, one row per (sublane i, slice, lane), each
    entry a plane value at the x column its window names
    (window_kernels.window_columns; the pads' zero values and the
    elements that gather nothing left out), times x; its output is ys."""
    li, vals, w10, seg_blk, x, row0, row1, out, nys, segw, G, wrl = args
    item, rows = rk.slice_rows(row0, row1)
    col, valid = wk.window_columns(li, w10, seg_blk, rows, segw, G, wrl,
                                   x.shape[0])
    v = vals[:, rows, :]
    keep = valid & (v != 0)
    row = slice_entry_rows(item, out, nys, rows.shape[0], x.device)
    return csr_call("window_reduce", row.expand_as(col)[keep], col[keep],
                    v[keep], (8 * nys * 128, x.shape[0]), x, args,
                    lambda y: y.view(8, nys, 128))


def hot_csr_call(args):
    """K7's library call (library_call): cuSPARSE's CSR SpMV of the
    entries its slices sum, one row per (sublane i, slice, lane), each
    entry a hot value at the column its rank names in the hot table xh
    (pads' zero values and ranks past the table left out), times xh; its
    output is ys."""
    xh, hidx, hvals, row0, row1, out, nys = args
    item, rows = rk.slice_rows(row0, row1)
    col = hidx[:, rows, :].long()
    v = hvals[:, rows, :]
    keep = (col >= 0) & (col < xh.shape[0]) & (v != 0)
    row = slice_entry_rows(item, out, nys, rows.shape[0], xh.device)
    return csr_call("reduce_hot", row.expand_as(col)[keep], col[keep],
                    v[keep], (8 * nys * 128, xh.shape[0]), xh, args,
                    lambda y: y.view(8, nys, 128))


def stream_csr_call(args):
    """K18's library call (library_call): cuSPARSE's CSR SpMV of the
    entries its slices sum (reduce_stream_table), one row per (sublane i,
    slice, lane), each entry a plane value at the column of the gx
    element its p3 entry names in gx flattened (made contiguous once,
    here: K18 reads its group's rows in place), pads' zero values and
    entries out of range left out, times gx flattened; its output is ys."""
    emit, _gemit, vals, gx, p3, nys = args
    row0, row1, out = rk.reduce_stream_table(emit, nys)
    item, rows = rk.slice_rows(row0, row1)
    S = gx.shape[1]
    p = p3[:, rows, :].long()
    v = vals[:, rows, :]
    col = (((p >> 7) * S + rows.view(1, -1, 1)) * 128) + (p & 127)
    keep = (p >= 0) & (p < 1024) & (v != 0)
    row = slice_entry_rows(item, out, nys, rows.shape[0], gx.device)
    return csr_call("reduce_stream", row.expand_as(col)[keep], col[keep],
                    v[keep], (8 * nys * 128, gx.numel()),
                    gx.contiguous().view(-1), args,
                    lambda y: y.view(8, nys, 128))


def library_ms(call, device) -> tuple[float | None, float | None]:
    """The library call's ms by CUDA events and its device ms (a trace),
    (None, None) where there is no call."""
    if call is None:
        return None, None
    return (time_iterations(call, KERNEL_ITERS, device) * 1e3,
            sum(device_ms(call, KERNEL_ITERS, None).values()))


def check_kernels(tag, path, sd, xd, launches, spmv_dms, device,
                  library=None, ring=False):
    """Each kernel launch of the path (kernel_cases) against its plain
    version at the same inputs, with times, bound and library call.
    ``launches`` and ``spmv_dms`` (device ms per SpMV by kernel) come from
    the path's own run and trace; ``library`` gives the library call's ms
    of a kernel that is the whole SpMV (cuSPARSE's, measured in drive).
    ``ring``: the path's expand ran as K15's ring steps, which
    check_ring_kernel holds against their plain version; the cases here
    are the passes after it, on the g1 that K1 gives the same shard."""
    cases = kernel_cases(tag, sd, xd)
    also = set()
    if ring:
        cases = [c for c in cases if c[0] != "expand"]
        also = {"expand_ring"}
    return check_path(tag, path, cases, launches, spmv_dms, device,
                      library, also)


def check_path(tag, path, cases, launches, path_dms, device, library=None,
               also=()):
    """check_case on each of ``cases`` (kernel, which launch, its
    arguments at the path's own tensors), once they are shown to cover
    every kernel the path launched (``launches``) and no other: ``also``
    names the launched kernels the caller checks itself."""
    library = library or {}
    checked = {name for name, _, _ in cases} | set(also)
    launched = {k for k, n in launches.items() if n}
    if checked != launched:
        raise AssertionError(f"{tag} cases {sorted(checked)} are not the "
                             f"kernels the path launched: {sorted(launched)}")
    return [check_case(tag, path, name, which, args, launches, path_dms,
                       device, library.get(name))
            for name, which, args in cases]


def check_case(tag, path, name, which, args, launches, path_dms, device,
               lib_ms=None):
    """One kernel launch against its plain version at the same inputs,
    with its times, bound and library call (``lib_ms`` where the caller
    measured it, else library_call's, by CUDA events and device time);
    ``launches`` and ``path_dms`` (device ms by kernel) come from the
    path's own run and trace.  Returns the kernels-JSON row."""
    wrapper, plain, replaces = kernels.KERNELS[name]
    label = f"{name} ({which})" if which else name
    got, want = wrapper(*args), plain(*args)
    if name in EXACT:
        same = torch.equal(got, want)
        verdict = "bit-exact" if same else "DIFFERS"
    else:
        scale = plain(*row_scale_args(name, args))
        same = bool(((got - want).abs() <= 1e-6 * scale + 1e-30).all())
        verdict = "within 1e-6 of the row scale" if same else "DIFFERS"
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if name in REPEAT:
        if not torch.equal(got, wrapper(*args)):
            raise AssertionError(f"{label}: two launches on the same inputs "
                                 "differ")
        verdict += "; two launches equal bit for bit"
    ms = time_iterations(lambda: wrapper(*args), KERNEL_ITERS, device) * 1e3
    plain_ms = time_iterations(lambda: plain(*args), KERNEL_ITERS,
                               device) * 1e3
    dms = sum(device_ms(lambda: wrapper(*args), KERNEL_ITERS,
                        event_of(name)).values())
    pdms = sum(device_ms(lambda: plain(*args), KERNEL_ITERS, None).values())
    bound_ms, bound_by = bound(name, args, got)
    lib_dms = None
    if lib_ms is None:
        lib_ms, lib_dms = library_ms(library_call(name, args), device)
    lib_dev = "" if lib_dms is None else f", device {lib_dms:.4f} ms"
    print(f"{tag} {label}: {verdict}, max abs err {err:.3e}, "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events); "
          f"device time kernel {dms:.4f} ms, plain {pdms:.4f} ms "
          f"(traces hold all {KERNEL_ITERS} calls); in the path's "
          f"trace {path_dms[name]:.4f} ms over {launches[name]} launches; "
          f"bound {bound_ms:.4f} ms ({bound_by}); library call "
          f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}{lib_dev}")
    if not same:
        raise AssertionError(f"{label} disagrees with its plain version")
    return {
        "name": name, "route": "cuda", "source": kernels.SOURCES[name],
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms, "library_device_ms": lib_dms, "path": path,
        "launch": which,
        "device_ms": dms, "plain_device_ms": pdms,
        "spmv_device_ms": path_dms[name],
    }


def pack_with(csr, split_len, hot, env):
    """sell_pack_routed under the environment switches ``env``."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return sell_pack_routed(csr, split_len=split_len, hot=hot)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_geometries(device) -> set[str]:
    """Each of GEOMETRIES through spmv_routed on ``device``, against the
    float64 golden and against the CPU plain path of the same pack.
    Returns the K7 row walks the hot packs reached."""
    yb = rp.YB
    walks = set()
    try:
        for name, make, split_len, case_yb, hot, env, reaches in GEOMETRIES:
            rp.YB = case_yb or yb
            coo = make()
            csr = coo.to_csr()
            sr = pack_with(csr, split_len, hot, env)
            if not reaches(sr):
                raise AssertionError(f"{name}: pack misses its branch: "
                                     f"{geometry(sr)}")
            if sr.hot is not None:
                walks |= hot_branches(sr.hot)
            x = np.random.default_rng(7).standard_normal(
                coo.shape[1]).astype(np.float32)
            sd = sp.to_device_routed(sr, device)
            if sd.yroute.src is not None:
                check_src(f"[4] {name}", sd.yroute)
            xd = torch.from_numpy(x).to(device)
            kernels.reset_launches()
            y = sp.spmv_routed(sd, xd).cpu().numpy()
            launches = kernels.launches()
            record_y(f"[4] {name}", lambda: sp.spmv_routed(sd, xd))
            # CPU tensors take the plain versions and launch nothing.
            y_cpu = sp.spmv_routed(sp.to_device_routed(sr, "cpu"),
                                   torch.from_numpy(x)).numpy()
            scale = spmv_row_scale(csr, x)
            ok, nbad, maxrel = verify(y, spmv_golden_numpy(csr, x),
                                      rtol=1e-6, row_scale=scale)
            ok_cpu, _, maxrel_cpu = verify(y, y_cpu, rtol=1e-6,
                                           row_scale=scale)
            print(f"[4] {name} (YB {rp.YB}): {geometry(sr)} | golden "
                  f"{'PASS' if ok else 'FAIL'} ({nbad} bad, max rel "
                  f"{maxrel:.2e}) | CPU plain path "
                  f"{'PASS' if ok_cpu else 'FAIL'} (max rel "
                  f"{maxrel_cpu:.2e}) | launches "
                  f"{ {k: n for k, n in launches.items() if n} }")
            if not (ok and ok_cpu) or launches != expected_launches(sd):
                raise AssertionError(f"{name}: spmv_routed on {device} "
                                     "disagrees or skipped a kernel")
    finally:
        rp.YB = yb
    return walks


def fsm_path(device, walks):
    """Phase [5]: fsm-like at full size through the hybrid and the
    2048-tile y-route, its kernels K5-K7, and the hot="off" comparison."""
    t0 = time.perf_counter()
    coo = syn.fsm_like()
    print(f"[5] fsm_like: {coo.shape[0]}x{coo.shape[1]}, {coo.nnz} nnz, "
          f"generated in {time.perf_counter() - t0:.2f} s")
    sr, sd, xd, launches, _ms, spmv_dms, _lib = drive(
        "[5]", "fsm_like", coo, device,
        lambda sr: (sr.hot is not None and sr.hot.NH == 256
                    and sr.y_ra["Tp"] == 2048
                    and sr.y_ra["mid_planes"]["kind"] == "rec"
                    and sr.mid["kind"] == "rec"),
    )
    want = {**dict.fromkeys(kernels.KERNELS, 0), "expand": 1,
            "route_small": 1, "reduce_hot": 1,
            "reduce_slices": 1 + second_pass(sd.red_plan.split)}
    if launches != want:
        raise AssertionError(f"[5] launches {launches}, want {want}")
    walks |= hot_branches(sr.hot)
    if walks != {"regular", "swept"}:
        raise AssertionError(f"K7 walked only {sorted(walks)} in [4] and [5]")
    rows = check_kernels("[5]", "fsm_like", sd, xd, launches, spmv_dms,
                         device)
    # the same matrix without the hybrid: data for the gate's constants
    t0 = time.perf_counter()
    sr_off = sell_pack_routed(coo.to_csr(), hot="off")
    pack_off = time.perf_counter() - t0
    sd_off = sp.to_device_routed(sr_off, device)
    times = {}
    for label, s in (("hot", sd), ("off", sd_off), ("off", sd_off),
                     ("hot", sd)):
        t = time_iterations(lambda: sp.spmv_routed(s, xd), ITERS, device)
        times.setdefault(label, []).append(t * 1e3)
    per_off = device_ms(lambda: sp.spmv_routed(sd_off, xd), KERNEL_ITERS,
                        "expand_kernel")
    print(f"[5] hot=auto (NH {sr.hot.NH}) vs hot=off, ms/iter over {ITERS} "
          f"iters in turns hot, off, off, hot: hot {times['hot']}, off "
          f"{times['off']}; off: pack {pack_off:.3f} s, T {sr_off.T} tiles, "
          f"device time {sum(per_off.values()):.4f} ms/iter; hot device "
          "time in [5] above")
    return rows


def entry_points(name, coo, small, device):
    """The user's entry points with their defaults: the bench harness with
    impl="auto" on ``coo``, and ``cli spmv`` (--format auto) on a
    MatrixMarket file of the smaller matrix ``small``; each prints its
    three-line report and must verify.  On "cuda" both run with their
    default device."""
    on = {} if device == "cuda" else {"device": device}
    r = run_spmv_benchmark(coo, name=name, impl="auto", iters=ITERS, **on)
    r.print_report()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{name}_small.mtx")
        write_matrix_market(path, small)
        rc = cli.main(["spmv", path, "--iters", str(ITERS),
                       *(f"--{k}={v}" for k, v in on.items())])
    if not r.verified or rc != 0:
        raise AssertionError(f"[6] {name}: the harness or the CLI failed "
                             "to verify")


def format_paths(device):
    """Phase [6]: each of FORMATS at full size through pack_auto and spmv,
    the harness and the CLI, then every kernel launch of its path against
    its plain version."""
    rows = []
    for name, make, reaches, kernel, small in FORMATS:
        t0 = time.perf_counter()
        coo = make()
        print(f"[6] {name}: {coo.shape[0]}x{coo.shape[1]}, {coo.nnz} nnz, "
              f"generated in {time.perf_counter() - t0:.2f} s")
        _A, sd, xd, launches, _ms, spmv_dms, lib_ms = drive(
            "[6]", name, coo, device, reaches, pack=pack_auto,
            marker=f"{kernel}_kernel")
        del _A
        entry_points(name, coo, small(), device)
        del coo
        # K8 is the whole SpMV: cuSPARSE's SpMV is its library call
        library = {"dia_spmv": lib_ms} if kernel == "dia_spmv" else {}
        rows += check_kernels("[6]", name, sd, xd, launches, spmv_dms,
                              device, library)
    return rows


def spmm_golden(csr, X):
    """Float64 golden Y and the row scale |A| @ |X| for the columns of the
    host array X."""
    A64 = sps.csr_matrix((csr.vals.astype(np.float64), csr.cols, csr.rowptr),
                         shape=csr.shape)
    X64 = X.astype(np.float64)
    return A64 @ X64, abs(A64) @ np.abs(X64)


def check_columns(tag, what, Y, golden, scale) -> float:
    """Y's first columns against the golden at rtol 1e-6, row-scaled."""
    ok, nbad, maxrel = verify(Y, golden, rtol=1e-6, row_scale=scale)
    print(f"{tag} {what} vs float64 golden over {Y.shape[1]} columns (rtol "
          f"1e-6, row-scaled): {'PASS' if ok else 'FAIL'}, {nbad} bad "
          f"entries, max rel {maxrel:.3e}")
    if not ok:
        raise AssertionError(f"{tag} {what} disagrees with the golden")
    return maxrel


def library_spmm(tag, csr, Xd, golden, scale, device, sd=None):
    """The yardsticks, never on the port's path, checked against the
    golden and timed by CUDA events: cuSPARSE's CSR SpMM
    (torch.sparse_csr_tensor @ X), and for a BSR artifact torch's BSR
    matmul on the same bricks (torch.sparse_bsr_tensor @ X, where torch
    takes it).  Returns {"csr": ms, "bsr": ms or None}."""
    dev = torch.device(device)
    c = SPMM_CHECK_COLS
    A = torch.sparse_csr_tensor(
        torch.from_numpy(csr.rowptr).to(dev),
        torch.from_numpy(csr.cols.astype(np.int64)).to(dev),
        torch.from_numpy(csr.vals.astype(np.float32)).to(dev),
        size=csr.shape, check_invariants=False,
    )
    check_columns(tag, "cuSPARSE CSR SpMM", (A @ Xd)[:, :c].cpu().numpy(),
                  golden, scale)
    out = {"csr": time_iterations(lambda: A @ Xd, KERNEL_ITERS, device) * 1e3,
           "bsr": None}
    print(f"{tag} cuSPARSE CSR SpMM (torch.sparse_csr_tensor @ X, "
          f"yardstick): {out['csr']:.4f} ms/iter over {KERNEL_ITERS} iters")
    del A
    if isinstance(sd, BsrDevice):
        nrows, ncols = sd.shape
        try:
            Ab = torch.sparse_bsr_tensor(
                sd.row_start, sd.brick_col.long(), sd.vals,
                size=(sd.nrb * 128, sd.ncb * 128), check_invariants=False)
            Xp = torch.nn.functional.pad(Xd, (0, 0, 0, sd.ncb * 128 - ncols))
            check_columns(tag, "torch BSR matmul",
                          (Ab @ Xp)[:nrows, :c].cpu().numpy(), golden, scale)
            out["bsr"] = time_iterations(lambda: Ab @ Xp, KERNEL_ITERS,
                                         device) * 1e3
            print(f"{tag} torch BSR matmul (torch.sparse_bsr_tensor @ X, "
                  f"yardstick): {out['bsr']:.4f} ms/iter over "
                  f"{KERNEL_ITERS} iters")
        except (RuntimeError, NotImplementedError) as e:
            print(f"{tag} torch BSR matmul: not taken by torch here "
                  f"({type(e).__name__}: {str(e).splitlines()[0][:200]})")
    return out


def spmm_case(tag, name, coo, K, entry, want, device):
    """One case of SPMM_CASES: the entry point with its pick, one SpMM of
    random X with the launch counts, the golden over the first columns,
    the SpMM's time and device time, the yardsticks, and every kernel
    launch against its plain version (a looped SpMM's at column 0, its
    launches there those of one SpMV).  Returns the kernel rows."""
    csr = coo.to_csr()
    if entry == "cli":
        args = argparse.Namespace(matrix=name, format="auto", rhs=K,
                                  iters=ITERS, device=device, no_verify=False)
        run = cli._spmm(args, coo)
        if run.rc != 0 or run.fmt != want:
            raise AssertionError(f"{tag} cli spmv --rhs {K} picked "
                                 f"{run.fmt!r} (rc {run.rc}), want {want!r}")
        sd = run.sd
    else:
        A = pack_auto(csr)
        print(f"{tag} pack_auto: {describe(A)}")
        if not isinstance(A, DiaMatrix) or want != "dia":
            raise AssertionError(f"{tag} pack_auto gave {type(A).__name__}")
        sd = upload(A, device)
        del A
    X = np.random.default_rng(K).standard_normal(
        (coo.shape[1], K)).astype(np.float32)
    Xd = torch.from_numpy(X).to(device)

    kernels.reset_launches()
    Y = spmm(sd, Xd)
    torch.cuda.synchronize()
    launches = kernels.launches()

    if Y.shape != (coo.shape[0], K) or not bool(torch.isfinite(Y).all()):
        raise AssertionError(f"{tag} bad output: shape {tuple(Y.shape)}")
    golden, scale = spmm_golden(csr, X[:, :SPMM_CHECK_COLS])
    check_columns(tag, f"{want} SpMM", Y[:, :SPMM_CHECK_COLS].cpu().numpy(),
                  golden, scale)
    del Y
    print(f"{tag} launches in this path's run: "
          f"{ {k: n for k, n in launches.items() if n} }")
    if launches != expected_spmm_launches(sd, K):
        raise AssertionError(f"{tag} launches {launches}, the {want} SpMM "
                             f"needs {expected_spmm_launches(sd, K)}")
    ms = time_iterations(lambda: spmm(sd, Xd), ITERS, device) * 1e3
    name_k = spmm_kernel(sd)
    marker = None if name_k is None else event_of(name_k)
    per = device_ms(lambda: spmm(sd, Xd), KERNEL_ITERS, marker)
    dev_ms = sum(per.values())
    ours = by_kernel(per)
    print(f"{tag} {want} SpMM, K {K}: {ms:.4f} ms/iter over {ITERS} iters "
          f"(CUDA events), {2 * csr.nnz * K / ms / 1e6:.3f} GFLOPS "
          f"(2*nnz*K); device time {dev_ms:.4f} ms/iter (trace holds all "
          f"{KERNEL_ITERS} calls; busy {100 * dev_ms / ms:.1f}%); in the "
          "same trace: " + ", ".join(f"{k} {v:.4f}" for k, v in ours.items()
                                     if v)
          + f", other device work {dev_ms - sum(ours.values()):.4f} ms")
    lib = library_spmm(tag, csr, Xd, golden, scale, device, sd)
    rows = []
    if name_k is not None:  # an SpMM kernel: hold it against its plain
        # K13's library call is its own (library_call): cuSPARSE's SpMM of
        # the entries its slots name
        lib_ms = lib["bsr"] if name_k == "bsr_spmm" and lib["bsr"] else (
            None if name_k == "lane_reduce" else lib["csr"])
        rows = check_kernels(tag, f"{name} K {K}", sd, Xd, launches, ours,
                             device, {name_k: lib_ms})
    else:  # one SpMV per column: its launches at column 0's tensors
        rows = check_kernels(f"{tag} column 0", f"{name} K {K}", sd,
                             Xd[:, 0].contiguous(), launches, ours, device)
    for r in rows:
        r["spmm_ms"], r["cusparse_spmm_ms"] = ms, lib["csr"]
        r["torch_bsr_ms"] = lib["bsr"]
    return rows


def ragged_spmm(device) -> None:
    """Phase [7]'s RAGGED cases: each packed as DIA, BSR, the lane plan or
    the PMM plan, through spmm at each of RAGGED_K (and RAGGED_VEC_K for
    the lane and PMM plans) and at K 64 with X at a 4 B offset: the launch
    count, every column at the float64 golden, and the launch against its
    plain version within 1e-6 of the row scale (K13's and K14's also
    against a second launch, bit for bit)."""
    packs = {"dia": dia_pack, "bsr": lambda c: bsr_pack(c, min_fill=0.0),
             "lane": spmm_lane.spmm_lane_pack,
             "pmm": lambda c: spmm_pmm.pmm_plan(c.row_ids(), c.cols, c.vals,
                                                c.shape)}
    for name, make, fmt in RAGGED:
        coo = make()
        csr = coo.to_csr()
        A = packs[fmt](csr)
        sd = upload(A, device)
        ks = [(k, 0) for k in RAGGED_K] + [(64, 1)]
        if fmt == "lane":
            split = sd.split
            width = int((sd.row1 - sd.row0).max())
            print(f"[7] {name}: lane plan, {sd.row0.shape[0]} slots (the "
                  f"widest {width} plane rows), K13 pieces of at most "
                  f"{split.rows} rows: {split.pieces.shape[0]}, "
                  f"{split.combine.shape[0]} slots split")
            if not split.combine.shape[0]:
                raise AssertionError(f"[7] {name}: no K13 slot is split")
            ks += [(k, 0) for k in RAGGED_VEC_K]
        elif fmt == "pmm":
            work = sd.work
            width = int((sd.rowptr[1:] - sd.rowptr[:-1]).max())
            print(f"[7] {name}: PMM plan, {sd.rowptr.shape[0] - 1} rows (the "
                  f"longest {width} entries), K14 segments of at most "
                  f"{work.piece} entries: {work.segptr.shape[0] - 1} in "
                  f"{work.units.shape[0]} units, {work.combine.shape[0]} "
                  f"rows split into {work.npart} pieces")
            if not work.combine.shape[0]:
                raise AssertionError(f"[7] {name}: no K14 row is split")
            ks += [(k, 0) for k in RAGGED_VEC_K]
        elif fmt == "dia":
            _, nwin, smem = dk.window_plan(sd.offsets)
            print(f"[7] {name}: {describe(A)}; K11 plan {nwin} windows, "
                  f"{smem} B of shared memory a block")
            if name == "wide_reach" and nwin < 2:
                raise AssertionError("[7] wide_reach fits one K11 window")
        else:
            zero = int((sd.vals.abs().sum((1, 2)) == 0).sum())
            print(f"[7] {name}: BSR {sd.vals.shape[0]} bricks ({zero} of "
                  f"them zero) in {sd.nrb} row blocks")
        for K, offset in ks:
            tag = f"[7] {name} K {K}" + (" (X at a 4 B offset)"
                                         if offset else "")
            X = np.random.default_rng(K).standard_normal(
                (coo.shape[1], K)).astype(np.float32)
            buf = torch.empty(X.size + offset, device=device)
            Xd = buf[offset:].view(X.shape)
            Xd.copy_(torch.from_numpy(X))
            kernels.reset_launches()
            Y = spmm(sd, Xd)
            torch.cuda.synchronize()
            launches = kernels.launches()
            if launches != expected_spmm_launches(sd, K):
                raise AssertionError(f"{tag} launches {launches}")
            golden, scale = spmm_golden(csr, X)
            check_columns(tag, f"{fmt} SpMM", Y.cpu().numpy(), golden, scale)
            if fmt == "bsr" and (Y[:128].any() or Y[640:].any()):
                raise AssertionError(f"{tag} rows without entries are not 0")
            [(kname, _, args)] = kernel_cases(tag, sd, Xd)
            wrapper, plain, _ = kernels.KERNELS[kname]
            if kname in ("lane_reduce", "pmm_spmm"):
                vec = K % 4 == 0 and Xd.data_ptr() % 16 == 0
                n = launches[kname]
                print(f"{tag} {kname} reads X {'16' if vec else '4'} B a "
                      f"lane; {n} launch{'es: the second adds the split '
                      'items\' partials' if n > 1 else ''}")
            got, want = wrapper(*args), plain(*args)
            row_scale = plain(*row_scale_args(kname, args))
            err = float((got - want).abs().max())
            ok = bool(((got - want).abs() <= 1e-6 * row_scale + 1e-30).all())
            if kname in REPEAT:
                ok = ok and torch.equal(got, wrapper(*args))
            again = ", a second launch bit for bit" if kname in REPEAT else ""
            print(f"{tag} {kname}: "
                  f"{'within' if ok else 'NOT within'} 1e-6 of the row "
                  f"scale of its plain version{again}, max abs err "
                  f"{err:.3e}")
            if not ok:
                raise AssertionError(f"{tag} {kname} disagrees with its "
                                     "plain version")


def spmm_paths(device):
    """Phase [7]: each of SPMM_CASES at full size, then ``cli spmv --rhs
    K`` on a MatrixMarket file of the smaller matrix of its generator,
    then the RAGGED cases."""
    rows = []
    for name, make, small, cases in SPMM_CASES:
        t0 = time.perf_counter()
        coo = make()
        print(f"[7] {name}: {coo.shape[0]}x{coo.shape[1]}, {coo.nnz} nnz, "
              f"generated in {time.perf_counter() - t0:.2f} s")
        for K, entry, want in cases:
            tag = f"[7] {name} K {K} ({entry})"
            rows += spmm_case(tag, name, coo, K, entry, want, device)
        del coo
        on = [] if device == "cuda" else [f"--device={device}"]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{name}_small.mtx")
            write_matrix_market(path, small())
            for K, entry, _ in cases:
                if entry != "cli":
                    continue
                rc = cli.main(["spmv", path, "--rhs", str(K), "--iters",
                               str(ITERS), *on])
                if rc != 0:
                    raise AssertionError(f"[7] cli spmv --rhs {K} on "
                                         f"{name}_small: rc {rc}")
    ragged_spmm(device)
    return rows


def dist_launches(dm, mode) -> dict[str, int]:
    """Launches of each kernel in one SpMV of the row-sharded artifact
    ``dm``: every shard runs one shard's passes (one geometry); the ring
    mode replaces each shard's K1 by one K15 per ring step with blocks."""
    want = dict.fromkeys(kernels.KERNELS, 0)
    for shard in dm.shards:  # K3's second pass runs where a shard splits
        for k, n in expected_launches(shard).items():
            want[k] += n
    if mode == "overlap":
        want["expand"] = 0
        want["expand_ring"] = dm.n_shards * sum(
            1 for c in dm.meta["ring_cnt"] if c)
    return want


def dist_geometry(dm) -> str:
    m = dm.meta
    rows = np.diff(dm.bounds).tolist()
    ring = ""
    if "ring_cnt" in m:
        off = np.concatenate([[0], np.cumsum(m["ring_cnt"])])
        # each shard's own table span per step (the meta holds the max)
        own = [[int(pl["seg_ring"][off[s]:off[s + 1]].max(initial=-1)) + 1
                for s in range(dm.n_shards)] for pl in dm.planes]
        k_lo = [ring_base(dm, i).tolist() for i in range(dm.n_shards)]
        ring = (f"; ring_cnt {m['ring_cnt']} blocks of {rp.TB} tiles, "
                f"ring_nsegtab {m['ring_nsegtab']} (per shard {own}), ring "
                f"piece {m['ring_Wr']} x 128 columns, table base per shard "
                f"and step {k_lo}")
    return (f"{dm.n_shards} shards, rows {rows}, nnz "
            f"{dm.balance['part_nnz'].tolist()} (imbalance "
            f"{dm.balance['imbalance']:.4f}); per shard: T {m['T']} tiles, "
            f"middle {m['mid_kind']!r} Tk {m['mid_Tk']}, S_pad {m['S_pad']}, "
            f"{m['nslices']} slices in {len(m['ycall_rows'])} reduce groups, "
            f"y-route Tp {m['y_Tp']} {m['ymid_kind']!r} over {m['y_n']} rows, "
            f"{m['n_segs']} x segments, "
            f"{dm.planes[0]['extra_src'].shape[0]} split-row extras"
            f"{ring}")


def ring_base(dm, i):
    m = dm.meta
    return ring_table_base(RingSpec(dm.n_shards, i, m["ring_Wr"],
                                    m["ring_cnt"]), m["segw"])


def ring_reached(args) -> int:
    """The distinct gathered-x elements one K15 launch reads: those its
    tiles' windows reach (this run's data; the rest of the step's table,
    pieces not yet arrived among them, is never read)."""
    w8_s, gcls_s, seg_s, li, xg, off, k_lo, segw = args
    n = seg_s.shape[0] * rp.TB
    idx = li[:, off * rp.TB : off * rp.TB + n].long()
    hi = idx >> 7
    row = ((k_lo + seg_s.long()) * segw * 8).repeat_interleave(rp.TB)
    row = (row + w8_s.long()).view(1, n, 1) + hi
    ok = ((hi < gcls_s.long().repeat_interleave(8).view(1, n, 1))
          & (row < xg.shape[0]))
    return int(torch.unique((row * 128 + (idx & 127))[ok]).numel())


def ring_steps(dm, xd):
    """Every K15 launch of a ring SpMV of ``dm``, in path order, as (shard,
    step, arguments at the path's own tensors with the gathered-x buffer
    as it stands at that step, the step's table span)."""
    m, D = dm.meta, dm.n_shards
    TB, Wr, segw = rp.TB, m["ring_Wr"], m["segw"]
    off = np.concatenate([[0], np.cumsum(m["ring_cnt"])])
    xp = torch.nn.functional.pad(xd, (0, D * Wr * 128 - xd.shape[0]))
    xp = xp.reshape(D * Wr, 128)
    XGR = max(m["n_segs"] * segw * 8 + 8, D * Wr)
    out = []
    for i, sd in enumerate(dm.shards):
        k_lo = ring_base(dm, i)
        xg = torch.zeros((XGR, 128), dtype=torch.float32, device=xd.device)
        for s in range(D):
            p = (i - s) % D
            xg[p * Wr : (p + 1) * Wr] = xp[p * Wr : (p + 1) * Wr]
            o0, o1 = int(off[s]), int(off[s + 1])
            if o1 > o0:
                args = (sd.w8[o0 * TB : o1 * TB],
                        sd.gcls[o0 * TB // 8 : o1 * TB // 8],
                        dm.seg_ring[i][o0:o1], sd.li, xg.clone(), o0,
                        int(k_lo[s]), segw)
                out.append((i, s, args, max(int(m["ring_nsegtab"][s]), 1)))
    return out


def check_ring_kernel(tag, path, dm, xd, launches, spmv_dms, device):
    """K15 on every step of every shard against expand_ring_plain, bit for
    bit, with its time alone (CUDA events per launch; device time of all
    the launches of one SpMV from one trace), its bound (li 2 B and g1
    4 B per element, the step's w8, gcls and seg_ring slices, and 4 B per
    gathered-x element the step's windows reach (ring_reached), over the
    HBM rate) and its library call (one torch.take of the step's xg by the
    composed index, as library_call; device time of all the steps' calls
    from one trace).  Returns one kernels-JSON row over all the launches
    of one SpMV (times and bounds summed)."""
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, lib_ms=0.0)
    lib_calls = []
    segw8 = dm.meta["segw"] * 8
    steps = ring_steps(dm, xd)
    if len(steps) != launches["expand_ring"]:
        raise AssertionError(f"{tag} {len(steps)} ring steps, "
                             f"{launches['expand_ring']} launches")
    g1 = torch.zeros((8, dm.meta["T"], 128), dtype=torch.float32,
                     device=xd.device)
    for i, s, args, nseg in steps:
        got = rk.expand_ring(*args, g1)
        want = rk.expand_ring_plain(*args)
        same = torch.equal(got, want)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        ms = time_iterations(lambda: rk.expand_ring(*args, g1),
                             KERNEL_ITERS, device) * 1e3
        plain_ms = time_iterations(lambda: rk.expand_ring_plain(*args),
                                   KERNEL_ITERS, device) * 1e3
        reached = ring_reached(args)
        nbytes = got.numel() * (2 + 4) + reached * 4 + sum(
            a.numel() * a.element_size() for a in args[:3])
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        lib_calls.append(library_call("expand_ring", args, want=got))
        lib_ms = time_iterations(lib_calls[-1], KERNEL_ITERS, device) * 1e3
        print(f"{tag} expand_ring shard {i} step {s} (blocks "
              f"{args[2].shape[0]}, table base {args[6]}, span {nseg}; "
              f"reads {reached} x elements of the table's "
              f"{nseg * (segw8 + 8) * 128}): "
              f"{'bit-exact' if same else 'DIFFERS'}, max abs err "
              f"{err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(CUDA events); bound {bound_ms:.4f} ms (bytes); library "
              f"call {lib_ms:.4f} ms (torch.take)")
        if not same:
            raise AssertionError(f"{tag} expand_ring shard {i} step {s} "
                                 "disagrees with its plain version")
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("bound_ms", bound_ms), ("lib_ms", lib_ms)):
            tot[k] += v
        tot["err"] = max(tot["err"], err)

    def all_steps():
        for _, _, args, _ in steps:
            rk.expand_ring(*args, g1)

    # K15 launches K1's kernel: its device events carry that name
    dms = sum(device_ms(all_steps, KERNEL_ITERS, "expand_kernel",
                        per_call=len(steps)).values())
    lib_dms = sum(device_ms(lambda: [c() for c in lib_calls], KERNEL_ITERS,
                            None).values())
    print(f"{tag} expand_ring over the {len(steps)} launches of one SpMV: "
          f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms (CUDA "
          f"events, summed), device time {dms:.4f} ms alone, "
          f"{spmv_dms['expand_ring']:.4f} ms in the path's trace; bound "
          f"{tot['bound_ms']:.4f} ms; library call {tot['lib_ms']:.4f} ms "
          f"(torch.take, summed), device {lib_dms:.4f} ms")
    return {
        "name": "expand_ring", "route": "cuda",
        "source": kernels.SOURCES["expand_ring"],
        "replaces": kernels.KERNELS["expand_ring"][2],
        "launches": launches["expand_ring"], "max_abs_err": tot["err"],
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"], "bound_by": "bytes",
        "library_ms": tot["lib_ms"], "library_device_ms": lib_dms,
        "path": path,
        "launch": f"all {len(steps)} ring steps of one SpMV, summed",
        "device_ms": dms, "spmv_device_ms": spmv_dms["expand_ring"],
    }


def dist_mode(tag, dm, mode, xd, golden, scale, device):
    """One row-sharded SpMV in ``mode`` with the launch counts and the
    golden, then its time by CUDA events and as device time.  Returns
    (launches, ms, device ms by kernel)."""
    kw = DIST_MODES[mode]
    kernels.reset_launches()
    y = dist_spmv_routed(dm, xd, **kw)
    torch.cuda.synchronize()
    launches = kernels.launches()
    yn = y.cpu().numpy()
    if yn.shape != golden.shape or not np.isfinite(yn).all():
        raise AssertionError(f"{tag} bad output: shape {yn.shape}")
    ok, nbad, maxrel = verify(yn, golden, rtol=1e-6, row_scale=scale)
    print(f"{tag} {mode}: verify vs float64 golden (rtol 1e-6, row-scaled): "
          f"{'PASS' if ok else 'FAIL'}, {nbad} bad rows, max rel "
          f"{maxrel:.3e}; launches "
          f"{ {k: n for k, n in launches.items() if n} }")
    if not ok:
        raise AssertionError(f"{tag} {mode} disagrees with the golden")
    if launches != dist_launches(dm, mode):
        raise AssertionError(f"{tag} {mode} launches {launches}, the pack "
                             f"needs {dist_launches(dm, mode)}")
    fn = functools.partial(dist_spmv_routed, dm, xd, **kw)
    record_y(f"{tag} {mode}", fn)
    ms = time_iterations(fn, ITERS, device) * 1e3
    per = device_ms(fn, KERNEL_ITERS, "reduce_slices_kernel",
                    per_call=dm.n_shards)
    dev = sum(per.values())
    ours = by_kernel(per)
    if mode == "overlap":  # K15 launches K1's kernel
        ours["expand_ring"], ours["expand"] = ours["expand"], 0.0
    print(f"{tag} {mode}: {ms:.4f} ms/iter over {ITERS} iters (CUDA events), "
          f"{2 * dm.nnz / ms / 1e6:.3f} GFLOPS (2*nnz); device time "
          f"{dev:.4f} ms/iter (busy {100 * dev / ms:.1f}%); in the same "
          "trace: " + ", ".join(f"{k} {v:.4f}" for k, v in ours.items() if v)
          + f", other device work {dev - sum(ours.values()):.4f} ms "
          f"(copies, pads, the all-gather or the ring's moves)")
    return launches, ms, ours


def shard_reduces(tag, path, dm, xd, launches, ours, device, shard0):
    """K3 on every shard but 0 (whose row is among ``shard0``) against its
    plain version, as check_case; every shard of a forced pack holds a
    slice of up to 1,024 plane rows, split into pieces.  Prints K3's
    launches, device time alone and bound summed over the shards.
    Returns the kernels-JSON rows of shards 1 .."""
    rows = []
    for i, s in enumerate(dm.shards[1:], 1):
        g1 = rk.expand(s.w8, s.gcls, s.seg_blk, s.li, xd, s.segw, s.n_segs)
        rows.append(check_case(tag, path, "reduce_slices", f"shard {i}",
                               k3_args(s, g1), launches, ours, device))
    every = [r for r in shard0 if r["name"] == "reduce_slices"] + rows
    splits = [second_pass(s.red_plan.split) for s in dm.shards]
    print(f"{tag} reduce_slices over the {dm.n_shards} shards: "
          f"{dm.n_shards + sum(splits)} launches (second passes on shards "
          f"{[i for i, k in enumerate(splits) if k]}), device time alone "
          f"{sum(r['device_ms'] for r in every):.4f} ms, bound "
          f"{sum(r['bound_ms'] for r in every):.4f} ms, in the path's trace "
          f"{ours['reduce_slices']:.4f} ms")
    return rows


def dist_paths(device, main_sd, main_coo):
    """Phase [8]: the row-sharded routed SpMV on DIST_SHARDS shards that
    share the one card, in each mode of DIST_CASES, beside the one-card
    SpMV of the same matrix; K15 on every ring step against its plain
    version, and K1-K6 at a shard's shapes against theirs."""
    print(f"[8] the {DIST_SHARDS} shards share one card: the all-gather and "
          "the ring's moves are copies inside it, and these times are not "
          "scaling figures")
    mesh = make_mesh(devices=[device] * DIST_SHARDS)
    rows = []
    for name, make, modes in DIST_CASES:
        t0 = time.perf_counter()
        coo = main_coo if name == "web_google_like" else make()
        csr = coo.to_csr()
        print(f"[8] {name}: {coo.shape[0]}x{coo.shape[1]}, {coo.nnz} nnz, "
              f"generated in {time.perf_counter() - t0:.2f} s")
        x = np.random.default_rng(0).standard_normal(
            coo.shape[1]).astype(np.float32)
        xd = torch.from_numpy(x).to(device)
        golden, scale = spmv_golden_numpy(csr, x), spmv_row_scale(csr, x)
        if name == "web_google_like":
            sd1 = main_sd  # the pack of [2]
        else:
            t0 = time.perf_counter()
            sr1 = sell_pack_routed(csr)
            print(f"[8] {name} one-card pack {time.perf_counter() - t0:.3f} "
                  f"s: {geometry(sr1)}")
            sd1 = sp.to_device_routed(sr1, device)
            del sr1
        one = functools.partial(sp.spmv_routed, sd1, xd)
        ok, _, maxrel = verify(one().cpu().numpy(), golden, rtol=1e-6,
                               row_scale=scale)
        if not ok:
            raise AssertionError(f"[8] {name} one-card SpMV disagrees")
        if name != "web_google_like":  # [2]'s y
            record_y(f"[8] {name} one-card", one)
        one_ms = time_iterations(one, ITERS, device) * 1e3
        one_dev = sum(device_ms(one, KERNEL_ITERS, "expand_kernel").values())
        print(f"[8] {name} one-card spmv_routed: {one_ms:.4f} ms/iter (CUDA "
              f"events), device time {one_dev:.4f} ms/iter, golden max rel "
              f"{maxrel:.3e}")
        packs = {}
        for overlap in sorted({ring for _, ring, _ in modes}):
            t0 = time.perf_counter()
            dm = dist_routed_pack(csr, mesh, overlap=overlap)
            phases = ", ".join(f"{k} {v:.3f}"
                               for k, v in dm.convert_phases.items())
            print(f"[8] {name} dist_routed_pack(overlap={overlap}) "
                  f"{time.perf_counter() - t0:.3f} s ({phases}): "
                  f"{dist_geometry(dm)}")
            for i, shard in enumerate(dm.shards):
                check_src(f"[8] {name} shard {i}", shard.yroute)
            print(f"[8] {name} shards 0-{dm.n_shards - 1}: each uploaded K4 "
                  f"index (y-route Tp {dm.shards[0].yroute.Tp}) equals "
                  "compose_route of its planes")
            packs[overlap] = dm
        for mode, ring, check in modes:
            dm = packs[ring]  # a ring pack also runs the all-gather modes
            tag = f"[8] {name}"
            launches, ms, ours = dist_mode(tag, dm, mode, xd, golden, scale,
                                           device)
            path = f"{name} {DIST_SHARDS} shards {mode}"
            ring_mode = mode == "overlap"
            if ring_mode:
                rows.append(check_ring_kernel(tag, path, dm, xd, launches,
                                              ours, device))
            if check:
                # shard 0's passes at their own tensors (every shard runs
                # the same ones): every kernel the mode launched
                got = check_kernels(f"{tag} {mode} shard 0", path,
                                    dm.shards[0], xd, launches, ours, device,
                                    ring=ring_mode)
                for r in got:
                    r["launch"] = f"shard 0 {r['launch']}".strip()
                rows += got
                rows += shard_reduces(f"{tag} {mode}", path, dm, xd,
                                      launches, ours, device, got)
            print(f"[8] {name} {mode}: {ms:.4f} ms/iter on {DIST_SHARDS} "
                  f"shards of one card vs {one_ms:.4f} ms/iter for the "
                  f"one-card spmv_routed (x{ms / one_ms:.2f})")
        del packs, coo, csr
    return rows


def path_run(tag, fn, want):
    """One run of ``fn`` with every launch count set to 0 just before it
    and read just after; the counts must be ``want`` (the others 0).
    Returns (fn's result, launches)."""
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = kernels.launches()
    want = {**dict.fromkeys(kernels.KERNELS, 0), **want}
    print(f"{tag} launches in this path's run: "
          f"{ {k: n for k, n in launches.items() if n} }")
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, want {want}")
    return out, launches


def flat_middle(device, sd, xd):
    """Phase [9] (a): [2]'s y stream through K5 (stage 1), middle_pass on
    the y-route's flat planes (K16) and K5 (stage 3), against K4's one
    pass; then each of these launches against its plain version."""
    ra = sd.yroute
    if ra.mid.kind != "flat":
        raise AssertionError("[9a] the y-route of [2] is not flat")
    g1 = rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li, xd, sd.segw, sd.n_segs)
    ysp = sp.y_stream(sd, sp.reduce(sd, g1))
    y4 = rk.route_small(ysp, ra.src, ra.n)

    def path():
        g2 = sp.middle_pass(rk.tileperm(ysp, ra.s1), ra.mid)
        return rk.stream_to_flat(rk.tileperm(g2, ra.s3))[: ra.n]

    y, launches = path_run("[9a]", path, {"tileperm": 2, "route_flat": 1})
    if not torch.equal(y, y4):
        raise AssertionError("[9a] K5 + K16 + K5 differ from K4")
    ms = time_iterations(path, ITERS, device) * 1e3
    k4_ms = time_iterations(lambda: rk.route_small(ysp, ra.src, ra.n),
                            ITERS, device) * 1e3
    per = device_ms(path, KERNEL_ITERS, event_of("route_flat"))
    ours = by_kernel(per)
    print(f"[9a] flat y-route of [2] (n {ra.n}) by K5 + K16 + K5: bit-exact "
          f"with K4; {ms:.4f} ms/iter (CUDA events) vs K4 {k4_ms:.4f} ms; "
          f"device time {device_split(per, ours)}")
    return check_path("[9a]", "web_google_like y-route K5+K16+K5",
                      route_cases(ra, ysp, "y side", small=False), launches,
                      ours, device)


# Phase [9] (b): (tile_multiple, middle kind, launches of one apply_route)
PERM_ROUTES = (
    (1, "brute", {"tileperm": 2, "groupperm": 1}),
    (1024, "rec", {"tileperm": 2, "route_middle": 1, "route_m3": 1}),
)


def permutation_routes(device, csr):
    """Phase [9] (b): apply_route of the permutation that sorts the
    matrix's nonzeros by column (the CSR -> CSC value order), compiled
    with tile_multiple 1 (the brute middle, K17) and 1024 (the recursive
    middle, K2 + K6), against v[perm]; then each launch of each route
    against its plain version."""
    perm = np.argsort(csr.cols, kind="stable")
    N = perm.shape[0]
    v = np.random.default_rng(1).standard_normal(N).astype(np.float32)
    vd = torch.from_numpy(v).to(device)
    permd = torch.from_numpy(perm).to(device)
    want_v = vd[permd]
    index_ms = time_iterations(lambda: vd[permd], ITERS, device) * 1e3
    rows = []
    for tm, kind, want in PERM_ROUTES:
        tag = f"[9b] {kind}"
        t0 = time.perf_counter()
        ra = rp.route_arrays_from_perm(perm, tile_multiple=tm)
        compile_s = time.perf_counter() - t0
        mp = ra["mid_planes"]
        if mp["kind"] != kind or (kind == "brute"
                                  and mp["Tk"] * 128 != ra["Tp"]):
            raise AssertionError(f"{tag} route has middle {mp['kind']!r}")
        rd = sp.route_to_device(ra, device)
        out, launches = path_run(tag, lambda: sp.apply_route(rd, vd), want)
        if not torch.equal(out, want_v):
            raise AssertionError(f"{tag} apply_route differs from v[perm]")
        fn = functools.partial(sp.apply_route, rd, vd)
        ms = time_iterations(fn, ITERS, device) * 1e3
        per = device_ms(fn, KERNEL_ITERS, event_of("tileperm"), per_call=2)
        ours = by_kernel(per)
        print(f"{tag}: {N} elements, tile_multiple {tm}: T {ra['T']}, Tp "
              f"{ra['Tp']}, middle {kind!r} Tk {mp['Tk']}, route compile "
              f"{compile_s:.3f} s; apply_route bit-exact with v[perm]: "
              f"{ms:.4f} ms/iter (CUDA events), device time "
              f"{device_split(per, ours)}; v[perm] (torch indexing) "
              f"{index_ms:.4f} ms")
        g = rk.flat_to_stream(torch.nn.functional.pad(
            vd, (0, rd.Tp * 1024 - N)), rd.Tp).contiguous()
        rows += check_path(
            tag, f"web_google_like CSR->CSC apply_route, {kind} Tk {mp['Tk']}",
            route_cases(rd, g, ""), launches, ours, device)
    return rows


def unfused_reduce(device, sr, sd, csr, x, xd):
    """Phase [9] (c): the unfused routed SpMV on [2]'s pack: the expand,
    middle_pass in full, then K18 once per reduce group (reduce_unfused)
    and the y-route; its ys against K3's within 1e-6 of the row scale, its
    y against the float64 golden, its time beside spmv_routed's; then
    each launch of the path (the expand, the x side's middle_pass, each
    K18, the y-route) against its plain version."""
    emit = torch.from_numpy(sr.emit).to(device)
    gemit = torch.from_numpy(rp.group_emit_encode(sr.emit)).to(device)
    groups = np.asarray(sr.ycall_rows).tolist()  # (first row, rows) each
    ngroups = sum(1 for _, nr in groups if nr)  # K18 launches

    def unfused():
        g1 = rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li, xd, sd.segw,
                       sd.n_segs)
        ys = sp.reduce_unfused(sd, sp.middle_pass(g1, sd.mid), emit, gemit,
                               sr.ycall_rows)
        return ys, sp.y_from_slices(sd, ys, xd)

    want = expected_launches(sd)
    want["reduce_slices"] = 0
    want["reduce_stream"] = ngroups
    if sd.mid.kind == "rec":  # middle_pass: K2 and K6
        want["route_middle"] += 1
        want["route_m3"] += 1
    else:
        want["route_flat"] += 1
    (ys, y), launches = path_run("[9c]", unfused, want)
    g1 = rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li, xd, sd.segw, sd.n_segs)
    ys3 = sp.reduce(sd, g1)
    abs_sd = dataclasses.replace(sd, vals_ss=sd.vals_ss.abs())
    scale = sp.reduce(abs_sd, g1.abs())
    err = float((ys - ys3).abs().max())
    if not bool(((ys - ys3).abs() <= 1e-6 * scale + 1e-30).all()):
        raise AssertionError(f"[9c] K18's ys differ from K3's ({err:.3e})")
    ok, nbad, maxrel = verify(y.cpu().numpy(), spmv_golden_numpy(csr, x),
                              rtol=1e-6, row_scale=spmv_row_scale(csr, x))
    print(f"[9c] unfused reduce on [2]'s pack ({ngroups} reduce groups): "
          f"ys within 1e-6 of the row scale of K3's (max abs diff "
          f"{err:.3e}); y vs float64 golden (rtol 1e-6, row-scaled): "
          f"{'PASS' if ok else 'FAIL'}, {nbad} bad rows, max rel {maxrel:.3e}")
    if not ok:
        raise AssertionError("[9c] the unfused SpMV disagrees with the golden")
    times = {}
    for label, fn in (("fused", lambda: sp.spmv_routed(sd, xd)),
                      ("unfused", unfused), ("unfused", unfused),
                      ("fused", lambda: sp.spmv_routed(sd, xd))):
        times.setdefault(label, []).append(
            time_iterations(fn, ITERS, device) * 1e3)
    per = device_ms(unfused, KERNEL_ITERS, "reduce_stream_kernel",
                    per_call=ngroups)
    ours = by_kernel(per)
    print(f"[9c] ms/iter over {ITERS} iters in turns fused, unfused, "
          f"unfused, fused: fused {times['fused']}, unfused "
          f"{times['unfused']}; unfused device time {device_split(per, ours)}")
    gx = sp.middle_pass(g1, sd.mid)
    cases = [("expand", "", (sd.w8, sd.gcls, sd.seg_blk, sd.li, xd, sd.segw,
                             sd.n_segs))]
    cases += middle_cases(g1, sd.mid, "x side")
    for j, (r0, nr) in enumerate(groups):
        if not nr:  # a group of zero-width slices launches nothing
            continue
        rows = slice(r0, r0 + nr)
        cases.append(("reduce_stream", f"group {j}", (
            emit[rows], gemit[r0 // 8 : (r0 + nr) // 8], sd.vals_ss[:, rows],
            gx[:, rows], sd.p3[:, rows],
            min(rp.YB, sd.nslices - j * rp.YB))))
    cases += y_cases("[9c]", sd, ys, xd)
    return check_path("[9c]", "web_google_like unfused reduce", cases,
                      launches, ours, device)


# Phase [9] (d): (kernel, planes, rows): K5 at a T no route of the phases
# reaches (odd), K17 at the largest K its int16 index reaches (192 KB of
# shared memory a block)
RAGGED_PERMS = (("tileperm", 8, 1001), ("groupperm", 256, 1024))


def ragged_perms(device):
    """Phase [9] (d): K5 and K17 (RAGGED_PERMS) on data and an index made
    from a seed, the index also reaching outside the staged planes
    (negative, and past them where int16 reaches: 0 there); one run with
    the launch counts, then each launch against its plain version, bit
    for bit."""
    rng = np.random.default_rng(9)
    cases = []
    for name, P, R in RAGGED_PERMS:
        data = rng.standard_normal((P, R, 128), dtype=np.float32)
        idx = rng.integers(-3, min(P * 128 + 3, 2**15), (P, R, 128),
                           dtype=np.int32).astype(np.int16)
        cases.append((name, f"{P} planes of {R} rows", (
            torch.from_numpy(data).to(device),
            torch.from_numpy(idx).to(device))))

    def path():
        return [kernels.KERNELS[name][0](*args) for name, _, args in cases]

    _, launches = path_run("[9d]", path, {name: 1 for name, _, _ in cases})
    ours = by_kernel(device_ms(path, KERNEL_ITERS, event_of("groupperm")))
    return check_path("[9d]", "synthetic planes, ragged T and K 256", cases,
                      launches, ours, device)


def route_api(device, sr, sd, coo):
    """Phase [9]: the route library's device API on [2]'s matrix, pack
    and tensors, then K5 and K17 on synthetic planes."""
    csr = coo.to_csr()
    x = np.random.default_rng(0).standard_normal(coo.shape[1]).astype(np.float32)
    xd = torch.from_numpy(x).to(device)
    rows = flat_middle(device, sd, xd)
    rows += permutation_routes(device, csr)
    rows += unfused_reduce(device, sr, sd, csr, x, xd)
    rows += ragged_perms(device)
    return rows


def y_digests(device) -> dict[str, str]:
    """y_digest of every routed y of the phases (PARENT_Y_SHA256's
    labels), each computed as its phase computes it (the same pack, x and
    call), by the package this script imports: run in a checkout of
    another commit, it gives that commit's."""
    out = {}

    def x_of(coo, seed=0):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(
            coo.shape[1]).astype(np.float32)).to(device)

    def spmv_of(label, coo, pack):
        sd, xd = upload(pack(coo.to_csr()), device), x_of(coo)
        out[label] = y_digest(lambda: spmv(sd, xd))

    web = syn.web_google_like()
    spmv_of("[2] web_google_like", web, sell_pack_routed)
    yb = rp.YB
    try:
        for name, make, split_len, case_yb, hot, env, _ in GEOMETRIES:
            rp.YB = case_yb or yb
            coo = make()
            sd = sp.to_device_routed(
                pack_with(coo.to_csr(), split_len, hot, env), device)
            xd = x_of(coo, 7)
            out[f"[4] {name}"] = y_digest(lambda: sp.spmv_routed(sd, xd))
    finally:
        rp.YB = yb
    spmv_of("[5] fsm_like", syn.fsm_like(), sell_pack_routed)
    spmv_of("[6] road_usa_like", syn.road_usa_like(), pack_auto)
    mesh = make_mesh(devices=[device] * DIST_SHARDS)
    for name, make, modes in DIST_CASES:
        coo = web if name == "web_google_like" else make()
        csr, xd = coo.to_csr(), x_of(coo)
        if name != "web_google_like":
            sd1 = sp.to_device_routed(sell_pack_routed(csr), device)
            out[f"[8] {name} one-card"] = y_digest(
                lambda: sp.spmv_routed(sd1, xd))
        for overlap in sorted({ring for _, ring, _ in modes}):
            dm = dist_routed_pack(csr, mesh, overlap=overlap)
            for mode, ring, _ in modes:
                if ring == overlap:
                    out[f"[8] {name} {mode}"] = y_digest(functools.partial(
                        dist_spmv_routed, dm, xd, **DIST_MODES[mode]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--y-digests", action="store_true",
                    help="print y_digests (a JSON object) and stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[0] device: {kind}")
    print(f"[0] nvidia-smi: {smi}")
    build()
    if args.y_digests:
        print(json.dumps(y_digests("cuda")))
        return 0
    t0 = time.perf_counter()
    coo = syn.web_google_like()
    print(f"[2] web_google_like: {coo.shape[0]}x{coo.shape[1]}, {coo.nnz} "
          f"nnz, generated in {time.perf_counter() - t0:.2f} s")
    sr, sd, xd, launches, _ms, spmv_dms, _lib = main_path(coo, "cuda")
    rows = check_kernels("[3]", "web_google_like", sd, xd, launches,
                         spmv_dms, "cuda")
    del xd
    walks = check_geometries("cuda")
    rows += fsm_path("cuda", walks)
    rows += format_paths("cuda")
    rows += spmm_paths("cuda")
    rows += dist_paths("cuda", sd, coo)
    rows += route_api("cuda", sr, sd, coo)
    if set(Y_SHA256) != set(PARENT_Y_SHA256):
        raise AssertionError(f"[10] the routed y's {sorted(Y_SHA256)} are "
                             f"not the recorded {sorted(PARENT_Y_SHA256)}")
    print(f"[10] all {len(Y_SHA256)} routed y's equal the parent's bit for "
          "bit (sha256)")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
