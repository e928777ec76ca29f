#!/usr/bin/env python3
"""Drive the port's SpMV and SpMM paths and its payloads once on one
NVIDIA H100.

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
     against the staged y-route), and K3 on every other shard against
     its plain version, untimed (each shard of a forced pack holds a
     slice of up to 1,024 plane rows), with its launches over the shards;
  9. the route library's device API on [2]'s matrix, pack and tensors:
     (a) [2]'s y stream through K5, middle_pass on the y-route's flat
     planes (K16) and K5, bit for bit against K4's one pass; (b)
     apply_route of the permutation that sorts its 6,162,120 nonzeros by
     column (CSR -> CSC value order) compiled with tile_multiple 1 (T
     6018, the brute middle: K5, K17, K5) and 1024 (T 6144, the recursive
     middle: K5, K2, K6, K5), bit for bit against v[perm], with the route
     compile time and v[perm]'s time by torch indexing beside it (K2 at
     Tk 6 takes its staged body); (c) the unfused SpMV (expand,
     middle_pass in full: K2 staged at Tk 7 and K6, then K18 once per
     reduce group by the plan made at upload, with a second pass where a
     slice is split, and the y-route): its ys within 1e-6 of the row
     scale of K3's, its y at the float64 golden, its time beside
     spmv_routed's, each K18 call without the plan bit for bit equal to
     one with it; (d) K5 on 8 planes of 1,001 tiles, K17 on 256 planes
     (192 KB of shared memory a block) and K2 at Tk 8 (its split body),
     on planes made from a seed whose index also reaches outside them
     (K2: chunk selects outside [0, Tk)); each phase with its launch
     counts, and every launch of each sub-path against its plain version
     as in [3] (the set checked equals the set launched; K18 also
     against a second launch, bit for bit);
 10. the digests: every routed y above (the SpMVs of [2], [4], [5], the
     road-usa-like of [6] and each mode of [8]) has its sha256 printed
     beside the one PARENT_Y_SHA256 records, taken with torch's
     deterministic algorithms (index_add_ adds the split-row extras by
     atomics otherwise); they must be equal (``--y-digests`` prints the
     digests of a checkout's package alone);
 11. the payloads (cvr_tpu_torch.models), each through the entry point a
     user calls, with its launch counts, its answer against float64 and
     every kernel it launched against its plain version at its last
     operator input (as in [3]; rows under paths models_*), and its time
     beside the same loop over cuSPARSE: (a) PageRank on [2]'s matrix's
     links transposed, through bench.models (pagerank_routed, 50
     iterations at tol 0, then to tol 1e-8); (b) CG to 1e-6 on the SPD
     banded system of 1,048,576 rows through bench.models (SELL-W: K10;
     cg_shaped's time); (c) a GCN 64 -> 64 -> 16 on gcn_normalize of [2]'s
     links through the artifact cli.spmm_pick("auto", K 64) picks, under a
     process-wide float32 matmul precision of "high" (TF32); (d) BiCGSTAB,
     Jacobi (K8), Lanczos, power iteration, subspace iteration (spmm),
     a GraphSAGE layer and pagerank_sell at tests/test_models.py's sizes
     and checks (a payload's kernels held only where it launched one
     that [11] has not held yet);
 12. the packed artifacts, saved in the JAX package's .npz layout, loaded
     and run on the card: (a) the main path's matrix as a MatrixMarket
     file through ``cli spmv --format routed --save-packed`` and ``cli spmv
     --load-packed`` (the kind sniffed from the keys; both verified), then
     loaded and uploaded here: its y's sha256 against [2]'s recorded one,
     its launches, golden and kernels (path loaded_web_google_like); (b)
     each other kind (LOADED: DIA, also through spmm at K 64; BELL with a
     routed spill; SELL-W, also with a y-route, K10 then K4; BSR, PMM and
     lane plans; the plain SELL planes; [4]'s pack with hot planes, its y
     against [4]'s digest) packed, saved, loaded and uploaded, each step
     timed: its y or Y against the packed artifact's bit for bit (torch's
     deterministic algorithms), at the golden, its launches, and each
     kernel launch against its plain version (paths loaded_*); (c) the
     artifacts the JAX package's savers wrote (tests/fixtures/jax_*.npz),
     each against the port's own pack of its matrix, bit for bit; (d)
     ``cli compare`` (six reports or refusals, then Best:), ``compare
     --rhs 8``, ``info --iters 2 --threads 68``, ``spmv --format window``
     and ``spmv --format sell --c 128 --sigma 64``, each exiting 0;
 14. the other row-sharded paths (cvr_tpu_torch.parallel) at full size
     on 4 shards of the one card (the 2-D mesh on 2 x 2 of it; the
     all-gather, the mesh's moves and its reduce-scatter are copies inside
     it, so the times are the cost of sharding, not scaling figures):
     dist_dia on banded-2M (K8), dist_window on fem-like (K10), dist_bell
     on road-usa-like (K9 and its spill's K1, K3, K4), dist_bsr on
     fem-like at K 64 (K12), dist_lane on web-Google-like at K 128 (K13),
     dist_pmm on fsm-like at K 32 (K14), dist2d on web-Google-like (K1,
     K3, K4 a block); each with its pack's seconds and geometry, then with
     x replicated and all-gathered (dist2d: x whole): launches against
     the geometry's, the float64 golden (SpMM: 8 columns), y's sha256
     under deterministic algorithms (printed), times by CUDA events and
     device time beside the one-card path of the same matrix; shard 0's
     kernel launches against their plain versions as in [3] and the
     path's kernel on every other shard against its plain version,
     untimed (in the replicated mode:
     the all-gathered x is checked equal to x, so the kernels' inputs are
     the same); then dryrun_multichip(4), the JAX dry run's ten paths, on
     the card;
 15. multi-process runs: 4 gloo ranks (initialize_distributed), each a
     process that torch.multiprocessing spawns and hands [2]'s CSR as
     shared CPU tensors, share the card, so every move goes through host
     memory: [8]'s routed SpMV of web-Google-like in its three modes (each
     rank packs every shard and uploads its own), with the packs' seconds
     and geometry, each rank's launches against its shard's geometry, y
     at the float64 golden (rank 0) and its sha256 on every rank
     (deterministic algorithms) equal to [8]'s recorded one, the time by
     CUDA events, rank 0's device time, the exchange alone and [8]'s
     one-process time beside it, and rank 0's kernel launches (K1, K3,
     K4 of the x_sharded mode, K15 on its ring steps; [8] holds the ring
     pack's K3 and K4) against their plain versions as in [3];
     [14]'s 2-D mesh on 2 x 2 ranks (its digest [14]'s); the multi-host
     script's window, dia, xla, bell and lane impls on the smaller
     matrices of their generators, each rank's y bit for bit that of the
     single-process mesh of 4 shards of the card; then ``python -m
     cvr_tpu_torch.multihost --impl routed`` as 4 gloo ranks and alone,
     each exiting 0;
 16. the tools (bench/sweep, spmm, profile_passes, comm_model, parity),
     the routed pack without the native library, and soc-LJ-full: (a)
     soc-LJ-full (R-MAT 23, edge factor 9: 8,388,608 rows, 74,366,358
     nnz, the JAX package's record) through run_spmv_benchmark(impl
     "auto"), which must pick the routed path packed by the native
     library: its route tiles and split-row extras beside the record's,
     its launches over the harness's calls, its report, y of a random x
     at the float64 golden, its time by CUDA events and device time by
     kernel beside cuSPARSE's CSR SpMV, its generation, pack and upload
     seconds, and every kernel of the path against its plain version as
     in [3]; (b) the sweep's default suite with impls auto, sell-xla,
     sell and csr, two packs a run, every run verified; (c) R-MAT 18
     packed without the native library (the tests' switch; the route's
     coloring alone still in the library), its pack seconds beside the
     native pack's, its SpMV at the golden and within the contract of the
     native pack's y, its kernels against their plain versions; (d)
     profile_passes' per-pass table of routed (web-Google-like), window
     (fem-like), dia and bsr (banded-2M, K 128) from one trace each; (e)
     ``spmm --quick`` (K12 at K 128) at the golden, then comm_model and
     parity over (a)'s and (b)'s rows, each table printed.  The
     generators' cache (CVR_TPU_CACHE) and the tools' files live in a
     temporary directory removed at the end;
 17. the headline entry, python -m cvr_tpu_torch.bench (root bench.py's
     counterpart) and cvr_tpu_torch.entry (__graft_entry__'s): (a) its
     --quick runs (rmat13: sell-routed at 200 iterations, sell-xla, csr,
     and sell-routed with --pack-repeats 2), each a subprocess that must
     exit 0 with "Verification: PASS", bench.py's four-key JSON object as
     the last line of stdout, rounded from the GFLOPS of the BenchResult
     it prints on stderr, whose device is the card (and, at two packs,
     the first pack's seconds); (b) its full default run (web-Google-like,
     sell-routed, 100 iterations) once, on the generator cache that
     full_size wrote, its GFLOPS, SpMV and pack seconds beside [2]'s; (c)
     entry("cuda") in this process: launches against the pack's, y at the
     float64 golden, every kernel launch against its plain version as in
     [3] (rows under path entry), then ``python -m cvr_tpu_torch.entry
     entry``, which must exit 0; (d) the --quick default in this process
     (its pack fires the hub-column gate: K7), its launches over the
     harness's calls and its kernels against their plain versions (path
     bench_quick_rmat13);
 13. a JSON line of the kernels of every path, then the last line
     {"ok": true, "device": {...}}.

``--phases 1,2,12`` runs the build, the main path and [12] alone,
``--phases 16`` the build and [16], ``--phases 15`` the build and [15],
and ``--phases 17`` the build and [17] (the
default runs every phase; [0], [1] and [13] always run, [3] with [2], [8]
and [9] need [2], [14] reuses [2]'s pack where [2] ran, and [10]'s check
runs when [2], [4], [5], [6] and [8] all ran).  The full-size matrices
are generated once per run (full_size) and shared by the phases.  Any failure raises, and the script exits non-zero.  It needs a
CUDA card and the repository around it; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import importlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sps
from scipy.sparse.linalg import spsolve
import torch

from cvr_tpu_torch import _native, cli, multihost
from cvr_tpu_torch import entry as flagship
from cvr_tpu_torch.bench import comm_model as bench_comm
from cvr_tpu_torch.bench import harness as bench_harness
from cvr_tpu_torch.bench import models as bench_models
from cvr_tpu_torch.bench import parity as bench_parity
from cvr_tpu_torch.bench import profile_passes as bench_passes
from cvr_tpu_torch.bench import spmm as bench_spmm
from cvr_tpu_torch.bench import sweep as bench_sweep
from cvr_tpu_torch.bench import synthetic as syn
from cvr_tpu_torch.bench.bounds import HBM_BYTES_PER_S, bound
from cvr_tpu_torch.bench.harness import (
    SECOND,
    by_kernel,
    device_ms,
    event_of,
    run_spmv_benchmark,
    time_iterations,
)
from cvr_tpu_torch.formats import pack_auto
from cvr_tpu_torch.formats.bell import BellMatrix, bell_pack
from cvr_tpu_torch.formats.bsr import BsrMatrix, bsr_pack
from cvr_tpu_torch.formats.coo import COOMatrix
from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.formats.dia import DiaMatrix, dia_pack
from cvr_tpu_torch.formats.sell import SellMatrix, sell_pack
from cvr_tpu_torch.formats.sell_routed import (
    RingSpec,
    SellRouted,
    load_routed,
    ring_table_base,
    sell_pack_routed,
)
from cvr_tpu_torch.formats.sell_window import SellWindow, sell_pack_window
from cvr_tpu_torch.io.mmio import write_matrix_market
from cvr_tpu_torch.models import (
    bicgstab,
    conjugate_gradient,
    gcn_forward,
    gcn_normalize,
    graphsage_layer,
    jacobi,
    lanczos,
    pagerank,
    power_iteration,
    subspace_iteration,
)
from cvr_tpu_torch.models.gnn import params_from_reference
from cvr_tpu_torch.models.pagerank import pagerank_routed, pagerank_sell
from cvr_tpu_torch.ops import _build, kernels
from cvr_tpu_torch.ops import route as troute
from cvr_tpu_torch.ops import dia_kernels as dk
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import route_planes as rp
from cvr_tpu_torch.ops import window_kernels as wk
from cvr_tpu_torch.ops import spmv_routed as sp
from cvr_tpu_torch.ops import spmm_bsr, spmm_lane, spmm_pmm
from cvr_tpu_torch.ops.spmm_bsr import BsrDevice
from cvr_tpu_torch.ops.spmm_lane import LaneDevice, LanePlan, spmm_lane_pack
from cvr_tpu_torch.ops.spmm_pmm import PmmDevice, PmmPlan, pmm_plan
from cvr_tpu_torch.ops.spmv import SellDevice, spmm, spmv, upload
from cvr_tpu_torch.ops.spmv_bell import BellDevice, gather_args
from cvr_tpu_torch.ops.spmv_dia import DiaDevice
from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify
from cvr_tpu_torch.ops.spmv_window import (
    SellWindowDevice,
    reduce_args,
    window_rows,
)
from cvr_tpu_torch.parallel import dist as tdist
from cvr_tpu_torch.parallel import (
    dist2d,
    dist_bell,
    dist_bsr,
    dist_dia,
    dist_lane,
    dist_pmm,
    dist_window,
)
from cvr_tpu_torch.parallel.dist import local_csrs, make_mesh
from cvr_tpu_torch.parallel.dist_routed import (
    dist_routed_pack,
    dist_spmv_routed,
)
from cvr_tpu_torch.parallel.dryrun import dryrun_multichip
from cvr_tpu_torch.utils.report import append_jsonl, append_result

ITERS = 100
KERNEL_ITERS = 20
EXACT = ("expand", "route_middle", "route_small", "tileperm", "route_m3",
         "route_flat", "groupperm")
# the pure gathers library_call computes by one torch.take (tileperm: by
# torch.gather where every index is in range): kernel -> the position of
# its data input among its arguments
GATHERS = {"expand": 4, "route_middle": 0, "route_small": 0, "tileperm": 0,
           "route_m3": 0, "route_flat": 0, "groupperm": 0, "expand_ring": 4}
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


# The full-size matrices of the phases, each generated once per run
# (full_size) and shared by the phases that run it.
FULL_SIZE = {
    "web_google_like": lambda: syn.web_google_like(),
    "fsm_like": lambda: syn.fsm_like(),
    "banded_2m": lambda: syn.banded_matrix(1 << 21, 27),
    "road_usa_like": lambda: syn.road_usa_like(),
    "fem_like": lambda: syn.fem_like(),
}
_GENERATED = {}


def full_size(name) -> COOMatrix:
    """FULL_SIZE[name], generated on its first call."""
    if name not in _GENERATED:
        _GENERATED[name] = FULL_SIZE[name]()
    return _GENERATED[name]


# Phase [6]: name, matrix, the format pack_auto must pick and the geometry
# it must reach, the kernel of the format, a smaller matrix of the same
# generator for the CLI (it reads a MatrixMarket file).
FORMATS = (
    ("banded_2m", functools.partial(full_size, "banded_2m"),
     lambda A: isinstance(A, DiaMatrix) and A.nd == 27, "dia_spmv",
     lambda: syn.banded_matrix(1 << 16, 27)),
    ("road_usa_like", functools.partial(full_size, "road_usa_like"),
     lambda A: (isinstance(A, BellMatrix)
                and (A.k, A.reach, A.ncand, A.TBb, A.R_sub)
                == (6, 64, 10, 128, 65536)
                and A.spill is not None and A.spill.nnz == 146396
                and A.spill_map.shape[0] == 106239 and A.spill.T == 9216),
     "bell_gather_mac", lambda: syn.road_usa_like(n=1 << 18)),
    ("fem_like", functools.partial(full_size, "fem_like"),
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
    ("banded_2m", functools.partial(full_size, "banded_2m"),
     lambda: syn.banded_matrix(1 << 16, 27),
     ((64, "cli", "bsr"), (64, "spmm", "dia"))),
    ("fem_like", functools.partial(full_size, "fem_like"),
     lambda: syn.fem_like(n=1 << 15), ((64, "cli", "bsr"),)),
    ("fsm_like", functools.partial(full_size, "fsm_like"),
     lambda: syn.fsm_like(n=1 << 17),
     ((32, "cli", "pmm"),)),
    ("web_google_like", functools.partial(full_size, "web_google_like"),
     lambda: syn.rmat_matrix(14, 6, seed=42),
     ((128, "cli", "lane"), (8, "cli", "sell-routed"))),
    ("road_usa_like", functools.partial(full_size, "road_usa_like"),
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
DIST_MS = {}  # [8]'s ms per SpMV (CUDA events) by (matrix, mode), for [15]
# drive's pack seconds and ms per SpMV (CUDA events) by "tag name", for [17]
DRIVEN = {}


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


# kernels whose output must repeat bit for bit from launch to launch
# (sums in a fixed order, split sums added in a fixed order, no float
# atomics)
REPEAT = (*SECOND, "window_reduce")


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
    if isinstance(sd, SellDevice):  # the plain SELL planes: torch ops
        pass
    elif isinstance(sd, DiaDevice):
        want["dia_spmv"] = 1
    elif isinstance(sd, SellWindowDevice):
        want["window_reduce"] = 1
        want["route_small"] = int(sd.yroute is not None)
    elif isinstance(sd, BellDevice):
        want["bell_gather_mac"] = 1
        if sd.spill is not None:
            for k, n in expected_launches(sd.spill).items():
                want[k] += n
    else:  # K1 and the route are composed into K3's and K4's indices
        want.update({
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
    if isinstance(A, BsrMatrix):
        return f"BSR: {A.nbricks} bricks, fill {A.fill:.4f}, {A.nnz} nnz"
    if isinstance(A, LanePlan):
        return (f"lane plan: {A.vals_l.shape[0]} plane rows, {A.nslices} "
                f"slices, {A.extra_pos.shape[0]} split-row extras, "
                f"{A.nnz} nnz")
    if isinstance(A, PmmPlan):
        return (f"PMM plan: {A.nchunks} chunks, {A.npairs} pairs, "
                f"{A.nrt} row tiles, {A.nnz} nnz")
    if isinstance(A, SellMatrix):
        return (f"SELL: C {A.C}, sigma {A.sigma}, {A.nslices} slices, "
                f"{A.n_slots} slots, {A.n_splits} splits, {A.nnz} nnz")
    y_route = "none" if A.y_ra is None else (
        f"Tp {A.y_ra['Tp']} {A.y_ra['mid_planes']['kind']!r}")
    return (f"SELL-W: D {A.D}, W {A.W}, wrl {A.wrl}, G {A.G}, {A.n_segs} x "
            f"segments, {A.nslices} slices in {len(A.ycall_rows)} reduce "
            f"groups, S {A.S}, S_pad {A.S_pad}, {A.nnz} nnz, y-route "
            f"{y_route}")


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


def cusparse_csr(csr, device):
    """csr as torch.sparse_csr_tensor on ``device``: cuSPARSE's operand,
    the yardstick, never on the port's path."""
    dev = torch.device(device)
    return torch.sparse_csr_tensor(
        torch.from_numpy(csr.rowptr).to(dev),
        torch.from_numpy(csr.cols.astype(np.int64)).to(dev),
        torch.from_numpy(csr.vals.astype(np.float32)).to(dev),
        size=csr.shape, check_invariants=False)


def cusparse_ms(tag, csr, xd, golden, scale, device) -> float:
    """cuSPARSE's CSR SpMV of the matrix (torch.sparse_csr_tensor @ x):
    the whole-SpMV yardstick, never on the port's path.  Checked against
    the golden, then timed by CUDA events."""
    A = cusparse_csr(csr, device)
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
          marker="route_small_kernel"):
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
    DRIVEN[f"{tag} {name}"] = pack_s, ms
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
    if isinstance(sd, SellDevice):  # the plain SELL planes: torch ops
        return []
    if isinstance(sd, SellWindowDevice):
        cases = [("window_reduce", "", reduce_args(sd, xd))]
        if sd.yroute is not None:  # K4 to natural rows
            g = sp.route_stream(sd.yroute, window_rows(sd, xd))
            check_small_route(tag, sd.yroute, g)
            cases += route_cases(sd.yroute, g, "y side")
        return cases
    if isinstance(sd, BellDevice):
        cases = [("bell_gather_mac", "", gather_args(sd, xd))]
        if sd.spill is not None:
            cases += [(name, f"spill {which}".strip(), args)
                      for name, which, args in kernel_cases(
                          f"{tag} spill", sd.spill, xd)]
        return cases
    g1 = rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li, xd, sd.segw,
                   sd.n_segs)
    check_fold(tag, sd, g1, xd)
    cases = [("reduce_slices", "", k3_args(sd, xd))]
    return cases + y_cases(tag, sd, sp.reduce(sd, xd), xd)


def k3_args(sd, src):
    """K3's arguments at the path's tensors (sp.reduce's call): x by the
    x plan, or the ring's g1 by the g1 plan."""
    plan = sd.red_plan if src.dim() == 1 else sp.g1_plan(sd)
    return (src, sd.vals_ss, plan, sd.nslices)


def check_fold(tag, sd, g1, xd) -> None:
    """K3's index composed through the route middle against the staged
    chain on the card, bit for bit: the products of the plane rows the
    slices name (vals times g1 by the composed index, against
    reduce_products_plain on the route middle's mstream, K2's output on
    a recursive middle), and K3's sums against K3 run on that mstream by
    the staged index (the parent design's K3) and against K3 gathering x
    by the index composed through K1's map too (the SpMV's K3; g1 is K1's
    output)."""
    m, m3 = sp.middle(sd, g1)
    item, rows = rk.slice_rows(sd.red_row0, sd.red_row1)
    plan = sp.g1_plan(sd)
    got = sd.vals_ss[:, rows, :] * rk.gather_or_zero(g1, plan.idx[:, rows, :])
    want = rk.reduce_products_plain(m, m3, sd.vals_ss, sd.p3, rows,
                                    sd.red_fast.bool()[item])
    staged = dataclasses.replace(plan, T=m.shape[1], idx=rk.reduce_index(
        m3, sd.p3, sd.red_row0, sd.red_row1, sd.red_fast))
    ys, ys_staged = (rk.reduce_slices(g1, sd.vals_ss, plan, sd.nslices),
                     rk.reduce_slices(m, sd.vals_ss, staged, sd.nslices))
    ys_x = rk.reduce_slices(xd, sd.vals_ss, sd.red_plan, sd.nslices)
    zeros = int((plan.idx[:, rows, :] < 0).sum())
    same = (torch.equal(got, want) and torch.equal(ys, ys_staged)
            and torch.equal(ys, ys_x))
    print(f"{tag} reduce_slices on g1 (middle {sd.mid.kind!r}, {zeros} "
          f"elements read as 0): products and K3's sums "
          f"{'bit-exact with' if same else 'DIFFER from'} the staged "
          "middle's and K3's on x")
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
        src, vals, *rest = args
        return (src.abs(), vals.abs(), *rest)
    if name == "reduce_stream":
        emit, gemit, vals, gx, p3, *rest = args
        return (emit, gemit, vals.abs(), gx.abs(), p3, *rest)
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
    entry a plane value at the column its composed index names in its
    source flattened (x, or g1; the elements it reads as 0 left out),
    times the source flattened; its output is ys flattened."""
    src, vals, plan, nys = args
    item, rows = rk.slice_rows(plan.row0, plan.row1)
    row = slice_entry_rows(item, plan.out, nys, rows.shape[0], src.device)
    col = plan.idx[:, rows, :].long()
    keep = (col >= 0) & (col < src.numel())
    return csr_call("reduce_slices", row.expand_as(col)[keep], col[keep],
                    vals[:, rows, :][keep], (8 * nys * 128, src.numel()),
                    src.reshape(-1), args, lambda y: y.view(8, nys, 128))


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
    emit, _gemit, vals, gx, p3, nys = args[:6]
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
    are the passes after it, K3 on the g1 that K1 gives the same shard
    by the g1 plan that the ring reads."""
    cases = kernel_cases(tag, sd, xd)
    also = set()
    if ring:
        g1 = rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li, xd, sd.segw,
                       sd.n_segs)
        cases = [("reduce_slices", w, k3_args(sd, g1))
                 if n == "reduce_slices" else (n, w, a)
                 for n, w, a in cases]
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


def against_plain(name, label, args):
    """One launch of kernel ``name`` against its plain version at the same
    inputs (EXACT kernels bit for bit, the others within 1e-6 of the row
    scale; REPEAT kernels also against a second launch): (its output,
    whether it agrees, the verdict, the max abs error)."""
    wrapper, plain, _ = kernels.KERNELS[name]
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
    return got, same, verdict, err


def check_plain(tag, name, which, args) -> None:
    """against_plain alone, without times, bound or library call: the
    check of a kernel launch on shards 1 .. of a row-sharded path, whose
    timings shard 0's launch gives (printed, raises where it disagrees)."""
    label = f"{name} ({which})" if which else name
    _, same, verdict, err = against_plain(name, label, args)
    print(f"{tag} {label}: {verdict}, max abs err {err:.3e} (not timed)")
    if not same:
        raise AssertionError(f"{label} disagrees with its plain version")


def check_case(tag, path, name, which, args, launches, path_dms, device,
               lib_ms=None):
    """One kernel launch against its plain version at the same inputs,
    with its times, bound and library call (``lib_ms`` where the caller
    measured it, else library_call's, by CUDA events and device time);
    ``launches`` and ``path_dms`` (device ms by kernel) come from the
    path's own run and trace.  Returns the kernels-JSON row."""
    wrapper, plain, replaces = kernels.KERNELS[name]
    label = f"{name} ({which})" if which else name
    got, same, verdict, err = against_plain(name, label, args)
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


@contextlib.contextmanager
def environment(env):
    """The environment switches ``env`` set inside the block."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pack_with(csr, split_len, hot, env):
    """sell_pack_routed under the environment switches ``env``."""
    with environment(env):
        return sell_pack_routed(csr, split_len=split_len, hot=hot)


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
    2048-tile y-route, its kernels K5-K7, and the hot="off" comparison;
    ``walks``: the K7 row walks of [4] (None where [4] did not run)."""
    t0 = time.perf_counter()
    coo = full_size("fsm_like")
    print(f"[5] fsm_like: {coo.shape[0]}x{coo.shape[1]}, {coo.nnz} nnz, "
          f"generated in {time.perf_counter() - t0:.2f} s")
    sr, sd, xd, launches, _ms, spmv_dms, _lib = drive(
        "[5]", "fsm_like", coo, device,
        lambda sr: (sr.hot is not None and sr.hot.NH == 256
                    and sr.y_ra["Tp"] == 2048
                    and sr.y_ra["mid_planes"]["kind"] == "rec"
                    and sr.mid["kind"] == "rec"),
    )
    want = {**dict.fromkeys(kernels.KERNELS, 0),
            "route_small": 1, "reduce_hot": 1,
            "reduce_slices": 1 + second_pass(sd.red_plan.split)}
    if launches != want:
        raise AssertionError(f"[5] launches {launches}, want {want}")
    if walks is not None:  # [4] ran: both walks in [4] and [5]
        walks |= hot_branches(sr.hot)
        if walks != {"regular", "swept"}:
            raise AssertionError(f"K7 walked only {sorted(walks)} in [4] "
                                 "and [5]")
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
                        "route_small_kernel")
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
    c = SPMM_CHECK_COLS
    A = cusparse_csr(csr, device)
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
                                  iters=ITERS, device=device, no_verify=False,
                                  c=None, sigma=0)
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
    held = [s for s in dm.shards if s is not None]  # a rank holds its own
    for shard in held:  # K3's second pass runs where a shard splits
        for k, n in expected_launches(shard).items():
            want[k] += n
    if mode == "overlap":
        want["expand"] = 0
        want["expand_ring"] = len(held) * sum(
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
        if sd is None:  # another rank's
            continue
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
    plain version (check_plain: shard 0's launch carries the times);
    every shard of a forced pack holds a slice of up to 1,024 plane rows,
    split into pieces.  Prints K3's launches over the shards and its time
    in the path's trace.  Returns no rows."""
    for i, s in enumerate(dm.shards[1:], 1):
        check_plain(tag, "reduce_slices", f"shard {i}", k3_args(s, xd))
    splits = [second_pass(s.red_plan.split) for s in dm.shards]
    print(f"{tag} reduce_slices over the {dm.n_shards} shards: "
          f"{dm.n_shards + sum(splits)} launches (second passes on shards "
          f"{[i for i, k in enumerate(splits) if k]}), in the path's trace "
          f"{ours['reduce_slices']:.4f} ms")
    return []


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
        one_dev = sum(device_ms(one, KERNEL_ITERS, "route_small_kernel").values())
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
            DIST_MS[name, mode] = ms
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


# Phase [9] (b): (tile_multiple, middle kind); one apply_route launches K5
# twice and its middle's kernels (middle_launches)
PERM_ROUTES = ((1, "brute"), (1024, "rec"))


def middle_launches(planes) -> dict[str, int]:
    """Launches of one sp.middle_pass on the middle ``planes``."""
    if planes.kind == "flat":
        return {"route_flat": 1}
    if planes.kind == "brute":
        return {"groupperm": 1}
    body = rk.route_middle_geometry(planes.m1.shape[1])
    return {"route_middle": rk.ROUTE_MIDDLE_LAUNCHES[body], "route_m3": 1}


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
    for tm, kind in PERM_ROUTES:
        tag = f"[9b] {kind}"
        t0 = time.perf_counter()
        ra = rp.route_arrays_from_perm(perm, tile_multiple=tm)
        compile_s = time.perf_counter() - t0
        mp = ra["mid_planes"]
        if mp["kind"] != kind or (kind == "brute"
                                  and mp["Tk"] * 128 != ra["Tp"]):
            raise AssertionError(f"{tag} route has middle {mp['kind']!r}")
        rd = sp.route_to_device(ra, device)
        want = {"tileperm": 2, **middle_launches(rd.mid)}
        out, launches = path_run(tag, lambda: sp.apply_route(rd, vd), want)
        if not torch.equal(out, want_v):
            raise AssertionError(f"{tag} apply_route differs from v[perm]")
        fn = functools.partial(sp.apply_route, rd, vd)
        ms = time_iterations(fn, ITERS, device) * 1e3
        per = device_ms(fn, KERNEL_ITERS, event_of("tileperm"), per_call=2)
        ours = by_kernel(per)
        body = ("" if kind != "rec" else
                f" (K2 {rk.route_middle_geometry(rd.Tp)})")
        print(f"{tag}: {N} elements, tile_multiple {tm}: T {ra['T']}, Tp "
              f"{ra['Tp']}, middle {kind!r} Tk {mp['Tk']}{body}, route "
              "compile "
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
    ngroups = sum(1 for _, nr in groups if nr)  # K18's first passes
    plans = sd.stream_plans  # K18's, one a group, made at upload

    def unfused():
        g1 = rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li, xd, sd.segw,
                       sd.n_segs)
        ys = sp.reduce_unfused(sd, sp.middle_pass(g1, sd.mid), emit, gemit,
                               sr.ycall_rows)
        return ys, sp.y_from_slices(sd, ys, xd)

    want = expected_launches(sd)
    want["reduce_slices"] = 0
    want["expand"] = 1
    want["reduce_stream"] = sum(1 + second_pass(plans[j].split)
                                for j, (_, nr) in enumerate(groups) if nr)
    for k, n in middle_launches(sd.mid).items():
        want[k] += n
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
    print(f"[9c] unfused reduce on [2]'s pack ({ngroups} reduce groups; "
          "K18's plans: "
          + ", ".join(f"{p.split.pieces.shape[0]} pieces, "
                      f"{p.split.combine.shape[0]} split slices"
                      for p in plans)
          + (f"; K2 {rk.route_middle_geometry(sd.T)} at Tk {sd.mid.Tk}"
             if sd.mid.kind == "rec" else "") + "): "
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
        args = (emit[rows], gemit[r0 // 8 : (r0 + nr) // 8],
                sd.vals_ss[:, rows], gx[:, rows], sd.p3[:, rows],
                min(rp.YB, sd.nslices - j * rp.YB))
        # a call without the upload's plan plans its group itself
        if not torch.equal(rk.reduce_stream(*args),
                           rk.reduce_stream(*args, plans[j])):
            raise AssertionError(f"[9c] K18 on group {j} without its plan "
                                 "differs from K18 with it")
        cases.append(("reduce_stream", f"group {j}", (*args, plans[j])))
    print("[9c] K18 on each group without the upload's plan: bit-exact "
          "with K18 by it")
    cases += y_cases("[9c]", sd, ys, xd)
    return check_path("[9c]", "web_google_like unfused reduce", cases,
                      launches, ours, device)


# Phase [9] (d): (kernel, planes, rows): K5 at a T no route of the phases
# reaches (odd), K17 at the largest K its int16 index reaches (192 KB of
# shared memory a block), K2 at a Tk past its staged body's shared memory
# (Tk 8: the split body)
RAGGED_PERMS = (("tileperm", 8, 1001), ("groupperm", 256, 1024))
RAGGED_MIDDLE_TK = 8


def ragged_perms(device):
    """Phase [9] (d): K5 and K17 (RAGGED_PERMS) on data and an index made
    from a seed, the index also reaching outside the staged planes
    (negative, and past them where int16 reaches: 0 there), and K2 at Tk
    RAGGED_MIDDLE_TK on g1, m1 (in [0, 1024)) and a chunk select in
    [-2, Tk + 2) made from the same seed (0 outside [0, Tk)); one run with
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
    tk = RAGGED_MIDDLE_TK
    shape = (8, tk * 1024, 128)
    body = rk.route_middle_geometry(tk * 1024)
    if body != "split":
        raise AssertionError(f"[9d] K2 at Tk {tk} takes its {body} body")
    planes = (rng.standard_normal(shape, dtype=np.float32),
              rng.integers(0, 1024, shape, dtype=np.int16),
              rng.integers(-2, tk + 2, shape, dtype=np.int16))
    cases.append(("route_middle", f"Tk {tk}, {body}, chunk selects out of "
                  "range", tuple(torch.from_numpy(a).to(device)
                                 for a in planes)))
    del planes

    def path():
        return [kernels.KERNELS[name][0](*args) for name, _, args in cases]

    want = {name: 1 for name, _, _ in cases}
    want["route_middle"] = rk.ROUTE_MIDDLE_LAUNCHES[body]
    _, launches = path_run("[9d]", path, want)
    ours = by_kernel(device_ms(path, KERNEL_ITERS, event_of("groupperm")))
    return check_path("[9d]", "synthetic planes, ragged T, K 256, Tk "
                      f"{tk}", cases, launches, ours, device)


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


# Phase [11]: the payloads of cvr_tpu_torch.models over the port's SpMVs
# and SpMMs.
PAGERANK_ITERS = 50
# PageRank's ranks are positive sums of positive terms: each float32 sum of
# a row's in-links (up to thousands) is within ~1e-5 of its float64 value,
# and 0.85 damps what earlier iterations carried in; 1e-4 elementwise,
# relative, leaves a margin of ~100 over the 1.1e-6 that R-MAT scale 16
# shows on the CPU (2.5e-7 on web-Google-like on the H100)
PAGERANK_RTOL = 1e-4
CG_ITERS = 100
CG_N = 1 << 20
GCN_WIDTHS = (64, 64, 16)
# the GCN against float64, row-scaled (|A| @ (|H| @ |W|)) at 1e-4, and
# at float32's grade, 1e-5: float32 sums of 64 products, then of a row's
# entries, err by a few ulp (4.4e-8 measured on the H100); the same
# products with TF32's 10-bit operands err by 6.2e-5 there, inside 1e-4
# but not 1e-5, so the float32 grade shows the precision guard at work
GCN_RTOL = 1e-4
GCN_F32 = 1e-5


class Counted:
    """A payload's operator ``op(sd, v)`` (an SpMV or SpMM of the device
    artifact ``sd``) that adds up the launches its calls need and keeps
    its last input, at which the payload's kernels are then checked."""

    def __init__(self, sd, op):
        self.sd, self.op = sd, op
        self.calls, self.last = 0, None
        self.want = dict.fromkeys(kernels.KERNELS, 0)

    def __call__(self, v):
        self.calls += 1
        self.last = v
        need = (expected_launches(self.sd) if v.dim() == 1
                else expected_spmm_launches(self.sd, v.shape[1]))
        for k, n in need.items():
            self.want[k] += n
        return self.op(self.sd, v)


def payload_run(tag, fn, want):
    """fn() once, with the launch counts set to 0 just before it and read
    just after; they must be ``want``.  Returns (fn's result, launches)."""
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = kernels.launches()
    print(f"{tag} launches in this path's run: "
          f"{ {k: n for k, n in launches.items() if n} }")
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, want {want}")
    return out, launches


def payload_kernels(tag, path, sd, x, fn, launches, device, per=None,
                    library=None):
    """Every kernel the payload's run launched against its plain version
    at the payload's own last operator input ``x`` (check_kernels, on x
    made contiguous as the SpMV and SpMM wrappers make it; a looped SpMM
    at x's column 0), with device ms per run of ``fn`` by kernel (``per``
    by event name where the caller traced fn, else from a trace here);
    ``library`` as check_kernels takes it."""
    launched = [k for k, n in launches.items() if n]
    if not launched:
        print(f"{tag} launched no kernel of ours")
        return []
    if per is None:
        # the marker: a kernel without a second pass
        single = [k for k in launched if k not in SECOND]
        per = device_ms(fn, KERNEL_ITERS,
                        event_of(single[0]) if single else None,
                        per_call=launches[single[0]] if single else 1)
        print(f"{tag} device time a run: "
              + device_split(per, by_kernel(per)))
    if x.dim() == 2 and spmm_kernel(sd) is None:
        x = x[:, 0]
    return check_kernels(tag, f"models_{path}", sd, x.contiguous(),
                         launches, by_kernel(per), device, library)


def pagerank_float64(csr_t, out_degree, iters, damping=0.85):
    """``iters`` PageRank iterations in float64 on the host: the same
    dangling-mass rule and L1 normalization as models.pagerank."""
    A = sps.csr_matrix((csr_t.vals.astype(np.float64), csr_t.cols,
                        csr_t.rowptr), shape=csr_t.shape)
    n = csr_t.shape[0]
    deg = out_degree.astype(np.float64)
    dangles = deg == 0
    p = np.full(n, 1.0 / n)
    for _ in range(iters):
        spread = A @ np.where(dangles, 0.0, p / np.maximum(deg, 1.0))
        p_new = (1.0 - damping) / n + damping * (spread + p[dangles].sum() / n)
        p = p_new / np.abs(p_new).sum()
    return p


def pagerank_unread(sd, odeg, iters, damping=0.85):
    """``iters`` of models.pagerank's iterations on the routed ``sd``
    without the stopping test's read back to the host each iteration:
    what that read costs (a measurement, never on the path).  Returns
    (ranks, the last delta)."""
    n = sd.shape[0]
    contributes, deg, dangles = odeg > 0, torch.clamp(odeg, min=1), odeg == 0
    p = torch.full((n,), 1.0 / n, dtype=torch.float32, device=odeg.device)
    for _ in range(iters):
        spread = sp.spmv_routed(sd, torch.where(contributes, p / deg, 0.0))
        dangling = torch.sum(torch.where(dangles, p, 0.0))
        p_new = (1.0 - damping) / n + damping * (spread + dangling / n)
        p_new = p_new / torch.sum(torch.abs(p_new))
        delta = torch.sum(torch.abs(p_new - p))
        p = p_new
    return p, delta


def operator_library_ms(csr, x, want, device) -> float:
    """cuSPARSE's product of the whole CSR matrix with x
    (torch.sparse_csr_tensor @ x), the library call of a kernel that is
    the whole SpMV or SpMM (K8, K11): checked within 1e-6 of the row
    scale against the kernel's output ``want``, then its ms by CUDA
    events."""
    A = cusparse_csr(csr, device)
    absA = cusparse_csr(dataclasses.replace(csr, vals=np.abs(csr.vals)),
                        device)
    scale = absA @ x.abs()
    if not bool(((A @ x - want).abs() <= 1e-6 * scale + 1e-30).all()):
        raise AssertionError("cuSPARSE's product is not the kernel's")
    return time_iterations(lambda: A @ x, KERNEL_ITERS, device) * 1e3


def times_line(tag, what, t, lib) -> None:
    """A payload's time per iteration (or forward) beside the same loop
    over cuSPARSE, both per_iteration's."""
    def one(t):
        if t["device_ms"] is None:
            return f"{t['ms']:.4f} ms (host clock)"
        return (f"{t['ms']:.4f} ms by CUDA events, device {t['device_ms']:.4f}"
                f" ms (busy {100 * t['device_ms'] / t['ms']:.1f}%)")

    print(f"{tag} {what}: {one(t)}; the same loop over cuSPARSE "
          f"(yardstick): {one(lib)}")
    if t["by_event"]:
        ours = by_kernel(t["by_event"])
        print(f"{tag} {what}, device ms by kernel: "
              + device_split(t["by_event"], ours))


def pagerank_payload(device, coo):
    """[11a]: PageRank on web-Google-like through bench.models."""
    tag = "[11a]"
    r = bench_models.bench_pagerank(PAGERANK_ITERS, device, coo=coo)
    sr, sd, csr_t = r["packed"], r["sd"], r["csr_t"]
    phases = ", ".join(f"{k} {v:.3f}" for k, v in sr.convert_phases.items())
    print(f"{tag} A^T {csr_t.shape[0]}x{csr_t.shape[1]}, {csr_t.nnz} nnz: "
          f"pack {r['pack_s']:.3f} s ({phases}): {describe(sr)}")
    odeg = torch.from_numpy(r["out_degree"]).to(device)
    per = expected_launches(sd)
    print(f"{tag} launches per iteration: "
          f"{ {k: n for k, n in per.items() if n} }")

    def run():
        return pagerank_routed(sd, out_degree=odeg, tol=0.0,
                               max_iters=PAGERANK_ITERS)

    want = {k: n * PAGERANK_ITERS for k, n in per.items()}
    (p, its, delta), launches = payload_run(tag, run, want)
    p = p.cpu().numpy()
    p64 = pagerank_float64(csr_t, r["out_degree"], PAGERANK_ITERS)
    rel = float(np.max(np.abs(p - p64) / p64))
    l1 = float(np.abs(p - p64).sum())
    ok = (its == PAGERANK_ITERS and rel <= PAGERANK_RTOL
          and np.isfinite(p).all())
    print(f"{tag} {its} iterations at tol 0 vs the float64 PageRank: max "
          f"rel {rel:.3e} (tolerance {PAGERANK_RTOL:g}), L1 {l1:.3e}, sum "
          f"{p.sum():.7f}: {'PASS' if ok else 'FAIL'}")
    if not ok or not abs(p.sum() - 1.0) < 1e-3:
        raise AssertionError(f"{tag} PageRank disagrees with float64")
    _, its_c, delta_c = pagerank_routed(sd, out_degree=odeg, tol=1e-8,
                                        max_iters=1000)
    print(f"{tag} to tol 1e-8: {its_c} iterations, final delta "
          f"{float(delta_c):.3e}")
    A = cusparse_csr(csr_t, device)
    lib = bench_models.per_iteration(
        lambda: pagerank(lambda v: A @ v, csr_t.shape[0], tol=0.0,
                         max_iters=PAGERANK_ITERS, out_degree=odeg,
                         device=device),
        PAGERANK_ITERS, device, None)
    times_line(tag, "PageRank per iteration", r["times"], lib)
    p_u, _ = pagerank_unread(sd, odeg, PAGERANK_ITERS)
    err_u = float(np.max(np.abs(p_u.cpu().numpy() - p64) / p64))
    unread = bench_models.per_iteration(
        lambda: pagerank_unread(sd, odeg, PAGERANK_ITERS), PAGERANK_ITERS,
        device, "route_small_kernel")
    print(f"{tag} the same iterations without the stopping test's read "
          f"(a measurement; ranks max rel {err_u:.3e} from float64): "
          f"{unread['ms']:.4f} ms by CUDA events"
          + ("" if unread["device_ms"] is None else
             f", device {unread['device_ms']:.4f} ms (busy "
             f"{100 * unread['device_ms'] / unread['ms']:.1f}%)"))
    if not err_u <= PAGERANK_RTOL:
        raise AssertionError(f"{tag} the unread loop is not PageRank")
    x = torch.where(odeg > 0, torch.from_numpy(p).to(device)
                    / torch.clamp(odeg, min=1), 0.0)
    per = r["times"]["by_event"]
    return payload_kernels(
        tag, "pagerank", sd, x, run, launches, device,
        per and {k: v * PAGERANK_ITERS for k, v in per.items()})


def cg_payload(device):
    """[11b]: CG on the SPD banded system of CG_N rows through
    bench.models (SELL-W: K10)."""
    tag = "[11b]"
    r = bench_models.bench_cg(CG_ITERS, device, n=CG_N)
    sw, sd, csr = r["packed"], r["sd"], r["csr"]
    phases = ", ".join(f"{k} {v:.3f}" for k, v in sw.convert_phases.items())
    print(f"{tag} {csr.shape[0]}x{csr.shape[1]}, {csr.nnz} nnz: pack "
          f"{r['pack_s']:.3f} s ({phases}): {describe(sw)}")
    op = Counted(sd, spmv)
    (x, its, res), launches = payload_run(
        tag, lambda: conjugate_gradient(op, r["b"], tol=1e-6,
                                        max_iters=1000, device=device),
        op.want)
    b64 = r["b"].cpu().numpy().astype(np.float64)
    rel = float(np.linalg.norm(b64 - spmv_golden_numpy(csr, x.cpu().numpy()))
                / np.linalg.norm(b64))
    print(f"{tag} CG to 1e-6: {its} iterations, {op.calls} SpMVs, reported "
          f"residual {float(res):.3e}, true float64 relative residual "
          f"{rel:.3e} (< 1e-4: {'PASS' if rel < 1e-4 else 'FAIL'})")
    if not rel < 1e-4:
        raise AssertionError(f"{tag} CG did not converge")
    A = cusparse_csr(csr, device)
    lib = bench_models.per_iteration(
        lambda: bench_models.cg_shaped(lambda v: A @ v, r["b"], 1.0,
                                       CG_ITERS), CG_ITERS, device, None)
    times_line(tag, "cg_shaped per iteration", r["times"], lib)
    return payload_kernels(
        tag, "cg", sd, op.last,
        lambda: conjugate_gradient(lambda v: spmv(sd, v), r["b"], tol=1e-6,
                                   max_iters=1000, device=device),
        launches, device)


def gcn_float64(csr, X, weights):
    """The GCN forward in float64 on the host, and its row scale (the
    same products in absolute values)."""
    A = sps.csr_matrix((csr.vals.astype(np.float64), csr.cols, csr.rowptr),
                       shape=csr.shape)
    H = X.astype(np.float64)
    S = np.abs(H)
    for i, W in enumerate(weights):
        W = W.astype(np.float64)
        H, S = A @ (H @ W), abs(A) @ (S @ np.abs(W))
        if i < len(weights) - 1:
            H = np.maximum(H, 0.0)
    return H, S


def gcn_payload(device, coo):
    """[11c]: a 2-layer GCN at widths GCN_WIDTHS on gcn_normalize of
    web-Google-like's links, through the artifact spmm_pick("auto", K 64)
    gives, with torch's float32 matmul precision set to "high" (TF32)."""
    tag = "[11c]"
    n = coo.shape[0]
    t0 = time.perf_counter()
    nr, nc, nv = gcn_normalize(coo.rows, coo.cols, np.ones_like(coo.vals), n)
    gcoo = COOMatrix(nr, nc, nv, (n, n)).sum_duplicates()
    csr = gcoo.to_csr()
    norm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fmt, packed = cli.spmm_pick("auto", gcoo, GCN_WIDTHS[0])
    pick_s = time.perf_counter() - t0
    geom = describe(packed) if isinstance(
        packed, (SellRouted, DiaMatrix, BellMatrix, SellWindow)) else ""
    print(f"{tag} Â = gcn_normalize(A): {n}x{n}, {gcoo.nnz} nnz in "
          f"{norm_s:.2f} s; spmm_pick('auto', K {GCN_WIDTHS[0]}) -> {fmt} "
          f"in {pick_s:.2f} s {geom}")
    sd = upload(packed, device)
    del packed
    rng = np.random.default_rng(64)
    X = rng.standard_normal((n, GCN_WIDTHS[0])).astype(np.float32)
    Ws = [(rng.standard_normal((a, b)) * 0.3).astype(np.float32)
          for a, b in zip(GCN_WIDTHS[:-1], GCN_WIDTHS[1:])]
    weights, _ = params_from_reference(Ws, device=device)
    Xd = torch.from_numpy(X).to(device)
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        op = Counted(sd, spmm)
        out, launches = payload_run(
            tag, lambda: gcn_forward(op, Xd, weights, device=device),
            op.want)
        ref, scale = gcn_float64(csr, X, Ws)
        out = out.cpu().numpy()
        err = float(np.max(np.abs(out - ref) / (scale + 1e-30)))
        ok = out.shape == ref.shape and err <= min(GCN_RTOL, GCN_F32)
        # the same products with TF32 allowed, as a plain torch.matmul
        # under "high" runs them
        H = torch.relu(spmm(sd, Xd @ weights[0]))
        tf32 = spmm(sd, H @ weights[1]).cpu().numpy()
        err_tf32 = float(np.max(np.abs(tf32 - ref) / (scale + 1e-30)))
        print(f"{tag} GCN {GCN_WIDTHS} under float32 matmul precision "
              f"'{torch.get_float32_matmul_precision()}', {op.calls} SpMMs: "
              f"max row-scaled error vs float64 {err:.3e} (tolerance "
              f"{GCN_RTOL:g}, float32 grade {GCN_F32:g}): "
              f"{'PASS' if ok else 'FAIL'}; the same products by plain "
              f"torch.matmul under it: {err_tf32:.3e}")
        if not ok:
            raise AssertionError(f"{tag} the GCN disagrees with float64")
        t = bench_models.per_iteration(
            lambda: gcn_forward(lambda M: spmm(sd, M), Xd, weights,
                                device=device), 1, device, None)
        A = cusparse_csr(csr, device)
        lib = bench_models.per_iteration(
            lambda: gcn_forward(lambda M: A @ M, Xd, weights, device=device),
            1, device, None)
        times_line(tag, "GCN forward", t, lib)
        return payload_kernels(
            tag, "gcn", sd, op.last,
            lambda: gcn_forward(lambda M: spmm(sd, M), Xd, weights,
                                device=device), launches, device,
            t["by_event"])
    finally:
        torch.set_float32_matmul_precision(saved)


def small_payloads(device, held):
    """[11d]: the other payloads at tests/test_models.py's sizes, each
    against its float64 or dense answer as those tests check it; the
    kernels of a payload that launched one not in ``held`` (the kernels
    [11] has held against their plain versions so far) are held against
    theirs."""
    rows = []

    def case(name, csr, op_kind, fn, check, pack=pack_auto):
        tag = f"[11d] {name}"
        A = pack(csr)
        sd = upload(A, device)
        op = Counted(sd, op_kind)
        out, launches = payload_run(tag, lambda: fn(op), op.want)
        verdict = check(out)
        print(f"{tag} ({type(A).__name__}, {op.calls} operator calls): "
              f"{verdict}")
        launched = {k for k, n in launches.items() if n}
        if launched <= held:
            print(f"{tag} {sorted(launched)} held against their plain "
                  "versions in [11] already")
            return
        # K8 and K11 are the whole product: cuSPARSE's is their library
        # call
        x = op.last.contiguous()
        library = {k: operator_library_ms(csr, x, op_kind(sd, x), device)
                   for k in launched & {"dia_spmv", "dia_spmm"}}
        got = payload_kernels(tag, name, sd, op.last,
                              lambda: fn(lambda v: op_kind(sd, v)),
                              launches, device, library=library)
        held.update(r["name"] for r in got)
        rows.extend(got)

    def close(got, want, rtol, atol, what):
        got = np.asarray(got)
        if not np.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"[11d] {what}: not within rtol {rtol}, "
                                 f"atol {atol} of float64")
        return (f"{what} within rtol {rtol:g}, atol {atol:g} of float64 "
                f"(max abs err {np.max(np.abs(got - want)):.3e})")

    def below(value, limit, what):
        if not value < limit:
            raise AssertionError(f"[11d] {what} {value:.3e} >= {limit:g}")
        return f"{what} {value:.3e} < {limit:g}"

    # BiCGSTAB on a nonsymmetric diagonally dominant band
    n = 3000
    rng = np.random.default_rng(0)
    m = sps.diags([rng.standard_normal(n - 1) * 0.2, np.full(n, 4.0),
                   rng.standard_normal(n - 1) * 0.3], offsets=[-1, 0, 1],
                  format="coo")
    b = rng.standard_normal(n).astype(np.float32)
    gold = spsolve(m.tocsr().astype(np.float64), b)
    case("bicgstab", COOMatrix.from_scipy(m).to_csr(), spmv,
         lambda op: bicgstab(op, b, device=device),
         lambda o: below(float(o[2]), 1e-5, f"{o[1]} iterations, residual")
         + "; " + close(o[0].cpu(), gold, 1e-3, 1e-4, "x"))

    # Jacobi on a diagonally dominant band, DIA (K8)
    n = 2000
    lil = syn.banded_matrix(n=n, bandwidth=5, seed=3).to_scipy().tolil()
    lil.setdiag(np.abs(lil).sum(axis=1).A1 + 1.0)
    mj = lil.tocsr()
    diag = np.asarray(mj.diagonal(), dtype=np.float32)
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    case("jacobi", COOMatrix.from_scipy(mj.tocoo()).to_csr(), spmv,
         lambda op: jacobi(op, diag, b, tol=1e-6, max_iters=3000,
                           device=device),
         lambda o: below(float(o[2]), 1e-5, f"{o[1]} sweeps, residual")
         + "; " + below(float(np.linalg.norm(b - mj @ o[0].cpu().numpy())
                              / np.linalg.norm(b)), 1e-4,
                        "true relative residual"), pack=dia_pack)

    # Lanczos on a random-diagonal tridiagonal matrix
    n = 500
    rng = np.random.default_rng(11)
    d = sps.diags([np.full(n - 1, -1.0), rng.uniform(2.1, 6.0, n),
                   np.full(n - 1, -1.0)], [-1, 0, 1]).tocoo()
    true = np.linalg.eigvalsh(d.toarray())

    def ritz(o):
        alpha, beta, V = (t.cpu().numpy() for t in o)
        r = np.linalg.eigvalsh(np.diag(alpha) + np.diag(beta, 1)
                               + np.diag(beta, -1))
        G = V.T @ V
        return (below(abs(r[-1] - true[-1]) / abs(true[-1]), 1e-3,
                      "top Ritz value's relative error")
                + "; " + below(abs(r[0] - true[0]) / abs(true[0]), 2e-2,
                               "bottom one's")
                + "; " + close(G, np.eye(G.shape[0]), 0, 1e-4, "V^T V"))

    case("lanczos", COOMatrix.from_scipy(d).to_csr(), spmv,
         lambda op: lanczos(op, n, k=40, seed=1, device=device), ritz)

    # power iteration on a random symmetric matrix
    n = 150
    m = sps.random(n, n, density=0.1, random_state=np.random.default_rng(2))
    ms = ((m + m.T) * 0.5).tocoo()
    ev = np.linalg.eigvalsh(ms.toarray())
    lam_ref = abs(ev[np.argmax(np.abs(ev))])
    case("power_iteration", COOMatrix.from_scipy(ms).to_csr(),
         spmv, lambda op: power_iteration(op, n, tol=1e-10, max_iters=2000,
                                          device=device),
         lambda o: below(abs(abs(float(o[0])) - lam_ref) / lam_ref, 1e-3,
                         f"{o[2]} iterations, |eigenvalue|'s relative error"))

    # subspace iteration through spmm on a symmetrized band
    n = 1200
    m = syn.banded_matrix(n=n, bandwidth=7, seed=5).to_scipy()
    ms = ((m + m.T) / 2).tocoo()
    top = np.sort(np.abs(np.linalg.eigvalsh(ms.toarray())))[-1]
    case("subspace_iteration", COOMatrix.from_scipy(ms).to_csr(),
         spmm, lambda op: subspace_iteration(op, n, k=4, iters=60,
                                             device=device),
         lambda o: below(abs(abs(float(o[0][0])) - top) / top, 5e-2,
                         "top eigenvalue's relative error"))

    # a GraphSAGE-mean layer
    n, fin, fout = 300, 12, 12
    rng = np.random.default_rng(7)
    coo = COOMatrix(np.repeat(np.arange(n, dtype=np.int32), 5),
                    rng.integers(0, n, size=5 * n).astype(np.int32),
                    np.ones(5 * n, dtype=np.float32), (n, n)).sum_duplicates()
    deg = np.zeros(n)
    np.add.at(deg, coo.rows, coo.vals)
    mean = COOMatrix(coo.rows, coo.cols, (coo.vals / np.maximum(
        deg[coo.rows], 1)).astype(np.float32), (n, n))
    X = rng.standard_normal((n, fin)).astype(np.float32)
    Ws = (rng.standard_normal((fin, fout)) * 0.3).astype(np.float32)
    Wn = (rng.standard_normal((fin, fout)) * 0.3).astype(np.float32)
    ref = np.maximum(X @ Ws + (mean.to_dense().astype(np.float64) @ X) @ Wn,
                     0.0)
    case("graphsage_layer", mean.to_csr(), spmm,
         lambda op: graphsage_layer(op, X, Ws, Wn, device=device),
         lambda o: close(o.cpu(), ref, 1e-4, 1e-5, "output"))

    # PageRank on the plain SELL planes (torch ops: no kernel of ours)
    n = 300
    rng = np.random.default_rng(0)
    adj = COOMatrix(np.repeat(np.arange(n, dtype=np.int32), 8),
                    rng.integers(0, n, size=8 * n).astype(np.int32),
                    np.ones(8 * n, dtype=np.float32), (n, n)).sum_duplicates()
    deg = np.zeros(n)
    np.add.at(deg, adj.rows, adj.vals)
    P = np.divide(adj.to_dense().astype(np.float64).T, np.maximum(deg, 1),
                  where=deg > 0)
    P[:, deg == 0] = 1.0 / n
    pr = np.full(n, 1.0 / n)
    for _ in range(200):
        pr_new = (1 - 0.85) / n + 0.85 * (P @ pr)
        pr_new /= np.abs(pr_new).sum()
        if np.abs(pr_new - pr).sum() < 1e-12:
            break
        pr = pr_new
    sd = upload(sell_pack(adj.transpose().to_csr(), C=128), device)
    (p, its, _), _ = payload_run(
        "[11d] pagerank_sell",
        lambda: pagerank_sell(sd, out_degree=deg, tol=1e-10, max_iters=200),
        dict.fromkeys(kernels.KERNELS, 0))
    print(f"[11d] pagerank_sell ({its} iterations; the SELL planes run as "
          f"torch ops, no kernel of ours): "
          + close(p.cpu(), pr, 2e-3, 1e-6, "ranks"))
    return rows


def model_paths(device, coo):
    """Phase [11]: the payloads, each through the entry point a user
    calls, held against float64 and its kernels against their plain
    versions."""
    rows = []
    for part, run in (("a", lambda: pagerank_payload(device, coo)),
                      ("b", lambda: cg_payload(device)),
                      ("c", lambda: gcn_payload(device, coo)),
                      ("d", lambda: small_payloads(
                          device, {r["name"] for r in rows}))):
        t0 = time.perf_counter()
        rows += run()
        print(f"[11{part}] took {time.perf_counter() - t0:.1f} s")
    return rows


# Phase [12]: packed artifacts saved, loaded and run.  (b): name, matrix,
# the artifact's kind (port_pack), the environment of its pack, the widths
# it runs at (0: the SpMV, K: the SpMM of K columns).
LOADED = (
    ("dia", lambda: syn.banded_matrix(1 << 16, 27), "dia", {}, (0, 64)),
    ("bell_spill", lambda: syn.road_usa_like(n=1 << 18), "bell", {}, (0,)),
    ("window", lambda: syn.fem_like(n=1 << 15), "sell-window", {}, (0,)),
    ("window_y_route", lambda: syn.fem_like(n=1 << 15), "window_y_route", {},
     (0,)),
    ("bsr", lambda: syn.fem_like(n=1 << 15), "bsr", {}, (64,)),
    ("pmm", lambda: syn.fsm_like(n=1 << 17), "pmm", {}, (32,)),
    ("lane", lambda: syn.rmat_matrix(14, 6, seed=42), "lane", {}, (128,)),
    ("sell", lambda: syn.rmat_matrix(14, 6, seed=42), "sell", {}, (0,)),
    # [4]'s pack with hot planes: its y digest is recorded
    ("rmat15_hot512", lambda: syn.rmat_matrix(15, 8, seed=5), "sell-routed",
     {**FORCE_HOT, "CVR_HOT_NH": "512"}, (0,)),
)
# (c): artifacts that the JAX package's savers wrote
# (tests/make_torch_fixtures.py writes tests/fixtures/jax_<name>.npz from
# this table): name -> (the matrix by the port's generator, the kind, the
# environment of the pack, the width it runs at).
JAX_FIXTURES = {
    "routed_hot": (lambda: syn.rmat_matrix(11, 8, seed=5), "sell-routed",
                   {**FORCE_HOT, "CVR_HOT_NH": "128"}, 0),
    "bell_spill": (lambda: syn.road_usa_like(n=1 << 14, reach=48), "bell",
                   {}, 0),
    "window_y_route": (lambda: syn.fem_like(n=1 << 12, deg=10, bw=100),
                       "window_y_route", {}, 0),
    "dia": (lambda: syn.banded_matrix(4096, 9), "dia", {}, 0),
    "bsr": (lambda: syn.banded_matrix(4096, 9), "bsr", {}, 8),
    "lane": (lambda: syn.rmat_matrix(10, 8, seed=3), "lane", {}, 8),
    "pmm": (lambda: syn.fsm_like(n=1 << 12), "pmm", {}, 8),
}
FIXTURE_DIR = Path(__file__).resolve().parent / "tests" / "fixtures"


def block_sorted(coo, block=128):
    """coo with the rows of each block of ``block`` rows sorted by
    descending length (stably), and for each row of coo its row there."""
    n = coo.shape[0]
    lengths = np.bincount(coo.rows, minlength=n)
    order = np.concatenate([
        s + np.argsort(-lengths[s : s + block], kind="stable")
        for s in range(0, n, block)]) if n else np.zeros(0, np.int64)
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    return COOMatrix(rows=inv[coo.rows].astype(np.int32), cols=coo.cols,
                     vals=coo.vals, shape=coo.shape), inv


def window_with_y_route(coo, block=128) -> SellWindow:
    """A SELL-W artifact with a y-route: the pack of coo's rows in
    block_sorted's order, and the route that takes its rows back to
    natural order (row i of y is row inv[i] of the planes)."""
    rows, inv = block_sorted(coo, block)
    return dataclasses.replace(
        sell_pack_window(rows.to_csr()),
        y_ra=rp.route_arrays_from_perm(inv, n=coo.shape[0]))


def port_pack(kind, coo, env=None):
    """The port's own pack of ``coo`` as an artifact of ``kind``, under
    the environment switches ``env``."""
    packs = {
        "sell-routed": sell_pack_routed, "bell": bell_pack,
        "sell-window": sell_pack_window,
        "window_y_route": lambda csr: window_with_y_route(coo),
        "dia": dia_pack, "bsr": bsr_pack, "lane": spmm_lane_pack,
        "pmm": lambda csr: pmm_plan(coo.rows, coo.cols, coo.vals, coo.shape),
        "sell": lambda csr: sell_pack(csr, C=128),
    }
    with environment(env or {}):
        return packs[kind](coo.to_csr())


def saved_kind(kind) -> str:
    """The kind cli.sniff_packed reads from a file of artifact ``kind``."""
    return {"window_y_route": "sell-window"}.get(kind, kind)


def same_outputs(tag, packed, loaded, coo, K, device):
    """The loaded device artifact's y (K 0, x from default_rng(7)) or Y (K
    columns from default_rng(K)) against the packed one's, bit for bit,
    both under torch's deterministic algorithms (index_add_ adds the
    split-row extras by atomics otherwise); the launches of the loaded
    one's run against what it needs; y (Y's first columns) at the float64
    golden.  Returns (x or X on the device, the launches)."""
    rng = np.random.default_rng(K or 7)
    X = rng.standard_normal(
        (coo.shape[1], K) if K else coo.shape[1]).astype(np.float32)
    Xd = torch.from_numpy(X).to(device)
    fn = spmm if K else spmv
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want = fn(packed, Xd)
        kernels.reset_launches()
        got = fn(loaded, Xd)
        torch.cuda.synchronize()
        launches = kernels.launches()
    finally:
        torch.use_deterministic_algorithms(False)
    same = torch.equal(got, want)
    csr = coo.to_csr()
    if K:
        c = SPMM_CHECK_COLS
        golden, scale = spmm_golden(csr, X[:, :c])
        got = got[:, :c]
    else:
        golden, scale = spmv_golden_numpy(csr, X), spmv_row_scale(csr, X)
    ok, nbad, maxrel = verify(got.cpu().numpy(), golden, rtol=1e-6,
                              row_scale=scale)
    need = expected_spmm_launches(loaded, K) if K else expected_launches(
        loaded)
    print(f"{tag} loaded artifact's {'Y' if K else 'y'} "
          f"{'bit-exact with' if same else 'DIFFERS from'} the packed one's; "
          f"float64 golden {'PASS' if ok else 'FAIL'} ({nbad} bad, max rel "
          f"{maxrel:.2e}); launches "
          f"{ {k: n for k, n in launches.items() if n} }")
    if not (same and ok) or launches != need:
        raise AssertionError(f"{tag} the loaded artifact differs, fails the "
                             f"golden, or launched {launches} for {need}")
    return Xd, launches


def library_whole(name, csr, Xd, device) -> dict:
    """The library call of a kernel that is the whole SpMV or SpMM
    (library_call has none for it): cuSPARSE's CSR SpMV or SpMM of the
    matrix, by CUDA events, checked against the golden."""
    if name not in ("dia_spmv", "dia_spmm", "bsr_spmm", "pmm_spmm"):
        return {}
    A = cusparse_csr(csr, device)
    X = Xd.cpu().numpy()
    if Xd.dim() == 1:
        golden, scale = spmv_golden_numpy(csr, X), spmv_row_scale(csr, X)
        got = (A @ Xd).cpu().numpy()
    else:
        c = SPMM_CHECK_COLS
        golden, scale = spmm_golden(csr, X[:, :c])
        got = (A @ Xd)[:, :c].cpu().numpy()
    if not verify(got, golden, rtol=1e-6, row_scale=scale)[0]:
        raise AssertionError(f"cuSPARSE is not {name}'s function")
    return {name: time_iterations(lambda: A @ Xd, KERNEL_ITERS, device) * 1e3}


def loaded_kernels(tag, path, sd, Xd, launches, csr, device):
    """The timed run of the loaded artifact ``sd`` and each kernel launch
    of it against its plain version (check_kernels, on ``path``)."""
    fn = spmm if Xd.dim() == 2 else spmv
    ms = time_iterations(lambda: fn(sd, Xd), ITERS, device) * 1e3
    name = spmm_kernel(sd) if Xd.dim() == 2 else None
    per = device_ms(lambda: fn(sd, Xd), KERNEL_ITERS,
                    None if name is None else event_of(name))
    ours = by_kernel(per)
    print(f"{tag} {'SpMM' if Xd.dim() == 2 else 'SpMV'} of the loaded "
          f"artifact: {ms:.4f} ms/iter over {ITERS} iters (CUDA events), "
          f"device time {device_split(per, ours)}")
    library = {}
    for k, n in launches.items():
        if n:
            library.update(library_whole(k, csr, Xd, device))
    rows = check_kernels(tag, path, sd, Xd, launches, ours, device, library)
    for r in rows:
        r["loaded_ms"] = ms
    return rows, ms


def cli_run(tag, argv) -> str:
    """cli.main(argv) with its standard output printed under ``tag``;
    raises unless it exits 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"{tag} | {line}")
    if rc != 0:
        raise AssertionError(f"{tag} cli {' '.join(argv)} exited {rc}")
    return out


def loaded_main_path(device, coo):
    """[12a]: the main path's matrix through the CLI, packed and saved
    (--save-packed), then run from the file (--load-packed), then loaded
    and uploaded here: its y against [2]'s recorded digest, its kernels
    against their plain versions."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        f = os.path.join(tmp, "web_google_like.mtx")
        p = os.path.join(tmp, "web_google_like.npz")
        t0 = time.perf_counter()
        write_matrix_market(f, coo)
        print(f"[12a] {f}: {os.path.getsize(f) / 1e6:.1f} MB written in "
              f"{time.perf_counter() - t0:.2f} s")
        out = cli_run("[12a] save", ["spmv", f, "--format", "routed",
                                     "--save-packed", p])
        saved = re.search(r"\(pack ([\d.]+) s, save ([\d.]+) s, ([\d.]+) MB",
                          out)
        passed = out.count("Verification: PASS")
        out = cli_run("[12a] load", ["spmv", f, "--load-packed", p])
        loaded = re.search(r"\[format: sell-routed\] load ([\d.]+) s, upload "
                           r"([\d.]+) s", out)
        spmv_ms = re.search(r"SpMV Execution Time: ([\d.]+) ms", out)
        if not (saved and loaded and spmv_ms) or passed + out.count(
                "Verification: PASS") != 2:
            raise AssertionError("[12a] the CLI's save or load did not "
                                 "report, sniff routed or verify")
        t0 = time.perf_counter()
        sr = load_routed(p)
        load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = upload(sr, device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    print(f"[12a] cli: pack {saved[1]} s, savez_compressed {saved[2]} s, "
          f"file {saved[3]} MB, load {loaded[1]} s, upload {loaded[2]} s, "
          f"SpMV {spmv_ms[1]} ms (x all ones); here: load_routed "
          f"{load_s:.3f} s, upload {upload_s:.3f} s: {geometry(sr)}")
    x = np.random.default_rng(0).standard_normal(coo.shape[1]).astype(
        np.float32)
    xd = torch.from_numpy(x).to(device)
    got = y_digest(lambda: spmv(sd, xd))
    want = PARENT_Y_SHA256["[2] web_google_like"]
    print(f"[12a] loaded y sha256 {got}, [2]'s recorded {want}: "
          f"{'equal' if got == want else 'DIFFERENT'}")
    if got != want:
        raise AssertionError("[12a] the loaded artifact's y is not [2]'s")
    kernels.reset_launches()
    y = spmv(sd, xd)
    torch.cuda.synchronize()
    launches = kernels.launches()
    csr = coo.to_csr()
    ok, nbad, maxrel = verify(y.cpu().numpy(), spmv_golden_numpy(csr, x),
                              rtol=1e-6, row_scale=spmv_row_scale(csr, x))
    print(f"[12a] golden {'PASS' if ok else 'FAIL'} ({nbad} bad, max rel "
          f"{maxrel:.2e}); launches "
          f"{ {k: n for k, n in launches.items() if n} }")
    if not ok or launches != expected_launches(sd):
        raise AssertionError(f"[12a] golden or launches {launches}, the "
                             f"artifact needs {expected_launches(sd)}")
    rows, _ = loaded_kernels("[12a]", "loaded_web_google_like", sd, xd,
                             launches, csr, device)
    return rows


def loaded_artifacts(device):
    """[12b]: each of LOADED packed, saved (cli.save_packed), loaded
    (cli.load_packed, the kind sniffed) and uploaded, with each step's
    time; its outputs against the packed artifact's (same_outputs), and
    each of its kernel launches against its plain version."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, make, kind, env, widths in LOADED:
            tag = f"[12b] {name}"
            coo = make()
            t0 = time.perf_counter()
            A = port_pack(kind, coo, env)
            pack_s = time.perf_counter() - t0
            path = os.path.join(tmp, f"{name}.npz")
            t0 = time.perf_counter()
            cli.save_packed(A, path)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got_kind, B = cli.load_packed(path)
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            sd = upload(B, device)
            torch.cuda.synchronize()
            upload_s = time.perf_counter() - t0
            print(f"{tag}: {coo.shape[0]}x{coo.shape[1]}, {coo.nnz} nnz; "
                  f"{describe(B)}; pack {pack_s:.3f} s, save {save_s:.3f} s, "
                  f"file {os.path.getsize(path) / 1e6:.3f} MB, load "
                  f"{load_s:.3f} s, upload {upload_s:.3f} s")
            if got_kind != saved_kind(kind):
                raise AssertionError(f"{tag} sniffed as {got_kind}")
            if name == "bell_spill" and B.spill is None:
                raise AssertionError(f"{tag} has no routed spill")
            packed = upload(A, device)
            del A
            if name == "rmat15_hot512":
                xd = torch.from_numpy(np.random.default_rng(7).standard_normal(
                    coo.shape[1]).astype(np.float32)).to(device)
                got = y_digest(lambda: spmv(sd, xd))
                want = PARENT_Y_SHA256[f"[4] {name}"]
                print(f"{tag} loaded y sha256 {got}, [4]'s recorded {want}: "
                      f"{'equal' if got == want else 'DIFFERENT'}")
                if got != want:
                    raise AssertionError(f"{tag} y is not [4]'s")
            for K in widths:
                at = f"{tag} K {K}" if K else tag
                Xd, launches = same_outputs(at, packed, sd, coo, K, device)
                got_rows, _ = loaded_kernels(
                    at, f"loaded_{name}" + (f" K {K}" if K else ""), sd, Xd,
                    launches, coo.to_csr(), device)
                rows += got_rows
            del packed, sd, B
    return rows


def jax_fixtures(device) -> None:
    """[12c]: each artifact of JAX_FIXTURES, as the JAX package saved it,
    loaded and uploaded by the port: its y or Y against the port's own
    pack of the same matrix, bit for bit, and at the golden."""
    for name, (make, kind, env, K) in JAX_FIXTURES.items():
        tag = f"[12c] jax_{name}"
        got_kind, B = cli.load_packed(FIXTURE_DIR / f"jax_{name}.npz")
        if got_kind != saved_kind(kind):
            raise AssertionError(f"{tag} sniffed as {got_kind}")
        coo = make()
        print(f"{tag}: {describe(B)}")
        same_outputs(tag, upload(port_pack(kind, coo, env), device),
                     upload(B, device), coo, K, device)


def cli_rest(device) -> None:
    """[12d]: the rest of the CLI on small files, each exiting 0: compare
    (six reports or refusals, then Best:), compare --rhs 8 (eight), info
    with the reference's --iters and --threads, spmv --format window and
    spmv --format sell --c 128 --sigma 64."""
    with tempfile.TemporaryDirectory() as tmp:
        road = os.path.join(tmp, "road_usa_like_small.mtx")
        fem = os.path.join(tmp, "fem_like_small.mtx")
        write_matrix_market(road, syn.road_usa_like(n=1 << 18))
        write_matrix_market(fem, syn.fem_like(n=1 << 15))
        out = cli_run("[12d] compare", ["compare", road])
        told = out.count("SpMV Execution Time") + out.count("] failed: ")
        if told != 6 or "Best:" not in out:
            raise AssertionError(f"[12d] compare told {told} of 6 impls")
        out = cli_run("[12d] compare --rhs 8", ["compare", road, "--rhs", "8"])
        told = out.count("SpMM Execution Time") + out.count("] failed: ")
        if told != 8 or out.count("Verification: PASS") + out.count(
                "] failed: ") != 8:
            raise AssertionError(f"[12d] compare --rhs 8 told {told} of 8")
        cli_run("[12d] info", ["info", road, "--iters", "2", "--threads",
                               "68"])
        for argv in (["spmv", fem, "--format", "window"],
                     ["spmv", road, "--format", "sell", "--c", "128",
                      "--sigma", "64"]):
            out = cli_run(f"[12d] {' '.join(argv[2:])}", argv)
            if "Verification: PASS" not in out:
                raise AssertionError(f"[12d] {argv} did not verify")


def loaded_paths(device, coo, card):
    """Phase [12]: the packed artifacts saved, loaded and run; ``card``
    names the card (torch's name and nvidia-smi's line)."""
    print(f"[12] card: {card}")
    rows = []
    for part, run in (("a", lambda: loaded_main_path(device, coo)),
                      ("b", lambda: loaded_artifacts(device)),
                      ("c", lambda: jax_fixtures(device)),
                      ("d", lambda: cli_rest(device))):
        t0 = time.perf_counter()
        rows += run() or []
        print(f"[12{part}] took {time.perf_counter() - t0:.1f} s")
    return rows


# Phase [14]: the row-sharded paths of the distributed layer on
# DIST_SHARDS shards of the one card (the 2-D mesh on 2 x 2 of it): path,
# the full-size matrix (FULL_SIZE), K (None: an SpMV), the kernel whose
# launches and device time stand for the path, one launch a shard.
DIST_FORMATS = (
    ("dist_dia", "banded_2m", None, "dia_spmv"),
    ("dist_window", "fem_like", None, "window_reduce"),
    ("dist_bell", "road_usa_like", None, "bell_gather_mac"),
    ("dist_bsr", "fem_like", 64, "bsr_spmm"),
    ("dist_lane", "web_google_like", 128, "lane_reduce"),
    ("dist_pmm", "fsm_like", 32, "pmm_spmm"),
    ("dist2d", "web_google_like", None, "route_small"),
)
DIST_PACKS = {
    "dist_dia": dist_dia.dist_dia_pack,
    "dist_window": dist_window.dist_window_pack,
    "dist_bell": dist_bell.dist_bell_pack,
    "dist_bsr": dist_bsr.dist_bsr_pack,
    "dist_lane": dist_lane.dist_lane_pack,
    "dist_pmm": dist_pmm.dist_pmm_pack,
    "dist2d": dist2d.dist_routed_pack_2d,
}


def dist_run(path, dm, xd, x_sharded):
    """One product of the row-sharded artifact ``dm`` of ``path``."""
    if path == "dist2d":  # x enters whole; its pieces move inside
        return dist2d.dist_spmv_routed_2d(dm, xd)
    fn = {"dist_dia": dist_dia.dist_spmv_dia,
          "dist_window": dist_window.dist_spmv_window,
          "dist_bell": dist_bell.dist_spmv_bell,
          "dist_bsr": dist_bsr.dist_spmm_bsr,
          "dist_lane": dist_lane.dist_spmm_lane,
          "dist_pmm": dist_pmm.dist_spmm_pmm}[path]
    return fn(dm, xd, x_sharded=x_sharded)


def dist_shards(path, dm):
    """The shards' (blocks') device artifacts, in shard order."""
    return dm.blocks if path == "dist2d" else dm.shards


def dist_format_launches(path, dm) -> dict[str, int]:
    """Launches of each kernel in one product of ``dm``, from its
    geometry: one launch of the path's kernel a shard (K13's and K14's
    second pass where a shard's plan splits an item), BELL's spill's
    routed passes on every shard, the routed passes on every 2-D block."""
    want = dict.fromkeys(kernels.KERNELS, 0)
    for sd in dist_shards(path, dm):
        if sd is None:  # another rank's
            continue
        if path == "dist_bell":
            want["bell_gather_mac"] += 1
            sd = sd.spill
            if sd is None:
                continue
        if path in ("dist_bsr", "dist_lane", "dist_pmm"):
            got = expected_spmm_launches(sd, 1)
        else:
            got = expected_launches(sd)
        for k, n in got.items():
            want[k] += n
    return want


def dist_format_geometry(path, dm) -> str:
    """The sharded pack's geometry, in one line."""
    rows = np.diff(dm.rb_bounds * 128 if path == "dist_bsr"
                   else dm.bounds).tolist()
    bal = getattr(dm, "balance", None)
    head = f"bounds {rows} rows a shard"
    if bal:
        head += (f", nnz {bal['part_nnz'].tolist()} (imbalance "
                 f"{bal['imbalance']:.4f})")
    if path == "dist_dia":
        sd = dm.shards[0]
        return (f"{head}; rows_max {dm.rows_max}, pre rows {dm.pre}, nd "
                f"{sd.bands.shape[0]}, offsets {dm.offsets[0]} .. "
                f"{dm.offsets[-1]}")
    if path == "dist_window":
        return (f"{head}; forced (D, W) ({dm.D}, {dm.W}), G {dm.G}, wrl "
                f"{dm.wrl}, {dm.n_segs} x segments, {dm.nslices_u} slices in "
                f"{len(dm.ycall_rows)} reduce groups of {dm.ycall_rows} "
                f"(start, rows), S_pad {dm.planes[0]['emit'].shape[0]} a "
                f"shard spliced, {[int(s.li.shape[1]) for s in dm.shards]} "
                f"uploaded, slices a shard "
                f"{[int(s.row0.shape[0]) for s in dm.shards]}")
    if path == "dist_bell":
        m, sp = dm.meta, dm.meta["spill"]
        spill = "none" if sp is None else (
            f"T {sp['T']}, S_pad {sp['S_pad']}, {sp['nslices']} slices, "
            f"{sp['rows_max']} rows a shard (rows per shard "
            f"{[int((pl['sp_map'] < dm.rows_max).sum()) for pl in dm.planes]}"
            f"), y-route Tp {sp['y_Tp']} {sp['ymid_kind']!r}")
        return (f"{head}; k {m['k']}, reach {m['reach']}, ncand "
                f"{m['ncand']}, R_sub {m['R_sub']}, TBb {m['TBb']}, d "
                f"{m['d']}, pre {m['pre']}; forced routed spill: {spill}")
    if path == "dist_bsr":
        return (f"{head}; row-block bounds {dm.rb_bounds.tolist()}, "
                f"nrb_local_max {dm.nrb_local_max}, bricks uploaded a shard "
                f"{[int(sd.vals.shape[0]) for sd in dm.shards]}")
    if path == "dist_lane":
        ex = [int((pl["extra_row"] < dm.rows_max).sum()) for pl in dm.planes]
        return (f"{head}; S_lane {dm.meta['S_lane']} padded, "
                f"{[int(s.vals_l.shape[0]) for s in dm.shards]} uploaded, "
                f"{dm.meta['nslices']} slices a shard, split-row extras {ex} "
                f"(padded to {dm.planes[0]['extra_row'].shape[0]}, the "
                f"padding not uploaded), K13 pieces "
                f"{[int(s.split.pieces.shape[0]) for s in dm.shards]}")
    if path == "dist_pmm":
        return (f"{head}; c_mean {dm.c_mean:.4f}, pairs "
                f"{[p.npairs for p in dm.plans]}, chunks "
                f"{[p.nchunks for p in dm.plans]}; the JAX kernel's segments "
                f"a shard {[dist_pmm.tpu_segments(p) for p in dm.plans]} "
                f"({dist_pmm.SEG} pairs each); K14's work: segments "
                f"{[int(s.work.segptr.shape[0]) - 1 for s in dm.shards]}, "
                f"units {[int(s.work.units.shape[0]) for s in dm.shards]}, "
                f"split rows {[int(s.work.combine.shape[0]) for s in dm.shards]}")
    m = dm.meta
    return (f"{head}; {dm.R} x {dm.C} blocks, {dm.nwin_u} windows a column "
            f"block, rows_max {dm.rows_max}; per block: T {m['T']}, S_pad "
            f"{m['S_pad']}, {m['nslices']} slices in {len(m['ycall_rows'])} "
            f"reduce groups, middle {m['mid_kind']!r}, y-route Tp "
            f"{m['y_Tp']} {m['ymid_kind']!r}, "
            f"{dm.planes[0]['extra_src'].shape[0]} split-row extras")


def dist_block_x(dm, xd, b):
    """Block b's gathered x of the 2-D mesh (its column block's windows)."""
    xp = torch.nn.functional.pad(xd, (0, dm.nwin_u * dm.C * 1024
                                      - xd.shape[0]))
    return xp.view(-1, 1024)[b % dm.C :: dm.C].reshape(-1).contiguous()


def dist_shard_cases(tag, path, dm, d, xd):
    """Every kernel launch of shard (block) d in one product, as
    kernel_cases gives them, at the tensors that shard runs on."""
    sd = dist_shards(path, dm)[d]
    if path == "dist_dia":
        p = dm.pre[d]
        return [("dia_spmv", "", (sd.bands, sd.offsets,
                                  xd[int(dm.bounds[d]) - p:]))]
    if path == "dist_bell":
        cases = [("bell_gather_mac", "",
                  dist_bell.shard_gather_args(dm, d, xd))]
        if sd.spill is not None:
            cases += [(name, f"spill {which}".strip(), args)
                      for name, which, args in kernel_cases(
                          f"{tag} spill", sd.spill, xd)]
        return cases
    if path == "dist2d":
        return kernel_cases(tag, sd, dist_block_x(dm, xd, d))
    return kernel_cases(tag, sd, xd)


def dist_shard_csr(path, dm, csr, d):
    """Shard d's rows of the matrix (global columns): what its kernel's
    library call multiplies."""
    if path == "dist_bsr":
        lo = min(int(dm.rb_bounds[d]) * 128, csr.shape[0])
        hi = min(int(dm.rb_bounds[d + 1]) * 128, csr.shape[0])
    else:
        lo, hi = int(dm.bounds[d]), int(dm.bounds[d + 1])
    return local_csrs(csr, np.asarray([lo, hi]))[0]


def graph_ms(wrapper, groups, device) -> float:
    """Device ms of one replay of a CUDA graph that runs each group of
    ``wrapper`` launches (argument tuples) in order on a stream of its
    own, the groups side by side: no host enqueue inside the timing."""
    side = [torch.cuda.Stream(device) for _ in groups]
    for grp in groups:  # builds and first-launch set-up outside the capture
        for args in grp:
            wrapper(*args)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        cur = torch.cuda.current_stream()
        for s, grp in zip(side, groups):
            s.wait_stream(cur)
            with torch.cuda.stream(s):
                for args in grp:
                    wrapper(*args)
        for s in side:
            cur.wait_stream(s)
    ms = time_iterations(g.replay, KERNEL_ITERS, device) * 1e3
    del g
    return ms


def dist_fill(tag, name, one_args, shard_args, device) -> None:
    """Why a shard's launch takes more than its share of the one-card
    launch: the one-card launch, the shards' launches in series, and the
    shards' launches side by side on a stream each, all replayed from CUDA
    graphs.  Side by side the launches fill the card together, so what
    they save against the series is the cost of launches that leave it
    part idle (a short last wave, the ramp and tail of each launch), and
    what remains above the one-card launch is work or bytes that sharding
    adds."""
    wrapper = kernels.KERNELS[name][0]
    one = graph_ms(wrapper, [[one_args]], device)
    series = graph_ms(wrapper, [shard_args], device)
    side = graph_ms(wrapper, [[a] for a in shard_args], device)
    print(f"{tag} {name} from CUDA graphs (device ms a replay): the "
          f"one-card launch {one:.4f}; the {len(shard_args)} shards' "
          f"launches in series {series:.4f} (x{series / one:.3f}), side by "
          f"side {side:.4f} (x{side / one:.3f})")


def dist_format_kernels(tag, path, label, dm, csr, xd, launches, ours,
                        main, one_sd, device):
    """Shard 0's kernel launches against their plain versions (with times,
    bound and library call, as [3]), then the path's main kernel on every
    other shard (block) against its plain version (check_plain), and the
    shards' launches against the one-card artifact ``one_sd``'s launch
    (dist_fill)."""
    cases = dist_shard_cases(tag, path, dm, 0, xd)
    library = library_whole(main, dist_shard_csr(path, dm, csr, 0), xd,
                            device) if path != "dist2d" else {}
    rows = check_path(f"{tag} shard 0", label, cases, launches, ours, device,
                      library)
    for r in rows:
        r["launch"] = f"shard 0 {r['launch']}".strip()
    first = "reduce_slices" if path == "dist2d" else main
    shard_args = [next(a for n, _, a in cases if n == first)]
    for d in range(1, len(dist_shards(path, dm))):
        args = next(a for n, w, a in dist_shard_cases(
            f"{tag} shard {d}", path, dm, d, xd) if n == first)
        shard_args.append(args)
        check_plain(tag, first, f"shard {d}", args)
    print(f"{tag} {first} over the {len(shard_args)} shards: "
          f"{launches[first]} launches, in the path's trace "
          f"{ours[first]:.4f} ms")
    one_args = next(a for n, _, a in kernel_cases(f"{tag} one-card", one_sd,
                                                  xd) if n == first)
    dist_fill(tag, first, one_args, shard_args, device)
    return rows


def dist_one_card(path, coo, csr, main_sd, device):
    """The one-card path of the same matrix: (function of x, its pack's
    line, its device artifact)."""
    t0 = time.perf_counter()
    if path == "dist2d":
        sd = main_sd if main_sd is not None else sp.to_device_routed(
            sell_pack_routed(csr), device)
        return functools.partial(sp.spmv_routed, sd), "[2]'s pack", sd
    A = {"dist_dia": lambda: dia_pack(csr),
         "dist_window": lambda: sell_pack_window(csr),
         "dist_bell": lambda: bell_pack(csr),
         "dist_bsr": lambda: bsr_pack(csr),
         "dist_lane": lambda: spmm_lane_pack(csr),
         "dist_pmm": lambda: pmm_plan(coo.rows, coo.cols, coo.vals,
                                      coo.shape)}[path]()
    sd = upload(A, device)
    line = f"pack {time.perf_counter() - t0:.3f} s: {describe(A)}"
    fn = spmm if path in ("dist_bsr", "dist_lane", "dist_pmm") else spmv
    return functools.partial(fn, sd), line, sd


def dist_format_path(device, path, name, K, main, main_sd):
    """One path of DIST_FORMATS: the sharded pack, each x mode (launches,
    golden, y's digest, times beside the one-card path's), then the
    kernels."""
    tag = f"[14] {path}"
    D = DIST_SHARDS
    coo = full_size(name)
    csr = coo.to_csr()
    if path == "dist2d":
        mesh = dist2d.make_mesh2d(2, 2, devices=[device] * 4)
    else:
        mesh = make_mesh(devices=[device] * D)
    t0 = time.perf_counter()
    dm = DIST_PACKS[path](csr, mesh)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    phases = getattr(dm, "convert_phases", None)
    print(f"{tag} {name}: {coo.shape[0]}x{coo.shape[1]}, {coo.nnz} nnz; "
          f"pack and upload {pack_s:.3f} s"
          + (f" ({', '.join(f'{k} {v:.3f}' for k, v in phases.items())})"
             if phases else "") + f": {dist_format_geometry(path, dm)}")
    rng = np.random.default_rng(0 if K is None else K)
    X = rng.standard_normal(coo.shape[1] if K is None
                            else (coo.shape[1], K)).astype(np.float32)
    xd = torch.from_numpy(X).to(device)
    if K is None:
        golden, scale = spmv_golden_numpy(csr, X), spmv_row_scale(csr, X)
    else:
        golden, scale = spmm_golden(csr, X[:, :SPMM_CHECK_COLS])
    one, line, one_sd = dist_one_card(path, coo, csr, main_sd, device)
    one_ms = time_iterations(lambda: one(xd), ITERS, device) * 1e3
    one_dev = sum(device_ms(lambda: one(xd), KERNEL_ITERS, None).values())
    print(f"{tag} one-card path ({line}): {one_ms:.4f} ms/iter (CUDA "
          f"events), device time {one_dev:.4f} ms/iter")
    label = f"{path} {name} {mesh.size} shards"
    if K is not None:
        label += f" K {K}"
    want = dist_format_launches(path, dm)
    rows = []
    for x_sharded in ((False,) if path == "dist2d" else (False, True)):
        mode = "x whole" if path == "dist2d" else (
            "x_sharded" if x_sharded else "replicated")
        fn = functools.partial(dist_run, path, dm, xd, x_sharded)
        kernels.reset_launches()
        y = fn()
        torch.cuda.synchronize()
        launches = kernels.launches()
        shape = (coo.shape[0],) if K is None else (coo.shape[0], K)
        if tuple(y.shape) != shape or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{tag} {mode}: bad output "
                                 f"{tuple(y.shape)}")
        if K is None:
            ok, nbad, maxrel = verify(y.cpu().numpy(), golden, rtol=1e-6,
                                      row_scale=scale)
            print(f"{tag} {mode}: verify vs float64 golden (rtol 1e-6, "
                  f"row-scaled): {'PASS' if ok else 'FAIL'}, {nbad} bad "
                  f"rows, max rel {maxrel:.3e}")
            if not ok:
                raise AssertionError(f"{tag} {mode} disagrees with the "
                                     "golden")
        else:
            check_columns(f"{tag} {mode}", f"K {K} SpMM",
                          y[:, :SPMM_CHECK_COLS].cpu().numpy(), golden,
                          scale)
        del y
        print(f"{tag} {mode}: launches "
              f"{ {k: n for k, n in launches.items() if n} }, the geometry "
              f"predicts { {k: n for k, n in want.items() if n} }")
        if launches != want:
            raise AssertionError(f"{tag} {mode} launches {launches}, the "
                                 f"pack needs {want}")
        print(f"{tag} {mode} y sha256 {y_digest(fn)} (deterministic "
              "algorithms)")
        ms = time_iterations(fn, ITERS, device) * 1e3
        per = device_ms(fn, KERNEL_ITERS, event_of(main),
                        per_call=len(dist_shards(path, dm)))
        dev = sum(per.values())
        ours = by_kernel(per)
        flops = 2 * coo.nnz * (1 if K is None else K)
        print(f"{tag} {mode}: {ms:.4f} ms/iter over {ITERS} iters (CUDA "
              f"events), {flops / ms / 1e6:.3f} GFLOPS; device time "
              f"{device_split(per, ours)} (busy {100 * dev / ms:.1f}%); "
              f"one-card path {one_ms:.4f} ms events, {one_dev:.4f} ms "
              f"device (x{ms / one_ms:.2f} events, x{dev / one_dev:.2f} "
              "device)")
        if not x_sharded:
            rep_ms = ms
        else:  # the kernels' inputs are those of the first mode
            xs = tdist.replicate_or_gather(xd, dm.mesh, coo.shape[1], True)
            if not all(torch.equal(xi, xd) for xi in xs):
                raise AssertionError(f"{tag} the all-gathered x is not x")
            print(f"{tag} x_sharded: every shard's all-gathered x equals x "
                  "bit for bit, so its kernels' inputs are the replicated "
                  "mode's")
            continue
        rows += dist_format_kernels(tag, path, label, dm, csr, xd, launches,
                                    ours, main, one_sd, device)
    for r in rows:
        r["dist_ms"], r["one_card_ms"] = rep_ms, one_ms
    return rows


def dist_formats(device, main_sd):
    """Phase [14]: each path of DIST_FORMATS at full size on DIST_SHARDS
    shards of the one card, then dryrun_multichip(4) on the card."""
    print(f"[14] the {DIST_SHARDS} shards share one card: the all-gather, "
          "the 2-D mesh's moves and its reduce-scatter are copies inside "
          "it, and these times are not scaling figures")
    rows = []
    for path, name, K, main in DIST_FORMATS:
        t0 = time.perf_counter()
        rows += dist_format_path(device, path, name, K, main, main_sd)
        torch.cuda.empty_cache()
        print(f"[14] {path} took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dryrun_multichip(DIST_SHARDS)
    print(f"[14] dryrun_multichip({DIST_SHARDS}) on the card: all paths at "
          f"the golden, {time.perf_counter() - t0:.1f} s")
    return rows


# Phase [15]: RANKS gloo ranks (initialize_distributed) that share the one
# card: the routed path of [8] on web-Google-like in its three modes, the
# 2-D mesh of [14], and the multi-host script's other impls, each on a
# smaller matrix of its generator (the ones [6] and [7] write for the CLI),
# with the single-process mesh of RANKS shards of the card beside it.
RANKS = 4
RANK_TIMEOUT = 900.0  # s a wait may take: rank 0 checks kernels alone
# a [15] SpMV takes 10-40 ms, its moves at the host's speed: fewer
# iterations than ITERS give a steady mean
RANK_ITERS = 20
RANK_IMPLS = (
    ("window", lambda: syn.fem_like(n=1 << 15)),
    ("dia", lambda: syn.banded_matrix(1 << 16, 27)),
    ("xla", lambda: syn.rmat_matrix(14, 6, seed=42)),
    ("bell", lambda: syn.road_usa_like(n=1 << 18)),
    ("lane", lambda: syn.rmat_matrix(14, 6, seed=42)),
)
# the [14] path whose launches each impl's geometry gives (xla: torch ops)
IMPL_PATHS = {"window": "dist_window", "dia": "dist_dia",
              "bell": "dist_bell", "lane": "dist_lane"}
# [14]'s dist2d y of web-Google-like on 2 x 2, as its runs on an H100 print it
DIST2D_SHA256 = "98737e9f1252ae78"
ENTRY_TIMEOUT = 600


def nonzero(counts) -> dict:
    """The kernels of a launch count that launched."""
    return {k: n for k, n in counts.items() if n}


def shared(csr):
    """The CSR's arrays as CPU tensors, which the spawned ranks share."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (csr.rowptr, csr.cols, csr.vals)) + (csr.shape,)


def unshared(t) -> CSRMatrix:
    return CSRMatrix(rowptr=t[0].numpy(), cols=t[1].numpy(),
                     vals=t[2].numpy(), shape=tuple(t[3]))


def lead_device_ms(fn, lead, *args, **kw):
    """device_ms(fn, ...) on rank 0 (it traces its own process), while
    every other rank calls fn as often: rank 0 broadcasts 1 before each
    call and 0 after the last, so that the collectives inside fn pair up.
    Returns rank 0's device ms by kernel, None on the others."""
    bcast = torch.distributed.broadcast
    if lead:
        def call():
            bcast(torch.ones(1), 0)
            return fn()
        try:
            return device_ms(call, *args, **kw)
        finally:
            bcast(torch.zeros(1), 0)
    flag = torch.zeros(1)
    while True:
        bcast(flag, 0)
        if not flag.item():
            return None
        fn()


def rank_exchange(dm, mode, xd):
    """The moves of one routed SpMV of ``mode`` alone: x's all-gather (or
    the ring's D - 1 moves) and y's all-gather, on this rank's tensors."""
    mesh = dm.mesh
    n = int(np.diff(dm.bounds)[mesh.rank])
    ys = tdist.on_shards(mesh, lambda i: torch.zeros(n, device=xd.device))
    if mode != "overlap":
        def fn():
            tdist.replicate_or_gather(xd, mesh, dm.shape[1],
                                      mode == "x_sharded")
            return tdist.concat_rows(mesh, ys, dm.bounds)
        return fn
    Wr = dm.meta["ring_Wr"]
    ring = tdist.RingPermute(mesh, (Wr, 128))
    piece = tdist.on_shards(mesh, lambda i: torch.zeros(
        (Wr, 128), device=xd.device))

    def fn():
        cur = piece
        for _ in range(mesh.size - 1):
            nxt = ring.start(cur)
            ring.wait()
            cur = nxt
        return tdist.concat_rows(mesh, ys, dm.bounds)
    return fn


def rank_time(tag, fn, want_sha, lead, golden, scale, device,
              exchange=None):
    """One run of ``fn`` on every rank: this rank's launches, y at the
    float64 golden (``golden``: (y's shape, the golden on rank 0)),
    y's digest on every rank against ``want_sha`` (None: the ranks agree),
    the time by CUDA events and the exchange's time alone.  Returns
    (launches, digest, ms, exchange ms or None)."""
    kernels.reset_launches()
    y = fn()
    torch.cuda.synchronize()
    launches = kernels.launches()
    if y.shape != golden[0] or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{tag} bad output {tuple(y.shape)}")
    if lead:
        ok, nbad, maxrel = verify(y.cpu().numpy(), golden[1], rtol=1e-6,
                                  row_scale=scale)
        print(f"{tag}: verify vs float64 golden (rtol 1e-6, row-scaled): "
              f"{'PASS' if ok else 'FAIL'}, {nbad} bad rows, max rel "
              f"{maxrel:.3e}")
        if not ok:
            raise AssertionError(f"{tag} disagrees with the golden")
    del y
    shas = multihost.world_list(y_digest(fn))
    if lead:
        print(f"{tag}: y sha256 on ranks 0-{len(shas) - 1} {shas} "
              f"(deterministic algorithms), want {want_sha or 'one'}")
    if len(set(shas)) != 1 or (want_sha is not None and shas[0] != want_sha):
        raise AssertionError(f"{tag}: y sha256 {shas}, want {want_sha}")
    ms = time_iterations(fn, RANK_ITERS, device) * 1e3
    ex = (time_iterations(exchange, RANK_ITERS, device) * 1e3 if exchange
          else None)
    return launches, shas[0], ms, ex


def rank_routed(tag, csr, mesh, xd, golden, scale, lead, dist_ms):
    """[8]'s web-Google-like modes on the world's ranks; rank 0 holds its
    kernel launches against their plain versions.  Returns (launches,
    times, kernels-JSON rows) of this rank."""
    device = xd.device
    packs = {}
    for ring in (False, True):
        t0 = time.perf_counter()
        dm = dist_routed_pack(csr, mesh, overlap=ring)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        phases = ", ".join(f"{k} {v:.3f}"
                           for k, v in dm.convert_phases.items())
        print(f"{tag} dist_routed_pack(overlap={ring}) {secs:.3f} s "
              f"({phases})" + (f": {dist_geometry(dm)}" if lead else ""))
        packs[ring] = dm
    got, times, rows = {}, {}, []
    for mode, ring, check in DIST_CASES[0][2]:
        dm = packs[ring]
        fn = functools.partial(dist_spmv_routed, dm, xd, **DIST_MODES[mode])
        want = dist_launches(dm, mode)
        launches, _, ms, ex = rank_time(
            f"{tag} {mode}", fn,
            PARENT_Y_SHA256[f"[8] web_google_like {mode}"], lead, golden,
            scale, device, rank_exchange(dm, mode, xd))
        per = lead_device_ms(fn, lead, KERNEL_ITERS, "reduce_slices_kernel")
        print(f"{tag} {mode}: launches {nonzero(launches)}, the geometry "
              f"of its shard {mesh.rank}: {nonzero(want)}")
        if launches != want:
            raise AssertionError(f"{tag} {mode} launches {launches}, the "
                                 f"pack needs {want}")
        got[mode], times[mode] = launches, (ms, ex)
        if lead:
            dev = sum(per.values())
            ours = by_kernel(per)
            if mode == "overlap":  # K15 launches K1's kernel
                ours["expand_ring"], ours["expand"] = ours["expand"], 0.0
            one = dist_ms.get(("web_google_like", mode))
            print(f"{tag} {mode}: {ms:.4f} ms/iter over {RANK_ITERS} iters "
                  f"(CUDA events), device time {dev:.4f} ms/iter (rank 0's "
                  f"process; busy {100 * dev / ms:.1f}%; "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ours.items() if v)
                  + f"); the exchange alone {ex:.4f} ms ({100 * ex / ms:.1f}"
                  f"% of the SpMV); [8]'s {DIST_SHARDS} shards in one "
                  "process " + (f"{one:.4f} ms" if one else "not run"))
            path = f"web_google_like {RANKS} ranks {mode}"
            ring_mode = mode == "overlap"
            if ring_mode:
                rows.append(check_ring_kernel(tag, path, dm, xd, launches,
                                              ours, device))
            if check and not ring_mode:
                for r in check_kernels(f"{tag} {mode}", path,
                                       dm.shards[0], xd, launches, ours,
                                       device):
                    r["launch"] = f"rank 0 {r['launch']}".strip()
                    rows.append(r)
        torch.distributed.barrier()  # rank 0's kernel checks
    del packs
    return got, times, rows


def rank_phase(rank, main, small, dist_ms):
    """Phase [15] on rank ``rank`` of the RANKS gloo ranks that share the
    card: [8]'s routed modes, [14]'s 2-D mesh and the multi-host script's
    other impls.  Returns this rank's launches, digests and times, and
    rank 0's kernels-JSON rows."""
    sys.stdout.reconfigure(line_buffering=True)
    lead = rank == 0
    tag = f"[15] rank {rank}"
    mesh = make_mesh()
    device = mesh.home
    csr = unshared(main)
    x = np.random.default_rng(0).standard_normal(csr.shape[1]).astype(
        np.float32)
    xd = torch.from_numpy(x).to(device)
    golden = scale = None
    if lead:
        golden, scale = spmv_golden_numpy(csr, x), spmv_row_scale(csr, x)
    golden = ((csr.shape[0],), golden)
    out = {"device": str(device)}
    out["routed"], out["times"], out["rows"] = rank_routed(
        tag, csr, mesh, xd, golden, scale, lead, dist_ms)

    t0 = time.perf_counter()
    dm = dist2d.dist_routed_pack_2d(csr, dist2d.make_mesh2d(2, 2))
    torch.cuda.synchronize()
    print(f"{tag} dist2d pack {time.perf_counter() - t0:.3f} s"
          + (f": {dist_format_geometry('dist2d', dm)}" if lead else ""))
    fn = functools.partial(dist2d.dist_spmv_routed_2d, dm, xd)
    launches, _, ms, _ = rank_time(f"{tag} dist2d 2 x 2", fn, DIST2D_SHA256,
                                   lead, golden, scale, device)
    per = lead_device_ms(fn, lead, KERNEL_ITERS, "route_small_kernel")
    want = dist_format_launches("dist2d", dm)
    if launches != want:
        raise AssertionError(f"{tag} dist2d launches {launches}, want {want}")
    out["dist2d"], out["times"]["dist2d"] = launches, (ms, None)
    if lead:
        print(f"{tag} dist2d 2 x 2: launches {nonzero(launches)} a rank, "
              f"{ms:.4f} ms/iter (CUDA events), device time "
              f"{sum(per.values()):.4f} ms/iter (rank 0's process)")
    del dm

    out["impls"] = {}
    for impl, t in small.items():
        c = unshared(t)
        xs = np.random.default_rng(0).standard_normal(c.shape[1]).astype(
            np.float32)
        xsd = torch.from_numpy(xs).to(device)
        t0 = time.perf_counter()
        dm, spmv = multihost.sharded_spmv(impl, c, mesh)
        pack_s = time.perf_counter() - t0
        want = (dist_format_launches(IMPL_PATHS[impl], dm)
                if impl in IMPL_PATHS else dict.fromkeys(kernels.KERNELS, 0))
        g = (spmv_golden_numpy(c, xs), spmv_row_scale(c, xs)) if lead else (
            None, None)
        launches, sha, ms, _ = rank_time(
            f"{tag} {impl}", functools.partial(spmv, xsd), None, lead,
            ((c.shape[0],), g[0]), g[1], device)
        if launches != want:
            raise AssertionError(f"{tag} {impl} launches {launches}, want "
                                 f"{want}")
        out["impls"][impl] = (sha, launches, pack_s, ms)
    return out


def rank_entry() -> None:
    """``python -m cvr_tpu_torch.multihost --impl routed`` as RANKS gloo
    ranks of one world, then alone with no coordinator flags; each must
    exit 0, and the leads' reports are printed."""
    cmd = [sys.executable, "-m", "cvr_tpu_torch.multihost", "--impl",
           "routed"]
    port = tdist.free_port()
    here = Path(__file__).resolve().parent
    for argvs in ([cmd + ["--coordinator", f"127.0.0.1:{port}",
                          "--num-processes", str(RANKS), "--process-id",
                          str(i), "--backend", "gloo"]
                   for i in range(RANKS)], [cmd]):
        t0 = time.perf_counter()
        procs = [subprocess.Popen(a, cwd=here, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for a in argvs]
        try:
            outs = [p.communicate(timeout=ENTRY_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rcs = [p.returncode for p in procs]
        more = " ..." if len(argvs) > 1 else ""
        print(f"[15] {' '.join(argvs[0][1:])}{more}: {len(procs)} "
              f"process(es), exit codes {rcs}, "
              f"{time.perf_counter() - t0:.1f} s; the lead's output:")
        for line in outs[0].splitlines():
            if "socket.cpp" not in line:
                print(f"[15]   {line}")
        if any(rcs):
            for i, o in enumerate(outs):
                print(f"[15] process {i}'s output ends: {o[-2000:]}")
            raise AssertionError(f"[15] the entry exited {rcs}")


def rank_paths(device, coo):
    """Phase [15]: RANKS gloo ranks on the card, each a process that
    torch.multiprocessing spawns and hands [2]'s CSR (shared, not
    copied), then the multi-host entry.  Returns rank 0's kernels-JSON
    rows."""
    print(f"[15] {RANKS} gloo ranks (initialize_distributed) share this "
          "card: each move goes through host memory, and these times are "
          "the cost of ranks and a host-staged exchange, not scaling "
          "figures")
    torch.cuda.empty_cache()
    small, want = {}, {}
    mesh = make_mesh(devices=[device] * RANKS)
    for impl, make in RANK_IMPLS:
        c = make().to_csr()
        small[impl] = shared(c)
        xs = torch.from_numpy(np.random.default_rng(0).standard_normal(
            c.shape[1]).astype(np.float32)).to(device)
        _, spmv = multihost.sharded_spmv(impl, c, mesh)
        want[impl] = y_digest(functools.partial(spmv, xs))
        print(f"[15] {impl}: {c.shape[0]}x{c.shape[1]}, {c.nnz} nnz; "
              f"{RANKS} shards in one process: y sha256 {want[impl]}")
    t0 = time.perf_counter()
    res = tdist.run_local_ranks(
        rank_phase, RANKS, args=(shared(coo.to_csr()), small, dict(DIST_MS)),
        timeout=RANK_TIMEOUT)
    print(f"[15] the {RANKS} ranks took {time.perf_counter() - t0:.1f} s, "
          f"on devices {[r['device'] for r in res]}")
    for mode in res[0]["routed"]:
        print(f"[15] routed {mode}: launches by rank "
              f"{[nonzero(r['routed'][mode]) for r in res]}; ms/iter by "
              "rank (CUDA events) "
              f"{[round(r['times'][mode][0], 4) for r in res]}, the "
              f"exchange alone {[round(r['times'][mode][1], 4) for r in res]}")
    for impl, (sha, launches, pack_s, ms) in res[0]["impls"].items():
        shas = {r["impls"][impl][0] for r in res}
        print(f"[15] {impl}: y sha256 on every rank {sorted(shas)}, "
              f"{RANKS} shards in one process {want[impl]}; pack "
              f"{pack_s:.3f} s, {ms:.4f} ms/iter (rank 0, CUDA events); "
              f"launches a rank {[nonzero(r['impls'][impl][1]) for r in res]}")
        if shas != {want[impl]}:
            raise AssertionError(f"[15] {impl}: the ranks' y is not the "
                                 "single-process mesh's")
    rank_entry()
    return res[0]["rows"]


# Phase [16]: the JAX package's record of soc-LJ-full (results_r3.jsonl:30,
# impl auto): rows, nnz and the routed stream's padded_nnz (T * 1024)
SOC_LJ_FULL = (8_388_608, 74_366_358, 81_788_928)
SWEEP_IMPLS = ("auto", "sell-xla", "sell", "csr")
NUMPY_PACK = ("rmat18", lambda: syn.rmat_matrix(18, 8, seed=42))
# the tools' inputs at full size: impl, the full_size matrix
PROFILED = (("routed", "web_google_like"), ("window", "fem_like"),
            ("dia", "banded_2m"), ("bsr", "banded_2m"))
# the comm model's links: NVLink 4 of an H100 SXM5, 18 links of 25 GB/s a
# direction (the data sheet's 900 GB/s both ways; not measured here)
NVLINK = ("25e9", "18")


@contextlib.contextmanager
def harness_capture(got):
    """Record what run_spmv_benchmark packs (its CSR and artifact) and
    uploads (the device artifact, and the upload's seconds): the first
    upload call; spmv's own calls (with the device artifact) pass
    through untouched."""
    # the module (cvr_tpu_torch.ops.spmv, the attribute, is its function)
    spmv_module = importlib.import_module("cvr_tpu_torch.ops.spmv")
    pack, up = bench_harness.pack_impl, spmv_module.upload

    def pack_impl(csr, *args, **kw):
        out = pack(csr, *args, **kw)
        got["csr"], got["packed"] = csr, out[0]
        return out

    def upload(A, device="cuda"):
        if "sd" in got:
            return up(A, device)
        t0 = time.perf_counter()
        got["sd"] = up(A, device)
        torch.cuda.synchronize()
        got["upload_s"] = time.perf_counter() - t0
        return got["sd"]

    bench_harness.pack_impl, spmv_module.upload = pack_impl, upload
    try:
        yield
    finally:
        bench_harness.pack_impl, spmv_module.upload = pack, up


def spmv_times(tag, sd, xd, device):
    """One SpMV's ms by CUDA events and its device ms by kernel (a
    trace), printed; returns the device ms by kernel of ours."""
    ms = time_iterations(lambda: spmv(sd, xd), ITERS, device) * 1e3
    per = device_ms(lambda: spmv(sd, xd), KERNEL_ITERS, "route_small_kernel")
    dev = sum(per.values())
    ours = by_kernel(per)
    print(f"{tag} spmv: {ms:.4f} ms/iter over {ITERS} iters (CUDA events); "
          f"device time {device_split(per, ours)} ms/iter, busy "
          f"{100 * dev / ms:.1f}%")
    return ours


def vector_golden(csr, x):
    """Float64 golden y and row scale of the host vector x (scipy)."""
    golden, scale = spmm_golden(csr, x[:, None])
    return golden[:, 0], scale[:, 0]


def soc_lj_full(device, out) -> list[dict]:
    """[16a]: soc-LJ-full at full size through the bench harness (impl
    auto, the user's entry), which must pick the routed path packed by
    the native library; its launches over the harness's calls, its
    report (appended to ``out``), the golden on a random x, times beside
    cuSPARSE, and every kernel of the path against its plain version."""
    tag = "[16a]"
    t0 = time.perf_counter()
    coo = syn.soc_livejournal_full()
    gen_s = time.perf_counter() - t0
    print(f"{tag} soc_livejournal_full: {coo.shape[0]}x{coo.shape[1]}, "
          f"{coo.nnz} nnz, generated in {gen_s:.2f} s (the JAX package's "
          f"record: {SOC_LJ_FULL[0]} rows, {SOC_LJ_FULL[1]} nnz)")
    if (coo.shape[0], coo.nnz) != SOC_LJ_FULL[:2]:
        raise AssertionError(f"{tag} not the recorded matrix")
    got = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    with harness_capture(got):
        r = run_spmv_benchmark(coo, name="soc-LJ-full", impl="auto",
                               iters=ITERS, pack_repeats=1, device=device)
    torch.cuda.synchronize()
    run_launches = kernels.launches()
    run_s = time.perf_counter() - t0
    del coo
    r.print_report(threads_label="auto")
    append_result(r, out)
    append_jsonl(r, out.with_suffix(".jsonl"))
    csr, sr, sd, upload_s = (got["csr"], got["packed"], got["sd"],
                             got["upload_s"])
    if not r.verified or not isinstance(sr, SellRouted):
        raise AssertionError(f"{tag} the harness picked "
                             f"{type(sr).__name__} or failed to verify")
    phases = ", ".join(f"{k} {v:.3f}" for k, v in sr.convert_phases.items())
    print(f"{tag} pack {r.preproc_s:.3f} s ({phases}); upload "
          f"{upload_s:.3f} s; the harness's run {run_s:.1f} s")
    if "stream" not in sr.convert_phases or "expand_tiles" in \
            sr.convert_phases:
        raise AssertionError(f"{tag} the pack did not run on the native "
                             "library")
    print(f"{tag} {geometry(sr)}")
    print(f"{tag} T {sr.T} route tiles ({sr.T * 1024} stream slots), "
          f"{sr.extra_src.shape[0]} split-row extras; the JAX package's "
          f"record: padded_nnz {SOC_LJ_FULL[2]} (T "
          f"{SOC_LJ_FULL[2] // 1024})")
    calls = ITERS + 4  # the harness: 3 warm-up calls, ITERS, then y
    want = {k: n * calls for k, n in expected_launches(sd).items()}
    print(f"{tag} launches over the harness's {calls} SpMVs: "
          f"{ {k: n for k, n in run_launches.items() if n} }")
    if run_launches != want:
        raise AssertionError(f"{tag} launches {run_launches}, the pack "
                             f"needs {want}")
    del sr
    got.clear()
    x = np.random.default_rng(0).standard_normal(csr.shape[1]).astype(
        np.float32)
    xd = torch.from_numpy(x).to(device)
    kernels.reset_launches()
    y = spmv(sd, xd)
    torch.cuda.synchronize()
    launches = kernels.launches()
    golden, scale = vector_golden(csr, x)
    ok, nbad, maxrel = verify(y.cpu().numpy(), golden, rtol=1e-6,
                              row_scale=scale)
    print(f"{tag} one SpMV of a random x: launches "
          f"{ {k: n for k, n in launches.items() if n} }, golden (rtol "
          f"1e-6, row-scaled) {'PASS' if ok else 'FAIL'}, {nbad} bad rows, "
          f"max rel {maxrel:.3e}")
    if not ok or launches != expected_launches(sd):
        raise AssertionError(f"{tag} disagrees with the golden or skipped "
                             "a kernel")
    ours = spmv_times(tag, sd, xd, device)
    cusparse_ms(tag, csr, xd, golden, scale, device)
    print(f"{tag} generation {gen_s:.2f} s, pack {r.preproc_s:.2f} s, "
          f"upload {upload_s:.3f} s")
    del csr, golden, scale, y
    rows = check_kernels(tag, "soc_lj_full", sd, xd, launches, ours, device)
    del sd, xd
    torch.cuda.empty_cache()
    return rows


def sweep_tools(device, out) -> None:
    """[16b]: the sweep's default suite in this process, four impls, two
    packs a run, appended to ``out``; every run must verify."""
    rows = bench_sweep.run_suite(bench_sweep.default_suite(), SWEEP_IMPLS,
                                 out=out, pack_repeats=2, device=device)
    print(bench_sweep.summary(rows))
    if len(rows) != 3 * len(SWEEP_IMPLS) or not all(r.verified
                                                     for r in rows):
        raise AssertionError("[16b] a sweep run failed or did not verify")


@contextlib.contextmanager
def native_hidden():
    """The tests' switch: _native.available() false, so the routed pack
    takes its numpy path; the route's Euler coloring alone still runs in
    the library (the pure-Python coloring takes about a minute a million
    elements), as in tests/test_torch_routed_fallback.py."""
    available, color = _native.available, troute.euler_color_py
    _native.available = lambda: False
    troute.euler_color_py = _native.euler_color_native
    try:
        yield
    finally:
        _native.available, troute.euler_color_py = available, color


def numpy_pack(device) -> list[dict]:
    """[16c]: the routed pack without the native library, on R-MAT 18:
    its pack seconds beside the native pack's, its SpMV's launches, y at
    the golden and within the contract of the native pack's y, and its
    kernels against their plain versions."""
    tag = "[16c]"
    name, make = NUMPY_PACK
    csr = make().to_csr()
    t0 = time.perf_counter()
    native = sell_pack_routed(csr)
    native_s = time.perf_counter() - t0
    with native_hidden():
        t0 = time.perf_counter()
        sr = sell_pack_routed(csr)
        numpy_s = time.perf_counter() - t0
    if "expand_tiles" not in sr.convert_phases or "stream" not in \
            native.convert_phases:
        raise AssertionError(f"{tag} the packs did not take their paths")
    for what, A, secs in (("native", native, native_s),
                          ("numpy", sr, numpy_s)):
        phases = ", ".join(f"{k} {v:.3f}" for k, v in
                           A.convert_phases.items())
        print(f"{tag} {name} {what} pack {secs:.3f} s ({phases}): "
              f"{geometry(A)}")
    x = np.random.default_rng(0).standard_normal(csr.shape[1]).astype(
        np.float32)
    xd = torch.from_numpy(x).to(device)
    sd, sd_native = upload(sr, device), upload(native, device)
    kernels.reset_launches()
    y = spmv(sd, xd)
    torch.cuda.synchronize()
    launches = kernels.launches()
    golden, scale = vector_golden(csr, x)
    yn = y.cpu().numpy()
    ok, nbad, maxrel = verify(yn, golden, rtol=1e-6, row_scale=scale)
    ok2, nbad2, maxrel2 = verify(yn, spmv(sd_native, xd).cpu().numpy(),
                                 rtol=1e-6, row_scale=scale)
    print(f"{tag} numpy pack's SpMV: launches "
          f"{ {k: n for k, n in launches.items() if n} }, golden "
          f"{'PASS' if ok else 'FAIL'} ({nbad} bad, max rel {maxrel:.3e}), "
          f"the native pack's y {'PASS' if ok2 else 'FAIL'} ({nbad2} bad, "
          f"max rel {maxrel2:.3e})")
    if not (ok and ok2) or launches != expected_launches(sd):
        raise AssertionError(f"{tag} the numpy pack's SpMV disagrees")
    ours = spmv_times(tag, sd, xd, device)
    return check_kernels(tag, f"numpy_pack_{name}", sd, xd, launches, ours,
                         device)


def profiled_passes(device, main_sd=None) -> None:
    """[16d]: bench/profile_passes's table for each impl at full size,
    on the full_size matrices (routed on [2]'s pack ``main_sd`` where [2]
    ran); its passes must be the kernels launched, each with a device
    time."""
    csrs = {}
    for impl, name in PROFILED:
        if name not in csrs:
            csrs[name] = full_size(name).to_csr()
        given = {}
        if impl == "routed" and main_sd is not None:
            x = np.random.default_rng(0).standard_normal(
                main_sd.shape[1]).astype(np.float32)
            given = {"sd": main_sd, "x": torch.from_numpy(x).to(device)}
        res = bench_passes.profile(impl, csrs[name], device,
                                   iters=KERNEL_ITERS, **given)
        print(f"[16d] {impl} on {name}:")
        for line in res["text"].splitlines():
            print(f"[16d]   {line}")
        names = {r["name"] for r in res["rows"]}
        timed = torch.device(device).type != "cuda" or all(
            r["device_ms"] is not None for r in res["rows"])
        if names != set(res["launches"]) or not timed:
            raise AssertionError(f"[16d] {impl}: passes {sorted(names)}, "
                                 f"launched {res['launches']}")


def spmm_comm_parity(device, out) -> None:
    """[16e]: ``spmm --quick`` (banded-200K, K 128, K12) at the golden,
    then the comm model's and the parity table over [16a]'s and [16b]'s
    rows (``out``'s JSONL)."""
    spmm_out = out.with_name("spmm_h100.jsonl")
    kernels.reset_launches()
    bench_spmm.main(["--quick", "--out", str(spmm_out), "--device",
                     str(device)])
    row = json.loads(spmm_out.read_text().splitlines()[-1])
    if row["max_rel_err"] > 1e-6 or not kernels.launches()["bsr_spmm"]:
        raise AssertionError(f"[16e] spmm --quick: {row}")
    jsonl = str(out.with_suffix(".jsonl"))
    links = ["--link-bw", NVLINK[0], "--links", NVLINK[1]]
    print(f"[16e] comm model over {jsonl} (NVLink links of the data sheet):")
    if bench_comm.main([jsonl, *links]) != 0:
        raise AssertionError("[16e] comm_model failed")
    if bench_parity.main([jsonl, *links]) != 0:
        raise AssertionError("[16e] parity failed")


def tools_paths(device, scratch, main_sd=None) -> list[dict]:
    """Phase [16]: soc-LJ-full at full size, the sweep, the routed pack
    without the native library, the per-pass profiles (``main_sd``: [2]'s
    pack, or None), then spmm, comm_model and parity, each through its
    tool.  Their CSV and JSONL go to ``scratch``."""
    out = Path(scratch) / "results_h100.csv"
    rows = []
    for part, run in (("a", lambda: soc_lj_full(device, out)),
                      ("b", lambda: sweep_tools(device, out)),
                      ("c", lambda: numpy_pack(device)),
                      ("d", lambda: profiled_passes(device, main_sd)),
                      ("e", lambda: spmm_comm_parity(device, out))):
        t0 = time.perf_counter()
        rows += run() or []
        print(f"[16{part}] took {time.perf_counter() - t0:.1f} s")
    return rows


# Phase [17]: the headline entry, python -m cvr_tpu_torch.bench (root
# bench.py's counterpart) and cvr_tpu_torch.entry
bench_entry = importlib.import_module("cvr_tpu_torch.bench.__main__")
HEADLINE_KEYS = ["metric", "value", "unit", "vs_baseline"]
# (a)'s runs, each a subprocess: the flags after --quick
HEADLINE_QUICK = ((), ("--impl", "sell-xla"), ("--impl", "csr"),
                  ("--pack-repeats", "2"))
HEADLINE_TIMEOUT = 300  # s a run of the entry may take
GENERATION_LINE = re.compile(r"^\[bench\] .* generated in ([0-9.]+) s$")


def headline_run(tag, argv, kind) -> tuple[dict, dict, float]:
    """``python -m cvr_tpu_torch.bench *argv`` as a subprocess, its
    stdout printed under ``tag``: it must exit 0 with a verified report,
    end stdout with bench.py's object, rounded from the GFLOPS of the
    BenchResult it prints on stderr, whose device is the card.  Returns
    (that object, the BenchResult, the generation seconds it printed)."""
    impl = argv[argv.index("--impl") + 1] if "--impl" in argv else \
        "sell-routed"
    name = "rmat13" if "--quick" in argv else "web-Google-like"
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "cvr_tpu_torch.bench", *argv],
                       cwd=Path(__file__).resolve().parent,
                       capture_output=True, text=True,
                       timeout=HEADLINE_TIMEOUT)
    print(f"{tag} python -m cvr_tpu_torch.bench {' '.join(argv)}: exit "
          f"{p.returncode}, {time.perf_counter() - t0:.1f} s")
    for line in p.stdout.splitlines():
        print(f"{tag} | {line}")
    if p.returncode != 0:
        print(f"{tag} its stderr ends: {p.stderr[-2000:]}")
        raise AssertionError(f"{tag} the entry exited {p.returncode}")
    head = json.loads(p.stdout.strip().splitlines()[-1])
    err = p.stderr.splitlines()
    res = json.loads(next(line for line in reversed(err)
                          if line.startswith("{")))
    gen = next(float(m.group(1)) for m in map(GENERATION_LINE.match, err) if m)
    g = res["gflops_2nnz"]
    knl = bench_entry.CVR_KNL_WEBGRAPH_GFLOPS
    print(f"{tag} BenchResult (stderr): {json.dumps(res)}")
    # bench.py rounds vs_baseline from the unrounded GFLOPS: from the
    # rounded value it may differ in its last digit
    if (list(head) != HEADLINE_KEYS
            or head["metric"] != f"SpMV GFLOPS (2*nnz) on {name}, {impl}"
            or head["unit"] != "GFLOPS" or not head["value"] > 0
            or head["value"] != round(g, 3)
            or head["vs_baseline"] != round(g / knl, 3)
            or f"[file: {name}] Verification: PASS" not in p.stdout
            or res["verified"] is not True or res["device"] != kind):
        raise AssertionError(f"{tag} not bench.py's output: {head}, {res}")
    return head, res, gen


def headline_quick_kernels(tag, device) -> list[dict]:
    """bench's --quick default (sell-routed on rmat13) in this process,
    json-only: its launches over the harness's calls, and every kernel
    of the path (K7 too: the hub-column gate fires on rmat13) against its
    plain version at the harness's pack, as in [3]."""
    got = {}
    out = io.StringIO()
    kernels.reset_launches()
    with harness_capture(got), contextlib.redirect_stdout(out):
        rc = bench_entry.main(["--quick", "--json-only", "--device",
                               str(device)])
    torch.cuda.synchronize()
    run_launches = kernels.launches()
    print(f"{tag} in process: exit {rc}, {out.getvalue().strip()}")
    sr, sd, csr = got["packed"], got["sd"], got["csr"]
    print(f"{tag} {geometry(sr)}")
    calls = 200 + 4  # the harness: 3 warm-up calls, 200, then y
    want = {k: n * calls for k, n in expected_launches(sd).items()}
    print(f"{tag} launches over the harness's {calls} SpMVs: "
          f"{ {k: n for k, n in run_launches.items() if n} }")
    if rc != 0 or run_launches != want or not want["reduce_hot"]:
        raise AssertionError(f"{tag} launches {run_launches}, the pack "
                             f"needs {want}")
    x = np.random.default_rng(0).standard_normal(csr.shape[1]).astype(
        np.float32)
    xd = torch.from_numpy(x).to(device)
    kernels.reset_launches()
    y = spmv(sd, xd)
    torch.cuda.synchronize()
    launches = kernels.launches()
    golden, scale = vector_golden(csr, x)
    ok, nbad, maxrel = verify(y.cpu().numpy(), golden, rtol=1e-6,
                              row_scale=scale)
    print(f"{tag} one SpMV of a random x: golden (rtol 1e-6, row-scaled) "
          f"{'PASS' if ok else 'FAIL'}, {nbad} bad rows, max rel "
          f"{maxrel:.3e}")
    if not ok or launches != expected_launches(sd):
        raise AssertionError(f"{tag} disagrees with the golden")
    ours = spmv_times(tag, sd, xd, device)
    return check_kernels(tag, "bench_quick_rmat13", sd, xd, launches, ours,
                         device)


def headline_flagship(tag, device) -> list[dict]:
    """entry(device): the flagship routed SpMV in this process, its
    launches against the pack's, y at the float64 golden and every kernel
    launch against its plain version as in [3]; then ``python -m
    cvr_tpu_torch.entry entry``, which must exit 0."""
    fn, (sd, xd) = flagship.entry(device)
    kernels.reset_launches()
    y = fn(sd, xd)
    torch.cuda.synchronize()
    launches = kernels.launches()
    csr = syn.rmat_matrix(scale=12, edge_factor=8, seed=0).to_csr()
    golden, scale = vector_golden(csr, xd.cpu().numpy())
    yn = y.cpu().numpy()
    ok, nbad, maxrel = verify(yn, golden, rtol=1e-6, row_scale=scale)
    print(f"{tag} entry({device!r}): y {yn.shape}, launches "
          f"{ {k: n for k, n in launches.items() if n} } (the pack needs "
          f"{ {k: n for k, n in expected_launches(sd).items() if n} }), "
          f"golden (rtol 1e-6, row-scaled) {'PASS' if ok else 'FAIL'}, "
          f"{nbad} bad rows, max rel {maxrel:.3e}")
    if (not ok or yn.shape != (csr.shape[0],) or not np.isfinite(yn).all()
            or launches != expected_launches(sd)):
        raise AssertionError(f"{tag} entry() disagrees with the golden or "
                             "skipped a kernel")
    ours = spmv_times(tag, sd, xd, device)
    rows = check_kernels(tag, "entry", sd, xd, launches, ours, device)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "cvr_tpu_torch.entry",
                        "entry"], cwd=Path(__file__).resolve().parent,
                       capture_output=True, text=True,
                       timeout=HEADLINE_TIMEOUT)
    print(f"{tag} python -m cvr_tpu_torch.entry entry: exit "
          f"{p.returncode}, {time.perf_counter() - t0:.1f} s: "
          f"{p.stdout.strip()}")
    if p.returncode != 0 or p.stdout.strip() != \
            f"entry(): OK ({csr.shape[0]},)":
        print(f"{tag} its stderr ends: {p.stderr[-2000:]}")
        raise AssertionError(f"{tag} python -m cvr_tpu_torch.entry entry "
                             f"exited {p.returncode}")
    return rows


def headline_paths(device, kind) -> list[dict]:
    """Phase [17]: (a) the entry's --quick runs (HEADLINE_QUICK), each a
    subprocess; (b) its full default run (web-Google-like, sell-routed,
    100 iterations) on the generator cache full_size wrote, beside [2];
    (c) entry(device) in this process and ``python -m
    cvr_tpu_torch.entry entry``; (d) the --quick default in this process,
    its kernels against their plain versions."""
    torch.cuda.empty_cache()  # the runs of (a) and (b) share the card
    t0 = time.perf_counter()
    for flags in HEADLINE_QUICK:
        head, res, _ = headline_run("[17a]", ["--quick", *flags], kind)
        print(f"[17a] headline: {json.dumps(head)}; spmv {res['spmv_s']} "
              f"s, pack {res['preproc_s']} s, first pack "
              f"{res['preproc_first_s']}")
        if ("--pack-repeats" in flags) != \
                (res["preproc_first_s"] is not None):
            raise AssertionError(f"[17a] preproc_first_s "
                                 f"{res['preproc_first_s']}")
    print(f"[17a] took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cache = Path(os.environ["CVR_TPU_CACHE"])
    cached = sorted(cache.iterdir())
    head, res, gen = headline_run("[17b]", [], kind)
    if not cached or sorted(cache.iterdir()) != cached:
        raise AssertionError(f"[17b] the run did not read the cache "
                             f"full_size wrote ({cached})")
    print(f"[17b] headline: {json.dumps(head)}; web-Google-like generated "
          f"in {gen} s (read from the cache full_size wrote)")
    two = DRIVEN.get("[2] web_google_like")
    beside = "[2] not run" if two is None else (
        f"[2]: {two[1] / 1e3} s by CUDA events, "
        f"{2 * res['nnz'] / two[1] / 1e6} GFLOPS (2*nnz); pack {two[0]} s")
    print(f"[17b] spmv {res['spmv_s']} s, {res['gflops_2nnz']} GFLOPS "
          f"(2*nnz), vs_baseline {head['vs_baseline']}, pack "
          f"{res['preproc_s']} s; {beside}")
    print(f"[17b] took {time.perf_counter() - t0:.1f} s")

    rows = []
    for part, run in (("c", lambda: headline_flagship("[17c]", device)),
                      ("d", lambda: headline_quick_kernels("[17d]",
                                                           device))):
        t0 = time.perf_counter()
        rows += run()
        print(f"[17{part}] took {time.perf_counter() - t0:.1f} s")
    return rows


PHASES = (2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 15, 16, 17)
# phases that run on [2]'s pack and tensors, and [10]'s, whose digests
# they record
NEEDS_2 = (8, 9)
DIGEST_PHASES = (2, 4, 5, 6, 8)


def phase_set(text) -> set[int]:
    """--phases: the phases to run ([0] and [1] always run, [3] runs
    with [2], [13]'s line closes every run)."""
    if text is None:
        return set(PHASES)
    got = {int(p) for p in text.split(",") if p.strip()} - {0, 1, 3, 13}
    if not got <= set(PHASES):
        raise SystemExit(f"chip_smoke: no phase {sorted(got - set(PHASES))}")
    if any(p in got for p in NEEDS_2) and 2 not in got:
        raise SystemExit(f"chip_smoke: phases {NEEDS_2} run on [2]'s pack: "
                         "add 2")
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--y-digests", action="store_true",
                    help="print y_digests (a JSON object) and stop")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run, e.g. 1,2,12 or "
                    "17 (default: all, 2-17)")
    args = ap.parse_args(argv)
    phases = phase_set(args.phases)
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
    print(f"[0] phases: {sorted(phases)}")
    # the generators' cache and the tools' files live for this run only
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    (scratch / "tools").mkdir()
    os.environ["CVR_TPU_CACHE"] = str(scratch / "cache")
    try:
        return run_phases(args, phases, kind, smi, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def run_phases(args, phases, kind, smi, scratch) -> int:
    """main's phases, once the card is known (``scratch``: this run's
    temporary directory)."""
    build()
    if args.y_digests:
        print(json.dumps(y_digests("cuda")))
        return 0
    t0 = time.perf_counter()
    coo = full_size("web_google_like")
    print(f"[2] web_google_like: {coo.shape[0]}x{coo.shape[1]}, {coo.nnz} "
          f"nnz, generated in {time.perf_counter() - t0:.2f} s")
    rows = []
    t0 = time.perf_counter()
    if 2 in phases:
        sr, sd, xd, launches, _ms, spmv_dms, _lib = main_path(coo, "cuda")
        rows += check_kernels("[3]", "web_google_like", sd, xd, launches,
                              spmv_dms, "cuda")
        del xd
        print(f"[2]/[3] took {time.perf_counter() - t0:.1f} s")
    if 4 in phases or 5 in phases:
        t0 = time.perf_counter()
        walks = check_geometries("cuda") if 4 in phases else None
        print(f"[4] took {time.perf_counter() - t0:.1f} s")
        if 5 in phases:
            t0 = time.perf_counter()
            rows += fsm_path("cuda", walks)
            print(f"[5] took {time.perf_counter() - t0:.1f} s")
    for p, run in ((6, lambda: format_paths("cuda")),
                   (7, lambda: spmm_paths("cuda")),
                   (8, lambda: dist_paths("cuda", sd, coo)),
                   (9, lambda: route_api("cuda", sr, sd, coo))):
        if p in phases:
            t0 = time.perf_counter()
            rows += run()
            print(f"[{p}] took {time.perf_counter() - t0:.1f} s")
    if set(DIGEST_PHASES) <= phases:
        if set(Y_SHA256) != set(PARENT_Y_SHA256):
            raise AssertionError(f"[10] the routed y's {sorted(Y_SHA256)} "
                                 f"are not the recorded "
                                 f"{sorted(PARENT_Y_SHA256)}")
        print(f"[10] all {len(Y_SHA256)} routed y's equal the parent's bit "
              "for bit (sha256)")
    for p, run in ((11, lambda: model_paths("cuda", coo)),
                   (12, lambda: loaded_paths("cuda", coo, f"{kind}; nvidia-smi: {smi}")),
                   (14, lambda: dist_formats("cuda", sd if 2 in phases
                                             else None)),
                   (15, lambda: rank_paths("cuda", coo)),
                   (16, lambda: tools_paths("cuda", scratch / "tools",
                                            sd if 2 in phases else None)),
                   (17, lambda: headline_paths("cuda", kind))):
        if p in phases:
            t0 = time.perf_counter()
            rows += run()
            print(f"[{p}] took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
