"""The row-sharded paths of the port on a world of gloo CPU ranks
(initialize_distributed, one process a shard), against the same paths in
one process and against the JAX package's.

One world of D ranks for each D of SIZES runs every path of
tests/torch_ranks.py in each of its x modes: the routed SpMV (x
replicated, all-gathered and moved round the ring), the SELL SpMV (the
multi-host script's ``xla``), SELL-W, DIA, BELL, the lane, BSR and PMM
SpMMs, and at D 4 the 2-D mesh at 2 x 2.  Every rank's y (Y) must equal,
bit for bit, the y of the port's single-process mesh of D CPU shards on
the same pack, and be within the row-scaled 1e-6 contract of the JAX
package's ``dist_*`` on D devices of its 8-device CPU mesh and of the
float64 golden.  The JAX outputs are read from FIXTURE, which
tests/make_torch_fixtures.py records (its interpret-mode calls take up to
~17 s each); the SELL path's, which runs no Pallas, is also run live and
held against the record.  Then the entry ``python -m
cvr_tpu_torch.multihost`` on two gloo ranks, its flags against
scripts/multihost_spmv.py's, the device each backend gives a rank, a lost
peer, and the kernel build's barrier.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_multiprocess.py -q
"""

import ast
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from cvr_tpu.parallel.dist import dist_sell_pack as j_dist_sell_pack
from cvr_tpu.parallel.dist import dist_spmv as j_dist_spmv
from cvr_tpu.parallel.dist import make_mesh as j_make_mesh

from cvr_tpu_torch import multihost
from cvr_tpu_torch.ops import _build
from cvr_tpu_torch.ops.spmv_ref import spmv_row_scale, verify
from cvr_tpu_torch.parallel import dist as tdist
from cvr_tpu_torch.parallel import initialize_distributed
from torch_cases import diagonals, fem, fsm, powerlaw, road
import torch_ranks as tr

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_ref_multiprocess.npz"
SIZES = (2, 4)
# the JAX package's modes recorded for each path: its routed SpMV moves x
# round the ring by a code path of its own
JAX_MODES = {"routed": ("x_sharded", "overlap"), "routed2d": ("x whole",)}
CASES = [(D, p) for D in SIZES for p in tr.paths(D)]


def matrices():
    """(JAX COO, port COO) of each matrix torch_ranks.PATHS names."""
    return {
        "ring": powerlaw(n=6000, avg_nnz=8, seed=11),
        "powerlaw": powerlaw(n=2000, avg_nnz=8, seed=3),
        "fem": fem(n=1 << 13, deg=10, bw=100, seed=5),
        "dia": diagonals(4099, 4093, (-300, -7, 0, 5, 600), seed=12),
        "road": road(n=1 << 13, reach=48, seed=9),
        "bsr": diagonals(2000, 1997, (-130, -3, 0, 2, 260), seed=13),
        "fsm": fsm(n=3000, seed=11),
    }


def jax_key(path, D, mode) -> str:
    return f"{path}_D{D}_{mode}"


def jax_ys(D: int) -> dict:
    """The JAX package's y (Y) of every path on D devices, by jax_key
    (tests/make_torch_fixtures.py records them)."""
    import cvr_tpu.parallel.dist2d as j2d
    from cvr_tpu.parallel import (dist_bell, dist_bsr, dist_dia, dist_lane,
                                  dist_pmm, dist_routed, dist_window)

    packs = {
        "routed": lambda c, m: dist_routed.dist_routed_pack(c, m,
                                                            overlap=True),
        "sell": j_dist_sell_pack, "window": dist_window.dist_window_pack,
        "dia": dist_dia.dist_dia_pack, "bell": dist_bell.dist_bell_pack,
        "lane": dist_lane.dist_lane_pack, "bsr": dist_bsr.dist_bsr_pack,
        "pmm": dist_pmm.dist_pmm_pack,
    }
    runs = {
        "routed": dist_routed.dist_spmv_routed, "sell": j_dist_spmv,
        "window": dist_window.dist_spmv_window,
        "dia": dist_dia.dist_spmv_dia, "bell": dist_bell.dist_spmv_bell,
        "lane": dist_lane.dist_spmm_lane, "bsr": dist_bsr.dist_spmm_bsr,
        "pmm": dist_pmm.dist_spmm_pmm,
    }
    mats = matrices()
    out = {}
    for path in tr.paths(D):
        jcsr = mats[tr.PATHS[path][0]][0].to_csr()
        x = tr.x_of(path, jcsr.shape[1])
        if path == "routed2d":
            jdm = j2d.dist_routed_pack_2d(jcsr, j2d.make_mesh2d(*tr.MESH2D))
            out[jax_key(path, D, "x whole")] = np.asarray(
                j2d.dist_spmv_routed_2d(jdm, x))
            continue
        jdm = packs[path](jcsr, j_make_mesh(D))
        for mode in JAX_MODES.get(path, ("x_sharded",)):
            kw = {"x_sharded": True, **({"overlap": True}
                                        if mode == "overlap" else {})}
            out[jax_key(path, D, mode)] = np.asarray(runs[path](jdm, x, **kw))
    return out


@pytest.fixture(scope="module")
def mats():
    """The port's matrices as tensors, which the ranks share."""
    return {name: (torch.from_numpy(t.rows), torch.from_numpy(t.cols),
                   torch.from_numpy(t.vals), tuple(t.shape))
            for name, (_, t) in matrices().items()}


@pytest.fixture(scope="module")
def worlds(mats):
    """world(D): (each rank's run_paths in a world of D gloo ranks, the
    same paths on one process's mesh of D CPU shards), one world a D."""
    cache = {}

    def world(D):
        if D not in cache:
            cache[D] = (tdist.run_local_ranks(tr.rank_body, D, args=(mats,)),
                        tr.run_paths(mats, D, cpu=True))
        return cache[D]

    return world


@pytest.fixture(scope="module")
def recorded():
    return dict(np.load(FIXTURE))


@pytest.mark.parametrize("D,path", CASES)
def test_every_rank_gives_the_one_process_y(worlds, D, path):
    """Every rank holds its own shard, and gets back the whole y (Y) of
    the single-process path bit for bit, in every x mode."""
    ranks, one = worlds(D)
    for r, got in enumerate(ranks):
        assert got["local"] == (r,) and got["home"] == "cpu"
        assert got["n_devices_refused"]
        for mode in tr.PATHS[path][2]:
            y = got["ys"][path, mode]
            assert y.dtype == np.float32 and y.shape == one[path, mode].shape
            assert np.array_equal(y, one[path, mode]), (r, mode)


@pytest.mark.parametrize("D,path", CASES)
def test_ranks_match_the_jax_package(worlds, recorded, D, path):
    """Rank 0's y (Y) of every mode within the row-scaled 1e-6 contract of
    the JAX package's dist_* on D devices and of the float64 golden."""
    ranks, _ = worlds(D)
    tcoo = matrices()[tr.PATHS[path][0]][1]
    csr = tcoo.to_csr()
    X = tr.x_of(path, csr.shape[1])
    cols = X[:, None] if X.ndim == 1 else X
    A = csr.to_scipy().astype(np.float64)
    for mode in tr.PATHS[path][2]:
        Y = ranks[0]["ys"][path, mode]
        Y = Y[:, None] if Y.ndim == 1 else Y
        for k in range(cols.shape[1]):
            x = cols[:, k]
            scale = spmv_row_scale(csr, x)
            for want in (A @ x.astype(np.float64),
                         *(recorded[jax_key(path, D, m)].reshape(
                             Y.shape)[:, k]
                           for m in JAX_MODES.get(path, ("x_sharded",)))):
                ok, nbad, maxrel = verify(Y[:, k], want, rtol=1e-6,
                                          row_scale=scale)
                assert ok, (mode, k, nbad, maxrel)


@pytest.mark.parametrize("D", SIZES)
def test_recorded_reference_is_the_jax_package(recorded, D):
    """FIXTURE holds every path and mode, and its SELL y is the JAX
    package's live one."""
    want = {jax_key(p, D, m) for p in tr.paths(D)
            for m in JAX_MODES.get(p, ("x_sharded",))}
    assert want <= set(recorded)
    jcoo = matrices()["powerlaw"][0]
    x = tr.x_of("sell", jcoo.shape[1])
    live = np.asarray(j_dist_spmv(j_dist_sell_pack(jcoo.to_csr(),
                                                   j_make_mesh(D)),
                                  x, x_sharded=True))
    assert np.array_equal(live, recorded[jax_key("sell", D, "x_sharded")])


def _launch(args, n, env=None):
    """``n`` processes of ``python -m cvr_tpu_torch.multihost`` with
    ``args`` and --process-id i over a fresh coordinator port: each one's
    (return code, output)."""
    port = tdist.free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cvr_tpu_torch.multihost", *args,
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
         "--process-id", str(i)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(n)]
    try:
        return [(p.wait(timeout=120), p.stdout.read()) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.stdout.close()


def test_multihost_entry_on_two_gloo_ranks():
    """The entry's routed SpMV at R-MAT scale 10 over two gloo CPU ranks:
    each exits 0, the lead prints the reference's three lines."""
    runs = _launch(["--impl", "routed", "--scale", "10", "--iters", "2",
                    "--backend", "gloo"], 2)
    assert [rc for rc, _ in runs] == [0, 0], runs
    lead = runs[0][1].splitlines()
    assert "processes=2 devices=2" in lead
    assert "exchange: gloo" in lead
    for what in ("Pre-processing Time: ", "SpMV Execution Time: ",
                 "Throughput: "):
        line = [ln for ln in lead if what in ln]
        assert len(line) == 1 and line[0].startswith(
            "[file: rmat10] [threads: 2chips] "), lead
    assert "% of aggregate HBM roofline" in line[0]
    assert not any("SpMV Execution" in ln for ln in runs[1][1].splitlines())


def _reference_flags():
    """{option: keyword arguments} of scripts/multihost_spmv.py's
    add_argument calls, read from its source."""
    tree = ast.parse((REPO / "scripts" / "multihost_spmv.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            kw = {k.arg: (k.value.id if isinstance(k.value, ast.Name)
                          else ast.literal_eval(k.value))
                  for k in node.keywords if k.arg != "help"}
            out[node.args[0].value] = kw
    return out


def test_multihost_flags_are_the_reference_scripts():
    """Every flag of scripts/multihost_spmv.py with its default, type,
    action and choices, plus --backend; --x-sharded stays store_true with
    default True, so x always enters row-sharded, as in the reference."""
    ref = _reference_flags()
    got = vars(multihost.parse_args([]))
    for opt, kw in ref.items():
        dest = opt.lstrip("-").replace("-", "_")
        assert got[dest] == kw.get("default"), opt
    assert set(got) == {o.lstrip("-").replace("-", "_") for o in ref} | {
        "backend"}
    assert tuple(ref["--impl"]["choices"]) == multihost.IMPLS
    assert ref["--x-sharded"] == {"action": "store_true", "default": True}
    assert multihost.parse_args(["--x-sharded"]).x_sharded is True
    args = multihost.parse_args(
        ["--coordinator", "h:1", "--num-processes", "4", "--process-id", "3",
         "--mtx", "a.mtx", "--scale", "12", "--iters", "7", "--impl",
         "routed2d", "--mesh2d", "4x2", "--backend", "gloo"])
    assert (args.num_processes, args.process_id, args.scale, args.iters) == (
        4, 3, 12, 7)
    assert (args.coordinator, args.mtx, args.mesh2d, args.backend) == (
        "h:1", "a.mtx", "4x2", "gloo")
    with pytest.raises(SystemExit):
        multihost.parse_args(["--impl", "csr"])
    with pytest.raises(SystemExit, match="--num-processes"):
        multihost.main(["--coordinator", "127.0.0.1:1", "--process-id", "0"])


def test_backend_picks_the_device_and_never_falls_back():
    """nccl: one card a rank, by the rank's index on its host, and a
    ValueError naming --backend gloo where a host has no card or more
    ranks than cards; gloo: ranks may share a card, and run on the CPU
    without one; no other backend."""
    rd = tdist.rank_device
    assert [rd("nccl", ["a", "a"], r, 2) for r in (0, 1)] == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    assert [rd("nccl", ["a", "b"], r, 1) for r in (0, 1)] == [
        torch.device("cuda", 0)] * 2
    for hosts, n_cuda in ((["a", "a"], 1), (["a", "b", "b"], 1),
                          (["a"], 0)):
        with pytest.raises(ValueError, match="--backend gloo"):
            rd("nccl", hosts, len(hosts) - 1, n_cuda)
    assert {rd("gloo", ["a"] * 4, r, 1) for r in range(4)} == {
        torch.device("cuda", 0)}
    assert rd("gloo", ["a"] * 4, 3, 2) == torch.device("cuda", 1)
    assert rd("gloo", ["a", "a"], 1, 0) == torch.device("cpu")
    with pytest.raises(ValueError, match="backend 'mpi'"):
        rd("mpi", ["a"], 0, 1)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="--backend gloo"):
            initialize_distributed("127.0.0.1:1", 2, 0, backend="nccl")


LOST_PEER = """
import os, sys, torch, torch.distributed as dist
from cvr_tpu_torch.parallel import initialize_distributed
rank = int(sys.argv[2])
initialize_distributed(sys.argv[1], 2, rank, backend="gloo", timeout=20)
if rank == 1:
    os._exit(0)  # lost without leaving the world
dist.all_reduce(torch.ones(4))
"""


def test_a_lost_peer_ends_the_run():
    """A rank whose peer is gone fails its next collective (or its
    timeout ends it) with a non-zero code instead of hanging."""
    port = tdist.free_port()
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", LOST_PEER, f"127.0.0.1:{port}", str(r)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in (0, 1)]
    try:
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.stdout.close()
    assert rcs[0] != 0 and time.monotonic() - t0 < 60


def test_kernel_build_waits_for_the_lead(monkeypatch):
    """A host's lead rank builds the kernel library before the barrier;
    every other rank reaches _build.build() only after it."""

    class Lib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    events = []
    monkeypatch.setattr(_build, "build",
                        lambda: events.append("build") or "lib.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    for lead, want in ((True, ["build", "barrier"]),
                       (False, ["barrier", "build"])):
        events.clear()
        monkeypatch.setattr(_build, "_LIB", None)
        multihost.load_kernels(lead, lambda: events.append("barrier"))
        assert events == want


def test_mesh_of_one_process_holds_every_shard():
    mesh = tdist.make_mesh(devices=["cpu"] * 3)
    assert mesh.group is None and mesh.local == (0, 1, 2)
    assert mesh.home == torch.device("cpu")
    assert tdist.on_shards(mesh, lambda i: i * i) == [0, 1, 4]
    assert tdist.on_shards(tdist.Mesh(mesh.devices, group=object(), rank=1),
                           lambda i: i) == [None, 1, None]
