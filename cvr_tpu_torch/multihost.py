"""The multi-process, multi-host distributed SpMV launcher.

Run one copy per rank:

  python -m cvr_tpu_torch.multihost --coordinator <host0>:8476 \\
      --num-processes 4 --process-id $RANK --backend gloo \\
      [--mtx file.mtx] [--iters 100] \\
      [--impl routed|window|dia|xla|routed2d|bell|lane]

``--backend nccl`` runs one rank on each card of a host (ranks 0..n-1 of
a host on its cards 0..n-1); ``--backend gloo`` lets the ranks share a
card (four ranks on one H100), or run on the CPU of a host without one,
and moves x and y through host memory.  Each rank joins the
torch.distributed world (cvr_tpu_torch.parallel.initialize_distributed),
the mesh's shards are the world's ranks, the matrix is row-partitioned by
nnz across them (every rank packs every shard and uploads its own), and x
is all-gathered before the per-shard SpMV (cvr_tpu_torch.parallel.dist).
With no coordinator flags one process runs over every visible card
(make_mesh()).  The flags, defaults and the lead's report are those of
the JAX package's scripts/multihost_spmv.py, plus ``--backend``.
"""

from __future__ import annotations

import argparse
import socket
import sys
import time

import torch
import torch.distributed as dist

from cvr_tpu_torch.bench.harness import HBM_BW, detect_chip
from cvr_tpu_torch.bench.synthetic import rmat_matrix
from cvr_tpu_torch.io.mmio import read_matrix_market
from cvr_tpu_torch.ops import _build
from cvr_tpu_torch.parallel.dist import (
    dist_sell_pack,
    dist_spmv,
    initialize_distributed,
    make_mesh,
    shutdown_distributed,
)

IMPLS = ("routed", "window", "dia", "xla", "routed2d", "bell", "lane")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", default=None, help="host0:port")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--mtx", default=None)
    ap.add_argument("--scale", type=int, default=18,
                    help="rmat scale if no --mtx")
    ap.add_argument("--iters", type=int, default=100)
    # as in the JAX script: store_true with default True, so x always
    # enters row-sharded and is all-gathered
    ap.add_argument("--x-sharded", action="store_true", default=True)
    ap.add_argument(
        "--impl", default="routed", choices=IMPLS,
        help="per-shard kernel (routed = the flagship pipeline; routed2d = "
        "the 2D row x col mesh, see --mesh2d)",
    )
    ap.add_argument(
        "--mesh2d", default=None, metavar="RxC",
        help="2D mesh shape for --impl routed2d (e.g. 4x2); default "
        "R = D//2, C = 2",
    )
    ap.add_argument(
        "--backend", default="nccl", choices=("nccl", "gloo"),
        help="torch.distributed backend with --coordinator: nccl, one rank "
        "a card; gloo, ranks that share a card or run on the CPU",
    )
    return ap.parse_args(argv)


def load_kernels(lead: bool, barrier) -> None:
    """The kernel library, built once a host: the host's lead rank loads
    it (nvcc builds it at its first load) while the host's other ranks
    wait at ``barrier``, and they load it after."""
    if lead:
        _build.load()
    barrier()
    if not lead:
        _build.load()


def world_list(value) -> list:
    """``value`` of every rank, in rank order ([value] in one process)."""
    if not dist.is_initialized():
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def sharded_spmv(impl: str, csr, mesh, x_sharded: bool = True,
                 mesh2d: str | None = None):
    """(artifact, function of x) of ``impl`` packed on ``mesh`` (the 2-D
    mesh: ``mesh2d`` "RxC", by default R = D // 2, C = 2, on the mesh's
    world or cards)."""
    xs = x_sharded
    if impl == "routed2d":
        from cvr_tpu_torch.parallel.dist2d import (
            dist_routed_pack_2d,
            dist_spmv_routed_2d,
            make_mesh2d,
        )

        D = mesh.size
        if mesh2d:
            R, C = (int(v) for v in mesh2d.lower().split("x"))
        else:
            R, C = max(D // 2, 1), min(2, D)
        dm = dist_routed_pack_2d(csr, make_mesh2d(
            R, C, devices=None if mesh.group else list(mesh.devices)))
        return dm, lambda v: dist_spmv_routed_2d(dm, v)
    if impl == "bell":
        from cvr_tpu_torch.parallel.dist_bell import (
            dist_bell_pack,
            dist_spmv_bell,
        )

        dm = dist_bell_pack(csr, mesh)
        return dm, lambda v: dist_spmv_bell(dm, v, x_sharded=xs)
    if impl == "lane":
        from cvr_tpu_torch.parallel.dist_lane import (
            dist_lane_pack,
            dist_spmm_lane,
        )

        dm = dist_lane_pack(csr, mesh)
        return dm, lambda v: dist_spmm_lane(dm, v[:, None],
                                            x_sharded=xs)[:, 0]
    if impl == "routed":
        from cvr_tpu_torch.parallel.dist_routed import (
            dist_routed_pack,
            dist_spmv_routed,
        )

        dm = dist_routed_pack(csr, mesh)
        return dm, lambda v: dist_spmv_routed(dm, v, x_sharded=xs)
    if impl == "window":
        from cvr_tpu_torch.parallel.dist_window import (
            dist_spmv_window,
            dist_window_pack,
        )

        dm = dist_window_pack(csr, mesh)
        return dm, lambda v: dist_spmv_window(dm, v, x_sharded=xs)
    if impl == "dia":
        from cvr_tpu_torch.parallel.dist_dia import (
            dist_dia_pack,
            dist_spmv_dia,
        )

        dm = dist_dia_pack(csr, mesh)
        return dm, lambda v: dist_spmv_dia(dm, v, x_sharded=xs)
    dm = dist_sell_pack(csr, mesh)
    return dm, lambda v: dist_spmv(dm, v, x_sharded=xs)


def run(args) -> int:
    """The SpMV on the world's mesh (make_mesh()): pack, a warm call,
    ``iters`` timed calls; the lead prints the report."""
    ranks = dist.is_initialized()
    rank = dist.get_rank() if ranks else 0
    is_lead = rank == 0
    mesh = make_mesh()
    home = mesh.home
    host = socket.gethostname()
    hosts = world_list(host)
    if home.type == "cuda":
        load_kernels(hosts.index(host) == rank,
                     dist.barrier if ranks else lambda: None)
    if is_lead:
        print(f"processes={dist.get_world_size() if ranks else 1} "
              f"devices={mesh.size}")
        how = ("copies between the mesh's devices" if not ranks
               else dist.get_backend() + (" via host" if (
                   dist.get_backend() == "gloo" and home.type == "cuda")
                   else ""))
        print(f"exchange: {how}")

    if args.mtx:
        coo = read_matrix_market(args.mtx)
        name = args.mtx
    else:
        coo = rmat_matrix(scale=args.scale, edge_factor=6, seed=1)
        name = f"rmat{args.scale}"
    csr = coo.to_csr(sort_cols=False)

    t0 = time.perf_counter()
    dm, fn = sharded_spmv(args.impl, csr, mesh, args.x_sharded, args.mesh2d)
    preproc = time.perf_counter() - t0
    x = torch.ones(coo.shape[1], dtype=torch.float32, device=home)

    def wait():
        if home.type == "cuda":
            torch.cuda.synchronize(home)

    fn(x)  # warm
    wait()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        y = fn(x)
    wait()
    per = (time.perf_counter() - t0) / args.iters
    if y.shape != (coo.shape[0],):
        raise AssertionError(f"y of shape {tuple(y.shape)}")

    # the aggregate bandwidth counts the world's distinct cards: ranks
    # that share one card share its bandwidth
    mine = {(host, str(mesh.devices[i]), detect_chip(mesh.devices[i]))
            for i in mesh.local}
    bw = sum(HBM_BW[chip] for _, _, chip in set().union(*world_list(mine)))
    if is_lead:
        if args.impl == "routed2d":
            R, C = dm.mesh.shape
            label = f"{R}x{C}mesh"
        else:
            label = f"{mesh.size}chips"
        nnz = csr.nnz
        print(f"[file: {name}] [threads: {label}] "
              f"Pre-processing Time: {preproc * 1e3:.3f} ms")
        print(f"[file: {name}] [threads: {label}] "
              f"SpMV Execution Time: {per * 1e3:.6f} ms")
        print(f"[file: {name}] [threads: {label}] "
              f"Throughput: {2 * nnz / per / 1e9:.3f} GFlops (2*nnz), "
              f"{nnz / per / 1e9:.3f} Gnnz/s, "
              f"{100 * nnz * 8.0 / per / bw:.1f}% of aggregate HBM "
              f"roofline")
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.coordinator:
        if args.num_processes is None or args.process_id is None:
            raise SystemExit("multihost: --coordinator needs "
                             "--num-processes and --process-id")
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id, backend=args.backend)
    try:
        return run(args)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    sys.exit(main())
