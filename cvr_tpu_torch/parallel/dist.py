"""Row-sharded SpMV over a mesh of shard devices: one process, or one
process a shard.

The JAX package runs its distributed paths single-controller: one process
drives every device of a ``jax.sharding.Mesh``, and shard_map's
``all_gather`` and ``ppermute`` are tensor moves between those devices;
on several hosts each host runs the same program under
``jax.distributed.initialize`` and drives its own devices.  The port has
both.  A ``Mesh`` is a tuple of torch devices, one per row shard.  Made
with ``devices=`` (or before ``initialize_distributed``), one process
drives every shard and the collectives are explicit copies between the
devices (``all_gather``, ``RingPermute``, ``concat_rows``); a device may
appear more than once, so D shards can share one card, as the JAX tests
give JAX 8 virtual CPU devices.  Made after ``initialize_distributed``,
shard i is rank i of the ``torch.distributed`` world: each process packs
every shard (the unified geometry needs them all) and uploads and runs
only its own, and the collectives are ``torch.distributed`` calls.  Under
gloo with CUDA tensors (ranks that share a card) every move is staged
through pinned host buffers.

The matrix is row-partitioned with nnz balance (partition_rows_by_nnz),
each shard is packed on its own, and x is either replicated or
row-sharded and all-gathered before the per-shard SpMV.  Shards are cut at
row boundaries, so y needs no cross-shard reduction: each shard owns a
disjoint slice of y, and the slices are put back in row order on the
mesh's first device, or on every rank's device.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import socket
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.formats.sell import DEFAULT_C, SellMatrix, sell_pack
from cvr_tpu_torch.parallel.partition import (
    partition_balance,
    partition_rows_by_nnz,
)


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the row-shard axis: shard i runs on devices[i].

    ``group`` is None where one process drives every shard; after
    initialize_distributed it is the world's process group, shard i is
    rank i and ``rank`` is this process's shard."""

    devices: tuple[torch.device, ...]
    group: object = None
    rank: int | None = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> tuple[int, ...]:
        """The shards this process holds: every shard in one process, its
        own in a run of ranks."""
        return (tuple(range(self.size)) if self.group is None
                else (self.rank,))

    @property
    def home(self) -> torch.device:
        """Where y comes back whole: the mesh's first device, or this
        rank's."""
        return self.devices[0 if self.group is None else self.rank]


def on_shards(mesh, fn) -> list:
    """[fn(i) for each shard i this process holds, None for the others]."""
    own = set(mesh.local)
    return [fn(i) if i in own else None for i in range(mesh.size)]


def world_devices() -> list[torch.device]:
    """Every rank's device after initialize_distributed, in rank order:
    the card it made current, or the CPU on a host without one."""
    own = (torch.device("cuda", torch.cuda.current_device())
           if torch.cuda.is_available() else torch.device("cpu"))
    devs = [None] * dist.get_world_size()
    dist.all_gather_object(devs, str(own))
    return [torch.device(d) for d in devs]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh.  After initialize_distributed, the mesh of the world's
    ranks (shard i is rank i; ``n_devices``, if given, must be the world
    size).  Otherwise every visible CUDA device (the first ``n_devices``
    of them), and it raises where there is none.  ``devices`` lists the
    shards' devices of a mesh that one process drives, and may repeat
    one, so that D shards share it (``["cpu"] * 4`` runs four shards on
    the CPU)."""
    if devices is None and dist.is_available() and dist.is_initialized():
        D = dist.get_world_size()
        if n_devices not in (None, D):
            raise ValueError(f"make_mesh: {n_devices} shards in a world of "
                             f"{D} ranks")
        return Mesh(tuple(world_devices()), group=dist.group.WORLD,
                    rank=dist.get_rank())
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices= (e.g. ['cpu'] * 4) "
                "for a run on the CPU"
            )
        devices = [f"cuda:{k}" for k in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("make_mesh: no devices")
    if len({d.type for d in devs}) != 1:
        raise ValueError("make_mesh: a mesh holds devices of one type")
    return Mesh(devs)


def rank_device(backend: str, hosts, rank: int, n_cuda: int) -> torch.device:
    """The device of rank ``rank`` of a world whose rank k runs on host
    ``hosts[k]``, on a host with ``n_cuda`` cards; its index among its
    host's ranks picks the card.  nccl puts one rank on each card and
    raises where a host has no card or more ranks than cards (NCCL will
    not put two ranks of one communicator on one card); gloo lets ranks
    share a card (the index modulo ``n_cuda``) and runs on the CPU of a
    host without one."""
    local = list(hosts[:rank]).count(hosts[rank])
    if backend == "nccl":
        per_host = list(hosts).count(hosts[rank])
        if n_cuda == 0:
            raise ValueError("initialize_distributed: backend nccl needs a "
                             "CUDA device; use --backend gloo "
                             "(backend='gloo') for ranks on the CPU")
        if per_host > n_cuda:
            raise ValueError(
                f"initialize_distributed: {per_host} ranks on host "
                f"{hosts[rank]!r} with {n_cuda} card(s); nccl runs one rank "
                "a card, use --backend gloo (backend='gloo') for ranks that "
                "share a card")
        return torch.device("cuda", local)
    if backend == "gloo":
        return (torch.device("cuda", local % n_cuda) if n_cuda
                else torch.device("cpu"))
    raise ValueError(f"initialize_distributed: backend {backend!r}, not "
                     "'nccl' or 'gloo'")


def initialize_distributed(coordinator_address: str, num_processes: int,
                           process_id: int, backend: str = "nccl",
                           timeout: float = 300.0) -> torch.device:
    """Join the ``torch.distributed`` world of ``num_processes`` ranks as
    rank ``process_id`` (jax.distributed.initialize's names), rendezvous
    at ``coordinator_address`` ("host:port", rank 0 listens there), over
    ``backend``: "nccl", one card a rank, or "gloo", for ranks that share
    a card or run on the CPU.  The ranks first tell each other their
    hosts, so that each picks its device (rank_device) and a rank raises,
    rather than falling back to another backend or the CPU, where nccl
    cannot run.  Every wait (the rendezvous, each collective) gives up
    after ``timeout`` seconds, so a lost peer ends the run instead of
    hanging it.  Returns this rank's device, made current."""
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    # no card for nccl, or no such backend: raise before the rendezvous
    rank_device(backend, ["local"], 0, n_cuda)
    host, port = coordinator_address.rsplit(":", 1)
    wait = datetime.timedelta(seconds=timeout)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=wait)
    store.set(f"host/{process_id}", socket.gethostname())
    hosts = [store.get(f"host/{k}").decode() for k in range(num_processes)]
    device = rank_device(backend, hosts, process_id, n_cuda)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=wait)
    return device


def shutdown_distributed() -> None:
    """Leave the world initialize_distributed joined (no-op outside one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank of ``group``'s ``t`` (one shape on every rank), in rank
    order along dim 0: dist.all_gather (gloo; through pinned host buffers
    where ``t`` is a CUDA tensor) or all_gather_single (nccl; its older
    name all_gather_into_tensor)."""
    n = dist.get_world_size(group)
    shape = (n * t.shape[0], *t.shape[1:])
    if dist.get_backend(group) != "gloo":
        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        out = t.new_empty(shape)
        gather(out, t.contiguous(), group=group)
        return out
    staged = t.device.type == "cuda"
    src = t.contiguous()
    if staged:
        src = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        src.copy_(t)
    out = torch.empty(shape, dtype=t.dtype, pin_memory=staged)
    r = t.shape[0]
    dist.all_gather([out[i * r : (i + 1) * r] for i in range(n)], src,
                    group=group)
    return out.to(t.device, non_blocking=True) if staged else out


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, nprocs, port, timeout, args, results):
    torch.set_num_threads(1)  # the ranks share the host's cores
    initialize_distributed(f"127.0.0.1:{port}", nprocs, rank, "gloo",
                           timeout)
    try:
        results.put((rank, fn(rank, *args)))
    finally:
        shutdown_distributed()


def run_local_ranks(fn, nprocs: int, args=(),
                    timeout: float = 300.0) -> list:
    """Run ``fn(rank, *args)`` on ``nprocs`` gloo ranks of this host (they
    may share a card), each a process that torch.multiprocessing spawns
    (CPU tensors among ``args`` are shared, not copied), one torch thread
    each, in a world that initialize_distributed joins at 127.0.0.1 with
    ``timeout``.  ``fn`` must be importable (a module's top-level
    function).  Returns the ranks' return values in rank order; where a
    rank fails, stops the others and raises its error."""
    results = mp.get_context("spawn").SimpleQueue()
    procs = mp.spawn(_rank_main, args=(fn, nprocs, free_port(), timeout,
                                        args, results),
                     nprocs=nprocs, join=False)
    got = {}
    while len(got) < nprocs:
        if not results.empty():
            rank, value = results.get()
            got[rank] = value
        elif procs.join(timeout=0.1) and results.empty():
            raise RuntimeError(f"run_local_ranks: ranks "
                               f"{sorted(set(range(nprocs)) - set(got))} "
                               "ended without a result")
    while not procs.join():
        pass
    return [got[r] for r in range(nprocs)]


def shard_vector(x: torch.Tensor, mesh: Mesh, n_pad: int):
    """x (or the rows of X (n, K)) padded with zeros to ``n_pad`` rows (a
    multiple of the mesh size) and cut into equal pieces, piece i on shard
    i's device (None where this process does not hold shard i): the
    row-sharded input."""
    D = mesh.size
    x = F.pad(x, (0, 0) * (x.dim() - 1) + (0, n_pad - x.shape[0]))
    w = n_pad // D
    return on_shards(mesh, lambda i: x[i * w : (i + 1) * w].to(
        mesh.devices[i]))


def all_gather(pieces, mesh: Mesh, n: int):
    """The all-gather: each shard's device gets the pieces concatenated,
    cut to the first ``n`` entries (jax.lax.all_gather(..., tiled=True)
    [:n]); in a run of ranks, by gather_rows over the world."""
    if mesh.group is not None:
        return on_shards(mesh, lambda i: gather_rows(pieces[i],
                                                     mesh.group)[:n])
    return [torch.cat([p.to(d) for p in pieces])[:n] for d in mesh.devices]


class RingPermute:
    """The ring step's collective (jax.lax.ppermute over the pairs
    (j, (j+1) % D)): each shard's current piece moves to its neighbour.

    ``start`` issues the moves and returns the moved pieces; ``wait``
    orders the devices' current streams after them.  Two buffers per
    shard take the pieces in turn, so a move never writes a piece still
    being read.  In one process the moves are copies; on CUDA they run on
    a side stream of each device, so kernels enqueued between ``start``
    and ``wait`` on the current (compute) streams overlap the move, and
    on the CPU they run in order.  In a run of ranks each rank sends its
    piece to rank (i+1) % D and receives from rank (i-1) % D by
    dist.batch_isend_irecv (every rank posts the send first), which runs
    while the kernels enqueued before ``wait`` run; under gloo with CUDA
    tensors the piece goes out through a pinned host buffer and comes in
    through another."""

    def __init__(self, mesh: Mesh, shape, dtype=torch.float32):
        self.mesh = mesh
        self.devices = mesh.devices
        self.bufs = [
            on_shards(mesh, lambda i: torch.empty(shape, dtype=dtype,
                                                  device=self.devices[i]))
            for _ in range(2)
        ]
        self.turn = 0
        self.side = {}
        self.works, self.pending = [], None
        self.host = None
        if mesh.group is not None:
            if (dist.get_backend(mesh.group) == "gloo"
                    and self.devices[mesh.rank].type == "cuda"):
                # per turn: (send buffer, receive buffer, the event after
                # the receive buffer's last copy to the card)
                self.host = [[torch.empty(shape, dtype=dtype,
                                          pin_memory=True)
                              for _ in range(2)] + [None] for _ in range(2)]
        elif self.devices[0].type == "cuda":
            for d in dict.fromkeys(self.devices):
                self.side[d] = torch.cuda.Stream(device=d)

    def start(self, pieces):
        D = len(self.devices)
        out = self.bufs[self.turn]
        if self.mesh.group is not None:
            self._post(pieces[self.mesh.rank], out[self.mesh.rank])
            self.turn ^= 1
            return out
        self.turn ^= 1
        with contextlib.ExitStack() as stack:
            for d, s in self.side.items():
                # the pieces and the last reads of ``out`` come first
                s.wait_stream(torch.cuda.current_stream(d))
                stack.enter_context(torch.cuda.stream(s))
            for j in range(D):
                out[(j + 1) % D].copy_(pieces[j], non_blocking=True)
        return out

    def _post(self, piece, dst) -> None:
        r, D, g = self.mesh.rank, self.mesh.size, self.mesh.group
        src, into = piece, dst
        if self.host is not None:
            send, recv, done = self.host[self.turn]
            if done is not None:  # its last copy to the card has run
                done.synchronize()
            send.copy_(piece)
            src, into = send, recv
        self.works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, (r + 1) % D, g),
            dist.P2POp(dist.irecv, into, (r - 1) % D, g),
        ])
        self.pending = (into, dst, self.turn)

    def wait(self) -> None:
        if self.mesh.group is not None:
            for w in self.works:
                w.wait()
            into, dst, turn = self.pending
            if self.host is not None:
                dst.copy_(into, non_blocking=True)
                self.host[turn][2] = torch.cuda.Event()
                self.host[turn][2].record()
            return
        for d, s in self.side.items():
            torch.cuda.current_stream(d).wait_stream(s)


def concat_rows(mesh: Mesh, ys, bounds) -> torch.Tensor:
    """The shards' outputs, each cut to its own rows (``bounds``: the
    shards' row bounds; None for a shard this process does not hold), in
    row order on the mesh's home device.  In a run of ranks each rank's
    rows are padded to the largest shard's row count, all-gathered and
    cut by ``bounds``, so that y comes back whole on every rank."""
    if mesh.group is None:
        return torch.cat([y.to(mesh.home) for y in ys])
    rows = np.diff(np.asarray(bounds, dtype=np.int64))
    m = int(rows.max())
    y = ys[mesh.rank]
    y = F.pad(y, (0, 0) * (y.dim() - 1) + (0, m - y.shape[0]))
    g = gather_rows(y, mesh.group)
    return torch.cat([g[i * m : i * m + int(n)] for i, n in enumerate(rows)])


def local_csrs(csr: CSRMatrix, bounds: np.ndarray) -> list[CSRMatrix]:
    """Each shard's rows as a CSR of its own (rows renumbered from 0)."""
    out = []
    for i in range(bounds.shape[0] - 1):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        out.append(CSRMatrix(
            rowptr=csr.rowptr[lo : hi + 1] - csr.rowptr[lo],
            cols=csr.cols[csr.rowptr[lo] : csr.rowptr[hi]],
            vals=csr.vals[csr.rowptr[lo] : csr.rowptr[hi]],
            shape=(hi - lo, csr.shape[1]),
        ))
    return out


@dataclass
class DistSellMatrix:
    """Row-sharded SELL planes, each shard's on its mesh device."""

    planes: tuple[dict | None, ...]  # per shard held: name -> tensor
    bounds: np.ndarray  # [D + 1] global row bounds
    shape: tuple[int, int]
    nnz: int
    C: int
    mesh: Mesh
    local_rows_max: int
    nslices_max: int
    balance: dict | None = None  # partition_balance diagnostics

    @property
    def n_shards(self) -> int:
        return int(self.bounds.shape[0] - 1)


def _pad_to(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    return a if a.shape[0] == n else np.pad(
        a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1),
        constant_values=fill,
    )


def dist_sell_pack(
    csr: CSRMatrix,
    mesh: Mesh,
    C: int = DEFAULT_C,
    sigma: int = 0,
    split_len: int | None = None,
) -> DistSellMatrix:
    """Partition rows by nnz, SELL-pack each shard on its own and put its
    planes on its device (in a run of ranks, this rank's only), padded to
    the largest shard's extent as the JAX package stacks them."""
    D = mesh.size
    bounds = partition_rows_by_nnz(csr.rowptr, D)
    shards: list[SellMatrix] = [
        sell_pack(lc, C=C, sigma=sigma, split_len=split_len)
        for lc in local_csrs(csr, bounds)
    ]
    S_max = max(s.n_slots for s in shards)
    nsl_max = max(s.nslices for s in shards)
    rows_max = max(int(b) for b in (bounds[1:] - bounds[:-1]))

    def upload(i):
        s = shards[i]
        pl = {
            "vals_plane": _pad_to(s.vals_plane, S_max),
            "cols_plane": _pad_to(s.cols_plane, S_max),
            # padding slots keep their slice id monotone: the last one
            "slot_slice": _pad_to(s.slot_slice, S_max,
                                  fill=max(s.nslices - 1, 0)),
            # local row per position; sentinel rows_max (absorbed)
            "perm": _pad_to(
                np.where(s.perm >= s.shape[0], rows_max, s.perm).astype(
                    np.int32),
                nsl_max * C, fill=rows_max,
            ),
        }
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            mesh.devices[i]) for k, v in pl.items()}

    return DistSellMatrix(
        planes=tuple(on_shards(mesh, upload)),
        bounds=bounds,
        shape=csr.shape,
        nnz=csr.nnz,
        C=C,
        mesh=mesh,
        local_rows_max=rows_max,
        nslices_max=nsl_max,
        balance=partition_balance(csr.rowptr, bounds),
    )


def _local_spmv(pl: dict, x_full: torch.Tensor, nslices: int,
                local_rows: int) -> torch.Tensor:
    """One shard's SELL SpMV: the gather, the per-slice sums and the
    unpermute, as plain torch ops."""
    contrib = pl["vals_plane"] * x_full[pl["cols_plane"].long()]
    y_sorted = torch.zeros((nslices, contrib.shape[1]), dtype=contrib.dtype,
                           device=contrib.device)
    y_sorted.index_add_(0, pl["slot_slice"].long(), contrib)
    y_local = torch.zeros(local_rows + 1, dtype=contrib.dtype,
                          device=contrib.device)
    y_local.index_add_(0, pl["perm"].long(), y_sorted.reshape(-1))
    return y_local[:local_rows]


def replicate_or_gather(x: torch.Tensor, mesh: Mesh, n: int,
                        x_sharded: bool):
    """x (or X (n, K)) on the device of every shard this process holds
    (None for the others): replicated (x_sharded False), or cut into row
    pieces (padded to a multiple of the mesh size) and all-gathered."""
    if not x_sharded:
        return on_shards(mesh, lambda i: x.to(mesh.devices[i]))
    n_pad = -(-n // mesh.size) * mesh.size
    return all_gather(shard_vector(x, mesh, n_pad), mesh, n)


def dist_spmv(dm: DistSellMatrix, x: torch.Tensor,
              x_sharded: bool = False) -> torch.Tensor:
    """y = A @ x across the mesh; y whole on the mesh's home device.

    x_sharded=False: x is replicated, no collective.  x_sharded=True: x
    enters row-sharded and is all-gathered before the per-shard SpMV.
    """
    xs = replicate_or_gather(x, dm.mesh, dm.shape[1], x_sharded)
    rows = np.diff(dm.bounds)
    return concat_rows(dm.mesh, on_shards(dm.mesh, lambda i: _local_spmv(
        dm.planes[i], xs[i], dm.nslices_max, dm.local_rows_max)[:rows[i]]),
        dm.bounds)


def dist_spmv_jit(dm: DistSellMatrix, x_sharded: bool = False):
    """A closure over the matrix for iteration-heavy callers (the JAX
    package jits it; torch runs eagerly)."""
    return functools.partial(dist_spmv, dm, x_sharded=x_sharded)
