"""Row-sharded SpMV over a mesh of shard devices, driven by one process.

The JAX package runs its distributed paths single-controller: one process
drives every device of a ``jax.sharding.Mesh``, and shard_map's
``all_gather`` and ``ppermute`` are tensor moves between those devices.
The port keeps that model.  A ``Mesh`` is a tuple of torch devices, one
per row shard, and the collectives are explicit copies between them
(``all_gather``, ``RingPermute``).  A device may appear more than once,
so D shards can share one card, as the JAX tests give JAX 8 virtual CPU
devices; the "transfers" are then copies inside that device.
Multi-process runs (``torch.distributed``) and multi-host runs are not
ported yet (``initialize_distributed``).

The matrix is row-partitioned with nnz balance (partition_rows_by_nnz),
each shard is packed on its own, and x is either replicated or
row-sharded and all-gathered before the per-shard SpMV.  Shards are cut at
row boundaries, so y needs no cross-shard reduction: each shard owns a
disjoint slice of y, and the slices are put back in row order on the
mesh's first device.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.formats.sell import DEFAULT_C, SellMatrix, sell_pack
from cvr_tpu_torch.parallel.partition import (
    partition_balance,
    partition_rows_by_nnz,
)


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the row-shard axis: shard i runs on devices[i]."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh.  By default every visible CUDA device (the first
    ``n_devices`` of them); raises where there is none.  ``devices`` lists
    the shards' devices instead and may repeat one, so that D shards
    share it (``["cpu"] * 4`` runs four shards on the CPU)."""
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


def initialize_distributed(**kwargs) -> None:
    """Multi-process and multi-host entry: not ported yet."""
    raise NotImplementedError(
        "multi-process and multi-host runs (torch.distributed, "
        "--coordinator) are not ported yet: ROADMAP slice F, item "
        "'multi-process torch.distributed'"
    )


def shard_vector(x: torch.Tensor, mesh: Mesh, n_pad: int):
    """x padded with zeros to ``n_pad`` entries (a multiple of the mesh
    size) and cut into equal pieces, piece i on shard i's device: the
    row-sharded input."""
    D = mesh.size
    x = F.pad(x, (0, n_pad - x.shape[0]))
    w = n_pad // D
    return [x[i * w : (i + 1) * w].to(d) for i, d in enumerate(mesh.devices)]


def all_gather(pieces, mesh: Mesh, n: int):
    """The all-gather: each shard's device gets the pieces concatenated,
    cut to the first ``n`` entries (jax.lax.all_gather(..., tiled=True)
    [:n])."""
    return [torch.cat([p.to(d) for p in pieces])[:n] for d in mesh.devices]


class RingPermute:
    """The ring step's collective (jax.lax.ppermute over the pairs
    (j, (j+1) % D)): each shard's current piece is copied to its
    neighbour's device.

    ``start`` issues the copies and returns the moved pieces; ``wait``
    orders the devices' current streams after them.  On CUDA the copies
    run on a side stream of each device, so kernels enqueued between
    ``start`` and ``wait`` on the current (compute) streams overlap the
    move; on the CPU they run in order.  Two buffers per shard take the
    pieces in turn, so a copy never writes a piece still being read."""

    def __init__(self, mesh: Mesh, shape, dtype=torch.float32):
        self.devices = mesh.devices
        self.bufs = [
            [torch.empty(shape, dtype=dtype, device=d) for d in self.devices]
            for _ in range(2)
        ]
        self.turn = 0
        self.side = {}
        if self.devices[0].type == "cuda":
            for d in dict.fromkeys(self.devices):
                self.side[d] = torch.cuda.Stream(device=d)

    def start(self, pieces):
        D = len(self.devices)
        out = self.bufs[self.turn]
        self.turn ^= 1
        with contextlib.ExitStack() as stack:
            for d, s in self.side.items():
                # the pieces and the last reads of ``out`` come first
                s.wait_stream(torch.cuda.current_stream(d))
                stack.enter_context(torch.cuda.stream(s))
            for j in range(D):
                out[(j + 1) % D].copy_(pieces[j], non_blocking=True)
        return out

    def wait(self) -> None:
        for d, s in self.side.items():
            torch.cuda.current_stream(d).wait_stream(s)


def unshard(mesh: Mesh, ys, unpad_index: torch.Tensor) -> torch.Tensor:
    """The shards' y slices (each padded to the same length) in row
    order on the mesh's first device."""
    dev = mesh.devices[0]
    return torch.stack([y.to(dev) for y in ys]).reshape(-1)[unpad_index]


def unpad_index(bounds: np.ndarray, rows_max: int,
                device) -> torch.Tensor:
    """[nrows] -> position of each row in the stacked (D, rows_max)
    per-shard y: global row r lives in shard d at local index
    r - bounds[d]."""
    D = bounds.shape[0] - 1
    nrows = int(bounds[-1])
    row_ids = np.arange(nrows, dtype=np.int64)
    shard_of_row = (
        np.searchsorted(bounds, row_ids, side="right").astype(np.int64) - 1
    )
    if D * rows_max >= 2**31:
        raise ValueError(
            "stacked local-y index exceeds int32 range "
            f"({D} shards x {rows_max} padded rows)"
        )
    unpad = shard_of_row * rows_max + (row_ids - bounds[shard_of_row])
    return torch.from_numpy(unpad).to(device)


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

    planes: tuple[dict, ...]  # per shard: name -> tensor
    bounds: np.ndarray  # [D + 1] global row bounds
    unpad_index: torch.Tensor  # [nrows] -> position in stacked local y
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
    planes on its device, padded to the largest shard's extent as the
    JAX package stacks them."""
    D = mesh.size
    bounds = partition_rows_by_nnz(csr.rowptr, D)
    shards: list[SellMatrix] = [
        sell_pack(lc, C=C, sigma=sigma, split_len=split_len)
        for lc in local_csrs(csr, bounds)
    ]
    S_max = max(s.n_slots for s in shards)
    nsl_max = max(s.nslices for s in shards)
    rows_max = max(int(b) for b in (bounds[1:] - bounds[:-1]))
    planes = []
    for s, dev in zip(shards, mesh.devices):
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
        planes.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                       for k, v in pl.items()})
    return DistSellMatrix(
        planes=tuple(planes),
        bounds=bounds,
        unpad_index=unpad_index(bounds, rows_max, mesh.devices[0]),
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
    """x on every shard's device: replicated (x_sharded False), or cut
    into row pieces (padded to a multiple of the mesh size) and
    all-gathered."""
    if not x_sharded:
        return [x.to(d) for d in mesh.devices]
    n_pad = -(-n // mesh.size) * mesh.size
    return all_gather(shard_vector(x, mesh, n_pad), mesh, n)


def dist_spmv(dm: DistSellMatrix, x: torch.Tensor,
              x_sharded: bool = False) -> torch.Tensor:
    """y = A @ x across the mesh.

    x_sharded=False: x is replicated, no collective.  x_sharded=True: x
    enters row-sharded and is all-gathered before the per-shard SpMV.
    """
    xs = replicate_or_gather(x, dm.mesh, dm.shape[1], x_sharded)
    ys = [_local_spmv(pl, xi, dm.nslices_max, dm.local_rows_max)
          for pl, xi in zip(dm.planes, xs)]
    return unshard(dm.mesh, ys, dm.unpad_index)


def dist_spmv_jit(dm: DistSellMatrix, x_sharded: bool = False):
    """A closure over the matrix for iteration-heavy callers (the JAX
    package jits it; torch runs eagerly)."""
    return functools.partial(dist_spmv, dm, x_sharded=x_sharded)
