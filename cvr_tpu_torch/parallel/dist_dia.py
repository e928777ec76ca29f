"""The row-sharded DIA SpMV: equal row ranges of one DIA pack, K8 per shard.

DIA work is the same for every row, so the shards are equal row ranges
(``rows_max = ceil(nrows / D)``), not nnz-balanced.  One global
``dia_pack``; each shard's band planes are its rows of the global ones.
x is replicated, or row-sharded and all-gathered; each shard runs the
port's single-card DIA SpMV (K8 ``dia_spmv``) on its own device, and the
shards' y slices are put back in row order on the mesh's first device.

Shard d's row r reads x[r0 + r + off] for its first global row r0, with
real x entries left of r0 on every shard after the first, while K8 reads
x[r + off] and takes x as 0 outside it.  So each shard's bands are
uploaded with ``pre = min(r0, -min(offsets))`` zero rows in front and K8
is given the view x[r0 - pre:] of x (no copy): its row pre + r then reads
x[r0 + r + off] exactly, 0 only outside [0, ncols).  The ``pre`` rows it
computes are dropped.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.formats.dia import dia_pack
from cvr_tpu_torch.ops.spmv_dia import DiaDevice, spmv_dia
from cvr_tpu_torch.parallel.dist import (
    Mesh,
    concat_rows,
    on_shards,
    replicate_or_gather,
)


@dataclass
class DistDiaMatrix:
    """Row-sharded band planes, each shard's on its mesh device."""

    shards: tuple[DiaDevice | None, ...]  # held: bands (nd, pre + rows_max)
    pre: tuple[int, ...]  # zero rows in front of each shard's bands
    offsets: tuple  # the diagonals, shared by all shards
    bounds: np.ndarray  # [D + 1] row bounds (equal split)
    shape: tuple[int, int]
    nnz: int
    mesh: Mesh
    rows_max: int

    @property
    def n_shards(self) -> int:
        return int(self.bounds.shape[0] - 1)

    def bands(self, d: int) -> torch.Tensor:
        """Shard d's band planes (nd, rows_max), as the JAX package stacks
        them (a shard this process holds)."""
        return self.shards[d].bands[:, self.pre[d]:]


def _assemble(bands, offsets, nrows, shape, nnz, mesh: Mesh):
    """Upload each shard's (nd, rows_max) bands to its device (the shards
    this process holds) with its ``pre`` zero rows in front."""
    D = mesh.size
    if bands.shape[0] != D:
        raise ValueError(f"{bands.shape[0]} shards on a mesh of {D} devices")
    rows_max = int(bands.shape[2])
    bounds = np.minimum(np.arange(D + 1, dtype=np.int64) * rows_max, nrows)
    offs = np.asarray(offsets, dtype=np.int64)
    base = max(-int(offs.min(initial=0)), 0)
    pre = [min(int(b), base) for b in bounds[:-1]]

    def upload(d):
        b = np.zeros((offs.shape[0], pre[d] + rows_max), dtype=np.float32)
        b[:, pre[d]:] = bands[d]
        dev = mesh.devices[d]
        return DiaDevice(bands=torch.from_numpy(b).to(dev),
                         offsets=torch.from_numpy(offs.copy()).to(dev),
                         shape=(pre[d] + rows_max, int(shape[1])), nnz=nnz)

    shards = on_shards(mesh, upload)
    return DistDiaMatrix(
        shards=tuple(shards), pre=tuple(pre),
        offsets=tuple(int(o) for o in offs), bounds=bounds,
        shape=tuple(shape), nnz=int(nnz), mesh=mesh, rows_max=rows_max,
    )


def dist_dia_pack(csr: CSRMatrix, mesh: Mesh, **pack_kw) -> DistDiaMatrix:
    """One dia_pack (``pack_kw`` its gate), its band planes cut into equal
    row ranges, each shard's uploaded to its device."""
    dm = dia_pack(csr, **pack_kw)
    D = mesh.size
    nrows = csr.shape[0]
    rows_max = -(-nrows // D)
    bands = np.zeros((D, dm.nd, rows_max), dtype=np.float32)
    for d in range(D):
        lo, hi = min(d * rows_max, nrows), min((d + 1) * rows_max, nrows)
        bands[d, :, : hi - lo] = dm.bands[:, lo:hi]
    return _assemble(bands, dm.offsets, nrows, csr.shape, csr.nnz, mesh)


def from_reference(jdm, mesh: Mesh) -> DistDiaMatrix:
    """The port's artifact from the JAX package's ``DistDiaMatrix``: its
    stacked bands (read as a numpy array; nothing of the JAX package is
    imported), offsets and shape, uploaded shard by shard to ``mesh``."""
    return _assemble(np.asarray(jdm.bands), jdm.offsets, jdm.shape[0],
                     jdm.shape, jdm.nnz, mesh)


def dist_spmv_dia(dm: DistDiaMatrix, x: torch.Tensor,
                  x_sharded: bool = False) -> torch.Tensor:
    """y = A @ x across the mesh, K8 on each shard; y whole on the mesh's
    home device.  x_sharded=True all-gathers a row-sharded x (padded to a
    multiple of the mesh size) first."""
    xs = replicate_or_gather(x.to(torch.float32), dm.mesh, dm.shape[1],
                             x_sharded)

    def shard(d):
        p, lo, hi = dm.pre[d], int(dm.bounds[d]), int(dm.bounds[d + 1])
        return spmv_dia(dm.shards[d], xs[d][lo - p:])[p : p + hi - lo]

    return concat_rows(dm.mesh, on_shards(dm.mesh, shard), dm.bounds)


def dist_spmv_dia_jit(dm: DistDiaMatrix, x_sharded: bool = False):
    """A closure over the matrix for iteration-heavy callers (the JAX
    package jits it; torch runs eagerly)."""
    return functools.partial(dist_spmv_dia, dm, x_sharded=x_sharded)
