"""The row-sharded BSR-128 SpMM: one brick pack cut at row-block bounds,
K12 per shard.

One global ``bsr_pack``; its brick stream (sorted by row block) is cut
into D near-equal brick counts, each cut snapped down to a row-block
bound, so that no row block is shared and Y needs no cross-shard sum.
The JAX package pads every shard to the largest shard's brick count with
zero bricks in the shard's last row block, for its one shard_map program;
the port uploads each shard's own bricks and row blocks only.  X is
replicated, or row-sharded and all-gathered; each shard runs K12
``bsr_spmm`` on its own device over its own row blocks, and the shards'
Y rows are put back in row order on the mesh's first device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.formats.bsr import B, bsr_pack
from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.ops.spmm_bsr import BsrDevice, spmm_bsr_fused
from cvr_tpu_torch.parallel.dist import (
    Mesh,
    concat_rows,
    on_shards,
    replicate_or_gather,
)


@dataclass
class DistBsrMatrix:
    """Brick planes of each row-block range, each shard's on its device."""

    shards: tuple[BsrDevice | None, ...]  # held: own row blocks, bricks
    rb_bounds: np.ndarray  # [D + 1] global row-block bounds
    shape: tuple[int, int]
    nnz: int
    mesh: Mesh
    nrb_local_max: int
    ncb: int

    @property
    def n_shards(self) -> int:
        return int(self.rb_bounds.shape[0] - 1)


def _real_bricks(vals: np.ndarray, brow: np.ndarray, nrb: int) -> int:
    """One shard's brick count without its padding: the trailing zero
    bricks of its last row block (they add nothing)."""
    k = vals.shape[0]
    while k and brow[k - 1] == max(nrb - 1, 0) and not vals[k - 1].any():
        k -= 1
    return k


def _assemble(vals, brow, bcol, rb_bounds, shape, nnz, mesh: Mesh):
    """Upload each shard's own bricks (local row blocks; the padding to
    the largest shard's count stays on the host) and its row blocks'
    brick ranges to its device, for the shards this process holds; K12
    computes the shard's own rows."""
    D = mesh.size
    if vals.shape[0] != D:
        raise ValueError(f"{vals.shape[0]} shards on a mesh of {D} devices")
    rb_bounds = np.asarray(rb_bounds, dtype=np.int64)
    nrb_local = np.diff(rb_bounds)
    nrows, ncols = (int(v) for v in shape)
    row_bounds = np.minimum(rb_bounds * B, nrows)

    def upload(d):
        dev = mesh.devices[d]
        nrb = int(nrb_local[d])
        k = _real_bricks(vals[d], brow[d], nrb)
        row_start = np.searchsorted(brow[d][:k], np.arange(nrb + 1))

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
                dev)

        return BsrDevice(
            vals=put(vals[d][:k], np.float32),
            brick_row=put(brow[d][:k], np.int32),
            brick_col=put(bcol[d][:k], np.int32),
            row_start=put(row_start, np.int64),
            shape=(int(row_bounds[d + 1] - row_bounds[d]), ncols), nnz=nnz,
            nrb=nrb, ncb=-(-ncols // B))

    return DistBsrMatrix(
        shards=tuple(on_shards(mesh, upload)), rb_bounds=rb_bounds,
        shape=(nrows, ncols),
        nnz=int(nnz), mesh=mesh,
        nrb_local_max=max(1, int(nrb_local.max())), ncb=-(-ncols // B),
    )


def dist_bsr_pack(csr: CSRMatrix, mesh: Mesh, **pack_kw) -> DistBsrMatrix:
    """Pack once (``pack_kw``: bsr_pack's gate), then cut the brick stream
    at row-block bounds into near-equal brick counts, as the JAX package
    cuts it."""
    bm = bsr_pack(csr, **pack_kw)
    D = mesh.size
    nb = bm.nbricks
    nrb = -(-csr.shape[0] // B)
    # equal-brick split points, snapped down to row-block bounds (bricks
    # are sorted by row block, so a row-block range is a slice)
    targets = (np.arange(1, D) * nb) // D
    cut_rb = (bm.brick_row[np.minimum(targets, max(nb - 1, 0))] if nb
              else np.zeros(D - 1, dtype=np.int32))
    rb_bounds = np.concatenate(
        ([0], np.maximum.accumulate(cut_rb.astype(np.int64)), [nrb]))
    idx = np.searchsorted(bm.brick_row, rb_bounds, side="left")
    nb_max = max(1, int(np.max(idx[1:] - idx[:-1])))
    nrb_local = rb_bounds[1:] - rb_bounds[:-1]
    vals = np.zeros((D, nb_max, B, B), dtype=np.float32)
    brow = np.zeros((D, nb_max), dtype=np.int32)
    bcol = np.zeros((D, nb_max), dtype=np.int32)
    for d in range(D):
        lo, hi = int(idx[d]), int(idx[d + 1])
        k = hi - lo
        vals[d, :k] = bm.vals[lo:hi]
        brow[d, :k] = bm.brick_row[lo:hi] - rb_bounds[d]
        # padding bricks: zeros in the shard's last row block (the row
        # blocks stay sorted; they add nothing)
        brow[d, k:] = max(int(nrb_local[d]) - 1, 0)
        bcol[d, :k] = bm.brick_col[lo:hi]
    return _assemble(vals, brow, bcol, rb_bounds, csr.shape, csr.nnz, mesh)


def from_reference(jdm, mesh: Mesh) -> DistBsrMatrix:
    """The port's artifact from the JAX package's ``DistBsrMatrix``: its
    stacked bricks and brick coordinates (read as numpy arrays; nothing of
    the JAX package is imported), row-block bounds and shape, uploaded
    shard by shard to ``mesh``."""
    return _assemble(np.array(jdm.vals), np.array(jdm.brick_row),
                     np.array(jdm.brick_col), jdm.rb_bounds, jdm.shape,
                     jdm.nnz, mesh)


def dist_spmm_bsr(dm: DistBsrMatrix, X: torch.Tensor,
                  x_sharded: bool = False, precision=None) -> torch.Tensor:
    """Y = A @ X across the mesh, K12 on each shard; Y whole on the mesh's
    home device.  X (ncols, K) is replicated, or row-sharded and all-gathered
    (x_sharded=True).  ``precision`` is accepted for the JAX package's
    signature: K12 always computes at float32 grade (3xTF32), its
    Precision.HIGHEST."""
    Xs = replicate_or_gather(X.to(torch.float32), dm.mesh, dm.shape[1],
                             x_sharded)
    bounds = np.minimum(dm.rb_bounds * B, dm.shape[0])
    return concat_rows(dm.mesh, on_shards(dm.mesh, lambda i: spmm_bsr_fused(
        dm.shards[i], Xs[i])), bounds)


def dist_spmm_bsr_jit(dm: DistBsrMatrix, x_sharded: bool = False):
    """A closure over the matrix for iteration-heavy callers (the JAX
    package jits it; torch runs eagerly)."""
    return functools.partial(dist_spmm_bsr, dm, x_sharded=x_sharded)
