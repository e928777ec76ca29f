"""The row-sharded PMM SpMM: K14 on each nnz-balanced row shard.

Rows are partitioned by nnz balance and each shard plans its own rows
against the global columns (``pmm_plan`` of the shard's local rows, as
the JAX package plans them).  X is replicated, or row-sharded and
all-gathered; each shard runs the port's single-card PMM SpMM (K14
``pmm_spmm`` over the plan's entries in row order and the work plan made
at upload), and the shards' Y rows are put back in row order on the
mesh's first device.  K > 128 is refused, as the JAX package refuses it.

The JAX package pads every shard's pair and chunk streams to one
geometry of its TPU kernel's segments (``SEG`` pairs each) for its one
shard_map program, and its ``DistPmmMatrix`` keeps only those segment
planes (win, rt, ch, li, lc, val, rl), not the plans.  K14 reads its own
entry layout, which the upload derives from a plan, so the carry-across
(``from_reference``) goes shard by shard from the JAX ``pmm_plan`` of
each shard's rows, through ``spmm_pmm.from_reference``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from cvr_tpu_torch.formats.csr import CSRMatrix
from cvr_tpu_torch.ops import spmm_pmm
from cvr_tpu_torch.ops.spmm_pmm import PmmDevice, PmmPlan, pmm_plan
from cvr_tpu_torch.parallel.dist import (
    Mesh,
    concat_rows,
    on_shards,
    replicate_or_gather,
)
from cvr_tpu_torch.parallel.partition import (
    partition_balance,
    partition_rows_by_nnz,
)

SEG = 32768  # pairs per segment of the JAX package's TPU kernel


def tpu_segments(plan: PmmPlan) -> int:
    """How many segments the JAX package's TPU kernel cuts the plan's pair
    stream into (at most SEG pairs each, cut at chunk bounds): its calls
    per SpMM of the shard.  K14 does not run them; the count is the
    geometry's, for comparison."""
    cuts = [0]
    while cuts[-1] + SEG < plan.npairs:
        q = cuts[-1] + SEG
        while plan.ch[q] == plan.ch[q - 1]:
            q -= 1
        cuts.append(q)
    return len(cuts)


@dataclass
class DistPmmMatrix:
    """Row-sharded PMM plans, each shard's entries on its device."""

    plans: tuple[PmmPlan, ...]  # per shard, its local rows
    shards: tuple[PmmDevice | None, ...]  # the held ones
    meta: dict  # nseg: the most segments the JAX kernel runs on a shard
    bounds: np.ndarray
    shape: tuple[int, int]
    nnz: int
    mesh: Mesh
    rows_max: int
    c_mean: float  # the worst shard's fan-in (the gate's input)
    balance: dict | None = None

    @property
    def n_shards(self) -> int:
        return int(self.bounds.shape[0] - 1)


def shard_plans(csr: CSRMatrix, bounds: np.ndarray, plan=pmm_plan) -> list:
    """``plan`` (this package's pmm_plan, or the JAX package's) of each
    shard's local rows against the global columns, as the JAX package's
    dist_pmm_pack builds them."""
    out = []
    for i in range(bounds.shape[0] - 1):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        s, e = int(csr.rowptr[lo]), int(csr.rowptr[hi])
        rows_l = np.repeat(np.arange(hi - lo, dtype=np.int64),
                           np.diff(csr.rowptr[lo : hi + 1]).astype(np.int64))
        out.append(plan(rows_l, csr.cols[s:e], csr.vals[s:e],
                        (max(hi - lo, 1), csr.shape[1])))
    return out


def _assemble(plans, bounds, shape, nnz, mesh: Mesh,
              balance) -> DistPmmMatrix:
    D = mesh.size
    if len(plans) != D:
        raise ValueError(f"{len(plans)} shards on a mesh of {D} devices")
    bounds = np.asarray(bounds, dtype=np.int64)
    rows_max = max(int(b) for b in np.diff(bounds))
    shards = tuple(on_shards(mesh, lambda i: spmm_pmm.to_device_pmm(
        plans[i], mesh.devices[i])))
    meta = {"nseg": max(tpu_segments(p) for p in plans)}
    return DistPmmMatrix(
        plans=tuple(plans), shards=shards, meta=meta, bounds=bounds,
        shape=tuple(shape), nnz=int(nnz), mesh=mesh, rows_max=rows_max,
        c_mean=max(p.c_mean for p in plans), balance=balance,
    )


def dist_pmm_pack(csr: CSRMatrix, mesh: Mesh) -> DistPmmMatrix:
    """Partition rows by nnz, PMM-plan each shard's rows and upload each
    plan's entries and K14's work plan to the shard's device."""
    bounds = partition_rows_by_nnz(csr.rowptr, mesh.size)
    return _assemble(shard_plans(csr, bounds), bounds, csr.shape, csr.nnz,
                     mesh, partition_balance(csr.rowptr, bounds))


def from_reference(jdm, mesh: Mesh, jplans) -> DistPmmMatrix:
    """The port's artifact from the JAX package's ``DistPmmMatrix`` (its
    bounds, shape, nnz and balance) and the JAX ``pmm_plan`` of each of
    its shards' rows (``shard_plans(csr, jdm.bounds, jax_pmm_plan)``; read
    as numpy arrays, nothing of the JAX package is imported): the
    ``DistPmmMatrix`` keeps only its TPU kernel's segment planes."""
    plans = [spmm_pmm.from_reference(p) for p in jplans]
    return _assemble(plans, jdm.bounds, jdm.shape, jdm.nnz, mesh,
                     jdm.balance)


def dist_spmm_pmm(dm: DistPmmMatrix, X: torch.Tensor,
                  x_sharded: bool = False) -> torch.Tensor:
    """Y = A @ X across the mesh, K14 on each shard; Y whole on the mesh's
    home device.  X (ncols, K <= 128) is replicated, or row-sharded and
    all-gathered (x_sharded=True)."""
    if X.shape[1] > 128:
        raise NotImplementedError(
            "dist PMM covers the small-K mandate (K <= 128); wider K "
            "runs 128-lane chunks through repeated calls"
        )
    Xs = replicate_or_gather(X.to(torch.float32), dm.mesh, dm.shape[1],
                             x_sharded)
    rows = np.diff(dm.bounds)  # a plan of an empty shard has one row
    return concat_rows(dm.mesh, on_shards(dm.mesh, lambda i: (
        spmm_pmm.spmm_pmm(dm.shards[i], Xs[i])[:rows[i]])), dm.bounds)


def dist_spmm_pmm_jit(dm: DistPmmMatrix, x_sharded: bool = False):
    """A closure over the matrix for iteration-heavy callers (the JAX
    package jits it; torch runs eagerly)."""
    return functools.partial(dist_spmm_pmm, dm, x_sharded=x_sharded)
