"""Communication volume and a weak-scaling projection of the row-sharded
SpMV (host numpy only).

A per-iteration byte account (what each shard streams from device memory
and what it receives from the other shards) and a projection of
weak-scaling efficiency for the blocking all-gather path and the ring
path (cvr_tpu_torch/parallel/dist_routed.py, ``overlap=True``), as the
JAX package's ``cvr_tpu.parallel.comm_model`` computes them.

Model (1-D row sharding, x_sharded=True; weak scaling: every device holds
one copy of the benchmark matrix, so the problem and the gathered x grow
D-fold):

  t_comp          the single-device SpMV time, the same on every device;
  gather bytes    (D - 1) * ncols * 4 received per device per iteration;
  t_comm(D)       gather bytes / (links * link_bw);
  blocking        T(D) = t_comp + t_comm(D);
  overlap         T(D) = max(f_exp * t_comp, t_comm(D))
                         + (1 - f_exp) * t_comp,
                  f_exp the expand pass's share of the SpMV (the ring hides
                  the move behind the expand blocks whose pieces arrived);
  E(D)            t_comp / T(D).

The 2-D mesh (cvr_tpu_torch/parallel/dist2d.py) gathers x only over its
row axis and reduce-scatters y over its column axis, so its volume per
device stays about constant in D for R ~ C ~ sqrt(D).

The link bandwidth (bytes/s per link and direction) and the number of
links a device moves x over are parameters with no default: they belong
to the interconnect the caller projects for (the JAX package's defaults,
45e9 and 2, are one TPU's links and say nothing of another machine).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class CommRow:
    name: str
    D: int
    stream_bytes: int  # device-memory bytes per device per iteration
    gather_bytes: int  # bytes received per device per iteration
    t_comp_s: float
    t_comm_s: float
    eff_blocking: float
    eff_overlap: float


def routed_stream_bytes(padded_nnz: int, n_slots: int | None = None) -> int:
    """Device-memory bytes one device streams per routed SpMV iteration,
    the JAX package's per-pass traffic model: the expand, middle and
    chunk-select passes each sweep the T * 1024 stream (6 + 10 + 10 bytes
    an element), the reduce and the y-route the S_pad plane slots (12
    bytes a slot; ~padded_nnz where the caller has no S_pad)."""
    slots = padded_nnz if n_slots is None else n_slots
    return padded_nnz * (6 + 10 + 10) + slots * 12


def weak_scaling(t_comp_s: float, ncols: int, D: int, *, link_bw: float,
                 links: int, f_exp: float = 0.35):
    """(t_comm, E_blocking, E_overlap) for D devices, weak scaling, over
    ``links`` links of ``link_bw`` bytes/s each."""
    gather = (D - 1) * ncols * 4
    t_comm = gather / (links * link_bw)
    e_block = t_comp_s / (t_comp_s + t_comm)
    t_ov = max(f_exp * t_comp_s, t_comm) + (1.0 - f_exp) * t_comp_s
    return t_comm, e_block, t_comp_s / t_ov


def weak_scaling_2d(t_comp_s: float, ncols: int, nrows: int, R: int, C: int,
                    *, link_bw: float, links: int, f_exp: float = 0.35):
    """(t_comm, E_blocking, E_overlap) on an R x C mesh, weak scaling: a
    device receives (R - 1) / R * ncols * 4 bytes of its x block over the
    row axis and moves (C - 1) / C * nrows * 4 bytes of partial y over the
    column axis.  The overlap hides only the x gather."""
    bw = links * link_bw
    gather = (R - 1) / R * ncols * 4
    scatter = (C - 1) / C * nrows * 4
    t_comm = (gather + scatter) / bw
    e_block = t_comp_s / (t_comp_s + t_comm)
    t_ov = (max(f_exp * t_comp_s, gather / bw) + (1.0 - f_exp) * t_comp_s
            + scatter / bw)
    return t_comm, e_block, t_comp_s / t_ov


def best_mesh_2d(t_comp_s: float, ncols: int, nrows: int, D: int, *,
                 link_bw: float, links: int, f_exp: float = 0.35):
    """(R, C, E_blocking, E_overlap): the R * C == D factorization with the
    best blocking efficiency (the first of equals, R ascending)."""
    best = None
    for R in range(1, D + 1):
        if D % R == 0:
            _, e_b, e_o = weak_scaling_2d(t_comp_s, ncols, nrows, R, D // R,
                                          link_bw=link_bw, links=links,
                                          f_exp=f_exp)
            if best is None or e_b > best[2]:
                best = (R, D // R, e_b, e_o)
    return best


def knee_devices(t_comp_s: float, ncols: int, *, link_bw: float, links: int,
                 f_exp: float = 0.35, target: float = 0.70):
    """The largest D that keeps E >= target: (blocking, overlap)."""

    def eff(d, idx):
        return weak_scaling(t_comp_s, ncols, d, link_bw=link_bw,
                            links=links, f_exp=f_exp)[idx]

    def largest(idx: int) -> int:
        d, last = 2, 1
        while d <= 1 << 20:
            if eff(d, idx) < target:
                break
            last = d
            d *= 2
        lo, hi = last, min(d, 1 << 20)
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if eff(mid, idx) >= target:
                lo = mid
            else:
                hi = mid
        return lo

    return largest(1), largest(2)


def comm_table(rows, D: int = 8, *, link_bw: float, links: int,
               f_exp: float = 0.35) -> list[CommRow]:
    """CommRows from bench-result dicts, each with name, ncols, nnz,
    padded_nnz and spmv_s; rows without ncols are skipped."""
    out = []
    for r in rows:
        ncols = int(r.get("ncols") or 0)
        if not ncols:
            continue
        t_comp = float(r["spmv_s"])
        t_comm, e_b, e_o = weak_scaling(t_comp, ncols, D, link_bw=link_bw,
                                        links=links, f_exp=f_exp)
        out.append(CommRow(
            name=r["name"], D=D,
            stream_bytes=routed_stream_bytes(int(r["padded_nnz"])),
            gather_bytes=(D - 1) * ncols * 4, t_comp_s=t_comp,
            t_comm_s=t_comm, eff_blocking=e_b, eff_overlap=e_o,
        ))
    return out
