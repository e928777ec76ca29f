"""Per-pass profile of an SpMV (SpMM for bsr) on the card.

On the card a pass is a kernel launch, so the table comes from one
torch.profiler trace of back-to-back calls (harness.device_ms, the same
machinery as chip_smoke.py's device times): per kernel of ours, its
launches in one call (the launch counters), its device ms per call, the
bytes it must move at this call's inputs (bench/bounds.work: each input
read once, each output written once, where the data names what it
reads: only that; the count of chip_smoke.py's bound) and that over its
time against the card's memory rate (harness.HBM_BW); then the other
device work between the kernels (the glue: relayouts, pads, gathers,
index_add_), the whole call's device ms and its ms by CUDA events.

impls: routed (K1 expand, K3 reduce, K7 on hot planes, K4 y-route),
window (K10, then K4 where a y-route runs), dia (K8) and bsr (K12, an
SpMM of ``--rhs`` columns): those of the JAX package's
``scripts/profile_passes.py``.  That script times each pass by the slope
between two loop lengths of a pass prefix, differencing consecutive
prefixes (XLA fuses the passes of one jitted call); it is not ported: a
trace gives each launch's own device time.  On the CPU (``--device
cpu``) the wrappers run their plain versions and the table has no device
times.

Usage:
  python -m cvr_tpu_torch.bench.profile_passes [--scale 20]
      [--edge-factor 6] [--impl routed|window|dia|bsr]
      [--matrix rmat|banded] [--rhs 128]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

IMPLS = ("routed", "window", "dia", "bsr")


def prepare(impl: str, csr, device, rhs: int = 128):
    """Pack ``csr`` for ``impl`` and upload it: (device artifact, x or X
    on the device, pack seconds, geometry line)."""
    t0 = time.perf_counter()
    if impl == "window":
        from cvr_tpu_torch.formats.sell_window import sell_pack_window
        from cvr_tpu_torch.ops.spmv_window import to_device_window

        A = sell_pack_window(csr)
        sd = to_device_window(A, device)
        geo = f"W={A.W}, D={A.D}, wrl={A.wrl}, S_pad={A.S_pad}"
    elif impl == "dia":
        from cvr_tpu_torch.formats.dia import dia_pack
        from cvr_tpu_torch.ops.spmv_dia import to_device_dia

        A = dia_pack(csr)
        sd = to_device_dia(A, device)
        geo = f"nd={A.nd}"
    elif impl == "bsr":
        from cvr_tpu_torch.formats.bsr import bsr_pack
        from cvr_tpu_torch.ops.spmm_bsr import to_device_bsr

        A = bsr_pack(csr)
        sd = to_device_bsr(A, device)
        geo = f"bricks={A.nbricks}, fill={A.fill:.3f}, K={rhs}"
    elif impl == "routed":
        from cvr_tpu_torch.formats.sell_routed import sell_pack_routed
        from cvr_tpu_torch.ops.spmv_routed import to_device_routed

        A = sell_pack_routed(csr)
        sd = to_device_routed(A, device)
        geo = (f"T={A.T}, S_pad={A.S_pad}, fillers={A.n_fillers}, "
               f"hot planes={'none' if A.hot is None else A.hot.NH}")
    else:
        raise ValueError(f"unknown impl {impl!r}: one of {IMPLS}")
    pack_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    shape = (csr.shape[1], rhs) if impl == "bsr" else (csr.shape[1],)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return sd, x.to(device), pack_s, geo


def call(impl: str, sd, x) -> torch.Tensor:
    """One SpMV (SpMM for bsr) through the port's entry."""
    from cvr_tpu_torch.ops.spmv import spmm, spmv

    return spmm(sd, x) if impl == "bsr" else spmv(sd, x)


def passes(impl: str, sd, x) -> list[tuple[str, tuple, torch.Tensor]]:
    """Each kernel launch of one call, in order: (kernel, its arguments
    at this call's tensors, its output)."""
    from cvr_tpu_torch.ops import dia_kernels as dk
    from cvr_tpu_torch.ops import route_kernels as rk
    from cvr_tpu_torch.ops import spmv_routed as sp

    out = []

    def run(name, fn, args):
        got = fn(*args)
        out.append((name, args, got))
        return got

    def y_route(ra, ysp):
        if ra.src is None:  # the upload composes every y-route
            raise ValueError("a y-route without its composed index")
        run("route_small", rk.route_small, (ysp, ra.src, ra.n))

    if impl == "dia":
        run("dia_spmv", dk.dia_spmv, (sd.bands, sd.offsets, x))
    elif impl == "bsr":
        from cvr_tpu_torch.ops import bsr_kernels as bk
        from cvr_tpu_torch.ops import spmm_bsr

        run("bsr_spmm", bk.bsr_spmm, spmm_bsr.kernel_args(sd, x))
    elif impl == "window":
        from cvr_tpu_torch.ops import window_kernels as wk
        from cvr_tpu_torch.ops.spmv_window import reduce_args, window_rows

        run("window_reduce", wk.window_reduce, reduce_args(sd, x))
        if sd.yroute is not None:
            y_route(sd.yroute, sp.route_stream(sd.yroute,
                                               window_rows(sd, x)))
    else:
        g1 = run("expand", rk.expand, (sd.w8, sd.gcls, sd.seg_blk, sd.li, x,
                                       sd.segw, sd.n_segs))
        ys = run("reduce_slices", rk.reduce_slices,
                 (g1, sd.vals_ss, sd.red_plan, sd.nslices))
        ysp = sp.y_stream(sd, ys)
        if sd.hot_nslices:
            ysp[:, : sd.hot_nslices] += run(
                "reduce_hot", rk.reduce_hot,
                (x[sd.hot_ids], sd.hidx, sd.hvals, sd.hot_row0,
                 sd.hot_row1, sd.hot_out, sd.hot_nslices))
        y_route(sd.yroute, ysp)
    return out


def profile(impl: str, csr, device="cuda", rhs: int = 128, iters: int = 20,
            repeats: int = 2, sd=None, x=None) -> dict:
    """The per-pass table of ``impl`` on ``csr`` (packed and uploaded
    here unless ``sd`` and ``x`` are given): a dict with "rows" (per
    kernel: name, launches, device_ms, bytes, gbps, hbm_frac), "glue_ms",
    "device_ms", "events_ms" and "text", the printed table.  Device times
    are the least over ``repeats`` traces of ``iters`` calls each (None
    on the CPU)."""
    from cvr_tpu_torch.bench import harness
    from cvr_tpu_torch.bench.bounds import work
    from cvr_tpu_torch.ops import kernels

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a CPU run")
    lines = []
    if sd is None:
        sd, x, pack_s, geo = prepare(impl, csr, dev, rhs)
        lines.append(f"pack: {pack_s:.1f}s, {geo}")

    def fn():
        return call(impl, sd, x)

    kernels.reset_launches()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {k: n for k, n in kernels.launches().items() if n}
    launched = passes(impl, sd, x)
    nbytes = {}
    for name, args, out in launched:
        nbytes[name] = nbytes.get(name, 0) + work(name, args, out)[0]
    events_ms = harness.time_iterations(fn, iters, dev) * 1e3
    per_kernel, dev_ms = {}, None
    if dev.type == "cuda":
        best = None
        for _ in range(max(1, repeats)):
            per = harness.device_ms(fn, iters, None)
            if best is None or sum(per.values()) < sum(best.values()):
                best = per
        dev_ms = sum(best.values())
        per_kernel = harness.by_kernel(best)
    bw = harness.HBM_BW[harness.detect_chip(dev)]
    rows = []
    for name in dict.fromkeys(n for n, _, _ in launched):
        ms = per_kernel.get(name)
        gbps = None if not ms else nbytes[name] / (ms * 1e-3) / 1e9
        rows.append({
            "name": name, "launches": launches.get(name, 0),
            "device_ms": ms, "bytes": nbytes[name], "gbps": gbps,
            "hbm_frac": None if gbps is None else gbps * 1e9 / bw,
        })
    glue = None if dev_ms is None else dev_ms - sum(per_kernel.values())

    def num(v, fmt):
        return "not measured" if v is None else format(v, fmt)

    lines.append(f"device: {harness.detect_chip(dev)}, memory rate "
                 f"{bw / 1e9:.0f} GB/s")
    lines.append(f"{'pass':<16s} {'launches':>8s} {'device ms':>12s} "
                 f"{'MB':>10s} {'GB/s':>12s} {'of HBM':>12s}")
    for r in rows:
        lines.append(
            f"{r['name']:<16s} {r['launches']:>8d} "
            f"{num(r['device_ms'], '.4f'):>12s} {r['bytes'] / 1e6:>10.2f} "
            f"{num(r['gbps'], '.0f'):>12s} {num(r['hbm_frac'], '.1%'):>12s}")
    lines.append(f"{'glue':<16s} {'':>8s} {num(glue, '.4f'):>12s}")
    lines.append(f"{'full, device':<16s} {'':>8s} {num(dev_ms, '.4f'):>12s}")
    lines.append(f"{'full, events':<16s} {'':>8s} {events_ms:>12.4f}")
    nnz = csr.nnz
    if impl == "bsr":
        lines.append(f"full SpMM (K={rhs}): {events_ms:.3f} ms = "
                     f"{2 * nnz * rhs / events_ms / 1e6:.1f} useful GFLOPS")
    else:
        lines.append(f"full SpMV: {events_ms:.3f} ms = "
                     f"{nnz / events_ms / 1e6:.2f} Gnnz/s = "
                     f"{2 * nnz / events_ms / 1e6:.2f} GFLOPS(2nnz), "
                     f"{100 * nnz * 8 / (events_ms * 1e-3) / bw:.1f}% of "
                     "naive 8B/nnz roofline")
    text = "\n".join(lines)
    return {"impl": impl, "rows": rows, "glue_ms": glue, "device_ms": dev_ms,
            "events_ms": events_ms, "launches": launches, "text": text}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--edge-factor", type=int, default=6)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--repeats", type=int, default=2,
                    help="traces taken; the table is the least one's")
    ap.add_argument("--impl", default="routed", choices=list(IMPLS))
    ap.add_argument("--matrix", default=None, choices=[None, "rmat",
                                                       "banded"])
    ap.add_argument("--rhs", type=int, default=128,
                    help="dense RHS columns for --impl bsr (SpMM)")
    ap.add_argument("--iters", type=int, default=20,
                    help="calls a trace (and the timed loop) holds")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a smoke run)")
    args = ap.parse_args(argv)

    from cvr_tpu_torch.bench.synthetic import banded_matrix, rmat_matrix
    from cvr_tpu_torch.utils import memarena

    memarena.warm()
    if args.matrix is None:
        args.matrix = "rmat" if args.impl == "routed" else "banded"
    if args.matrix == "banded":
        coo = banded_matrix(1 << args.scale, bandwidth=27, seed=args.seed)
    else:
        coo = rmat_matrix(scale=args.scale, edge_factor=args.edge_factor,
                          seed=args.seed)
    csr = coo.to_csr()
    print(f"matrix: {csr.shape[0]}x{csr.shape[1]}, {csr.nnz} nnz")
    res = profile(args.impl, csr, args.device, rhs=args.rhs,
                  iters=args.iters, repeats=args.repeats)
    print(res["text"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
