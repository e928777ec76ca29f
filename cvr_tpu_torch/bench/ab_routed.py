"""Time the routed SpMV's K1 (expand), K3 (reduce_slices), K4
(route_small) and K15 (expand_ring), and the route API's K16
(route_flat), of several checkouts of this repository on one card, in
turns.

    python3 -m cvr_tpu_torch.bench.ab_routed ROOT [ROOT ...] [--kernels K,..]

Each ROOT is a directory holding a checkout's ``cvr_tpu_torch/`` and
``native/`` (for example the parent commit unpacked with ``git archive``
into a directory that .gitignore lists).  The matrix, web-Google-like
(R-MAT scale 20, 6,162,120 nnz), is generated once; then, for each root in
the order given (give them as A B B A), a subprocess imports that root's
package, builds its kernels and native library, packs the matrix with
``sell_pack_routed`` and, for the ring, ``dist_routed_pack`` on 4 shards of
the one card, and takes from torch.profiler traces the device time per
launch of K1 and K4 at the main path's tensors, of K16 on the y-route's
flat middle, and of K15 in the ring SpMV (K1's kernel: its events carry
K1's name), and the device time per call of K3 (its kernels, a split
slice's second pass included) at the main path's tensors and at each
shard's of ``dist_routed_pack`` forced on 4 shards (x replicated).  It
prints one JSON line per root with a checksum of K1's output and of K4's
and K16's on a y stream made from a seed, and exits 1 if two roots'
differ (the SpMVs' own outputs are not compared: the split-row extras
are added by index_add_, whose atomics add in any order) or if a root's
K3 is not
within 1e-6 of the row scale of that root's plain version (the order of
its sums is free).  ``--kernels`` names the ones to time (default all).
It needs a CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ITERS = 50
SHARDS = 4
# K3's kernels' device event names (the second pass where a checkout has
# one)
K3_EVENTS = ("reduce_slices_kernel", "reduce_slices_combine_kernel")
KERNELS = ("expand", "route_small", "route_flat", "expand_ring",
           "reduce_slices")


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _device_us(fn, event: str, iters: int):
    """(mean device us per event whose name holds ``event``, events per
    call) over a trace of ``iters`` calls after a warm-up; a trace may
    lose some events, so the mean is over those it holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    durs = [e.device_time for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and event in e.name]
    if not durs:
        raise RuntimeError(f"the trace holds no {event} event")
    return sum(durs) / len(durs), len(durs) / iters


def _device_per_call(fn, events, iters: int) -> float:
    """Device us per call of ``fn`` in the kernels whose event names hold
    one of ``events`` (one trace each; a name no trace holds counts 0:
    an older checkout may lack a kernel)."""
    total = 0.0
    for event in events:
        try:
            us, per_call = _device_us(fn, event, iters)
        except RuntimeError:
            continue
        total += us * round(per_call)
    return total


def _k3_case(rk, sp, sd, g1):
    """(K3 at the shard's or matrix's tensors as a call, the largest
    error of its output over 1e-6 of the row scale of its plain version:
    at most 1 when within)."""
    m, m3 = sp.middle(sd, g1)
    got = sp.reduce(sd, m, m3)
    args = (sd.p3, sd.red_row0, sd.red_row1, sd.red_out, sd.red_fast,
            sd.nslices)
    want = rk.reduce_slices_plain(m, m3, sd.vals_ss, *args)
    scale = rk.reduce_slices_plain(m.abs(), m3, sd.vals_ss.abs(), *args)
    ratio = float(((got - want).abs() / (1e-6 * scale + 1e-30)).max())
    return (lambda: sp.reduce(sd, m, m3)), ratio


def worker(root: str, npz: str, iters: int, names) -> dict:
    """One root's measurements (run in a subprocess whose path starts at
    ``root``)."""
    import numpy as np
    import torch

    import cvr_tpu_torch
    from cvr_tpu_torch import _native
    from cvr_tpu_torch.formats.coo import COOMatrix
    from cvr_tpu_torch.formats.sell_routed import sell_pack_routed
    from cvr_tpu_torch.ops import _build
    from cvr_tpu_torch.ops import route_kernels as rk
    from cvr_tpu_torch.ops import spmv_routed as sp
    from cvr_tpu_torch.parallel.dist import make_mesh
    from cvr_tpu_torch.parallel.dist_routed import (
        dist_routed_pack,
        dist_spmv_routed,
    )

    pkg = Path(cvr_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(root).resolve():
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    _native.build()
    _build.load()
    z = np.load(npz)
    csr = COOMatrix(rows=z["rows"], cols=z["cols"], vals=z["vals"],
                    shape=tuple(z["shape"])).to_csr()
    sd = sp.to_device_routed(sell_pack_routed(csr), "cuda")
    xd = torch.from_numpy(np.random.default_rng(0).standard_normal(
        csr.shape[1]).astype(np.float32)).to("cuda")

    def k1():
        return rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li, xd, sd.segw,
                         sd.n_segs)

    g1 = k1()
    ra = sd.yroute
    # K4 gathers whatever stream it is given: one made from a seed, the
    # same in every root (K3's sums, which feed it on the path, may differ
    # in their last bits from root to root)
    ysp = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, ra.Tp, 128)).astype(np.float32)).to("cuda")
    if getattr(ra, "src", None) is not None:
        def k4():
            return rk.route_small(ysp, ra.src, ra.n)
    else:  # the three-plane K4 of PRs 1-6
        def k4():
            return rk.route_small(ysp, ra.s1, ra.mid.mid, ra.s3, ra.n)

    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    # K16: the y-route's flat middle on the seeded stream after stage 1
    g2 = rk.tileperm(ysp, ra.s1)
    timed = [("expand", k1, "expand_kernel"),
             ("route_small", k4, "route_small_kernel"),
             ("route_flat", lambda: rk.route_flat(g2, ra.mid.mid),
              "route_m3_kernel<true>")]
    if "expand_ring" in names:
        dm = dist_routed_pack(csr, make_mesh(devices=["cuda"] * SHARDS),
                              overlap=True)
        timed.append(("expand_ring", lambda: dist_spmv_routed(
            dm, xd, x_sharded=True, overlap=True), "expand_kernel"))
    for name, fn, event in timed:
        if name not in names:
            continue
        if name != "expand_ring":  # its SpMV sums by index_add_, in any order
            out[f"{name}_digest"] = _digest(fn())
        us, per_call = _device_us(fn, event, iters)
        out[f"{name}_ms"] = us / 1e3
        out[f"{name}_launches"] = per_call
    if "reduce_slices" not in names:
        return out
    forced = dist_routed_pack(csr, make_mesh(devices=["cuda"] * SHARDS))
    k3 = [("reduce_slices", sd, g1)] + [
        (f"reduce_slices_shard{i}", s,
         rk.expand(s.w8, s.gcls, s.seg_blk, s.li, xd, s.segw, s.n_segs))
        for i, s in enumerate(forced.shards)]
    for name, s, g in k3:
        fn, ratio = _k3_case(rk, sp, s, g)
        out[f"{name}_ms"] = _device_per_call(fn, K3_EVENTS, iters) / 1e3
        out[f"{name}_err_over_tol"] = ratio
    out["reduce_slices_shards_ms"] = sum(
        out[f"reduce_slices_shard{i}_ms"] for i in range(SHARDS))
    return out


def card() -> str:
    """nvidia-smi's name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run_roots(script: str, roots, npz: str, iters: int,
              extra=()) -> list[dict]:
    """Run ``script --worker ROOT NPZ [extra]`` once per root, in the
    order given, each in a subprocess started in the root, and print and
    return the JSON line each prints last."""
    rows = []
    for root in roots:
        proc = subprocess.run(
            [sys.executable, str(Path(script).resolve()), "--worker",
             str(Path(root).resolve()), npz, "--iters", str(iters), *extra],
            cwd=root, capture_output=True, text=True, timeout=900,
        )
        if proc.returncode:
            raise SystemExit(f"{Path(script).stem}: {root} failed:\n"
                             f"{proc.stderr[-3000:]}")
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "NPZ"))
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated kernels to time")
    args = ap.parse_args(argv)
    names = args.kernels.split(",")
    if not set(names) <= set(KERNELS):
        raise SystemExit(f"ab_routed: --kernels among {KERNELS}")
    if args.worker:
        # the root's package, not the one beside this file
        sys.path[0] = str(Path(args.worker[0]).resolve())
        print(json.dumps(worker(*args.worker, args.iters, names)))
        return 0
    import numpy as np
    import torch

    from cvr_tpu_torch.bench.synthetic import web_google_like

    if not torch.cuda.is_available():
        raise SystemExit("ab_routed: torch.cuda.is_available() is false")
    print(f"nvidia-smi: {card()}")
    coo = web_google_like()
    with tempfile.TemporaryDirectory() as tmp:
        npz = str(Path(tmp) / "matrix.npz")
        np.savez(npz, rows=coo.rows, cols=coo.cols, vals=coo.vals,
                 shape=np.asarray(coo.shape))
        rows = run_roots(__file__, args.roots, npz, args.iters,
                         ["--kernels", args.kernels])
    digests = {k for r in rows for k in r if k.endswith("_digest")}
    differ = [k for k in sorted(digests) if len({r[k] for r in rows}) > 1]
    if differ:
        print(f"ab_routed: the roots' outputs differ: {differ}")
        return 1
    bad = [(r["root"], k) for r in rows for k, v in r.items()
           if k.endswith("_err_over_tol") and not v <= 1.0]
    if bad:
        print(f"ab_routed: K3 disagrees with its plain version: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
