"""Time the routed SpMV's K1 (expand), K4 (route_small) and K15
(expand_ring) of several checkouts of this repository on one card, in
turns.

    python3 -m cvr_tpu_torch.bench.ab_routed ROOT [ROOT ...]

Each ROOT is a directory holding a checkout's ``cvr_tpu_torch/`` and
``native/`` (for example the parent commit unpacked with ``git archive``
into a directory that .gitignore lists).  The matrix, web-Google-like
(R-MAT scale 20, 6,162,120 nnz), is generated once; then, for each root in
the order given (give them as A B B A), a subprocess imports that root's
package, builds its kernels and native library, packs the matrix with
``sell_pack_routed`` and, for the ring, ``dist_routed_pack`` on 4 shards of
the one card, and takes from torch.profiler traces the device time per
launch of K1 and K4 at the main path's tensors and of K15 in the ring
SpMV (K1's kernel: its events carry K1's name).  It prints one JSON line
per root with a checksum of K1's and K4's outputs, and exits 1 if two
roots' differ (the SpMVs' own outputs are not compared: the split-row
extras are added by index_add_, whose atomics add in any order).  It
needs a CUDA card and imports nothing of JAX.
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


def worker(root: str, npz: str, iters: int) -> dict:
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
    ysp = sp.y_stream(sd, sp.reduce(sd, *sp.middle(sd, g1)))
    ra = sd.yroute
    if getattr(ra, "src", None) is not None:
        def k4():
            return rk.route_small(ysp, ra.src, ra.n)
    else:  # the three-plane K4 of PRs 1-6
        def k4():
            return rk.route_small(ysp, ra.s1, ra.mid.mid, ra.s3, ra.n)

    dm = dist_routed_pack(csr, make_mesh(devices=["cuda"] * SHARDS),
                          overlap=True)

    def ring():
        return dist_spmv_routed(dm, xd, x_sharded=True, overlap=True)

    out = {"root": root, "device": torch.cuda.get_device_name(0),
           "expand_digest": _digest(k1()),
           "route_small_digest": _digest(k4())}
    for name, fn, event in (("expand", k1, "expand_kernel"),
                            ("route_small", k4, "route_small_kernel"),
                            ("ring_expand", ring, "expand_kernel")):
        us, per_call = _device_us(fn, event, iters)
        out[f"{name}_ms"] = us / 1e3
        out[f"{name}_launches"] = per_call
    return out


def card() -> str:
    """nvidia-smi's name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run_roots(script: str, roots, npz: str, iters: int) -> list[dict]:
    """Run ``script --worker ROOT NPZ`` once per root, in the order given,
    each in a subprocess started in the root, and print and return the
    JSON line each prints last."""
    rows = []
    for root in roots:
        proc = subprocess.run(
            [sys.executable, str(Path(script).resolve()), "--worker",
             str(Path(root).resolve()), npz, "--iters", str(iters)],
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
    args = ap.parse_args(argv)
    if args.worker:
        # the root's package, not the one beside this file
        sys.path[0] = str(Path(args.worker[0]).resolve())
        print(json.dumps(worker(*args.worker, args.iters)))
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
        rows = run_roots(__file__, args.roots, npz, args.iters)
    digests = {k for r in rows for k in r if k.endswith("_digest")}
    differ = [k for k in sorted(digests) if len({r[k] for r in rows}) > 1]
    if differ:
        print(f"ab_routed: the roots' outputs differ: {differ}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
