"""Time the routed SpMV's K1 (expand), K3 (reduce_slices), K4
(route_small) and K15 (expand_ring), the route API's K2 (route_middle),
K5 (tileperm), K6 (route_m3), K16 (route_flat), K17 (groupperm) and K18
(reduce_stream), and whole routed SpMVs, of several checkouts of this
repository on one card, in turns.

    python3 -m cvr_tpu_torch.bench.ab_routed ROOT [ROOT ...] [--kernels K,..]

Each ROOT is a directory holding a checkout's ``cvr_tpu_torch/`` and
``native/`` (for example the parent commit unpacked with ``git archive``
into a directory that .gitignore lists).  The matrices are generated once;
then, for each root in the order given (give them as A B B A), a
subprocess imports that root's package, builds its kernels and native
library, and takes device times from torch.profiler traces:

  * on web-Google-like (R-MAT scale 20, 6,162,120 nnz) packed with
    ``sell_pack_routed``: K1 (off the SpMV's path where a checkout's K3
    reads x) and K4 per launch at the main path's tensors,
    K5 (stages 1 and 3) and K16 on its y stream through its flat y-route
    (chip_smoke.py's phase [9a]), K5, K17 and K6 in ``apply_route`` of the
    permutation that sorts its nonzeros by column, compiled at
    ``tile_multiple`` 1 (T 6144, the brute middle: K5, K17, K5) and 1024
    (the recursive middle: K5, K2, K6, K5; phase [9b]), K2 per call on
    that route's stage-1 output (Tk 6) and on the x side's middle of the
    unfused SpMV (Tk 7, phase [9c]), each also by its "split" body where
    a checkout has two, K18 per call on each reduce group of that SpMV
    ([9c]: by the plan made at upload where a checkout has one, else with
    the slice starts its wrapper derives on every call), K15 in the ring
    SpMV of
    ``dist_routed_pack`` on 4 shards of the one card (K1's kernel: its
    events carry K1's name), and K3 per call (its kernels, a split
    slice's second pass included) at the main path's tensors and at each
    shard's of the forced 4-shard pack (x replicated): by x where a
    checkout's K3 reads x, with K3 by the plan into g1 beside it (the
    chain the x plan replaced, built for comparison: ``*_g1_ms``);
  * (``spmv``) on web-Google-like and fsm-like through
    ``sell_pack_routed`` and road-usa-like through ``pack_auto``, whose
    BELL artifact routes its spill: K3 per call (and by the g1 plan, as
    above: ``*_k3_g1_ms``), the x side's route
    middle per call (K2 where a checkout still runs it), the y-route per
    call (K4, or the staged K5, K2, K6, K5 of a checkout without the
    composed index above 1024 tiles) on a y stream made from a seed, and
    the whole SpMV's device time per call (every kernel and copy of its
    trace), and the upload's seconds (``upload``, host clock to a
    synchronize: the compositions of the route run there).

It prints one JSON line per root with checksums: K1's output, K4's on a
seeded y stream, K2's, K5's, K6's, K16's and K17's, each matrix's K3 sums
and y-route output, and
each SpMV's y, taken with torch's deterministic algorithms (index_add_
adds the split-row extras by atomics otherwise).  It exits 1 if two
roots' checksums differ or if a root's K3 or K18 is not within 1e-6 of
the row scale of that root's plain version (K18 sums in another order
than its parent: no checksum), K18 differs from a second call, or K3 by
the g1 plan differs from K3 by x (``*_equal``).  ``--kernels`` names the ones to time
(default all).  It needs a CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ITERS = 50
SHARDS = 4
# K3's kernels' device event names (the second pass where a checkout has
# one)
K3_EVENTS = ("reduce_slices_kernel", "reduce_slices_combine_kernel")
KERNELS = ("expand", "route_small", "tileperm", "route_flat", "groupperm",
           "route_m3", "route_middle", "reduce_stream", "expand_ring",
           "reduce_slices", "spmv")
# the route API's kernels: their device events' names, the parent's (PR 11's
# tree, where K16 was an instantiation of K6's kernel) and this tree's
EVENTS = {"tileperm": ("tileperm_kernel<false>",),
          "groupperm": ("tileperm_kernel<true>",),
          "route_m3": ("route_m3_kernel",),
          "route_flat": ("route_m3_kernel<true>", "route_flat_kernel")}
MATRICES = ("web_google_like", "fsm_like", "road_usa_like")


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _y_digest(fn) -> str:
    """_digest of fn()'s output under torch's deterministic algorithms."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _digest(fn())
    finally:
        torch.use_deterministic_algorithms(False)


def _trace(fn, iters: int):
    """(device us of each event, by event name) over a trace of ``iters``
    calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    durs = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            durs.setdefault(e.name, []).append(e.device_time)
    return durs


def _device_us(fn, event, iters: int):
    """(mean device us per event whose name holds ``event``, or one of
    them for a tuple, events per call) over a trace of ``iters`` calls; a
    trace may lose some events, so the mean is over those it holds."""
    events = (event,) if isinstance(event, str) else event
    durs = [d for name, ds in _trace(fn, iters).items()
            if any(e in name for e in events) for d in ds]
    if not durs:
        raise RuntimeError(f"the trace holds no {event} event")
    return sum(durs) / len(durs), len(durs) / iters


def _device_per_call(fn, events, iters: int) -> float:
    """Device us per call of ``fn`` in the kernels whose event names hold
    one of ``events`` (one trace each; a name no trace holds counts 0:
    an older checkout may lack a kernel), or in all of them for None."""
    if events is None:
        return sum(sum(ds) / len(ds) * round(len(ds) / iters)
                   for ds in _trace(fn, iters).values())
    total = 0.0
    for event in events:
        try:
            us, per_call = _device_us(fn, event, iters)
        except RuntimeError:
            continue
        total += us * round(per_call)
    return total


def _k3_case(rk, sp, sd, g1, x):
    """(K3 at the shard's or matrix's tensors as a call, its output, the
    largest error of that output over 1e-6 of the row scale of its plain
    version: at most 1 when within).  K3 reads what the checkout's SpMV
    gives it: x where its plan says so (``source``), else the expanded
    stream g1; a checkout whose K3 reads the route middle's mstream
    (sp.reduce(sd, m, m3)) gets it made here, outside the call."""
    if "m3" in inspect.signature(sp.reduce).parameters:
        m, m3 = sp.middle(sd, g1)
        args = (sd.p3, sd.red_row0, sd.red_row1, sd.red_out, sd.red_fast,
                sd.nslices)
        want = rk.reduce_slices_plain(m, m3, sd.vals_ss, *args)
        scale = rk.reduce_slices_plain(m.abs(), m3, sd.vals_ss.abs(), *args)
        fn = lambda: sp.reduce(sd, m, m3)  # noqa: E731
    else:
        src = x if getattr(sd.red_plan, "source", "g1") == "x" else g1
        want = rk.reduce_slices_plain(src, sd.vals_ss, sd.red_plan,
                                      sd.nslices)
        scale = rk.reduce_slices_plain(src.abs(), sd.vals_ss.abs(),
                                       sd.red_plan, sd.nslices)
        fn = lambda: sp.reduce(sd, src)  # noqa: E731
    got = fn()
    ratio = float(((got - want).abs() / (1e-6 * scale + 1e-30)).max())
    return fn, got, ratio


def _x_middle(sp, sd):
    """The x side's route middle as a call where a checkout runs it apart
    from K3 (sp.reduce(sd, m, m3)), else None."""
    if "m3" not in inspect.signature(sp.reduce).parameters:
        return None
    return lambda g1: sp.middle(sd, g1)


def _matrix_case(rk, sp, spmv, name, sd, xd, iters) -> dict:
    """The SpMV of ``sd`` (routed, or BELL with a routed spill) on xd:
    its routed part's K3, x-side middle and y-route per call, the SpMV's
    device time per call, with checksums."""
    import numpy as np
    import torch

    rsd = getattr(sd, "spill", None) or sd
    g1 = rk.expand(rsd.w8, rsd.gcls, rsd.seg_blk, rsd.li, xd, rsd.segw,
                   rsd.n_segs)
    fn, ys, ratio = _k3_case(rk, sp, rsd, g1, xd)
    ra = rsd.yroute
    ysp = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, ra.Tp, 128)).astype(np.float32)).to(xd.device)
    out = {
        f"{name}_k3_ms": _device_per_call(fn, K3_EVENTS, iters) / 1e3,
        f"{name}_k3_err_over_tol": ratio,
        f"{name}_k3_digest": _digest(ys),
        f"{name}_yroute_ms": _device_per_call(
            lambda: sp.apply_route_stream(ra, ysp), None, iters) / 1e3,
        f"{name}_yroute_digest": _digest(sp.apply_route_stream(ra, ysp)),
        f"{name}_spmv_ms": _device_per_call(
            lambda: spmv(sd, xd), None, iters) / 1e3,
        f"{name}_y_digest": _y_digest(lambda: spmv(sd, xd)),
    }
    mid = _x_middle(sp, rsd)
    out[f"{name}_xmid_ms"] = 0.0 if mid is None else _device_per_call(
        lambda: mid(g1), None, iters) / 1e3
    out.update(_g1_chain_ms(sp, rsd, g1, ys, f"{name}_k3_g1", iters))
    return out


def _g1_chain_ms(sp, sd, g1, ys, key, iters) -> dict:
    """Where the checkout's K3 reads x: K3 by the plan into g1 (composed
    here, outside the call; the chain the x plan replaced, K1's output g1
    in place) per call (``key``_ms), and whether its sums equal ys, the x
    plan's, bit for bit."""
    import torch

    if not hasattr(sp, "g1_plan"):
        return {}
    plan = sp.g1_plan(sd)

    def fn():
        return sp.reduce(sd, g1, plan)

    return {f"{key}_ms": _device_per_call(fn, K3_EVENTS, iters) / 1e3,
            f"{key}_equal": bool(torch.equal(fn(), ys))}


def route_api_cases(rk, sp, rp, sd, g1, csr):
    """(name, call, its device events) of the route API's kernels at
    chip_smoke.py's phase [9] tensors: K5 (stages 1 and 3) and K16 on the
    y stream of web-Google-like's SpMV through its flat y-route ([9a]);
    K5 (stages 1 and 3), K17 and K6 in apply_route of the permutation that
    sorts its nonzeros by column (v from default_rng(1)), compiled at
    tile_multiple 1 (brute) and 1024 (rec) ([9b]); K6 on the x side's
    recursive middle of the unfused SpMV ([9c]).  Each kernel's input is
    its path's: the output of the launch before it."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    ra = sd.yroute
    ysp = sp.y_stream(sd, sp.reduce(sd, g1))
    g2 = rk.tileperm(ysp, ra.s1)
    g3 = rk.route_flat(g2, ra.mid.mid)
    cases = [("tileperm 9a_stage1", lambda: rk.tileperm(ysp, ra.s1)),
             ("route_flat", lambda: rk.route_flat(g2, ra.mid.mid)),
             ("tileperm 9a_stage3", lambda: rk.tileperm(g3, ra.s3))]
    perm = np.argsort(csr.cols, kind="stable")
    v = np.random.default_rng(1).standard_normal(perm.shape[0])
    vd = torch.from_numpy(v.astype(np.float32)).to(g1.device)
    for tm, kind in ((1, "brute"), (1024, "rec")):
        rd = sp.route_to_device(
            rp.route_arrays_from_perm(perm, tile_multiple=tm), g1.device)
        if rd.mid.kind != kind:
            raise RuntimeError(f"tile_multiple {tm}: middle {rd.mid.kind}")
        g = rk.flat_to_stream(F.pad(vd, (0, rd.Tp * 1024 - vd.shape[0])),
                              rd.Tp).contiguous()
        s1 = rk.tileperm(g, rd.s1)
        if kind == "brute":
            m = rk.stream_to_middle(s1).contiguous()
            cases.append(("groupperm", lambda m=m, rd=rd: rk.groupperm(
                m, rd.mid.mid)))
        else:
            m = rk.route_middle(s1, rd.mid.m1, rd.mid.csel)
            cases.append(("route_m3 9b_rec", lambda m=m, rd=rd: rk.route_m3(
                m, rd.mid.m3)))
        s2 = sp.middle_pass(s1, rd.mid)
        cases += [(f"tileperm 9b_{kind}_stage1",
                   lambda g=g, rd=rd: rk.tileperm(g, rd.s1)),
                  (f"tileperm 9b_{kind}_stage3",
                   lambda s2=s2, rd=rd: rk.tileperm(s2, rd.s3))]
    if sd.mid.kind == "rec":
        mx = rk.route_middle(g1, sd.mid.m1, sd.mid.csel)
        cases.append(("route_m3 9c_x", lambda: rk.route_m3(mx, sd.mid.m3)))
    return [(name, fn, EVENTS[name.split(" ")[0]]) for name, fn in cases]


def route_middle_cases(rk, sp, rp, sd, g1, csr):
    """(name, call) of K2 per call at chip_smoke.py's phase [9] tensors:
    on the stage-1 output of apply_route's recursive route ([9b], Tk 6)
    and on the x side's g1 ([9c], Tk 7); also by the "split" body where
    the checkout's route_middle has a ``body``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    perm = np.argsort(csr.cols, kind="stable")
    v = np.random.default_rng(1).standard_normal(perm.shape[0])
    vd = torch.from_numpy(v.astype(np.float32)).to(g1.device)
    rd = sp.route_to_device(rp.route_arrays_from_perm(perm, tile_multiple=1024),
                            g1.device)
    g = rk.flat_to_stream(F.pad(vd, (0, rd.Tp * 1024 - vd.shape[0])),
                          rd.Tp).contiguous()
    ins = {"9b_rec": (rk.tileperm(g, rd.s1), rd.mid),
           "9c_x": (g1, sd.mid)}
    bodies = [None]
    if "body" in inspect.signature(rk.route_middle).parameters:
        bodies.append("split")
    cases = []
    for where, (s1, mid) in ins.items():
        for body in bodies:
            kw = {} if body is None else {"body": body}
            cases.append((f"route_middle {where}" + (f"_{body}" if body
                                                     else ""),
                          lambda s1=s1, mid=mid, kw=kw: rk.route_middle(
                              s1, mid.m1, mid.csel, **kw)))
    return cases


def reduce_stream_cases(rk, sp, rp, sr, sd, g1, iters: int) -> dict:
    """K18 on each reduce group of the unfused SpMV ([9c]): device ms per
    call (all its device work, and its kernels alone), by the upload's
    plan where the checkout has one, each call's largest error over 1e-6
    of the row scale of its plain version (at most 1 when within) and
    whether a second call repeats it bit for bit."""
    import numpy as np
    import torch

    emit = torch.from_numpy(sr.emit).to(g1.device)
    gemit = torch.from_numpy(rp.group_emit_encode(sr.emit)).to(g1.device)
    gx = sp.middle_pass(g1, sd.mid)
    plans = getattr(sd, "stream_plans", ())
    out = {}
    for j, (r0, nr) in enumerate(np.asarray(sr.ycall_rows).tolist()):
        rows = slice(r0, r0 + nr)
        args = (emit[rows], gemit[r0 // 8 : (r0 + nr) // 8],
                sd.vals_ss[:, rows], gx[:, rows], sd.p3[:, rows],
                min(rp.YB, sd.nslices - j * rp.YB))
        plan = (plans[j],) if plans else ()
        fn = lambda args=args, plan=plan: rk.reduce_stream(*args, *plan)  # noqa: E731
        got, want = fn(), rk.reduce_stream_plain(*args)
        scale = rk.reduce_stream_plain(args[0], args[1], args[2].abs(),
                                       args[3].abs(), *args[4:])
        key = f"reduce_stream_g{j}"
        out[f"{key}_err_over_tol"] = float(
            ((got - want).abs() / (1e-6 * scale + 1e-30)).max())
        out[f"{key}_repeats"] = bool(torch.equal(got, fn()))
        out[f"{key}_ms"] = _device_per_call(fn, None, iters) / 1e3
        out[f"{key}_kernels_ms"] = _device_per_call(
            fn, ("reduce_stream_kernel", "reduce_stream_combine_kernel"),
            iters) / 1e3
    return out


def worker(root: str, npz: str, iters: int, names) -> dict:
    """One root's measurements (run in a subprocess whose path starts at
    ``root``)."""
    import numpy as np
    import torch

    import cvr_tpu_torch
    from cvr_tpu_torch import _native
    from cvr_tpu_torch.formats import pack_auto
    from cvr_tpu_torch.formats.coo import COOMatrix
    from cvr_tpu_torch.formats.sell_routed import sell_pack_routed
    from cvr_tpu_torch.ops import _build
    from cvr_tpu_torch.ops import route_kernels as rk
    from cvr_tpu_torch.ops import route_planes as rp
    from cvr_tpu_torch.ops import spmv_routed as sp
    from cvr_tpu_torch.ops.spmv import spmv, upload
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

    def load(name):
        z = np.load(str(Path(npz) / f"{name}.npz"))
        coo = COOMatrix(rows=z["rows"], cols=z["cols"], vals=z["vals"],
                        shape=tuple(z["shape"]))
        x = np.random.default_rng(0).standard_normal(coo.shape[1])
        return coo.to_csr(), torch.from_numpy(x.astype(np.float32)).to("cuda")

    csr, xd = load("web_google_like")
    sr = sell_pack_routed(csr)
    sd = sp.to_device_routed(sr, "cuda")

    def k1():
        return rk.expand(sd.w8, sd.gcls, sd.seg_blk, sd.li, xd, sd.segw,
                         sd.n_segs)

    g1 = k1()
    ra = sd.yroute
    # K4 gathers whatever stream it is given: one made from a seed, the
    # same in every root
    ysp = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, ra.Tp, 128)).astype(np.float32)).to("cuda")

    def k4():
        return rk.route_small(ysp, ra.src, ra.n)

    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    timed = [("expand", k1, "expand_kernel"),
             ("route_small", k4, "route_small_kernel")]
    if {"tileperm", "route_flat", "groupperm", "route_m3"} & set(names):
        timed += route_api_cases(rk, sp, rp, sd, g1, csr)
    if "route_middle" in names:
        for name, fn in route_middle_cases(rk, sp, rp, sd, g1, csr):
            key = name.replace(" ", "_")
            out[f"{key}_digest"] = _digest(fn())
            out[f"{key}_ms"] = _device_per_call(fn, None, iters) / 1e3
    if "reduce_stream" in names:
        out.update(reduce_stream_cases(rk, sp, rp, sr, sd, g1, iters))
    if "expand_ring" in names:
        dm = dist_routed_pack(csr, make_mesh(devices=["cuda"] * SHARDS),
                              overlap=True)
        timed.append(("expand_ring", lambda: dist_spmv_routed(
            dm, xd, x_sharded=True, overlap=True), "expand_kernel"))
    for name, fn, event in timed:
        if name.split(" ")[0] not in names:
            continue
        key = name.replace(" ", "_")
        if name != "expand_ring":  # its SpMV sums by index_add_, in any order
            out[f"{key}_digest"] = _digest(fn())
        us, per_call = _device_us(fn, event, iters)
        out[f"{key}_ms"] = us / 1e3
        out[f"{key}_launches"] = per_call
    if "reduce_slices" in names:
        forced = dist_routed_pack(csr, make_mesh(devices=["cuda"] * SHARDS))
        k3 = [("reduce_slices", sd, g1)] + [
            (f"reduce_slices_shard{i}", s,
             rk.expand(s.w8, s.gcls, s.seg_blk, s.li, xd, s.segw, s.n_segs))
            for i, s in enumerate(forced.shards)]
        for name, s, g in k3:
            fn, ys, ratio = _k3_case(rk, sp, s, g, xd)
            out[f"{name}_ms"] = _device_per_call(fn, K3_EVENTS, iters) / 1e3
            out[f"{name}_err_over_tol"] = ratio
            out[f"{name}_digest"] = _digest(ys)
            out.update(_g1_chain_ms(sp, s, g, ys, f"{name}_g1", iters))
        out["reduce_slices_shards_ms"] = sum(
            out[f"reduce_slices_shard{i}_ms"] for i in range(SHARDS))
        del forced
    if "spmv" in names:
        packs = {"web_google_like": sell_pack_routed,
                 "fsm_like": sell_pack_routed, "road_usa_like": pack_auto}
        for name in MATRICES:
            mcsr, mx = load(name)
            A = packs[name](mcsr)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            msd = upload(A, "cuda")
            torch.cuda.synchronize()
            out[f"{name}_upload_s"] = time.perf_counter() - t0
            out.update(_matrix_case(rk, sp, spmv, name, msd, mx, iters))
            del A, msd
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

    from cvr_tpu_torch.bench import synthetic as syn

    if not torch.cuda.is_available():
        raise SystemExit("ab_routed: torch.cuda.is_available() is false")
    print(f"nvidia-smi: {card()}")
    wanted = set(MATRICES) if "spmv" in names else {"web_google_like"}
    with tempfile.TemporaryDirectory() as tmp:
        for name in sorted(wanted):
            coo = getattr(syn, name)()
            np.savez(str(Path(tmp) / f"{name}.npz"), rows=coo.rows,
                     cols=coo.cols, vals=coo.vals, shape=np.asarray(coo.shape))
            del coo
        rows = run_roots(__file__, args.roots, tmp, args.iters,
                         ["--kernels", args.kernels])
    digests = {k for r in rows for k in r if k.endswith("_digest")}
    # a key only some roots have (a body the parent lacks) is compared
    # among those, and a split body's output with its root's other body's
    differ = [k for k in sorted(digests)
              if len({r[k] for r in rows if k in r}) > 1]
    differ += [(r["root"], k) for r in rows for k in r
               if k.endswith("_split_digest")
               and r[k] != r.get(k.replace("_split_digest", "_digest"))]
    if differ:
        print(f"ab_routed: the roots' outputs differ: {differ}")
        return 1
    bad = [(r["root"], k) for r in rows for k, v in r.items()
           if (k.endswith("_err_over_tol") and not v <= 1.0)
           or (k.endswith(("_repeats", "_equal")) and not v)]
    if bad:
        print(f"ab_routed: K3 or K18 disagrees with its plain version or "
              f"with itself: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
