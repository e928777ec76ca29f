#!/usr/bin/env python3
"""Drive the port's routed SpMV paths once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed on its own lines:

  0. the card: torch's device name, and nvidia-smi's name and power limit;
  1. build native/libcvr_native.so and the Hopper kernels from the
     sources in this checkout (print the build time and ptxas' report);
  2. the main path: web-Google-like (R-MAT scale 20, ~6.2M nnz) -> CSR ->
     sell_pack_routed (the default hot="auto": its gate declines, no hot
     planes) -> to_device_routed -> spmv_routed; check that each kernel
     of the path launched as often as the pack says, verify against the
     float64 golden at rtol 1e-6 (row-scaled), and time 100 iterations
     with CUDA events;
  3. each of its kernels (K1-K4) against its plain PyTorch version at the
     main path's own tensors: expand, route_middle and route_small bit for
     bit, reduce_slices within 1e-6 of the row scale (it sums in another
     order); kernel time beside plain time, by CUDA events and as device
     time from a torch.profiler trace (alone, and inside the SpMV's trace
     of [2]), with the bound and, where one PyTorch call computes the
     same function, that call's time;
  4. smaller packs, each built to reach one branch (flat and recursive
     middles, several reduce groups, a w=16 regular region, two x
     segments, split-row extras, a row mask, wiki-Talk-like at full size
     with a y-route of 2048 tiles, hot planes with 4 gather windows, hot
     planes over several reduce groups, hot regular regions):
     spmv_routed on the card against the float64 golden and against its
     own CPU plain path;
  5. fsm-like at full size (2,097,152 rows, ~16.5M nnz): the hub-column
     hybrid (NH 256) and the y-route of 2048 tiles (K5, K2, K6, K5) as
     in [2]; then every kernel launch of that path (K1, K2 on the x and
     the y side, K3, K7, K5 at both stages, K6) against its plain version
     at its own tensors as in [3]; then the same matrix packed with
     hot="off", its SpMV timed beside the hybrid's;
  6. a JSON line of the seven kernels, then the last line
     {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero.  It needs a CUDA card
and the repository around it; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from cvr_tpu_torch import _native
from cvr_tpu_torch.bench import synthetic as syn
from cvr_tpu_torch.bench.harness import time_iterations
from cvr_tpu_torch.formats.sell_routed import sell_pack_routed
from cvr_tpu_torch.ops import _build
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops import route_planes as rp
from cvr_tpu_torch.ops import spmv_routed as sp
from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify

ITERS = 100
KERNEL_ITERS = 20
EXACT = ("expand", "route_middle", "route_small", "tileperm", "route_m3")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, 80 GB HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
FORCE_HOT = {"CVR_HOT": "1"}

# name, matrix, split_len, YB (None: the default), hot, environment of the
# pack, the branch its pack must reach.
GEOMETRIES = (
    ("rmat11", lambda: syn.rmat_matrix(11, 8, seed=2), None, None, "off",
     {}, lambda sr: sr.mid["kind"] == "flat"),
    ("banded", lambda: syn.banded_matrix(3000, 9), None, None, "off", {},
     lambda sr: sr.nslA > 0),
    ("rmat_split16", lambda: syn.rmat_matrix(10, 12, seed=5), 16, None,
     "off", {}, lambda sr: sr.extra_src.shape[0] > 0),
    ("empty_rows_cols", syn.empty_rows_cols, 16, None, "off", {},
     lambda sr: sr.ymask.shape[0] > 0),
    ("uniform_w16", syn.uniform_rows, None, None, "off", {},
     lambda sr: (sr.regions[:, 3] == 16).any()),
    ("multisegment", syn.multisegment, None, None, "off", {},
     lambda sr: sr.n_segs == 2),
    ("rmat12_yb2", lambda: syn.rmat_matrix(12, 8, seed=4), None, 2, "off",
     {}, lambda sr: len(sr.ycall_rows) > 1),
    ("rmat14_yb4", lambda: syn.rmat_matrix(14, 16, seed=4), None, 4, "off",
     {}, lambda sr: len(sr.ycall_rows) > 1 and sr.mid["kind"] == "rec"),
    ("rmat17_T2048", lambda: syn.rmat_matrix(17, 8, seed=4), None, None,
     "off", {}, lambda sr: sr.T == 2048 and sr.mid["kind"] == "rec"),
    ("wiki_talk_like", syn.wiki_talk_like, None, None, "auto", {},
     lambda sr: (sr.y_ra["Tp"] == 2048 and sr.hot is None
                 and sr.y_ra["mid_planes"]["kind"] == "rec"
                 and sr.extra_src.shape[0] > 0)),
    ("rmat15_hot512", lambda: syn.rmat_matrix(15, 8, seed=5), None, None,
     "auto", {**FORCE_HOT, "CVR_HOT_NH": "512"},
     lambda sr: (sr.hot is not None and sr.hot.ncand == 4
                 and np.unique(sr.hot.hgcls).shape[0] > 1)),
    ("rmat13_hot_yb2", lambda: syn.rmat_matrix(13, 8, seed=4), None, 2,
     "auto", FORCE_HOT,
     lambda sr: sr.hot is not None and len(sr.hot.ycall_rows) > 1),
    ("fsm17_hot_regions", lambda: syn.fsm_like(n=1 << 17), None, None,
     "auto", FORCE_HOT,
     lambda sr: sr.hot is not None and sr.hot.regions.shape[0] > 0),
)


TRACES = 3  # traces device_ms takes at most to find one that holds every call


def device_ms(fn, iters: int, marker: str | None) -> dict[str, float]:
    """Device time per call of ``fn``, by kernel name: the durations of the
    device events in a torch.profiler trace over ``iters`` calls (CUDA
    events around back-to-back calls also count the host, when enqueueing
    is the slower side).

    A trace can lose device events: those of its first calls, and now and
    then one or two calls' kernels in the middle.  So ``iters`` lead calls
    open the trace, only the events inside the range of the ``iters``
    calls after them count, and a trace counts only if it holds all of
    them: ``marker``, a kernel that one call launches once, ``iters`` times
    (None where ``fn`` launches no kernel of ours), and every device event
    a multiple of ``iters`` times, since each call launches the same
    kernels.  Up to TRACES traces are taken; it raises when none holds
    every call."""
    faults = []
    for _ in range(TRACES):
        per, count = _trace(fn, iters)
        seen = sum(c for n, c in count.items()
                   if marker is None or marker in n)
        uneven = {n: c for n, c in count.items() if c % iters}
        if count and not uneven and (marker is None or seen == iters):
            if faults:
                print(f"    (trace {len(faults) + 1} holds every call; "
                      f"the earlier lost device events: {faults})")
            return per
        faults.append(f"{marker} seen {seen} times of {iters}, "
                      f"{len(uneven)} kernels seen a count not a multiple "
                      f"of {iters}")
    raise AssertionError(f"{TRACES} traces of {iters} calls each lost "
                         f"device events: {faults}")


def _trace(fn, iters: int):
    """One trace of ``iters`` lead calls, then ``iters`` kept calls: (ms
    per kept call by device event name, the count of each name)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    kept = "chip_smoke.kept_calls"
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.001)
        with record_function(kept):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    dt = torch.autograd.DeviceType
    window = [e.time_range for e in events
              if e.name == kept and e.device_type == dt.CPU]
    if len(window) != 1:
        raise AssertionError(f"the trace holds {len(window)} ranges {kept}")
    t0, t1 = window[0].start, window[0].end
    per, count = {}, {}
    for e in events:
        # the range itself is also laid over the device timeline
        if (e.device_type == dt.CUDA and e.name != kept
                and t0 <= e.time_range.start <= t1):
            per[e.name] = per.get(e.name, 0.0) + e.device_time / iters / 1e3
            count[e.name] = count.get(e.name, 0) + 1
    return per, count


def hot_branches(hp) -> set[str]:
    """The row walks K7 takes on hot planes ``hp``: "regular" (regular
    regions) and "swept" (emissions outside every region)."""
    covered = np.zeros(hp.hemit.shape[0], dtype=bool)
    for _, r0, nr, _, _ in hp.regions:
        covered[r0 : r0 + nr] = True
    out = {"regular"} if len(hp.regions) else set()
    if ((hp.hemit >= 0) & ~covered).any():
        out.add("swept")
    return out


def geometry(sr) -> str:
    ya = sr.y_ra
    hp = sr.hot
    hot = "none" if hp is None else (
        f"NH {hp.NH} (ncand {hp.ncand}, classes "
        f"{sorted(set(hp.hgcls.tolist()))}), {hp.nslices} slices in "
        f"{len(hp.ycall_rows)} reduce groups, {len(hp.regions)} regular "
        f"regions, {hp.hemit.shape[0]} plane rows, K7 walks "
        f"{sorted(hot_branches(hp))}"
    )
    return (
        f"nnz {sr.nnz}, T {sr.T} tiles, middle {sr.mid['kind']!r} Tk "
        f"{sr.mid['Tk']}, y-route Tp {ya['Tp']} "
        f"{ya['mid_planes']['kind']!r}, {sr.nslices} slices in "
        f"{len(sr.ycall_rows)} reduce groups, {len(sr.regions)} regular "
        f"regions, zone A {sr.nslA} slices over {sr.zone_rows} plane rows, "
        f"{sr.n_segs} x segments, {sr.extra_src.shape[0]} split-row extras, "
        f"ymask {sr.ymask.shape[0]}, S_pad {sr.S_pad} plane rows; hot "
        f"planes: {hot}"
    )


def expected_launches(sr) -> dict[str, int]:
    """Launches of each kernel in one SpMV of pack ``sr`` on the card."""
    yrec = sr.y_ra["mid_planes"]["kind"] == "rec"
    return {
        "expand": 1,
        "route_middle": int(sr.mid["kind"] == "rec") + int(yrec),
        "reduce_slices": 1,
        "route_small": int(not yrec),
        "tileperm": 2 * int(yrec),
        "route_m3": int(yrec),
        "reduce_hot": int(sr.hot is not None),
    }


def read_launches() -> dict[str, int]:
    return {k: w.launches for k, (w, _, _) in rk.KERNELS.items()}


def build() -> None:
    t0 = time.perf_counter()
    how = _native.build()
    if not _native.available():
        raise RuntimeError("native/libcvr_native.so did not load")
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.load()
    print(f"[1] build: native ({how}) {t_native:.2f} s, kernels "
          f"{time.perf_counter() - t0:.2f} s ({_build.library_path().name})")
    for line in (_build.build_log or "").splitlines():
        if "ptxas info" in line:
            print(f"[1]   {line.strip()}")


def drive(tag, coo, device, reaches):
    """Pack (hot="auto"), check the branch, upload, one verified SpMV with
    the launch counts, and the timed loop.  Returns (sr, sd, x on the
    device, launches, ms per SpMV)."""
    csr = coo.to_csr()
    t0 = time.perf_counter()
    sr = sell_pack_routed(csr)
    pack_s = time.perf_counter() - t0
    phases = ", ".join(f"{k} {v:.3f}" for k, v in sr.convert_phases.items())
    print(f"{tag} pack {pack_s:.3f} s ({phases}): {geometry(sr)}")
    if not reaches(sr):
        raise AssertionError(f"{tag} pack misses its branch")
    sd = sp.to_device_routed(sr, device)
    x = np.random.default_rng(0).standard_normal(coo.shape[1]).astype(np.float32)
    xd = torch.from_numpy(x).to(device)

    rk.reset_launches()
    y = sp.spmv_routed(sd, xd)
    torch.cuda.synchronize()
    launches = read_launches()

    yn = y.cpu().numpy()
    if yn.shape != (coo.shape[0],) or not np.isfinite(yn).all():
        raise AssertionError(f"bad output: shape {yn.shape}")
    ok, nbad, maxrel = verify(yn, spmv_golden_numpy(csr, x), rtol=1e-6,
                              row_scale=spmv_row_scale(csr, x))
    print(f"{tag} verify vs float64 golden (rtol 1e-6, row-scaled): "
          f"{'PASS' if ok else 'FAIL'}, {nbad} bad rows, max rel {maxrel:.3e}")
    if not ok:
        raise AssertionError(f"{tag} disagrees with the golden")
    print(f"{tag} launches in this path's run: {launches}")
    if launches != expected_launches(sr):
        raise AssertionError(f"{tag} launches {launches}, the pack needs "
                             f"{expected_launches(sr)}")

    ms = time_iterations(lambda: sp.spmv_routed(sd, xd), ITERS, device) * 1e3
    print(f"{tag} spmv_routed: {ms:.4f} ms/iter over {ITERS} iters, "
          f"{2 * sr.nnz / ms / 1e6:.3f} GFLOPS (2*nnz), "
          f"{sr.nnz / ms / 1e6:.3f} Gnnz/s")
    per = device_ms(lambda: sp.spmv_routed(sd, xd), KERNEL_ITERS,
                    "expand_kernel")
    dev = sum(per.values())
    ours = {k: sum(v for n, v in per.items() if f"{k}_kernel" in n)
            for k in rk.KERNELS}
    print(f"{tag} spmv_routed device time {dev:.4f} ms/iter "
          f"(trace holds all {KERNEL_ITERS} calls; device busy "
          f"{100 * dev / ms:.1f}% of the timed loop); in the same trace: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ours.items() if v)
          + f", other device work {dev - sum(ours.values()):.4f} ms")
    return sr, sd, xd, launches, ms, ours


def main_path(coo, device):
    return drive(
        "[2]", coo, device,
        lambda sr: (sr.mid["kind"] == "rec" and sr.y_ra["Tp"] == 1024
                    and sr.hot is None),
    )


def kernel_cases(sd, xd):
    """Every kernel launch of one SpMV of ``sd``, in path order, as
    (kernel, which launch, its arguments at the path's own tensors)."""
    cases = []
    args = (sd.w8, sd.gcls, sd.seg_blk, sd.li, xd, sd.segw, sd.n_segs)
    cases.append(("expand", "", args))
    g1 = rk.expand(*args)
    if sd.mid.kind == "rec":
        cases.append(("route_middle", "x side", (g1, sd.mid.m1,
                                                 sd.mid.csel)))
    m, m3 = sp.middle(sd, g1)
    cases.append(("reduce_slices", "", (m, m3, sd.vals_ss, sd.p3,
                                        sd.red_row0, sd.red_row1,
                                        sd.red_out, sd.red_fast,
                                        sd.nslices)))
    ysp = sp.y_stream(sd, sp.reduce(sd, m, m3))
    if sd.hot_nslices:
        args = (xd[sd.hot_ids], sd.hidx, sd.hvals, sd.hot_row0,
                sd.hot_row1, sd.hot_out, sd.hot_nslices)
        cases.append(("reduce_hot", "", args))
        ysp[:, : sd.hot_nslices] += rk.reduce_hot(*args)
    ra = sd.yroute
    if ra.mid.kind == "flat":
        cases.append(("route_small", "", (ysp, ra.s1, ra.mid.mid, ra.s3,
                                          ra.n)))
    else:
        cases.append(("tileperm", "stage 1", (ysp, ra.s1)))
        g1y = rk.tileperm(ysp, ra.s1)
        cases.append(("route_middle", "y side", (g1y, ra.mid.m1,
                                                 ra.mid.csel)))
        mid = rk.route_middle(g1y, ra.mid.m1, ra.mid.csel)
        cases.append(("route_m3", "", (mid, ra.mid.m3)))
        cases.append(("tileperm", "stage 3", (rk.route_m3(mid, ra.mid.m3),
                                              ra.s3)))
    return cases


def row_scale_args(name, args):
    """The kernel's arguments with values and gathered data made
    nonnegative: the plain version then computes the row scale."""
    if name == "reduce_slices":
        m, m3, vals, *rest = args
        return (m.abs(), m3, vals.abs(), *rest)
    xh, hidx, hvals, *rest = args
    return (xh.abs(), hidx, hvals.abs(), *rest)


def bound(name, args, out) -> tuple[float, str]:
    """The least time (ms) the card could take for the kernel's work, and
    what sets it: each input byte read once and each output byte written
    once over the HBM rate, or the float32 operations over the card's
    rate outside the tensor cores.  The reduces read only the plane rows
    their slice tables name (this run's data)."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    ops = 0
    if name in ("reduce_slices", "reduce_hot"):
        row0, row1 = (args[4], args[5]) if name == "reduce_slices" else (
            args[3], args[4])
        used = int((row1.long() - row0.long()).sum()) * 8 * 128
        planes = args[:4] if name == "reduce_slices" else args[1:3]
        for t in planes:
            if t.dim() == 3:  # read only the used plane elements
                nbytes -= t.numel() * t.element_size()
                nbytes += min(used, t.numel()) * t.element_size()
        ops = 2 * used  # one multiply and one add per plane element
    nbytes += out.numel() * out.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_ms(name, args, device):
    """One PyTorch call computing the kernel's function on the same
    inputs, timed by CUDA events; None where no single call does.  Only
    tileperm has one: torch.gather over the flat (T, 1024) tile view
    (its inputs are laid out flat beforehand, outside the timing)."""
    if name != "tileperm":
        return None
    data, idx = args
    T = data.shape[1]
    df = rk.stream_to_flat(data).view(T, 1024)
    ixf = rk.stream_to_flat(idx).long().view(T, 1024)
    want = rk.stream_to_flat(rk.tileperm(data, idx)).view(T, 1024)
    if not torch.equal(torch.gather(df, 1, ixf), want):
        raise AssertionError("torch.gather is not tileperm's function")
    return time_iterations(lambda: torch.gather(df, 1, ixf), KERNEL_ITERS,
                           device) * 1e3


def check_kernels(tag, path, sd, xd, launches, spmv_dms, device):
    """Each kernel launch of the path (kernel_cases) against its plain
    version at the same inputs, with times, bound and library call.
    ``launches`` and ``spmv_dms`` (device ms per SpMV by kernel) come from
    the path's own run and trace."""
    rows = []
    cases = kernel_cases(sd, xd)
    launched = {k for k, n in launches.items() if n}
    if {name for name, _, _ in cases} != launched:
        raise AssertionError(f"{tag} cases {[c[:2] for c in cases]} miss "
                             f"kernels the path launched: {launched}")
    for name, which, args in cases:
        wrapper, plain, replaces = rk.KERNELS[name]
        label = f"{name} ({which})" if which else name
        got, want = wrapper(*args), plain(*args)
        if name in EXACT:
            same = torch.equal(got, want)
            verdict = "bit-exact" if same else "DIFFERS"
        else:
            scale = plain(*row_scale_args(name, args))
            same = bool(((got - want).abs() <= 1e-6 * scale + 1e-30).all())
            verdict = "within 1e-6 of the row scale" if same else "DIFFERS"
        err = float((got - want).abs().max()) if got.numel() else 0.0
        ms = time_iterations(lambda: wrapper(*args), KERNEL_ITERS, device) * 1e3
        plain_ms = time_iterations(lambda: plain(*args), KERNEL_ITERS,
                                   device) * 1e3
        dms = sum(device_ms(lambda: wrapper(*args), KERNEL_ITERS,
                            f"{name}_kernel").values())
        pdms = sum(device_ms(lambda: plain(*args), KERNEL_ITERS,
                             None).values())
        bound_ms, bound_by = bound(name, args, got)
        lib_ms = library_ms(name, args, device)
        print(f"{tag} {label}: {verdict}, max abs err {err:.3e}, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events); "
              f"device time kernel {dms:.4f} ms, plain {pdms:.4f} ms "
              f"(traces hold all {KERNEL_ITERS} calls); in the SpMV "
              f"{spmv_dms[name]:.4f} ms over {launches[name]} launches; "
              f"bound {bound_ms:.4f} ms ({bound_by}); library call "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}")
        if not same:
            raise AssertionError(f"{label} disagrees with its plain version")
        rows.append({
            "name": name, "route": "cuda", "source": rk.SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "path": path, "launch": which,
            "device_ms": dms, "plain_device_ms": pdms,
            "spmv_device_ms": spmv_dms[name],
        })
    return rows


def pack_with(csr, split_len, hot, env):
    """sell_pack_routed under the environment switches ``env``."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return sell_pack_routed(csr, split_len=split_len, hot=hot)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_geometries(device) -> set[str]:
    """Each of GEOMETRIES through spmv_routed on ``device``, against the
    float64 golden and against the CPU plain path of the same pack.
    Returns the K7 row walks the hot packs reached."""
    yb = rp.YB
    walks = set()
    try:
        for name, make, split_len, case_yb, hot, env, reaches in GEOMETRIES:
            rp.YB = case_yb or yb
            coo = make()
            csr = coo.to_csr()
            sr = pack_with(csr, split_len, hot, env)
            if not reaches(sr):
                raise AssertionError(f"{name}: pack misses its branch: "
                                     f"{geometry(sr)}")
            if sr.hot is not None:
                walks |= hot_branches(sr.hot)
            x = np.random.default_rng(7).standard_normal(
                coo.shape[1]).astype(np.float32)
            rk.reset_launches()
            y = sp.spmv_routed(sp.to_device_routed(sr, device),
                               torch.from_numpy(x).to(device)).cpu().numpy()
            launches = read_launches()
            # CPU tensors take the plain versions and launch nothing.
            y_cpu = sp.spmv_routed(sp.to_device_routed(sr, "cpu"),
                                   torch.from_numpy(x)).numpy()
            scale = spmv_row_scale(csr, x)
            ok, nbad, maxrel = verify(y, spmv_golden_numpy(csr, x),
                                      rtol=1e-6, row_scale=scale)
            ok_cpu, _, maxrel_cpu = verify(y, y_cpu, rtol=1e-6,
                                           row_scale=scale)
            print(f"[4] {name} (YB {rp.YB}): {geometry(sr)} | golden "
                  f"{'PASS' if ok else 'FAIL'} ({nbad} bad, max rel "
                  f"{maxrel:.2e}) | CPU plain path "
                  f"{'PASS' if ok_cpu else 'FAIL'} (max rel "
                  f"{maxrel_cpu:.2e}) | launches {launches}")
            if not (ok and ok_cpu) or launches != expected_launches(sr):
                raise AssertionError(f"{name}: spmv_routed on {device} "
                                     "disagrees or skipped a kernel")
    finally:
        rp.YB = yb
    return walks


def fsm_path(device, walks):
    """Phase [5]: fsm-like at full size through the hybrid and the
    2048-tile y-route, its kernels K5-K7, and the hot="off" comparison."""
    t0 = time.perf_counter()
    coo = syn.fsm_like()
    print(f"[5] fsm_like: {coo.shape[0]}x{coo.shape[1]}, {coo.nnz} nnz, "
          f"generated in {time.perf_counter() - t0:.2f} s")
    sr, sd, xd, launches, _ms, spmv_dms = drive(
        "[5]", coo, device,
        lambda sr: (sr.hot is not None and sr.hot.NH == 256
                    and sr.y_ra["Tp"] == 2048
                    and sr.y_ra["mid_planes"]["kind"] == "rec"
                    and sr.mid["kind"] == "rec"),
    )
    want = {"expand": 1, "route_middle": 2, "reduce_slices": 1,
            "route_small": 0, "tileperm": 2, "route_m3": 1, "reduce_hot": 1}
    if launches != want:
        raise AssertionError(f"[5] launches {launches}, want {want}")
    walks |= hot_branches(sr.hot)
    if walks != {"regular", "swept"}:
        raise AssertionError(f"K7 walked only {sorted(walks)} in [4] and [5]")
    rows = check_kernels("[5]", "fsm_like", sd, xd, launches, spmv_dms,
                         device)
    # the same matrix without the hybrid: data for the gate's constants
    t0 = time.perf_counter()
    sr_off = sell_pack_routed(coo.to_csr(), hot="off")
    pack_off = time.perf_counter() - t0
    sd_off = sp.to_device_routed(sr_off, device)
    times = {}
    for label, s in (("hot", sd), ("off", sd_off), ("off", sd_off),
                     ("hot", sd)):
        t = time_iterations(lambda: sp.spmv_routed(s, xd), ITERS, device)
        times.setdefault(label, []).append(t * 1e3)
    per_off = device_ms(lambda: sp.spmv_routed(sd_off, xd), KERNEL_ITERS,
                        "expand_kernel")
    print(f"[5] hot=auto (NH {sr.hot.NH}) vs hot=off, ms/iter over {ITERS} "
          f"iters in turns hot, off, off, hot: hot {times['hot']}, off "
          f"{times['off']}; off: pack {pack_off:.3f} s, T {sr_off.T} tiles, "
          f"device time {sum(per_off.values()):.4f} ms/iter; hot device "
          "time in [5] above")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[0] device: {kind}")
    print(f"[0] nvidia-smi: {smi}")
    build()
    t0 = time.perf_counter()
    coo = syn.web_google_like()
    print(f"[2] web_google_like: {coo.shape[0]}x{coo.shape[1]}, {coo.nnz} "
          f"nnz, generated in {time.perf_counter() - t0:.2f} s")
    _sr, sd, xd, launches, _ms, spmv_dms = main_path(coo, "cuda")
    rows = check_kernels("[3]", "web_google_like", sd, xd, launches,
                         spmv_dms, "cuda")
    del sd, xd
    walks = check_geometries("cuda")
    rows += fsm_path("cuda", walks)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
