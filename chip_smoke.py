#!/usr/bin/env python3
"""Drive the port's routed SpMV main path once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed on its own line:

  0. the card: torch's device name, and nvidia-smi's name and power limit;
  1. build native/libcvr_native.so and the Hopper kernels from the
     sources in this checkout (print the build time and ptxas' report);
  2. the main path: web-Google-like (R-MAT scale 20, ~6.2M nnz) -> CSR ->
     sell_pack_routed(hot="off") -> to_device_routed -> spmv_routed; check
     that every kernel of the path launched, verify against the float64
     golden at rtol 1e-6 (row-scaled), and time 100 iterations with CUDA
     events;
  3. each kernel against its plain PyTorch version at the main path's own
     tensors: expand, route_middle and route_small bit for bit,
     reduce_slices within 1e-6 of the row scale (it sums in another order);
     kernel time beside plain time, by CUDA events and as device time
     from a torch.profiler trace;
  4. nine smaller packs, each built to reach one branch of the slice (flat
     and recursive middles, several reduce groups, a w=16 regular region,
     two x segments, split-row extras, a row mask): spmv_routed on the
     card against the float64 golden and against its own CPU plain path;
  5. a JSON line of the kernels, then the last line
     {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero.  It needs a CUDA card
and the repository around it; it imports nothing of JAX.
"""

from __future__ import annotations

import json
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
EXACT = ("expand", "route_middle", "route_small")

# name, matrix, split_len, YB (None: the default), the branch its pack
# must reach.
GEOMETRIES = (
    ("rmat11", lambda: syn.rmat_matrix(11, 8, seed=2), None, None,
     lambda sr: sr.mid["kind"] == "flat"),
    ("banded", lambda: syn.banded_matrix(3000, 9), None, None,
     lambda sr: sr.nslA > 0),
    ("rmat_split16", lambda: syn.rmat_matrix(10, 12, seed=5), 16, None,
     lambda sr: sr.extra_src.shape[0] > 0),
    ("empty_rows_cols", syn.empty_rows_cols, 16, None,
     lambda sr: sr.ymask.shape[0] > 0),
    ("uniform_w16", syn.uniform_rows, None, None,
     lambda sr: (sr.regions[:, 3] == 16).any()),
    ("multisegment", syn.multisegment, None, None,
     lambda sr: sr.n_segs == 2),
    ("rmat12_yb2", lambda: syn.rmat_matrix(12, 8, seed=4), None, 2,
     lambda sr: len(sr.ycall_rows) > 1),
    ("rmat14_yb4", lambda: syn.rmat_matrix(14, 16, seed=4), None, 4,
     lambda sr: len(sr.ycall_rows) > 1 and sr.mid["kind"] == "rec"),
    ("rmat17_T2048", lambda: syn.rmat_matrix(17, 8, seed=4), None, None,
     lambda sr: sr.T == 2048 and sr.mid["kind"] == "rec"),
)


def device_ms(fn, iters: int) -> dict[str, float]:
    """Device time per call of ``fn``, by kernel name: the durations of the
    device events in a torch.profiler trace over ``iters`` calls (CUDA
    events around back-to-back calls also count the host, when enqueueing
    is the slower side).  Empty where the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.device_time / iters / 1e3
    return per


def geometry(sr) -> str:
    ya = sr.y_ra
    return (
        f"nnz {sr.nnz}, T {sr.T} tiles, middle {sr.mid['kind']!r} Tk "
        f"{sr.mid['Tk']}, y-route Tp {ya['Tp']} "
        f"{ya['mid_planes']['kind']!r}, {sr.nslices} slices in "
        f"{len(sr.ycall_rows)} reduce groups, {len(sr.regions)} regular "
        f"regions, zone A {sr.nslA} slices over {sr.zone_rows} plane rows, "
        f"{sr.n_segs} x segments, {sr.extra_src.shape[0]} split-row extras, "
        f"ymask {sr.ymask.shape[0]}, S_pad {sr.S_pad} plane rows"
    )


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


def main_path(coo, device):
    """Pack, upload, one verified SpMV with the launch counts, and the
    timed loop.  Returns (sd, x on the device, launches)."""
    csr = coo.to_csr()
    t0 = time.perf_counter()
    sr = sell_pack_routed(csr, hot="off")
    pack_s = time.perf_counter() - t0
    print(f"[2] pack {pack_s:.3f} s: {geometry(sr)}")
    if sr.mid["kind"] != "rec" or sr.y_ra["Tp"] != 1024:
        raise AssertionError("web-Google-like must pack to the recursive "
                             "middle and a y-route of Tp == 1024")
    sd = sp.to_device_routed(sr, device)
    x = np.random.default_rng(0).standard_normal(coo.shape[1]).astype(np.float32)
    xd = torch.from_numpy(x).to(device)

    rk.reset_launches()
    y = sp.spmv_routed(sd, xd)
    if y.is_cuda:
        torch.cuda.synchronize()
    launches = {k: w.launches for k, (w, _, _) in rk.KERNELS.items()}

    yn = y.cpu().numpy()
    if yn.shape != (coo.shape[0],) or not np.isfinite(yn).all():
        raise AssertionError(f"bad output: shape {yn.shape}")
    ok, nbad, maxrel = verify(yn, spmv_golden_numpy(csr, x), rtol=1e-6,
                              row_scale=spmv_row_scale(csr, x))
    print(f"[2] verify vs float64 golden (rtol 1e-6, row-scaled): "
          f"{'PASS' if ok else 'FAIL'}, {nbad} bad rows, max rel {maxrel:.3e}")
    if not ok:
        raise AssertionError("main path disagrees with the golden")
    print(f"[2] launches in the main path's run: {launches}")

    ms = time_iterations(lambda: sp.spmv_routed(sd, xd), ITERS, device) * 1e3
    print(f"[2] spmv_routed: {ms:.4f} ms/iter over {ITERS} iters, "
          f"{2 * sr.nnz / ms / 1e6:.3f} GFLOPS (2*nnz), "
          f"{sr.nnz / ms / 1e6:.3f} Gnnz/s")
    if y.is_cuda:
        per = device_ms(lambda: sp.spmv_routed(sd, xd), KERNEL_ITERS)
        dev = sum(per.values())
        ours = {k: sum(v for n, v in per.items() if f"{k}_kernel" in n)
                for k in rk.KERNELS}
        print(f"[2] spmv_routed device time {dev:.4f} ms/iter "
              f"(device busy {100 * dev / ms:.1f}% of the timed loop); "
              "in the same trace: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ours.items())
              + f", other device work {dev - sum(ours.values()):.4f} ms")
    return sd, xd, launches


def kernel_cases(sd, xd):
    """Each kernel's arguments at the main path's own tensors."""
    cases = {}
    cases["expand"] = (sd.w8, sd.gcls, sd.seg_blk, sd.li, xd, sd.segw,
                       sd.n_segs)
    g1 = rk.expand(*cases["expand"])
    if sd.mid.kind == "rec":
        cases["route_middle"] = (g1, sd.mid.m1, sd.mid.csel)
    m, m3 = sp.middle(sd, g1)
    cases["reduce_slices"] = (m, m3, sd.vals_ss, sd.p3, sd.red_row0,
                              sd.red_row1, sd.red_out, sd.red_fast,
                              sd.nslices)
    ysp = sp.y_stream(sd, sp.reduce(sd, m, m3))
    ra = sd.yroute
    cases["route_small"] = (ysp, ra.s1, ra.mid, ra.s3, ra.n)
    return cases


def check_kernels(sd, xd, launches, device):
    rows = []
    for name, args in kernel_cases(sd, xd).items():
        wrapper, plain, replaces = rk.KERNELS[name]
        got, want = wrapper(*args), plain(*args)
        if name in EXACT:
            same = torch.equal(got, want)
            verdict = "bit-exact" if same else "DIFFERS"
        else:
            m, m3, vals, *rest = args
            scale = plain(m.abs(), m3, vals.abs(), *rest)
            same = bool(((got - want).abs() <= 1e-6 * scale + 1e-30).all())
            verdict = "within 1e-6 of the row scale" if same else "DIFFERS"
        err = float((got - want).abs().max()) if got.numel() else 0.0
        ms = time_iterations(lambda: wrapper(*args), KERNEL_ITERS, device) * 1e3
        plain_ms = time_iterations(lambda: plain(*args), KERNEL_ITERS,
                                   device) * 1e3
        dms = pdms = None
        if got.is_cuda:
            dms = sum(device_ms(lambda: wrapper(*args), KERNEL_ITERS).values())
            pdms = sum(device_ms(lambda: plain(*args), KERNEL_ITERS).values())
        print(f"[3] {name}: {verdict}, max abs err {err:.3e}, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events); "
              f"device time kernel {dms} ms, plain {pdms} ms")
        if not same:
            raise AssertionError(f"{name} disagrees with its plain version")
        rows.append({
            "name": name, "route": "cuda", "source": rk.SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dms, "plain_device_ms": pdms,
        })
    return rows


def check_geometries(device) -> None:
    """Each of GEOMETRIES through spmv_routed on ``device``, against the
    float64 golden and against the CPU plain path of the same pack."""
    yb = rp.YB
    try:
        for name, make, split_len, case_yb, reaches in GEOMETRIES:
            rp.YB = case_yb or yb
            coo = make()
            csr = coo.to_csr()
            sr = sell_pack_routed(csr, split_len=split_len, hot="off")
            if not reaches(sr):
                raise AssertionError(f"{name}: pack misses its branch: "
                                     f"{geometry(sr)}")
            x = np.random.default_rng(7).standard_normal(
                coo.shape[1]).astype(np.float32)
            rk.reset_launches()
            y = sp.spmv_routed(sp.to_device_routed(sr, device),
                               torch.from_numpy(x).to(device)).cpu().numpy()
            launches = {k: w.launches for k, (w, _, _) in rk.KERNELS.items()}
            # CPU tensors take the plain versions and launch nothing.
            on_card = torch.device(device).type == "cuda"
            want = {k: int(on_card) for k in rk.KERNELS}
            want["route_middle"] &= int(sr.mid["kind"] == "rec")
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
            if not (ok and ok_cpu) or launches != want:
                raise AssertionError(f"{name}: spmv_routed on {device} "
                                     "disagrees or skipped a kernel")
    finally:
        rp.YB = yb


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
    sd, xd, launches = main_path(coo, "cuda")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    rows = check_kernels(sd, xd, launches, "cuda")
    del sd, xd
    check_geometries("cuda")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
