"""Benchmark harness: pre-processing time, SpMV time, GFLOPS, nnz/s.

N timed iterations of y = A @ x after a warm-up, the mean time per
iteration, throughput, and the greppable report: lines tagged
``Pre-processing``, ``SpMV Execution`` and ``Throughput``, then the
verification line.  GFLOPS is reported both ways, over true nnz: 2*nnz
(the CSR5 convention) and nnz/s.

On a CUDA device the SpMV time comes from CUDA events around the whole
run of iterations (``time_iterations``); on the CPU (``device="cpu"``, for
smoke runs) from the host clock, and the report then names the CPU.  The
roofline share is the nnz*8 bytes of the value and column streams over
the device's HBM bandwidth.  ``device_ms`` gives a call's device time by
kernel from a torch.profiler trace (CUDA events also count the host
whenever it is the slower side).
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass

import numpy as np
import torch

# Per-device memory bandwidth (bytes/s) for roofline accounting
# (NVIDIA data sheets; the CPU entry is nominal, for smoke runs only).
HBM_BW = {
    "h100-sxm": 3.35e12,  # H100 SXM5, 80 GB HBM3
    "h100-pcie": 2.0e12,  # H100 PCIe, 80 GB HBM2e
    "cpu": 50e9,
}


def detect_chip(device) -> str:
    """HBM_BW key of ``device``, from torch.cuda.get_device_name."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(dev)
    if "H100" in name:
        return "h100-pcie" if "PCIe" in name else "h100-sxm"
    raise ValueError(f"no memory bandwidth entry for {name!r}")


@dataclass
class BenchResult:
    name: str
    impl: str
    nnz: int
    padded_nnz: int
    preproc_s: float
    spmv_s: float  # mean per iteration
    iters: int
    gflops_2nnz: float  # 2*nnz / t / 1e9
    gnnz_per_s: float  # nnz / t / 1e9
    roofline_frac: float
    amortize_iters: float  # preproc_s / spmv_s
    verified: bool | None = None
    max_rel_err: float | None = None
    nrows: int = 0
    ncols: int = 0
    # the first pack's time where pack_repeats > 1 (preproc_s is then the
    # least over the repeats: the first pack also pays the host's first
    # touch of its memory)
    preproc_first_s: float | None = None
    device: str = ""

    def print_report(self, threads_label: str | None = None) -> None:
        """The greppable report; its ``[threads: ...]`` tag names the
        device unless ``threads_label`` is given (``cli compare`` and the
        sweep give the impl)."""
        label = self.device if threads_label is None else threads_label
        first = (
            f" (min over repeats; first run {self.preproc_first_s * 1e3:.3f} ms)"
            if self.preproc_first_s is not None
            else ""
        )
        print(
            f"[file: {self.name}] [threads: {label}] "
            f"Pre-processing Time: {self.preproc_s * 1e3:.3f} ms{first}"
        )
        print(
            f"[file: {self.name}] [threads: {label}] "
            f"SpMV Execution Time: {self.spmv_s * 1e3:.6f} ms"
        )
        print(
            f"[file: {self.name}] [threads: {label}] "
            f"Throughput: {self.gflops_2nnz:.3f} GFlops (2*nnz), "
            f"{self.gnnz_per_s:.3f} Gnnz/s, "
            f"{100 * self.roofline_frac:.1f}% of HBM roofline"
        )
        if self.verified is not None:
            print(
                f"[file: {self.name}] Verification: "
                + ("PASS" if self.verified else "FAIL")
                + (
                    f" (max rel err {self.max_rel_err:.2e})"
                    if self.max_rel_err is not None
                    else ""
                )
            )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def time_iterations(fn, iters: int, device, warmup: int = 3) -> float:
    """Mean seconds per call of ``fn`` over ``iters`` calls, after
    ``warmup`` calls: CUDA events on a CUDA device, the host clock on the
    CPU."""
    dev = torch.device(device)
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


TRACES = 8  # traces device_ms takes at most to find one that holds every call
# torch.cuda._sleep's kernel marks the kept calls' range on the device's own
# timeline: OPEN_CYCLES spins open it, CLOSE_CYCLES spins (20 us and more)
# close it, each one launched with the card idle, and a trace that loses
# one spin of a kind still holds the range
BRACKET = "spin_kernel"
OPEN_CYCLES, CLOSE_CYCLES, SPINS = 1_000, 100_000, 2
CLOSE_MIN_MS = 0.02


def device_ms(fn, iters: int, marker: str | None,
              per_call: int = 1) -> dict[str, float]:
    """Device time per call of ``fn``, by kernel name: the durations of the
    device events in a torch.profiler trace over ``iters`` calls (CUDA
    events around back-to-back calls also count the host, when enqueueing
    is the slower side).

    A trace can lose device events, and its device timestamps, put on
    the host's clock, may stand off it by an amount that varies from trace
    to trace (on an H100 a range taken on the host's clock between idle
    margins of 20 ms held now none, now part, now more than all of the
    kept calls' kernels).  So ``iters`` lead
    calls open the trace, and the kept ``iters`` calls after them lie
    between SPINS short BRACKET kernels and SPINS long ones, each launched
    with the card idle; only the device events between the last short
    one and the first long one after it count, both on the device's
    timeline.  A trace counts only if it holds a spin of each kind and all
    of the kept calls: ``marker`` (a part of an event name, or a
    tuple of such), a kernel that one call launches ``per_call`` times,
    ``iters * per_call`` times (None where ``fn`` launches no kernel of
    ours), and every device event a multiple of ``iters`` times, since
    each call launches the same kernels.  Up to TRACES traces are taken;
    it raises when none holds every call."""
    faults = []
    for _ in range(TRACES):
        per, count = _trace(fn, iters)
        if isinstance(count, str):
            faults.append(f"the trace holds {count}")
            continue
        seen = sum(c for n, c in count.items()
                   if marker is None or is_event(n, marker))
        uneven = {n: c for n, c in count.items() if c % iters}
        if count and not uneven and (marker is None
                                     or seen == iters * per_call):
            if faults:
                print(f"    (trace {len(faults) + 1} holds every call; "
                      f"the earlier lost device events: {faults})")
            return per
        faults.append(f"{marker} seen {seen} times of {iters * per_call}, "
                      f"{len(uneven)} kernels seen a count not a multiple "
                      f"of {iters}")
    raise AssertionError(f"{TRACES} traces of {iters} calls each lost "
                         f"device events: {faults}")


def _trace(fn, iters: int):
    """One trace of ``iters`` lead calls, then ``iters`` kept calls between
    the spins that open and close their range (BRACKET): (ms per kept call
    by device event name, the count of each name), or (None, what it
    holds) where it lacks a spin of a kind, the closing one after the
    opening one."""
    from torch.profiler import ProfilerActivity, profile

    def spins(cycles):
        for _ in range(SPINS):
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        spins(OPEN_CYCLES)
        for _ in range(iters):
            fn()
        spins(CLOSE_CYCLES)
    dt = torch.autograd.DeviceType
    events = [e for e in prof.events() if e.device_type == dt.CUDA]
    marks = [e for e in events if BRACKET in e.name]
    opens = [e.time_range.start for e in marks
             if e.device_time / 1e3 < CLOSE_MIN_MS]
    closes = [e.time_range.start for e in marks
              if e.device_time / 1e3 >= CLOSE_MIN_MS]
    # a trace may also hold the spins of an earlier one, before its own
    closes = [t for t in closes if opens and t > max(opens)]
    if not opens or not closes:
        return None, f"{len(opens)} opening and {len(closes)} closing spins"
    t0, t1 = max(opens), min(closes)
    if any(t0 < e.time_range.start < t1 for e in marks):
        return None, "a spin between its own"
    per, count = {}, {}
    for e in events:
        if BRACKET not in e.name and t0 < e.time_range.start < t1:
            per[e.name] = per.get(e.name, 0.0) + e.device_time / iters / 1e3
            count[e.name] = count.get(e.name, 0) + 1
    return per, count


def is_event(event: str, names) -> bool:
    """Whether the device event ``event`` is one of ``names`` (a part of
    a name, or a tuple of such)."""
    return any(n in event for n in ((names,) if isinstance(names, str)
                                    else names))


# kernels of ours whose device events are not named "<kernel>_kernel": K5
# and K17 launch one instantiation each of tileperm_kernel, K2 one of two
# bodies (staged, or split: route_middle_m1_kernel first): kernel -> the
# names (a part of them) of its first pass's device events (the profiler
# demangles kernel names)
EVENTS = {"tileperm": ("tileperm_kernel<false>",),
          "groupperm": ("tileperm_kernel<true>",),
          "route_middle": ("route_middle_kernel", "route_middle_m1_kernel")}


# kernels of ours whose wrapper may launch a second pass (adding a split
# item's partials; K2's split body's chunk select): kernel -> the second
# pass's device events' name
SECOND = {"reduce_slices": "reduce_slices_combine_kernel",
          "reduce_slices_cols": "reduce_slices_cols_combine_kernel",
          "lane_reduce": "lane_reduce_combine_kernel",
          "pmm_spmm": "pmm_spmm_combine_kernel",
          "reduce_stream": "reduce_stream_combine_kernel",
          "route_middle": "route_middle_select_kernel"}


def event_of(name: str) -> tuple[str, ...]:
    """The names (a part of them) of kernel ``name``'s first pass's device
    events."""
    return EVENTS.get(name, (f"{name}_kernel",))


def by_kernel(per) -> dict[str, float]:
    """Device ms by kernel of ours (both passes where it has two), from
    device_ms's ms by event name."""
    from cvr_tpu_torch.ops import kernels

    return {k: sum(v for n, v in per.items()
                   if is_event(n, event_of(k))
                   or (k in SECOND and SECOND[k] in n))
            for k in kernels.KERNELS}


# the impls' other names, as the JAX harness takes them
IMPL_ALIASES = {"routed": "sell-routed", "window": "sell-window"}
# the impls that pack a format (pack_impl)
PACKED_IMPLS = ("sell-xla", "auto", "sell-routed", "dia", "bell",
                "sell-window")


def impl_name(impl: str) -> str:
    """The PACKED_IMPLS name ``impl`` runs, or "csr": as in the JAX
    harness, "routed" and "window" name "sell-routed" and "sell-window",
    and every other name that starts with "sell" (``sell``, ``sell-c128``)
    runs the plain SELL planes, as "sell-xla" does."""
    impl = IMPL_ALIASES.get(impl, impl)
    if impl in PACKED_IMPLS or impl == "csr":
        return impl
    if impl.startswith("sell"):
        return "sell-xla"
    raise ValueError(f"unknown impl {impl!r}")


def _timed_pack(fn, repeats: int = 1):
    """Run the pack ``repeats`` times; return (result, least seconds,
    first seconds).  The previous repeat's result is dropped before each
    pack, so that two never live at once on a full-scale matrix."""
    best = float("inf")
    first = None
    out = None
    for _ in range(max(1, repeats)):
        out = None
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        if first is None:
            first = dt
        best = min(best, dt)
    return out, best, first


def pack_impl(csr, impl: str, C: int | None = None, sigma: int = 0):
    """(packed artifact, padded nnz) of ``impl``'s format; C and sigma
    reach the plain SELL pack of impl "sell-xla".  As in the JAX
    harness, a BELL artifact counts its routed spill's stream under
    impl="bell" but not under impl="auto"."""
    from cvr_tpu_torch.formats import pack_auto
    from cvr_tpu_torch.formats.bell import BellMatrix, bell_pack
    from cvr_tpu_torch.formats.dia import dia_pack
    from cvr_tpu_torch.formats.sell import DEFAULT_C, sell_pack
    from cvr_tpu_torch.formats.sell_routed import SellRouted, sell_pack_routed
    from cvr_tpu_torch.formats.sell_window import sell_pack_window

    packed = {
        "sell-xla": lambda a: sell_pack(a, C=C or DEFAULT_C, sigma=sigma),
        "auto": pack_auto,
        "sell-routed": sell_pack_routed,
        "dia": dia_pack,
        "bell": bell_pack,
        "sell-window": sell_pack_window,
    }[impl](csr)
    if isinstance(packed, SellRouted):
        return packed, packed.T * 1024
    if impl == "auto" and isinstance(packed, BellMatrix):
        return packed, packed.k * packed.R_sub * 128
    return packed, packed.padded_nnz


def run_spmv_benchmark(
    coo,
    name: str = "matrix",
    impl: str = "sell-xla",
    iters: int = 100,
    C: int | None = None,
    sigma: int = 0,
    device="cuda",
    verify_result: bool = True,
    x: np.ndarray | None = None,
    pack_repeats: int = 1,
) -> BenchResult:
    """End to end: convert (timed) -> SpMV iterations (timed) -> verify.

    impl "sell-xla" (the default, as in the JAX harness): the plain SELL
    planes (``sell_pack``) through ``sell_spmv``, torch ops, as every
    other name that starts with "sell" ("sell", "sell-c128"); "auto":
    ``pack_auto``'s format (DIA, BELL, SELL-W, the routed path, or above
    its cap the plain SELL planes); "sell-routed", "dia", "bell",
    "sell-window": that format's pack and SpMV ("sell-routed" with the
    hub-column hybrid where its gate fires; "routed" and "window" name
    them too); "csr": plain torch CSR.  C (None: 1024) and sigma reach
    the plain SELL pack.  ``pack_repeats`` packs that many times: the
    result's preproc_s is the least, preproc_first_s the first (None at
    1).
    """
    from cvr_tpu_torch.ops.spmv import spmv, upload
    from cvr_tpu_torch.ops.spmv_ref import (
        spmv_csr_torch,
        spmv_golden_numpy,
        spmv_row_scale,
        verify,
    )
    from cvr_tpu_torch.utils import memarena

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a CPU run")
    chip = detect_chip(dev)
    name_run = impl_name(impl)
    # a lazily backed host makes cold numpy temporaries ~100x slow
    # (utils/memarena.py): warm the allocator arena before the pack timer
    memarena.warm()
    memarena.wait()
    csr = coo.to_csr()
    nnz = csr.nnz
    if x is None:
        x = np.ones(csr.shape[1], dtype=np.float32)
    xd = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)

    if name_run == "csr":
        preproc_first = None
        t0 = time.perf_counter()
        rowptr = torch.from_numpy(csr.rowptr).to(dev)
        cols = torch.from_numpy(csr.cols.astype(np.int64)).to(dev)
        vals = torch.from_numpy(csr.vals.astype(np.float32)).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        preproc = time.perf_counter() - t0
        padded = nnz
        nrows = csr.shape[0]

        def fn():
            return spmv_csr_torch(rowptr, cols, vals, xd, nrows)
    else:
        (packed, padded), preproc, preproc_first = _timed_pack(
            lambda: pack_impl(csr, name_run, C, sigma), pack_repeats)
        sd = upload(packed, dev)
        del packed

        def fn():
            return spmv(sd, xd)

    spmv_s = time_iterations(fn, iters, dev)
    y = fn().cpu().numpy()

    ok = max_rel = None
    if verify_result:
        ok, _nbad, max_rel = verify(
            y, spmv_golden_numpy(csr, x), rtol=1e-6,
            row_scale=spmv_row_scale(csr, x),
        )
    return BenchResult(
        name=name,
        impl=impl,
        nnz=nnz,
        padded_nnz=padded,
        preproc_s=preproc,
        spmv_s=spmv_s,
        iters=iters,
        gflops_2nnz=2 * nnz / spmv_s / 1e9,
        gnnz_per_s=nnz / spmv_s / 1e9,
        roofline_frac=(nnz * 8.0 / spmv_s) / HBM_BW[chip],
        amortize_iters=preproc / spmv_s if spmv_s > 0 else float("inf"),
        verified=ok,
        max_rel_err=max_rel,
        nrows=csr.shape[0],
        ncols=csr.shape[1],
        preproc_first_s=preproc_first if pack_repeats > 1 else None,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    )
