"""The traced window: device time by kernel, busy and idle time, gaps.

The window's range is marked on the device's own timeline, as the
program's ``bench/harness.py:_trace`` marks it (a frozen copy of that
arithmetic): ``torch.cuda._sleep`` spins launched with the card idle,
short ones before the traced products and long ones after them; only
device events between the last short spin and the first long one count,
and the window runs from the first of them to the end of the last.

The program's own kernels are the ``__global__`` functions of the
package's ``csrc/*.cu`` and the ``@triton.jit`` functions of its Python
files, found when the run reads the trace, so a kernel that a later
change adds is counted as the program's without an edit here.
"""

from __future__ import annotations

import re
from pathlib import Path

BRACKET = "spin_kernel"
OPEN_CYCLES, CLOSE_CYCLES, SPINS = 1_000, 100_000, 2
CLOSE_MIN_US = 20.0

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")


def own_kernels(package: Path) -> frozenset[str]:
    """The names of the kernels the package's sources define."""
    names = set()
    for cu in package.rglob("*.cu"):
        names.update(_GLOBAL.findall(cu.read_text(errors="replace")))
    for py in package.rglob("*.py"):
        text = py.read_text(errors="replace")
        if "triton.jit" in text:
            names.update(_TRITON.findall(text))
    return frozenset(names)


def _plain(event: str) -> str:
    s = event.strip().replace("(anonymous namespace)", "anon")
    return s[5:] if s.startswith("void ") else s


def kernel_name(event: str) -> str:
    """The function's own name in a demangled device event name:
    ``void ns::f<true>(int, float*)`` -> ``f``."""
    s = _plain(event)
    cut = min((i for i in (s.find("("), s.find("<")) if i >= 0),
              default=len(s))
    return s[:cut].split("::")[-1].strip()


def short(event: str) -> str:
    """A device event's name without its argument list (at most 120
    characters)."""
    s = _plain(event)
    return (s[:s.find("(")] if "(" in s else s).strip()[:120]


def spins(cycles: int) -> None:
    import torch

    for _ in range(SPINS):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
    torch.cuda.synchronize()


def traced(lead, window):
    """Run ``lead()`` and then ``window()`` (which issues the traced
    products) under torch.profiler, the window between the bracket's
    spins; return the profile.  The lead products open the trace: a
    trace can lose its first device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead()
        spins(OPEN_CYCLES)
        window()
        spins(CLOSE_CYCLES)
    return prof


def read(prof, own: frozenset[str]) -> dict:
    """What the trace says of the bracketed window: its length, the busy
    time (the union of device events), device seconds by event name,
    those of the program's own kernels, and the ten longest idle gaps,
    each named by what the host was doing in its middle and the device
    op that ended it.  The window runs from the start of the first
    device event after the opening spins to the end of the last one
    before the closing spin, so that the host's time to issue the first
    product after the bracket opens, and to reach the closing spin after
    the last, is not counted as idle; those two stretches are returned
    apart (``lead_s``, ``tail_s``).  Raises where the trace lacks a spin
    of either kind or any device event between them."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    dev = [e for e in events if e.device_type == cuda]
    marks = [e for e in dev if BRACKET in e.name]
    opens = [e for e in marks
             if e.time_range.end - e.time_range.start < CLOSE_MIN_US]
    closes = [e for e in marks
              if e.time_range.end - e.time_range.start >= CLOSE_MIN_US]
    if not opens or not closes:
        raise RuntimeError(f"the trace holds {len(opens)} opening and "
                           f"{len(closes)} closing spins")
    t0 = max(e.time_range.end for e in opens)
    later = [e.time_range.start for e in closes if e.time_range.start > t0]
    if not later:
        raise RuntimeError("no closing spin after the opening ones")
    t1 = min(later)
    inside = sorted((e for e in dev if BRACKET not in e.name
                     and t0 <= e.time_range.start < t1),
                    key=lambda e: e.time_range.start)
    if not inside:
        raise RuntimeError("no device event inside the bracket")
    w0 = inside[0].time_range.start
    w1 = min(t1, max(e.time_range.end for e in inside))
    by_name, own_s, own_n = {}, 0.0, 0
    busy, gaps = 0.0, []
    cur = w0  # the end of the busy time so far (us)
    for e in inside:
        s, f = e.time_range.start, min(e.time_range.end, w1)
        d = (e.time_range.end - s) / 1e6
        by_name[e.name] = by_name.get(e.name, 0.0) + d
        if kernel_name(e.name) in own:
            own_s += d
            own_n += 1
        if s > cur:
            gaps.append((cur, s, short(e.name)))
        if f > cur:
            busy += (f - max(s, cur)) / 1e6
            cur = f
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if e.device_type != cuda]
    named = [(f"{_host_op(host, (a + b) / 2)} | before {nxt}", (b - a) / 1e6)
             for a, b, nxt in gaps[:10]]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy,
        "lead_s": (w0 - t0) / 1e6,
        "tail_s": (t1 - w1) / 1e6,
        "device_s": sum(by_name.values()),
        "own_s": own_s,
        "own_events": own_n,
        "by_name": by_name,
        "gaps": named,
        "events": len(inside),
    }


def _host_op(host, t: float) -> str:
    """The innermost host event (an op, a runtime call) running at time
    ``t`` (us), or "host idle"."""
    inner = None
    for e in host:
        a, b = e.time_range.start, e.time_range.end
        if a <= t <= b and (inner is None or b - a < inner[1] - inner[0]):
            inner = (a, b, e.name)
    return inner[2] if inner else "host idle"


def breakdown(t: dict) -> dict:
    """The ten device ops that took most time and the ten longest idle
    gaps, [name, seconds] each."""
    ops = {}
    for name, s in t["by_name"].items():
        ops[short(name)] = ops.get(short(name), 0.0) + s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in t["gaps"]]}
