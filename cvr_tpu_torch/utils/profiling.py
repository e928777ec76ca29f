"""Profiling and tracing support: the program's record of its own spans,
and torch.profiler around a block.

The record is off by default.  ``recording()`` turns it on (as a plain
switch, or for a ``with`` block); while it is off, ``span`` returns one
shared no-op context, so the hot paths pay one global read.  While it is
on, each ``span(name)`` enters a record-function range of its name, so
that under a profiler the span sits on the device events' clock with the
launches made inside it as its children, and on closing appends one
tuple (name, detail, parent, sequence number, start and end on
``time.perf_counter_ns``) to an in-memory list; the span reads its clock
inside the range, so the profiler's own cost stays outside it.  A closed
span is a tuple of strings and integers, which the garbage collector
stops tracking, so a long record does not lengthen its collections.  A
span opened with no span around it (``spmv``, ``spmm``, ``load``,
``upload``) takes the next sequence number; the spans inside it share
it.  ``record()`` returns the closed spans, ``reset()`` clears them.

The range is torch's fast record function
(``torch._C._profiler._RecordFunctionFast``, the one torch's generated
code uses), a private API of torch that
``tests/test_torch_tracing.py`` holds to its contract: a host range like
an op's, where ``torch.profiler.record_function`` makes a user
annotation, which the profiler also copies onto the device's timeline
over the work launched inside it, so that a trace reader would count it
as device work and its gaps as busy; and it costs a fraction as much.

``trace()`` records the CPU and CUDA activity of the enclosed block, with
the record on, and writes a Chrome trace (open it in Perfetto or
chrome://tracing) under ``CVR_TPU_TRACE_DIR`` (default
/tmp/cvr_tpu_traces).  ``load_npz`` opens a saved artifact for the
loaders, a ``load.read`` span for each member they read.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

DEFAULT_TRACE_DIR = os.environ.get("CVR_TPU_TRACE_DIR", "/tmp/cvr_tpu_traces")

_on = False
# the closed spans: (id, name, detail, parent id, seq, start_ns, end_ns)
_spans: list[tuple] = []
_open: list[tuple[int, int]] = []  # (id, seq) of the spans still open
_next = 0  # the next span's id: its place in the opening order
_seq = 0


class Span(NamedTuple):
    """One closed span of the record; ``parent`` is the index of the span
    around it in the record's list (while no span is open), or None."""

    name: str
    detail: str | None
    parent: int | None
    seq: int
    start_ns: int
    end_ns: int


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("_name", "_detail", "_sync", "_rf", "_id", "_parent",
                 "_seq", "_start")

    def __init__(self, name, detail, sync):
        self._name, self._detail, self._sync = name, detail, sync

    def __enter__(self):
        global _next, _seq
        self._rf = torch._C._profiler._RecordFunctionFast(self._name)
        self._rf.__enter__()
        if _open:
            self._parent, self._seq = _open[-1]
        else:
            _seq += 1
            self._parent, self._seq = None, _seq
        self._id = _next
        _next += 1
        _open.append((self._id, self._seq))
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._sync is not None and torch.device(self._sync).type == "cuda":
            torch.cuda.synchronize(self._sync)
        end = time.perf_counter_ns()
        if _open and _open[-1][0] == self._id:
            _open.pop()
            _spans.append((self._id, self._name, self._detail, self._parent,
                           self._seq, self._start, end))
        self._rf.__exit__(*exc)
        return False


def span(name: str, detail: str | None = None, sync=None):
    """A named span of the program's record (see the module doc); while
    recording is off, the shared no-op context.  ``detail`` is kept
    beside the name (a kernel's symbol, a member's key).  With ``sync``
    a device, the span closes on ``torch.cuda.synchronize`` of it where
    it is a CUDA device, so that the device work issued inside it is
    inside it too (only while recording)."""
    if not _on:
        return _NULL
    return _Span(name, detail, sync)


def spanned(name: str, fn, *args, sync=None, **kw):
    """``fn(*args, **kw)`` inside ``span(name, sync=sync)``: for a call
    inside an expression, such as an argument list whose order is the
    order of the device's allocations."""
    with span(name, sync=sync):
        return fn(*args, **kw)


class _Switch:
    __slots__ = ("_was",)

    def __init__(self, was: bool):
        self._was = was

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _on
        _on = self._was
        return False


def recording(on: bool = True) -> _Switch:
    """Turn the record on (or off) now; used in a ``with`` statement, the
    previous state comes back at the block's end."""
    global _on
    was, _on = _on, bool(on)
    return _Switch(was)


def record() -> list[Span]:
    """The closed spans of the record, in the order they opened."""
    return [Span(*s[1:]) for s in sorted(_spans)]


def reset() -> None:
    """Clear the record (no span may be open)."""
    global _next, _seq
    _spans.clear()
    _open.clear()
    _next = _seq = 0


class _Npz:
    """A saved ``.npz`` artifact, read-only: ``files``, ``in``, ``[key]``
    and ``close`` as ``np.load``'s NpzFile has them.  While recording,
    each member read is a ``load.read`` span, its key as the detail."""

    __slots__ = ("_z",)

    def __init__(self, z):
        self._z = z

    @property
    def files(self) -> list[str]:
        return self._z.files

    def __contains__(self, key) -> bool:
        return key in self._z

    def __getitem__(self, key: str) -> np.ndarray:
        with span("load.read", key):
            return self._z[key]

    def close(self) -> None:
        self._z.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def load_npz(path) -> _Npz:
    """``np.load(path)`` of a saved ``.npz`` artifact, its member reads
    recorded (see _Npz)."""
    return _Npz(np.load(path))


@contextlib.contextmanager
def trace(name: str = "trace", trace_dir: str | None = None):
    """Capture a torch.profiler trace (CPU, and CUDA where torch has it)
    around the enclosed block, with the program's record on (its spans
    appear in the trace); yields the directory the trace goes to,
    ``<trace_dir>/<name>``, where ``trace.json`` is written on exit.

    Usage:
        with trace("spmv_web_google"):
            run_spmv_benchmark(...)
    """
    from torch.profiler import ProfilerActivity, profile

    out = Path(trace_dir or DEFAULT_TRACE_DIR) / name
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with recording(True), profile(activities=activities) as prof:
        yield str(out)
    prof.export_chrome_trace(str(out / "trace.json"))
