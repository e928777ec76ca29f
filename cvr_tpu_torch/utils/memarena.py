"""Host-memory arena warming for lazily backed hosts.

On a host whose hypervisor backs guest memory lazily, the first write to
a fresh anonymous page costs ~100 us (the JAX package measured a 6M-nnz
routed pack at 12.4 s cold against 2.4 s warm on such a VM).  glibc's
default M_MMAP_THRESHOLD makes every numpy buffer over ~128 KB a fresh
mmap that is unmapped on free, so a converter pass re-pays that cost on
every large temporary.  The fix:

  1. mallopt(M_MMAP_THRESHOLD, 1 GB) / mallopt(M_TRIM_THRESHOLD, INT_MAX)
     so that large buffers come from the sbrk arena and stay there;
  2. touch the arena once, in a background thread (one ctypes memset,
     which releases the GIL).

``warm_if_lazy()`` (the CLI's entry) probes first and does nothing on a
host whose first touch runs at memory speed.  The port's own copy of the
JAX package's module: libc and ctypes only.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_ARENA_MAX = -8

_state: dict = {"thread": None, "bytes": 0, "seconds": 0.0, "enabled": None}
_lock = threading.Lock()


def _libc():
    return ctypes.CDLL(None, use_errno=True)


def arena_mb_default() -> int:
    """Arena size in MB (env CVR_ARENA_MB; 0 disables)."""
    return int(os.environ.get("CVR_ARENA_MB", "1536"))


def _warm_block(n: int) -> float:
    """Fault n bytes of the sbrk arena in; returns seconds.

    One malloc(n) would NOT work: any block over M_MMAP_THRESHOLD is
    mmap'd and munmap'd on free, warming nothing (measured: a 56 MB
    np.empty+fill still cost 1.46 s cold after a 1.5 GB single-block
    "warm").  Instead hold several sub-threshold blocks live at once so
    the heap top extends across the whole arena, memset each, then free
    them all — with M_TRIM_THRESHOLD raised the pages stay resident.
    """
    libc = _libc()
    libc.malloc.restype = ctypes.c_void_p
    libc.malloc.argtypes = [ctypes.c_size_t]
    libc.memset.restype = ctypes.c_void_p
    libc.memset.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t]
    libc.free.argtypes = [ctypes.c_void_p]
    t0 = time.perf_counter()
    chunk = 256 << 20
    ptrs = []
    left = n
    while left > 0:
        ptr = libc.malloc(min(chunk, left))
        if not ptr:
            break
        # memset releases the GIL for the whole sweep
        libc.memset(ptr, 0, min(chunk, left))
        ptrs.append(ptr)
        left -= chunk
    for ptr in ptrs:
        libc.free(ptr)
    return time.perf_counter() - t0


def warm(mb: int | None = None, block: bool = False) -> None:
    """Raise glibc thresholds and fault the arena in (async by default).

    Safe to call from anywhere, any number of times; only the first call
    does work.  With block=True, waits for the warm to finish.
    """
    with _lock:
        if _state["enabled"] is None:
            mb = arena_mb_default() if mb is None else mb
            _state["enabled"] = mb > 0
            if _state["enabled"]:
                libc = _libc()
                one_gb = 1 << 30
                int_max = (1 << 31) - 1
                libc.mallopt(_M_MMAP_THRESHOLD, one_gb)
                # Trim must exceed the ARENA size, not just be "large":
                # free() returns the top chunk to the OS whenever it
                # exceeds the threshold, and a 1 GB threshold un-warmed
                # the whole 1.5 GB arena on the spot (measured: 56 MB
                # np fill 1.46 s cold right after a "warmed" arena).
                libc.mallopt(_M_TRIM_THRESHOLD, int_max)
                # The warm runs in a background thread; without this,
                # glibc hands that thread its own (mmap'd) arena and
                # the main thread's sbrk heap stays cold.
                libc.mallopt(_M_ARENA_MAX, 1)
                n = mb * (1 << 20)
                _state["bytes"] = n

                def run():
                    _state["seconds"] = _warm_block(n)

                t = threading.Thread(
                    target=run, name="cvr-arena-warm", daemon=True
                )
                t.start()
                _state["thread"] = t
    if block:
        wait()


def lazy_backed(probe_mb: int = 8, min_gbps: float = 1.0) -> bool:
    """Probe whether this host backs fresh anonymous pages lazily.

    Writes one fresh mmap (not the heap: malloc could reuse warm pages)
    and compares the first-touch rate against min_gbps; a lazily backed
    VM runs at ~0.04 GB/s, bare metal at more than 5 GB/s.
    """
    import mmap as _mmap

    n = probe_mb << 20
    buf = _mmap.mmap(-1, n)
    t0 = time.perf_counter()
    buf.write(b"\0" * n)
    dt = time.perf_counter() - t0
    buf.close()
    return n / max(dt, 1e-9) < min_gbps * (1 << 30)


def warm_if_lazy() -> None:
    """warm(), but only on hosts that need it (the CLI's entry: any other
    host would pay for a pointless 1.5 GB allocation and memset sweep)."""
    if _state["enabled"] is None and lazy_backed():
        warm()


def wait() -> float:
    """Block until the arena warm (if any) finished; returns its seconds."""
    t = _state["thread"]
    if t is not None:
        t.join()
    return _state["seconds"]


def stats() -> dict:
    return {
        "arena_bytes": _state["bytes"],
        "warm_seconds": _state["seconds"],
        "done": _state["thread"] is None or not _state["thread"].is_alive(),
    }
