"""Profiling and tracing support: torch.profiler around a block.

``trace()`` records the CPU and CUDA activity of the enclosed block and
writes a Chrome trace (open it in Perfetto or chrome://tracing) under
``CVR_TPU_TRACE_DIR`` (default /tmp/cvr_tpu_traces); ``annotate()`` scopes
a named region, so converter phases and kernel launches are attributable
in the timeline.  The JAX package's on-demand profiling server has no
torch counterpart (``server``).
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

import torch

DEFAULT_TRACE_DIR = os.environ.get("CVR_TPU_TRACE_DIR", "/tmp/cvr_tpu_traces")


@contextlib.contextmanager
def trace(name: str = "trace", trace_dir: str | None = None):
    """Capture a torch.profiler trace (CPU, and CUDA where torch has it)
    around the enclosed block; yields the directory the trace goes to,
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
    with profile(activities=activities) as prof:
        yield str(out)
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """Named scope that shows up in profiler timelines (host and device)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def server(port: int = 9999):
    """The JAX package's on-demand profiling server
    (jax.profiler.start_server): torch.profiler has none, so this raises
    NotImplementedError; take a trace() around the code instead."""
    raise NotImplementedError(
        f"no on-demand profiling server in torch (port {port}): "
        "torch.profiler records only inside a trace(); use "
        "cvr_tpu_torch.utils.profiling.trace"
    )
    yield  # pragma: no cover
