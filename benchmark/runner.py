"""One run of one cell: set-up, the window, the reference, the line.

The traffic file says what the window does: ``op`` (``spmv`` or
``spmm``) at ``rhs`` columns, over ``inputs`` dense inputs drawn from
N(0, 1) on the card from ``--seed`` in set-up and used in turn, the
products issued back to back by one caller with no synchronize inside
the window, which closes on ``torch.cuda.synchronize()``.
``check_samples`` outputs of the window are kept (positions drawn from
the seed, and always the last) and compared, once the window has closed
and the program's state is freed, with the plain float64 reference.

Untraced, the line holds the cell's end-to-end metrics; traced
(``--trace 1``), its per-layer metrics, read from the host's spans, the
program's launch counter, the enqueue of ``enqueue_samples`` products
each issued right after a synchronize, and a trace of ``trace_products``
products.  Each metric is computed by its own reader,
``metrics/<name>.py``, from the context this module gathers.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from benchmark import matrix as mx
from benchmark import program, reference, spec, tracing, work

FORBIDDEN = ("jax", "jaxlib", "flax", "cvr_tpu")
TRACE_TRIES = 4


class NoDevice(RuntimeError):
    """The run lacks the cards its cell asks for."""


class TraceMismatch(RuntimeError):
    """No trace of the traced products held as many device events of the
    program's kernels as the program counted launches."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is one of
    FORBIDDEN (``cvr_tpu_torch`` is not ``cvr_tpu``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _device(chips: int, device: str):
    import torch

    if device != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} CUDA device(s); "
                       f"available: {torch.cuda.is_available()}, "
                       f"count {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _inputs(n: int, K: int, count: int, seed: int, dev):
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed % (1 << 63))
    shape = (n,) if K == 1 else (n, K)
    return [torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
            for _ in range(count)]


def positions(seed: int, count: int, expected: int) -> set[int]:
    """``count`` - 1 output positions in [0, expected), drawn from the
    seed (the window's last output is always kept besides)."""
    rng = np.random.default_rng(seed)
    return {int(f * expected) for f in rng.random(max(0, count - 1))}


def _power_limit() -> str | None:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", root=spec.ROOT,
        cache=mx.CACHE) -> dict:
    """One run of the cell; the result's dict (without printing).
    ``t_start`` is the process's start on ``time.perf_counter``'s clock;
    ``root`` the checkout whose ``BENCHMARK.json`` and ``benchmark/``
    files name the cell."""
    spans = {"start": time.perf_counter() - t_start}
    t = time.perf_counter()
    import torch

    here = root / "benchmark"
    manifest = spec.load(root / "BENCHMARK.json")
    cell = spec.cell(manifest, cell_name)
    config = spec.config(manifest, cell["config"], root)
    mix = spec.traffic(cell["traffic"], here)
    limits = spec.limits(cell_name, here)
    dev = _device(cell["chips"], device)
    torch.empty(1, device=dev)  # the device's context
    op, K = mix["op"], mix["rhs"]
    n = config["expect"]["rows"]
    nnz = config["expect"]["nnz"]
    spans["torch"] = time.perf_counter() - t

    sd, m = program.set_up(config, op, K, dev, spans, cache)
    t = time.perf_counter()
    xs = _inputs(n, K, mix["inputs"], seed, dev)
    call = program.product(op)
    R = len(xs)
    _sync(dev)
    spans["inputs"] = time.perf_counter() - t

    # warm-up (the first launch loads, or builds, the kernel library),
    # then a timed stretch of every input for the window's length
    t = time.perf_counter()
    for i in range(mix["warmup_products"]):
        call(sd, xs[i % R])
    _sync(dev)
    spans["warmup"] = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(R):
        y = call(sd, xs[i % R])
    _sync(dev)
    per_product = (time.perf_counter() - t) / R
    # room in the allocator's cache for the outputs the window keeps, so
    # that keeping one costs no cudaMalloc inside the window
    room = [torch.empty_like(y) for _ in range(mix["check_samples"] + 1)]
    del room, y

    ctx = {"spans": spans, "flops": work.flops(nnz, K),
           "least_s": work.least_seconds(n, n, nnz, K)}
    kept = {}
    if not trace:
        expected = max(1, int(0.8 * seconds / per_product))
        want = positions(seed, mix["check_samples"], expected)
        i, y = 0, None
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            y = call(sd, xs[i % R])
            if i in want:
                kept[i] = y
            i += 1
            if time.perf_counter() >= end:
                break
        kept[i - 1] = y
        del y
        _sync(dev)
        t1 = time.perf_counter()
        ctx.update(setup_s=t0 - t_start, window_s=t1 - t0, products=i)
        attempted = i
    else:
        enq = []
        for i in range(mix["enqueue_samples"]):
            _sync(dev)
            t = time.perf_counter()
            call(sd, xs[i % R])
            enq.append(time.perf_counter() - t)
        _sync(dev)
        ctx["enqueue_s"] = enq
        count = mix["trace_products"]
        want = positions(seed, mix["check_samples"], count)
        own = tracing.own_kernels(program.package_dir())
        for attempt in range(1, TRACE_TRIES + 1):
            kept.clear()

            def lead():
                for j in range(R):
                    call(sd, xs[j])

            def window():
                program.reset_launches()
                for j in range(count):
                    y = call(sd, xs[j % R])
                    if j in want or j == count - 1:
                        kept[j] = y
                ctx["launches"] = program.launches()

            tr = tracing.read(tracing.traced(lead, window), own)
            ctx["trace_tries"] = attempt
            if tr["own_events"] == ctx["launches"]:
                break
            print(f"trace {attempt}: {tr['own_events']} device events "
                  f"of the program's kernels for {ctx['launches']} "
                  "launches", file=sys.stderr)
        else:
            raise TraceMismatch(
                f"{TRACE_TRIES} traces each lost or gained device events "
                "of the program's kernels against its launch counter")
        ctx.update(trace=tr, products=count)
        attempted = count

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0)}
    if trace:
        device_info.update(busy_s=ctx["trace"]["busy_s"],
                           window_s=ctx["trace"]["window_s"])

    # the program's state goes before the reference runs on the card
    del sd, call
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    if m is None:
        m, _ = mx.load(config, cache)
    rows, cols = (torch.from_numpy(a).to(dev, torch.int64)
                  for a in (m.rows, m.cols))
    vals = torch.from_numpy(m.vals).to(dev)
    gaps = {}
    for r in range(R):  # one reference an input, every output of it
        mine = [i for i in sorted(kept) if i % R == r]
        if mine:
            ref, scale = reference.reference(rows, cols, vals, xs[r], m.n)
            for i in mine:
                gaps[i] = reference.gap(kept.pop(i), ref, scale)
            del ref, scale
    del rows, cols, vals, xs
    _sync(dev)
    ctx["reference_s"] = time.perf_counter() - t
    widest = max(gaps.values())
    limit = limits["widest_gap"]
    failed = sum(1 for g in gaps.values() if not g <= limit)

    metrics = {}
    for meta in spec.metrics_of(manifest, cell_name, trace):
        v = spec.reader(meta["name"], here)(ctx)
        if v is not None:
            metrics[meta["name"]] = {"value": v, "unit": meta["unit"]}
    if dev.type == "cuda":
        device_info["power_limit"] = _power_limit()
    result = {"correct": failed == 0,
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = tracing.breakdown(ctx["trace"])
    result["compared"] = {
        "widest_gap": {"value": widest, "limit": limit},
    }
    result["_context"] = {"spans": spans, "reference_s": ctx["reference_s"],
                          "gaps": {str(k): v for k, v in gaps.items()}}
    if trace:
        result["_context"].update(
            trace_tries=ctx["trace_tries"],
            bracket_lead_s=ctx["trace"]["lead_s"],
            bracket_tail_s=ctx["trace"]["tail_s"])
    return result


def emit(result: dict) -> int:
    """Print the compared numbers as the last lines of standard error and
    the result as the last line of standard output; the exit code."""
    extra = result.pop("_context", {})
    print(json.dumps(extra), file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
