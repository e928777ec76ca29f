"""Benchmark harness: pre-processing time, SpMV time, GFLOPS, nnz/s.

N timed iterations of y = A @ x after a warm-up, the mean time per
iteration, throughput, and the greppable report: lines tagged
``Pre-processing``, ``SpMV Execution`` and ``Throughput``, then the
verification line.  GFLOPS is reported both ways, over true nnz: 2*nnz
(the CSR5 convention) and nnz/s.

On a CUDA device the SpMV time comes from CUDA events around the whole
run of iterations; on the CPU (``device="cpu"``, for smoke runs) from the
host clock, and the report then names the CPU.  The roofline share is
the nnz*8 bytes of the value and column streams over the device's HBM
bandwidth.
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
    device: str = ""

    def print_report(self) -> None:
        label = self.device
        print(
            f"[file: {self.name}] [threads: {label}] "
            f"Pre-processing Time: {self.preproc_s * 1e3:.3f} ms"
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


def _pack(csr, impl: str):
    """(packed artifact, padded nnz) of ``impl``'s format."""
    from cvr_tpu_torch.formats import pack_auto
    from cvr_tpu_torch.formats.bell import bell_pack
    from cvr_tpu_torch.formats.dia import dia_pack
    from cvr_tpu_torch.formats.sell import sell_pack
    from cvr_tpu_torch.formats.sell_routed import SellRouted, sell_pack_routed
    from cvr_tpu_torch.formats.sell_window import sell_pack_window

    packed = {
        "sell-xla": sell_pack,
        "auto": pack_auto,
        "sell-routed": sell_pack_routed,
        "dia": dia_pack,
        "bell": bell_pack,
        "sell-window": sell_pack_window,
    }[impl](csr)
    if isinstance(packed, SellRouted):
        return packed, packed.T * 1024
    return packed, packed.padded_nnz


def run_spmv_benchmark(
    coo,
    name: str = "matrix",
    impl: str = "sell-xla",
    iters: int = 100,
    device="cuda",
    verify_result: bool = True,
    x: np.ndarray | None = None,
) -> BenchResult:
    """End to end: convert (timed) -> SpMV iterations (timed) -> verify.

    impl "sell-xla" (the default, as in the JAX harness): the plain SELL
    planes (``sell_pack``) through ``sell_spmv``, torch ops; "auto":
    ``pack_auto``'s format (DIA, BELL, SELL-W, the routed path, or above
    its cap the plain SELL planes); "sell-routed", "dia", "bell",
    "sell-window": that format's pack and SpMV ("sell-routed" with the
    hub-column hybrid where its gate fires); "csr": plain torch CSR.
    """
    from cvr_tpu_torch.ops.spmv import spmv, upload
    from cvr_tpu_torch.ops.spmv_ref import (
        spmv_csr_torch,
        spmv_golden_numpy,
        spmv_row_scale,
        verify,
    )

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a CPU run")
    chip = detect_chip(dev)
    csr = coo.to_csr()
    nnz = csr.nnz
    if x is None:
        x = np.ones(csr.shape[1], dtype=np.float32)
    xd = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)

    if impl == "csr":
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
    elif impl in ("sell-xla", "auto", "sell-routed", "dia", "bell",
                  "sell-window"):
        t0 = time.perf_counter()
        packed, padded = _pack(csr, impl)
        preproc = time.perf_counter() - t0
        sd = upload(packed, dev)

        def fn():
            return spmv(sd, xd)
    else:
        raise ValueError(f"unknown impl {impl!r}")

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
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    )
