"""The work counts, the least time and each metric's reader."""

from __future__ import annotations

import pytest

from benchmark import spec, work

GRAPH500_S21 = (2_097_152, 63_540_720)
HPCG_256 = (256 ** 3, 449_455_096)  # nnz (3 * 256 - 2) ** 3


def test_graph500_s21_spmv_counts():
    n, nnz = GRAPH500_S21
    assert work.bytes_moved(n, n, nnz, 1) == 270_940_096
    assert work.flops(nnz, 1) == 127_081_440
    assert work.least_seconds(n, n, nnz, 1) == pytest.approx(0.080878e-3,
                                                              rel=1e-4)


def test_graph500_s21_spmm_k8_counts():
    n, nnz = GRAPH500_S21
    assert work.bytes_moved(n, n, nnz, 8) == 388_380_608
    assert work.flops(nnz, 8) == 1_016_651_520
    assert work.least_seconds(n, n, nnz, 8) == pytest.approx(0.115935e-3,
                                                              rel=1e-4)


def test_graph500_s21_spmm_k128_counts():
    n, nnz = GRAPH500_S21
    assert work.bytes_moved(n, n, nnz, 128) == 2_401_646_528
    # bound by bytes: the operations take 0.243 ms at 67 TFLOP/s
    assert work.flops(nnz, 128) / 67e12 == pytest.approx(0.24278e-3,
                                                         rel=1e-4)
    assert work.least_seconds(n, n, nnz, 128) == pytest.approx(0.716909e-3,
                                                                rel=1e-4)


def test_bytes_are_a_least_for_every_format():
    """Each stored value once, X once, Y once, no index: HPCG's 27-point
    stencil at 256^3 counts fewer bytes than the DIA kernel K8 reads (27
    bands of 4 B a row, x and y once), so DIA cannot read above 100%."""
    n, nnz = HPCG_256
    assert work.bytes_moved(n, n, nnz, 1) == \
        4 * nnz + 4 * n + 4 * n == 1_932_038_112
    assert work.least_seconds(n, n, nnz, 1) == pytest.approx(0.57673e-3,
                                                              rel=1e-4)
    dia_k8 = 27 * 4 * n + 4 * n + 4 * n
    assert dia_k8 == 1_946_157_056
    assert work.bytes_moved(n, n, nnz, 1) < dia_k8


def test_roofline_pct_of_a_given_device_time():
    n, nnz = GRAPH500_S21
    read = spec.reader("roofline_pct")
    ctx = {"least_s": work.least_seconds(n, n, nnz, 1), "products": 100,
           "trace": {"device_s": 100 * 1.6e-3}}
    assert read(ctx) == pytest.approx(5.0549, abs=0.001)


def _trace_ctx():
    return {"products": 10, "least_s": 1e-4, "launches": 40,
            "flops": 2e6, "spans": {"load": 3.0, "upload": 0.5},
            "enqueue_s": [3e-4, 1e-4, 2e-4],
            "trace": {"window_s": 0.02, "busy_s": 0.019, "device_s": 0.018,
                      "own_s": 0.015, "own_events": 40}}


@pytest.mark.parametrize("name, want", [
    ("kernel_ms", 1.5), ("glue_ms", 0.3), ("launches", 4.0),
    ("roofline_pct", 100 * 1e-4 / 1.8e-3), ("idle_pct", 5.0),
    ("enqueue_ms", 0.2), ("load_s", 3.5),
])
def test_per_layer_readers(name, want):
    assert spec.reader(name)(_trace_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["kernel_ms", "glue_ms", "launches",
                                  "roofline_pct", "idle_pct", "enqueue_ms",
                                  "load_s", "gflops"])
def test_readers_return_nothing_where_nothing_was_read(name):
    assert spec.reader(name)({"spans": {}, "products": 0}) is None


def test_end_to_end_readers():
    ctx = {"flops": 2e9, "products": 300, "window_s": 2.0, "setup_s": 21.5,
           "spans": {}}
    assert spec.reader("gflops")(ctx) == pytest.approx(300.0)
    assert spec.reader("setup_s")(ctx) == 21.5
