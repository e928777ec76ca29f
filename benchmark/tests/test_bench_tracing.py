"""The trace arithmetic on a made-up trace: the bracketed window, busy
time as a union, the program's own kernels by name, idle gaps."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark import program, tracing

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _ev(name, start, end, dev=CUDA):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_own_kernels_are_found_in_the_sources(tmp_path):
    own = tracing.own_kernels(program.package_dir())
    assert {"expand_kernel", "reduce_slices_kernel", "route_small_kernel",
            "lane_reduce_kernel", "lane_reduce_combine_kernel",
            "tileperm_kernel"} <= own
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "new.cu").write_text(
        "template <int K>\n__global__ void __launch_bounds__(256, 2)\n"
        "    new_fold_kernel(const float* x) {}\n")
    (tmp_path / "tk.py").write_text(
        "import triton\n\n@triton.jit\ndef fold_tile(x_ptr):\n    pass\n")
    assert tracing.own_kernels(tmp_path) == {"new_fold_kernel", "fold_tile"}


def test_kernel_names_from_demangled_events():
    assert tracing.kernel_name("void tileperm_kernel<false>(float const*)") \
        == "tileperm_kernel"
    assert tracing.kernel_name("expand_kernel(short const*, int)") \
        == "expand_kernel"
    assert tracing.kernel_name(
        "void at::native::(anonymous namespace)::indexSelectLargeIndex"
        "<float, long>(x)") == "indexSelectLargeIndex"


def test_read_a_bracketed_window():
    """The window runs from the first device event after the opening
    spins to the end of the last one before the closing spin; the host's
    lead-in and tail around it are returned apart, not as idle time."""
    own = frozenset({"expand_kernel", "reduce_slices_kernel"})
    events = [
        _ev("aten::index", 0, 5, dev=CPU),
        _ev("runner.window", 96, 210, dev=CPU),
        _ev("cudaStreamSynchronize", 151, 199, dev=CPU),
        _ev("expand_kernel(int)", 10, 20),  # before the bracket: left out
        _ev("void spin_kernel(long)", 90, 91),
        _ev("void spin_kernel(long)", 95, 96),
        _ev("expand_kernel(int)", 100, 110),
        _ev("reduce_slices_kernel(int)", 105, 130),  # overlaps the first
        _ev("void at::native::index_kernel<1>(int)", 140, 150),
        _ev("expand_kernel(int)", 170, 180),
        _ev("void spin_kernel(long)", 200, 260),
        _ev("void spin_kernel(long)", 300, 360),
    ]
    t = tracing.read(_Prof(events), own)
    assert abs(t["window_s"] - 80e-6) < 1e-12  # from 100 to 180
    assert abs(t["lead_s"] - 4e-6) < 1e-12  # 96 to 100
    assert abs(t["tail_s"] - 20e-6) < 1e-12  # 180 to 200
    assert abs(t["busy_s"] - 50e-6) < 1e-12  # 100-130, 140-150, 170-180
    assert abs(t["own_s"] - 45e-6) < 1e-12 and t["own_events"] == 3
    assert abs(t["device_s"] - 55e-6) < 1e-12
    names = [g[0] for g in t["gaps"]]
    # 150 to 170, the host in a synchronize at its middle
    assert names == ["cudaStreamSynchronize | before expand_kernel",
                     "runner.window | before at::native::index_kernel<1>"]
    b = tracing.breakdown(t)
    assert b["device_ops"][0] == ["reduce_slices_kernel", 25e-6]
    assert b["idle_gaps"][0][1] == 20e-6 and len(b["idle_gaps"]) == 2


def test_read_refuses_a_bracket_with_nothing_inside():
    import pytest

    events = [_ev("void spin_kernel(long)", 0, 1),
              _ev("void spin_kernel(long)", 50, 150)]
    with pytest.raises(RuntimeError):
        tracing.read(_Prof(events), frozenset())


def test_read_refuses_a_trace_without_its_bracket():
    import pytest

    with pytest.raises(RuntimeError):
        tracing.read(_Prof([_ev("expand_kernel(int)", 0, 1)]), frozenset())
