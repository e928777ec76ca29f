"""The program's record (cvr_tpu_torch.utils.profiling): off by default
and free there, its spans while on, under torch.profiler, and the spans
of the artifact load, the upload's plans and the products of a routed,
a lane and a DIA artifact, at test size on the CPU (the DIA product's
launch span also on a card).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tracing.py -q
"""

from __future__ import annotations

import contextlib
import gc
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import matrix as mx
from cvr_tpu_torch import cli
from cvr_tpu_torch.bench import synthetic as tsyn
from cvr_tpu_torch.formats import pack_auto
from cvr_tpu_torch.formats.coo import COOMatrix
from cvr_tpu_torch.formats.sell_routed import sell_pack_routed
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops.spmm_lane import spmm_lane_pack
from cvr_tpu_torch.ops.spmv import spmm, spmv, upload
from cvr_tpu_torch.utils import profiling as prof


@pytest.fixture(autouse=True)
def clean_record():
    prof.recording(False)
    prof.reset()
    yield
    prof.recording(False)
    prof.reset()


@pytest.fixture(scope="module")
def coo():
    return tsyn.rmat_matrix(scale=10, edge_factor=8, seed=5, cache=False)


@pytest.fixture(scope="module")
def saved(coo, tmp_path_factory):
    """name -> (path of the saved artifact, the artifact, K of its product:
    0 for an SpMV); ``dia`` is HPCG's problem at 8^3."""
    d = tmp_path_factory.mktemp("artifacts")
    rows, cols, vals, n = mx.generator("hpcg27").make(8, 8, 8)
    hpcg = COOMatrix(rows=rows, cols=cols, vals=vals, shape=(n, n))
    out = {}
    for name, host, K in (
            ("routed", sell_pack_routed(coo.to_csr(), hot="off"), 0),
            ("lane", spmm_lane_pack(coo.to_csr()), 16),
            ("dia", pack_auto(hpcg.to_csr()), 0)):
        path = str(d / f"{name}.npz")
        cli.save_packed(host, path)
        out[name] = (path, host, K)
    return out


def _names(rec):
    return [s.name for s in rec]


def _product(sd, K, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    if K == 0:
        return spmv(sd, torch.randn(n, generator=g))
    return spmm(sd, torch.randn(n, K, generator=g))


def test_off_span_is_one_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record function called while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    a, b = prof.span("spmv"), prof.span("launch", "cvr_expand", sync="cpu")
    assert a is b
    with a, b:
        pass
    assert prof.record() == []


def test_off_by_default_and_switch_restores():
    assert prof.span("x") is prof.span("y")
    with prof.recording():
        assert prof.span("x") is not prof.span("x")
        with prof.recording(False):
            assert prof.span("x") is prof.span("y")
        assert prof.span("x") is not prof.span("y")
    assert prof.span("x") is prof.span("y")
    prof.recording(True)  # a plain switch as well
    assert prof.span("x") is not prof.span("y")


def test_nested_spans_keep_parents_and_sequence():
    with prof.recording():
        with prof.span("spmv"):
            with prof.span("routed.reduce"):
                with prof.span("launch", "cvr_reduce_slices"):
                    pass
        with prof.span("spmv"):
            pass
        with prof.span("load.read", "w8"):
            pass
    spans = prof.record()
    assert [(s.name, s.detail, s.parent, s.seq) for s in spans] == [
        ("spmv", None, None, 1), ("routed.reduce", None, 0, 1),
        ("launch", "cvr_reduce_slices", 1, 1), ("spmv", None, None, 2),
        ("load.read", "w8", None, 3)]
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert spans[0].start_ns <= spans[1].start_ns <= spans[2].start_ns
    assert spans[2].end_ns <= spans[1].end_ns <= spans[0].end_ns
    prof.reset()
    assert prof.record() == []
    with prof.recording(), prof.span("spmm"):
        pass
    assert [(s.name, s.parent, s.seq) for s in prof.record()] == [
        ("spmm", None, 1)]


def test_closed_spans_leave_the_garbage_collector():
    # a long record adds nothing to what each collection walks
    with prof.recording():
        for _ in range(1000):
            with prof.span("spmv"), prof.span("launch", "cvr_expand"):
                pass
    gc.collect()
    assert len(prof._spans) == 2000
    assert not any(gc.is_tracked(s) for s in prof._spans)


def test_spans_sit_in_the_profile_around_their_ops():
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(64)
    with prof.recording(), profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.span("spmv"):
            with prof.span("routed.y"):
                torch.add(a, a)
    ev = {e.name: e for e in p.events()}
    assert {"spmv", "routed.y", "aten::add"} <= set(ev)
    outer, inner, op = ev["spmv"], ev["routed.y"], ev["aten::add"]
    assert op.cpu_parent is inner and inner.cpu_parent is outer
    # host ranges, not user annotations the profiler would copy onto
    # the device's timeline
    assert not any(getattr(e, "is_user_annotation", False)
                   for e in (outer, inner))
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.start <= op.time_range.start
    assert op.time_range.end <= inner.time_range.end <= outer.time_range.end
    # the record's own clock reads inside the profiler's event
    assert [s.name for s in prof.record()] == ["spmv", "routed.y"]


def test_trace_records_while_it_runs(tmp_path):
    with prof.trace("t", trace_dir=tmp_path):
        with prof.span("spmm"):
            pass
        assert prof.span("x") is not prof.span("x")
    assert prof.span("x") is prof.span("y")
    assert _names(prof.record()) == ["spmm"]


@pytest.mark.parametrize("name", ["routed", "lane", "dia"])
def test_load_reads_each_member_in_a_span(saved, name):
    path, _, _ = saved[name]
    with prof.recording():
        kind, _ = cli.load_packed(path)
    assert kind == {"routed": "sell-routed", "lane": "lane",
                    "dia": "dia"}[name]
    spans = prof.record()
    load = spans[0]
    assert load.name == "load" and load.parent is None
    reads = [s for s in spans if s.name == "load.read"]
    assert reads and _names(spans) == ["load"] + ["load.read"] * len(reads)
    assert all(s.parent == 0 and s.seq == load.seq for s in reads)
    assert all(load.start_ns <= s.start_ns <= s.end_ns <= load.end_ns
               for s in reads)
    # each member read once, every member the file holds
    assert sorted(s.detail for s in reads) == sorted(np.load(path).files)


def test_sniffing_reads_no_member(saved):
    with prof.recording():
        assert cli.sniff_packed(saved["routed"][0]) == "sell-routed"
    assert prof.record() == []


@pytest.mark.parametrize("name", ["routed", "lane", "dia"])
def test_upload_records_its_plans(saved, name):
    _, host, _ = saved[name]
    with prof.recording():
        upload(host, "cpu")
        upload(upload(host, "cpu"), "cpu")  # a device form: no span
    spans = prof.record()
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["upload", "upload"]
    plans = [s for s in spans if s.name == "upload.plan"]
    assert plans and {s.parent for s in plans} <= set(roots)
    assert {s.name for s in spans} == {"upload", "upload.plan"}
    if name == "dia":  # K11's window plan, once an upload
        assert [(s.detail, s.parent) for s in plans] == [
            ("dia", i) for i in roots]


@pytest.mark.parametrize("name, stages", [
    ("routed", ["routed.reduce", "routed.y"]),
    ("lane", ["lane.reduce", "lane.fold"]),
    ("dia", []),
])
def test_product_spans_name_its_stages(saved, name, stages):
    _, host, K = saved[name]
    sd = upload(host, "cpu")
    with prof.recording():
        _product(sd, K, host.shape[1])
        _product(sd, K, host.shape[1])
    spans = prof.record()
    root = "spmv" if K == 0 else "spmm"
    assert _names(prof.record()) == ([root] + stages) * 2
    assert [s.seq for s in spans] == [1] * (1 + len(stages)) + [2] * (
        1 + len(stages))
    if name == "routed":  # K3 gathers x: the reduce's detail says so
        assert [s.detail for s in spans if s.name == "routed.reduce"] == [
            "x", "x"]


@pytest.mark.parametrize("name", ["routed", "lane", "dia"])
def test_recording_leaves_outputs_bit_for_bit(saved, name):
    path, _, K = saved[name]
    outs = []
    for on in (False, True):
        with prof.recording(on):
            _, host = cli.load_packed(path)
            sd = upload(host, "cpu")
            outs.append((host, sd, _product(sd, K, host.shape[1], seed=3)))
    (h0, d0, y0), (h1, d1, y1) = outs
    assert torch.equal(y0, y1)
    for f, v in vars(h0).items():
        w = getattr(h1, f)
        assert (np.array_equal(v, w) if isinstance(v, np.ndarray)
                else f == "convert_time" or repr(v) == repr(w)), f
    for f, v in vars(d0).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(d1, f)), f


def test_launch_span_carries_the_symbol(monkeypatch):
    from cvr_tpu_torch.ops import _build

    calls = []
    lib = SimpleNamespace(cvr_route_small=lambda *a: calls.append(a) or 0,
                          cvr_tileperm=lambda *a: 7)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    with prof.recording():
        with prof.span("routed.y"):
            rk._launch("cvr_route_small", torch.device("cpu"), 1, 2)
        with pytest.raises(RuntimeError, match="cvr_tileperm"):
            rk._launch("cvr_tileperm", torch.device("cpu"))
    spans = prof.record()
    assert [(s.name, s.detail, s.parent) for s in spans] == [
        ("routed.y", None, None), ("launch", "cvr_route_small", 0),
        ("launch", "cvr_tileperm", None)]
    assert len(calls) == 1 and len(calls[0]) == 3


def test_dia_product_on_a_card_is_one_k8_launch(saved):
    """On a card the DIA product is one ``launch`` span, K8's symbol, in
    its ``spmv`` span; recording leaves y bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel's launch span")
    _, host, _ = saved["dia"]
    sd = upload(host, "cuda")
    x = torch.randn(host.shape[1], generator=torch.Generator().manual_seed(3))
    y0 = spmv(sd, x.cuda())
    with prof.recording():
        y1 = spmv(sd, x.cuda())
    assert [(s.name, s.detail, s.parent) for s in prof.record()] == [
        ("spmv", None, None), ("launch", "cvr_dia_spmv", 0)]
    assert torch.equal(y0, y1)
