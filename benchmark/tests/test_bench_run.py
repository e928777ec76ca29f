"""Whole runs on the CPU at test size (the harness's look for a card
skipped), the result line, the faults that must come out not correct,
and the exits without a card or without the program."""

from __future__ import annotations

import importlib
import json
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from benchmark import runner, spec

CELLS = [c["name"] for c in spec.load()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2**31 + 11


def _run(root, cell, cache, seed=SEED):
    return runner.run(cell, seed, 0.3, False, time.perf_counter(),
                      device="cpu", root=root, cache=cache)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, tmp_path, cell):
    r = _run(tiny_root, cell, tmp_path / "cache")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"gflops", "setup_s"}
    assert r["compared"]["widest_gap"]["value"] < 1e-6
    again = _run(tiny_root, cell, tmp_path / "cache")  # from the cache
    assert again["correct"]


def _stale():
    last = {}

    def wrap(f):
        def g(sd, x):
            y = f(sd, x)
            out = last.get("y", y)
            last["y"] = y
            return out
        return g
    return wrap


def _unchanged(f):
    return lambda sd, x: x.clone()


def _half_left_out(f):
    def g(sd, x):
        y = f(sd, x).clone()
        y[1::2] = y[0::2].mean(0)
        return y
    return g


def _one_altered(f):
    def g(sd, x):
        y = f(sd, x).clone()
        j = int(y.reshape(-1).abs().argmax())
        flat = y.reshape(-1)
        flat[j] += 1e-3 * (1.0 + abs(float(flat[j])))
        return y
    return g


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _one_altered,
                                   "stale"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_product_is_not_correct(tiny_root, shared_cache,
                                         monkeypatch, cell, fault):
    """The timed path broken underneath: the state returned unchanged,
    half of the outputs left out and the mean of the rest put in their
    place, one answer altered where it is produced, the previous call's
    answer returned."""
    dispatch = importlib.import_module("cvr_tpu_torch.ops.spmv")
    wrap = _stale() if fault == "stale" else fault
    for name in ("spmv", "spmm"):
        monkeypatch.setattr(dispatch, name, wrap(getattr(dispatch, name)))
    r = _run(tiny_root, cell, shared_cache)
    assert not r["correct"] and r["failed"] >= 1


def test_the_result_line(capsys):
    result = {"correct": True, "attempted": 3, "failed": 0,
              "metrics": {"gflops": {"value": 1.0, "unit": "GFLOP/s"}},
              "device": {"platform": "gpu", "kind": "x", "count": 1,
                         "memory_peak_bytes": 1},
              "breakdown": {"device_ops": [], "idle_gaps": []},
              "compared": {"widest_gap": {"value": 1e-7, "limit": 1e-5}},
              "_context": {}}
    assert runner.emit(result) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS + ["breakdown", "compared"]
    assert err.strip().splitlines()[-1] == \
        "compared widest_gap 1e-07 limit 1e-05"


def test_result_keys_of_a_run(tiny_root, shared_cache):
    r = _run(tiny_root, CELLS[0], shared_cache)
    r.pop("_context")
    assert list(r) == KEYS + ["compared"]
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}


def test_positions_are_drawn_from_the_seed():
    a = runner.positions(5, 4, 1000)
    assert a == runner.positions(5, 4, 1000) and len(a) <= 3
    assert all(0 <= p < 1000 for p in a)
    assert a != runner.positions(6, 4, 1000)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    fake = types.ModuleType("x")
    for name in ("cvr_tpu_torch_like", "jaxtyping", "cvr_tpu_torch.y"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cvr_tpu.ops", fake)
    monkeypatch.setitem(sys.modules, "jaxlib", fake)
    assert runner.forbidden_modules() == ["cvr_tpu.ops", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root, tmp_path):
    code = (f"import sys, time; sys.path.insert(0, {str(spec.ROOT)!r})\n"
            "from pathlib import Path\n"
            "from benchmark import runner\n"
            f"r = runner.run({CELLS[1]!r}, 3, 0.2, False, time.perf_counter(),"
            f" device='cpu', root=Path({str(tiny_root)!r}),"
            f" cache=Path({str(tmp_path / 'cache')!r}))\n"
            "assert r['correct']\n"
            "print(runner.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _no_result(out) -> bool:
    lines = out.stdout.strip().splitlines()
    if not lines:
        return True
    try:
        return "correct" not in json.loads(lines[-1])
    except ValueError:
        return True


def test_without_a_card_it_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and _no_result(out)


def test_without_the_program_it_exits_without_a_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/."""
    shutil.copy(spec.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[1],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and _no_result(out)


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cuda, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(
        tiny_root, shared_cache, monkeypatch, cell):
    """The reference one precision lower put in the program's place, the
    rest of the run the harness's own: its comparison fails it."""
    from benchmark import control, program, reference
    from benchmark import matrix as mx

    for name in ("set_up", "product"):
        monkeypatch.setattr(program, name, getattr(program, name))
    control.put_in_place(program, mx, reference)
    r = _run(tiny_root, cell, shared_cache)
    assert not r["correct"] and r["failed"] >= 1
    assert r["compared"]["widest_gap"]["value"] > \
        r["compared"]["widest_gap"]["limit"]


def _fake_trace(counts):
    """tracing.traced and tracing.read stand-ins whose n-th trace counts
    ``counts[n]`` more device events of the program's kernels than it
    launched."""
    seen = []

    def traced(lead, window):
        lead()
        window()

    def read(prof, own):
        extra = counts[len(seen)]
        seen.append(extra)
        return {"window_s": 1e-3, "busy_s": 9e-4, "lead_s": 1e-5,
                "tail_s": 1e-5, "device_s": 9e-4, "own_s": 8e-4,
                "own_events": _launches["n"] + extra, "by_name": {},
                "gaps": [], "events": 1}
    return traced, read, seen


_launches = {"n": 0}


@pytest.mark.parametrize("counts, tries", [([1, 0], 2), ([1, -1, 2, 1], None)])
def test_a_trace_that_disagrees_with_the_launch_counter(
        tiny_root, shared_cache, monkeypatch, counts, tries):
    """A trace whose count of the program's kernel events differs from
    the launch counter is taken again; after the last try the run raises
    and gives no result.  The tries taken are recorded."""
    from benchmark import program, tracing

    traffic = spec.traffic
    monkeypatch.setattr(spec, "traffic", lambda name, here=spec.HERE: dict(
        traffic(name, here), trace_products=4, enqueue_samples=2))
    traced, read, seen = _fake_trace(counts)
    monkeypatch.setattr(tracing, "traced", traced)
    monkeypatch.setattr(tracing, "read", read)
    monkeypatch.setattr(program, "launches", lambda: _launches["n"])
    monkeypatch.setattr(program, "reset_launches", lambda: None)
    cell = CELLS[0]
    if tries is None:
        with pytest.raises(runner.TraceMismatch):
            runner.run(cell, SEED, 0.3, True, time.perf_counter(),
                       device="cpu", root=tiny_root, cache=shared_cache)
        assert len(seen) == runner.TRACE_TRIES
        return
    r = runner.run(cell, SEED, 0.3, True, time.perf_counter(), device="cpu",
                   root=tiny_root, cache=shared_cache)
    assert r["correct"] and r["_context"]["trace_tries"] == tries
    assert r["_context"]["bracket_lead_s"] == 1e-5


def test_a_config_that_packs_on_every_run(tiny_root, tmp_path):
    """``"artifact": "packed"``: the run packs and uploads, and saves and
    loads nothing."""
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    for c in spec.load(root / "BENCHMARK.json")["configs"]:
        f = root / c["file"]
        f.write_text(json.dumps(dict(json.loads(f.read_text()),
                                     artifact="packed")))
    r = runner.run(CELLS[1], SEED, 0.3, False, time.perf_counter(),
                   device="cpu", root=root, cache=tmp_path / "cache")
    spans = r["_context"]["spans"]
    assert r["correct"] and "pack" in spans and "load" not in spans
    assert not (tmp_path / "cache" / "packed").exists()
