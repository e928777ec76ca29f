"""The manifest and the files it names: found by name, its rules on
names and units, and a cell added by adding files only."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import spec

MANIFEST = spec.load()


def test_manifest_keeps_its_rules():
    assert spec.check(MANIFEST) == []
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert (spec.MANIFEST.stat().st_size) <= 64 * 1024


@pytest.mark.parametrize("cell", [c["name"] for c in MANIFEST["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = spec.cell(MANIFEST, cell)
    cfg = spec.config(MANIFEST, c["config"])
    assert cfg["name"] == c["config"]
    assert {"generator", "expect", "artifact", "dtype"} <= set(cfg)
    mix = spec.traffic(c["traffic"])
    assert mix["op"] in ("spmv", "spmm") and mix["rhs"] >= 1
    assert spec.limits(cell)["widest_gap"] > 0
    for trace in (False, True):
        for m in spec.metrics_of(MANIFEST, cell, trace):
            assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    MANIFEST["end_to_end"]
                                    + MANIFEST["per_layer"]])
def test_each_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


@pytest.mark.parametrize("bad, fault", [
    (lambda m: m["workloads"][0].update(name="has space"), "cell"),
    (lambda m: m["end_to_end"][0].update(unit="GFLOP per s"), "metric"),
    (lambda m: m["end_to_end"][0].update(unit="µs"), "metric"),
    (lambda m: m["per_layer"][0].update(why="a key no metric has"),
     "keys"),
    (lambda m: m["end_to_end"][0].update(bound=0.5), "bound"),
    (lambda m: m["workloads"].append(dict(m["workloads"][0], name="x")),
     "twice"),
    (lambda m: m["per_layer"][0].update(moves="nothing"), "moves"),
    (lambda m: m.update(extra=1), "top-level"),
])
def test_check_refuses_a_broken_manifest(bad, fault):
    m = json.loads(json.dumps(MANIFEST))
    bad(m)
    assert any(fault in f for f in spec.check(m))


def test_names_and_units_use_allowed_characters():
    names = ([c["name"] for c in MANIFEST["configs"]]
             + [c[k] for c in MANIFEST["workloads"]
                for k in ("name", "config", "traffic")]
             + [m["name"] for m in MANIFEST["end_to_end"]
                + MANIFEST["per_layer"]])
    assert all(spec.NAME.fullmatch(n) for n in names)
    units = [m["unit"] for m in MANIFEST["end_to_end"]
             + MANIFEST["per_layer"]]
    assert all(spec.UNIT.fullmatch(u) for u in units)
    assert not spec.NAME.fullmatch("a/b") and not spec.NAME.fullmatch("a b")
    assert not spec.UNIT.fullmatch("tokens per second")


NEW_GENERATOR = '''"""A path graph's Laplacian: 2 on the diagonal, -1 beside it."""

import numpy as np

PARAMS = ("n",)
TINY = {"n": 300}


def make(n):
    rows = np.repeat(np.arange(n, dtype=np.int32), 3)
    cols = rows + np.tile(np.array([-1, 0, 1], dtype=np.int32), n)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = np.where(rows == cols, 2.0, -1.0).astype(np.float32)
    return rows, cols, vals, n
'''


def test_a_new_cell_is_found_without_editing_a_file(tmp_path):
    """A generator, a configuration, a traffic mix, a limit, a metric and
    a cell, added as new files and new manifest entries: found by name,
    the manifest keeps its rules, and the cell runs end to end at test
    size on the CPU from that checkout (its own benchmark/ package, the
    program beside it); no existing file under benchmark/ changes."""
    here = tmp_path / "root" / "benchmark"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    before = {p.relative_to(here): p.read_bytes()
              for p in here.rglob("*") if p.is_file()}
    (here / "generators" / "path_laplacian.py").write_text(NEW_GENERATOR)
    (here / "configs" / "new_cfg.json").write_text(json.dumps(
        {"name": "new_cfg", "generator": "path_laplacian", "n": 300,
         "expect": {"rows": 300, "nnz": 898}, "artifact": "packed",
         "dtype": "float32"}))
    (here / "traffic" / "new_mix.json").write_text(json.dumps(
        {"op": "spmm", "rhs": 8, "inputs": 2, "warmup_products": 2,
         "check_samples": 2, "enqueue_samples": 2, "trace_products": 4}))
    (here / "limits" / "new.cell.json").write_text('{"widest_gap": 1e-5}')
    (here / "metrics" / "new_metric.ms.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    m = json.loads(json.dumps(MANIFEST))
    m["configs"].append({"name": "new_cfg", "source": "https://example.org/m",
                         "file": "benchmark/configs/new_cfg.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "new.cell", "config": "new_cfg",
                           "traffic": "new_mix", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "new_metric.ms", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "kernels", "moves": "gflops",
                           "workloads": ["new.cell"]})
    root = here.parent
    assert spec.check(m, root) == []
    c = spec.cell(m, "new.cell")
    assert spec.config(m, c["config"], root)["expect"]["rows"] == 300
    assert spec.traffic(c["traffic"], here)["rhs"] == 8
    assert spec.limits("new.cell", here)["widest_gap"] == 1e-5
    got = [x["name"] for x in spec.metrics_of(m, "new.cell", True)]
    assert "new_metric.ms" in got
    assert spec.reader("new_metric.ms", here)({}) == 1.5
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    code = (f"import sys, time; sys.path[:0] = [{str(root)!r}, "
            f"{str(spec.ROOT)!r}]\n"
            "from pathlib import Path\n"
            "from benchmark import matrix, runner\n"
            f"assert matrix.GENERATORS == Path({str(here / 'generators')!r})\n"
            "r = runner.run('new.cell', 7, 0.2, False, time.perf_counter(),"
            f" device='cpu', root=Path({str(root)!r}),"
            f" cache=Path({str(tmp_path / 'cache')!r}))\n"
            "print(r['correct'], r['attempted'] > 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True True"
    after = {p.relative_to(here): p.read_bytes()
             for p in here.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
