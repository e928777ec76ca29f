"""The tools of the port against the JAX package's, on the CPU: the
synthetic generators and their cache, the SuiteSparse cache loader, the
COO reference SpMV, Timer / PhaseTimer.report, the result appenders, the
harness's pack repeats and its ``sell*`` names, and the scripts' ports
(bench/sweep.py, parity.py, comm_model.py, spmm.py, profile_passes.py)
against scripts/sweep.py, make_parity.py, comm_model.py, spmm_bench.py
and profile_passes.py: their flags, suites, tables and rows.  The
full-size generators run with R-MAT shrunk to scale 16 (or n shrunk) in
both packages; every cache write goes to a temporary CVR_TPU_CACHE.
"""

import ast
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvr_tpu.bench import harness as jharness
from cvr_tpu.bench import synthetic as jsyn
from cvr_tpu.formats.sell import DEFAULT_C, sell_pack as j_sell_pack
from cvr_tpu.io.suitesparse import load_suitesparse as j_load
from cvr_tpu.ops.spmv_ref import spmv_coo_jnp
from cvr_tpu.utils import report as jreport
from cvr_tpu.utils import timing as jtiming

from cvr_tpu_torch.bench import (
    comm_model,
    harness,
    parity,
    profile_passes,
    spmm,
    sweep,
)
from cvr_tpu_torch.bench import synthetic as tsyn
from cvr_tpu_torch.io import load_suitesparse as t_load
from cvr_tpu_torch.io.mmio import write_matrix_market
from cvr_tpu_torch.ops import (
    bsr_kernels,
    dia_kernels,
    kernels,
    route_kernels,
    spmv_coo_torch,
    window_kernels,
)
from cvr_tpu_torch.utils import Timer, append_jsonl, append_result, profiling
from cvr_tpu_torch.utils import report as treport
from cvr_tpu_torch.utils.timing import PhaseTimer
from torch_cases import banded, fem, fsm, powerlaw, rmat

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"


def _script(name):
    """The JAX package's scripts/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(path) -> list[str]:
    """The options and positionals a module's add_argument calls name."""
    tree = ast.parse(Path(path).read_text())
    return [n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call)
            and getattr(n.func, "attr", "") == "add_argument"]


# --- the generators ---------------------------------------------------------

RMAT_GENERATORS = ("soc_livejournal_like", "soc_livejournal_full",
                   "citation_like", "web_google_like_b",
                   "soc_livejournal_like_b", "wiki_talk_like_b",
                   "citation_like_b")
# generator -> (the generator it calls, the size keyword to shrink)
SIZED_GENERATORS = {"road_usa_like_b": ("road_usa_like", 1 << 12),
                    "rgg_like_b": ("rgg_like", 1 << 12),
                    "fsm_like_b": ("fsm_like", 1 << 12),
                    "fem_like_b": ("fem_like", 1 << 10)}


def _same_coo(j, t):
    assert j.shape == t.shape
    for k in ("rows", "cols", "vals"):
        a, b = getattr(j, k), getattr(t, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("gen", RMAT_GENERATORS)
def test_rmat_generators_match_reference(gen, monkeypatch):
    """Each R-MAT generator passes the JAX one's parameters exactly and,
    at scale 16 without the cache, gives its COO arrays bit for bit."""
    seen = {}

    def shrink(mod, key):
        real = mod.rmat_matrix

        def small(scale, **kw):
            seen[key] = (scale, dict(kw))
            return real(16, **{**kw, "cache": False})

        monkeypatch.setattr(mod, "rmat_matrix", small)

    shrink(jsyn, "jax")
    shrink(tsyn, "torch")
    j, t = getattr(jsyn, gen)(), getattr(tsyn, gen)()
    assert seen["jax"] == seen["torch"]
    _same_coo(j, t)
    if gen == "soc_livejournal_full":
        assert seen["torch"] == (23, {"edge_factor": 9, "seed": 11})


@pytest.mark.parametrize("gen", sorted(SIZED_GENERATORS))
def test_second_stand_ins_match_reference(gen, monkeypatch):
    """The non-R-MAT second stand-ins pass the JAX one's parameters to
    their generator and, shrunk, give its arrays bit for bit."""
    base, n = SIZED_GENERATORS[gen]
    seen = {}

    def shrink(mod, key):
        real = getattr(mod, base)

        def small(**kw):
            seen[key] = dict(kw)
            return real(**{**kw, "n": n})

        monkeypatch.setattr(mod, base, small)

    shrink(jsyn, "jax")
    shrink(tsyn, "torch")
    _same_coo(getattr(jsyn, gen)(), getattr(tsyn, gen)())
    assert seen["jax"] == seen["torch"] and seen["torch"]["n"] > n


def test_rmat_cache_round_trip(tmp_path, monkeypatch):
    """The cache under CVR_TPU_CACHE: the JAX package's key and layout,
    each package reads the other's file, cache=False and scale < 16 touch
    nothing, and no partial file is left."""
    monkeypatch.setenv("CVR_TPU_CACHE", str(tmp_path))
    key = "rmat_s16_e2_a0.57_b0.19_c0.19_seed5.npz"
    t = tsyn.rmat_matrix(16, 2, seed=5)
    assert sorted(p.name for p in tmp_path.iterdir()) == [key]
    _same_coo(jsyn.rmat_matrix(16, 2, seed=5), t)
    # a file the JAX package wrote, altered: the port reads it
    j = jsyn.rmat_matrix(16, 2, seed=6)
    jkey = tmp_path / key.replace("seed5", "seed6")
    np.savez(jkey, rows=j.rows, cols=j.cols, vals=2 * j.vals)
    got = tsyn.rmat_matrix(16, 2, seed=6)
    np.testing.assert_array_equal(got.vals, 2 * j.vals)
    _same_coo(j, tsyn.rmat_matrix(16, 2, seed=6, cache=False))
    tsyn.rmat_matrix(15, 2, seed=5)
    tsyn.rmat_matrix(16, 3, seed=5, cache=False)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [key, jkey.name])


# --- the loader and the COO SpMV -------------------------------------------


def test_load_suitesparse_from_the_cache(tmp_path):
    """Both cache layouts read as the JAX loader reads them; a missing
    matrix raises FileNotFoundError (the port never downloads)."""
    _, tcoo = powerlaw(n=500, seed=4)
    write_matrix_market(tmp_path / "flat.mtx", tcoo)
    (tmp_path / "nested").mkdir()
    write_matrix_market(tmp_path / "nested" / "nested.mtx", tcoo)
    for name in ("flat", "nested"):
        _same_coo(j_load(name, cache_dir=tmp_path),
                  t_load(name, cache_dir=tmp_path))
    with pytest.raises(FileNotFoundError,
                       match=r"absent\.mtx not found in cache .* Place the "
                       r"\.mtx file in the cache directory\."):
        t_load("absent", group="SNAP", cache_dir=tmp_path)


@pytest.mark.parametrize("K", [None, 3])
def test_spmv_coo_matches_reference(K):
    """spmv_coo_torch against spmv_coo_jnp on unsorted entries (and on K
    columns), within 1e-6 of the row scale."""
    rng = np.random.default_rng(8)
    n, nnz = 700, 5000
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    shape = (n,) if K is None else (n, K)
    x = rng.standard_normal(shape).astype(np.float32)
    got = spmv_coo_torch(torch.from_numpy(rows).long(),
                         torch.from_numpy(cols).long(),
                         torch.from_numpy(vals), torch.from_numpy(x), n)
    jvals = jnp.asarray(vals) if K is None else jnp.asarray(vals)[:, None]
    want = np.asarray(spmv_coo_jnp(jnp.asarray(rows), jnp.asarray(cols),
                                   jvals, jnp.asarray(x), n))
    scale = np.zeros(shape)
    np.add.at(scale, rows, (np.abs(vals.astype(np.float64))
                            if K is None else np.abs(vals)[:, None])
              * np.abs(x[cols]))
    assert (np.abs(got.numpy() - want) <= 1e-6 * scale + 1e-30).all()


# --- the utilities ----------------------------------------------------------


def test_timer_and_phase_report_match_reference():
    for T in (jtiming.Timer, Timer):
        t = T()
        with pytest.raises(RuntimeError, match="stop\\(\\) without start"):
            t.stop()
        with t:
            sum(range(1000))
        first = t.elapsed
        assert first > 0 and t.start() is t and t.stop() > first
    phases = {"sort": 0.0123, "pack": 1.5, "route_plan": 0.000456}
    assert (PhaseTimer(phases=dict(phases)).report()
            == jtiming.PhaseTimer(phases=dict(phases)).report())


RESULT = dict(name="m", impl="auto", nnz=1000, padded_nnz=2048,
              preproc_s=0.5, spmv_s=1.25e-4, iters=100, gflops_2nnz=16.0,
              gnnz_per_s=8.0, roofline_frac=0.02, amortize_iters=4000.0,
              verified=True, max_rel_err=1.2e-7, nrows=30, ncols=40)


@pytest.mark.parametrize("first", [None, 0.75])
def test_results_and_report_match_reference(first, tmp_path, capsys):
    """append_result / append_jsonl: the JAX package's CSV columns and
    JSON keys, in its order, then the port's device; the report's text
    (with the first pack's suffix where pack_repeats > 1)."""
    j = jharness.BenchResult(**RESULT, preproc_first_s=first)
    t = harness.BenchResult(**RESULT, preproc_first_s=first, device="cpu")
    jreport.append_result(j, tmp_path / "j.csv")
    jreport.append_jsonl(j, tmp_path / "j.jsonl")
    for _ in range(2):
        append_result(t, tmp_path / "t.csv")
        append_jsonl(t, tmp_path / "t.jsonl")
    jl = (tmp_path / "j.csv").read_text().splitlines()
    tl = (tmp_path / "t.csv").read_text().splitlines()
    assert treport.REFERENCE_FIELDS == jreport.FIELDS
    assert tl[0] == jl[0] + ",device" and tl[1] == tl[2] == jl[1] + ",cpu"
    jd = json.loads((tmp_path / "j.jsonl").read_text())
    td = json.loads((tmp_path / "t.jsonl").read_text().splitlines()[1])
    assert list(td)[:-1] == list(jd) and td.pop("device") == "cpu"
    assert td == jd
    j.print_report(threads_label="auto")
    want = capsys.readouterr().out
    t.print_report(threads_label="auto")
    got = capsys.readouterr().out
    assert got == want
    assert ("(min over repeats; first run 750.000 ms)" in got) == bool(first)


def test_profiling_trace_and_server(tmp_path):
    with profiling.trace("t", trace_dir=tmp_path) as out:
        with profiling.annotate("region"):
            torch.ones(8).sum()
    assert Path(out) == tmp_path / "t"
    assert "region" in (tmp_path / "t" / "trace.json").read_text()
    with pytest.raises(NotImplementedError, match="profiling server"):
        with profiling.server(9999):
            pass


# --- the harness ------------------------------------------------------------


def test_pack_repeats_and_first_pack():
    _, tcoo = powerlaw(n=1500, seed=6)
    one = harness.run_spmv_benchmark(tcoo, impl="auto", iters=1,
                                     device="cpu")
    two = harness.run_spmv_benchmark(tcoo, impl="auto", iters=1,
                                     device="cpu", pack_repeats=2)
    assert one.preproc_first_s is None and one.verified
    assert two.verified and two.preproc_s <= two.preproc_first_s
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        two.print_report()
    assert "(min over repeats; first run" in out.getvalue()


@pytest.mark.parametrize("impl", ["sell", "sell-c128", "sell-xla"])
def test_every_sell_name_runs_the_plain_sell_planes(impl):
    """As the JAX harness: every name that starts with "sell" and is no
    named format packs the plain SELL planes (C 1024 unless C is given)
    and verifies; the port raised ValueError for "sell" before."""
    jcoo, tcoo = powerlaw(n=1500, seed=6)
    r = harness.run_spmv_benchmark(tcoo, impl=impl, iters=1, device="cpu")
    assert r.verified and r.impl == impl
    assert r.padded_nnz == j_sell_pack(jcoo.to_csr(),
                                       C=DEFAULT_C).padded_nnz
    with pytest.raises(ValueError, match="unknown impl 'cell'"):
        harness.run_spmv_benchmark(tcoo, impl="cell", device="cpu")


# --- the scripts ------------------------------------------------------------

PORTS = {"sweep": "sweep", "make_parity": "parity",
         "comm_model": "comm_model", "spmm_bench": "spmm",
         "profile_passes": "profile_passes"}
PRE_PORT = {"results.csv", "results.jsonl", "results_r2.csv",
            "results_r2.jsonl", "results_r3.csv", "results_r3.jsonl",
            "results_r4.csv", "results_r4.jsonl", "results_spmm.jsonl",
            "docs/PARITY.md"}


@pytest.mark.parametrize("script", sorted(PORTS))
def test_tools_take_the_reference_flags(script):
    """Each tool takes every flag of the JAX script it ports; none writes
    a file from before the port by default."""
    port = REPO / "cvr_tpu_torch" / "bench" / f"{PORTS[script]}.py"
    assert set(_flags(SCRIPTS / f"{script}.py")) <= set(_flags(port))
    defaults = {sweep.parser().get_default("out"), parity.DEFAULT_PARITY,
                treport.DEFAULT_CSV, treport.DEFAULT_JSONL, spmm.DEFAULT_OUT}
    assert not defaults & PRE_PORT


def test_sweep_suites_are_the_reference_ones():
    jsweep = _script("sweep")
    assert ([n for n, _ in sweep.default_suite()]
            == [n for n, _ in jsweep.default_suite()])
    assert ([n for n, _ in sweep.cgo18_suite()]
            == [n for n, _ in jsweep.cgo18_suite()])


def test_sweep_writes_verified_rows(tmp_path, capsys):
    """A small sweep on the CPU: each run's report, CSV and JSONL row
    (verified), a FAILED line for an impl that raises, the summary."""
    suite = [("r12", lambda: rmat(12, 6, 1)[1]),
             ("band", lambda: banded(4000, 9)[1])]
    out = tmp_path / "s.csv"
    rows = sweep.run_suite(suite, ["auto", "sell", "csr", "nope"], iters=2,
                           out=out, pack_repeats=2, device="cpu")
    text = capsys.readouterr().out
    assert len(rows) == 6 and all(r.verified for r in rows)
    assert "[r12/nope] FAILED: ValueError: unknown impl 'nope'" in text
    assert text.count("Verification: PASS") == 6
    assert len(out.read_text().splitlines()) == 7
    jl = [json.loads(x) for x in out.with_suffix(".jsonl").read_text()
          .splitlines()]
    assert [r["impl"] for r in jl] == ["auto", "sell", "csr"] * 2
    assert all(r["verified"] and r["preproc_first_s"] is not None
               for r in jl if r["impl"] != "csr")
    assert "=== summary (GFLOPS 2*nnz) ===" in sweep.summary(rows)


def _rows():
    """Result rows over the parity domains: medians of several runs,
    baselines and a failed run left out, extras, a missing matrix."""
    out = []
    for name, impl, g, ok in (
            ("web-Google-like", "auto", 9.5, True),
            ("web-Google-like", "auto", 10.5, True),
            ("web-Google-like", "auto", 8.0, True),
            ("web-Google-like", "csr", 99.0, True),
            ("web-rmat-b", "auto", 6.0, True),
            ("soc-LJ-like", "auto", 7.0, True),
            ("soc-rmat-b", "sell-routed", 7.5, True),
            ("wiki-Talk-like", "auto", 1.0, False),
            ("fem-like", "auto", 30.0, True),
            ("fem-b", "auto", 25.0, True),
            ("banded-2M", "auto", 40.0, True),
            ("soc-LJ-full", "auto", 5.0, True)):
        n = 1000 + len(out)
        out.append(dict(RESULT, name=name, impl=impl, gflops_2nnz=g,
                        verified=ok, nrows=n, ncols=2 * n,
                        preproc_s=0.1 * len(out), spmv_s=1e-4 * (1 + g),
                        nnz=10 * n, padded_nnz=16 * n))
    return out


def test_parity_tables_match_reference():
    """build() byte for byte; comm_block's table byte for byte at the JAX
    package's link figures (its closing paragraph names the links)."""
    jparity = _script("make_parity")
    rows = _rows()
    assert parity.build(rows) == jparity.build(rows)
    assert parity.DOMAINS == jparity.DOMAINS
    assert parity.EXTRAS == jparity.EXTRAS
    want = jparity.comm_block(rows).split("\n\n")[0]
    got = parity.comm_block(rows, link_bw=45e9, links=2)
    assert got.split("\n\n")[0] == want
    assert "over 2 links of 45 GB/s" in got


def test_parity_write_touches_only_the_named_file(tmp_path, capsys):
    jsonl = tmp_path / "r.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in _rows()))
    before = (REPO / "docs" / "PARITY.md").read_bytes()
    target = tmp_path / "P.md"
    target.write_text("# notes\n")
    argv = [str(jsonl), "--write", "--parity", str(target),
            "--link-bw", "45e9", "--links", "2"]
    for _ in range(2):
        assert parity.main(argv) == 0
    text = target.read_text()
    assert text.startswith("# notes\n\n") and text.count(parity.BEGIN) == 1
    assert "Source artifact: `r.jsonl`." in text
    assert (REPO / "docs" / "PARITY.md").read_bytes() == before
    assert parity.main(argv[:1] + argv[4:]) == 0
    assert parity.BEGIN in capsys.readouterr().out
    with pytest.raises(SystemExit):
        parity.main([str(jsonl)])  # the link figures are required


def test_comm_model_table_matches_reference(tmp_path, capsys, monkeypatch):
    jsonl = tmp_path / "r.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in _rows()))
    jcomm = _script("comm_model")
    monkeypatch.setattr("sys.argv", ["comm_model.py", str(jsonl)])
    assert jcomm.main() == 0
    want = capsys.readouterr().out
    assert comm_model.main([str(jsonl), "--link-bw", "45e9",
                            "--links", "2"]) == 0
    assert capsys.readouterr().out == want
    with pytest.raises(SystemExit):
        comm_model.main([str(jsonl)])


def _row_keys(fn: str) -> list[str]:
    """The keys of the row dict literal in scripts/spmm_bench.py's fn."""
    tree = ast.parse((SCRIPTS / "spmm_bench.py").read_text())
    f = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name == fn)
    d = next(n.value for n in ast.walk(f) if isinstance(n, ast.Assign)
             and getattr(n.targets[0], "id", "") == "row")
    return [k.value for k in d.keys]


def test_spmm_rows_have_the_reference_keys(capsys):
    """Each bench row starts with the JAX script's keys, in its order,
    and its first columns are at the float64 golden."""
    _, band = banded(3000, 27)
    _, web = rmat(11, 6, 2)
    _, fsm_coo = fsm(n=1 << 12)
    for fn, row in (
            ("bench_one", spmm.bench_one("b", band, 16, iters=2,
                                         device="cpu")),
            ("bench_one", spmm.bench_one("b", band, 16, "high", iters=2,
                                         device="cpu")),
            ("bench_vmapped", spmm.bench_vmapped("w", web, 4, iters=2,
                                                 device="cpu")),
            ("bench_lane", spmm.bench_lane("w", web, 16, iters=2,
                                           device="cpu")),
            ("bench_pmm", spmm.bench_pmm("f", fsm_coo, 16, iters=2,
                                         device="cpu"))):
        keys = _row_keys(fn)
        assert list(row)[: len(keys)] == keys, fn
        assert row["max_rel_err"] <= 1e-6 and row["device"] == "cpu"
    assert row["impl"] == "pmm"
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[1])["impl"] == "bsr-high"
    assert json.loads(lines[1])["k12_grade"] == spmm.K12_GRADE


@pytest.fixture
def counted(monkeypatch):
    """The wrappers count a launch on CPU tensors (their plain versions
    run), as on the card."""
    def on_card(name, *tensors, planes=()):
        kernels.KERNELS[name][0].launches += 1
        return False

    for mod in (route_kernels, dia_kernels, window_kernels, bsr_kernels):
        monkeypatch.setattr(mod, "_on_card", on_card)


@pytest.mark.parametrize("impl,make,env", [
    ("routed", lambda: rmat(12, 6, 1)[1], {}),
    ("routed", lambda: rmat(12, 8, 4)[1], {"CVR_HOT": "1",
                                           "CVR_HOT_NH": "128"}),
    ("window", lambda: fem(n=1 << 13)[1], {}),
    ("dia", lambda: banded(5000, 27)[1], {}),
    ("bsr", lambda: banded(3000, 27)[1], {}),
])
def test_profile_passes_lists_the_launched_passes(impl, make, env, counted,
                                                  monkeypatch):
    """The table's passes are the kernels the launch counters report for
    one call, in launch order, each with the bytes it moves; on the CPU
    no device time."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    res = profile_passes.profile(impl, make().to_csr(), "cpu", rhs=8,
                                 iters=2)
    names = [r["name"] for r in res["rows"]]
    assert set(names) == set(res["launches"])
    want = {"routed": ["expand", "reduce_slices", "route_small"],
            "window": ["window_reduce"], "dia": ["dia_spmv"],
            "bsr": ["bsr_spmm"]}[impl]
    if env:
        want = ["expand", "reduce_slices", "reduce_hot", "route_small"]
    assert names == want
    assert all(r["bytes"] > 0 and r["device_ms"] is None
               for r in res["rows"])
    assert res["device_ms"] is None and "not measured" in res["text"]


def test_profile_passes_entry_on_the_cpu(capsys):
    assert profile_passes.main(["--scale", "12", "--impl", "dia",
                                "--device", "cpu", "--iters", "2"]) == 0
    out = capsys.readouterr().out
    assert "matrix: 4096x4096" in out and "dia_spmv" in out
