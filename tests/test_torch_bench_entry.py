"""The port's headline entries against the JAX package's: ``python -m
cvr_tpu_torch.bench`` against root ``bench.py`` and the JAX harness, and
``cvr_tpu_torch.entry`` against ``__graft_entry__``.

Every run here asks for the CPU (``--device cpu``, ``device="cpu"``): the
wrappers then run their kernels' plain versions.  The JAX package's
routed SpMV runs in Pallas interpret mode, as its own routed tests run it
on the CPU (~7 s).
"""

import argparse
import ast
import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_cases  # noqa: F401  (one torch thread a test process)
from cvr_tpu.bench import harness as jharness
from cvr_tpu.bench.synthetic import rmat_matrix as j_rmat
from cvr_tpu.formats.sell_routed import sell_pack_routed as j_pack_routed
from cvr_tpu.utils import memarena as jmemarena

from cvr_tpu_torch import entry as tentry
from cvr_tpu_torch.bench import harness, synthetic
from cvr_tpu_torch.ops import spmv_ref
from cvr_tpu_torch.ops.spmv_ref import (
    spmv_golden_numpy,
    spmv_row_scale,
    verify,
)

bench = importlib.import_module("cvr_tpu_torch.bench.__main__")

ROOT = Path(__file__).resolve().parent.parent
QUICK = ["--quick", "--iters", "2", "--device", "cpu"]
KEYS = ["metric", "value", "unit", "vs_baseline"]
SKIP = ("convert_time", "convert_phases")

# the JAX harness warms a 1.5 GB arena once a process unless told not to
jmemarena.warm(mb=0)


def _reference(name):
    """Root ``<name>.py`` of the JAX package as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_py_parser() -> argparse.ArgumentParser:
    """A parser built from the add_argument calls of root bench.py's
    AST (its module imports nothing of JAX at the top, but its main
    does)."""
    types = {"int": int, "float": float, "str": str}
    ap = argparse.ArgumentParser()
    tree = ast.parse((ROOT / "bench.py").read_text())
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and \
                getattr(n.func, "attr", "") == "add_argument":
            kw = {k.arg: (types[k.value.id] if isinstance(k.value, ast.Name)
                          else ast.literal_eval(k.value))
                  for k in n.keywords}
            ap.add_argument(*[ast.literal_eval(a) for a in n.args], **kw)
    return ap


def _actions(ap) -> dict:
    """Each option's action, dest, default, type, help (as argparse
    prints it: "%%" is "%"), nargs and const."""
    return {a.option_strings[0]: (type(a).__name__, a.dest, a.default,
                                  a.type, a.help and a.help.replace("%%", "%"),
                                  a.nargs, a.const)
            for a in ap._actions if a.option_strings[0] != "-h"}


def _headline(out: str) -> dict:
    """The last line of stdout as bench.py's object, checked."""
    got = json.loads(out.strip().splitlines()[-1])
    assert list(got) == KEYS
    assert got["unit"] == "GFLOPS" and got["value"] > 0
    # vs_baseline is rounded from the unrounded GFLOPS, value too
    assert abs(got["vs_baseline"] - got["value"] / 7.28) <= \
        0.0005 + 0.0005 / 7.28 + 1e-12
    return got


# --- python -m cvr_tpu_torch.bench ------------------------------------------


def test_flags_are_bench_py_s_plus_device():
    """bench.py's option strings, actions, dests, defaults, types and
    help, and --device with default cuda."""
    want = _actions(_bench_py_parser())
    got = _actions(bench.parser())
    device = got.pop("--device")
    assert got == want
    assert device[1:3] == ("device", "cuda")
    assert bench.CVR_KNL_WEBGRAPH_GFLOPS == 7.28
    args = bench.parser().parse_args([])
    assert (args.impl, args.iters, args.pack_repeats, args.quick,
            args.json_only) == ("sell-routed", None, 1, False, False)


def test_help_prints_where_bench_py_s_raises():
    """bench.py's --pack-repeats help holds an unescaped "%", so its
    --help raises; the port's prints that help."""
    with pytest.raises(ValueError, match="unsupported format character"):
        _bench_py_parser().format_help()
    text = " ".join(bench.parser().format_help().split())
    assert "opt into min-over-N on this ±40%-variance single-core host." \
        in text


@pytest.mark.parametrize("impl", ["sell-routed", "sell-xla", "csr"])
def test_quick_json_only_prints_one_headline(impl, capsys):
    assert bench.main([*QUICK, "--json-only", "--impl", impl]) == 0
    out, err = capsys.readouterr()
    assert len(out.strip().splitlines()) == 1 and err == ""
    got = _headline(out)
    assert got["metric"] == f"SpMV GFLOPS (2*nnz) on rmat13, {impl}"


@pytest.mark.parametrize("impl", ["sell-routed", "sell-xla", "csr"])
def test_quick_report_and_result_json(impl, capsys):
    """Without --json-only: the three-line report and the verification
    line on stdout, the generation line and the BenchResult on stderr,
    then the headline, rounded from the result's own GFLOPS."""
    assert bench.main([*QUICK, "--impl", impl]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 5
    for line, tag in zip(lines, ("Pre-processing Time", "SpMV Execution "
                                 "Time", "Throughput", "Verification: "
                                 "PASS")):
        assert line.startswith("[file: rmat13] ") and tag in line
    assert "[threads: cpu]" in lines[0]
    gen, res = err.strip().splitlines()
    assert gen.startswith("[bench] rmat13: 8192x8192, 58942 nnz, generated")
    r = json.loads(res)
    assert (r["name"], r["impl"], r["iters"], r["device"], r["verified"]) \
        == ("rmat13", impl, 2, "cpu", True)
    got = _headline(out)
    assert got["value"] == round(r["gflops_2nnz"], 3)
    assert got["vs_baseline"] == round(r["gflops_2nnz"] / 7.28, 3)


def test_pack_repeats_report_the_first_pack(capsys):
    assert bench.main([*QUICK, "--pack-repeats", "2"]) == 0
    out, err = capsys.readouterr()
    r = json.loads(err.strip().splitlines()[-1])
    assert r["preproc_first_s"] is not None
    assert r["preproc_s"] <= r["preproc_first_s"]
    assert "(min over repeats; first run" in out.splitlines()[0]


def test_default_runs_web_google_like_at_100_iters(monkeypatch, capsys):
    """Without --quick: web-Google-like at 100 iterations, through the
    harness with the flags' values (the harness itself is stubbed: the
    matrix is the generator's, stood in by a small one)."""
    small = synthetic.rmat_matrix(scale=10, edge_factor=4, seed=1)
    seen = {}
    monkeypatch.setattr(synthetic, "web_google_like", lambda: small)

    def run(coo, **kw):
        seen.update(kw, coo=coo)
        return harness.BenchResult(
            name=kw["name"], impl=kw["impl"], nnz=coo.nnz,
            padded_nnz=coo.nnz, preproc_s=1.0, spmv_s=1e-4,
            iters=kw["iters"], gflops_2nnz=14.56, gnnz_per_s=7.28,
            roofline_frac=0.1, amortize_iters=1e4, verified=None,
            device="cpu")

    monkeypatch.setattr(harness, "run_spmv_benchmark", run)
    assert bench.main(["--device", "cpu", "--pack-repeats", "3",
                       "--impl", "csr"]) == 0
    assert seen == dict(coo=small, name="web-Google-like", impl="csr",
                        iters=100, pack_repeats=3, device="cpu")
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == {
        "metric": "SpMV GFLOPS (2*nnz) on web-Google-like, csr",
        "value": 14.56, "unit": "GFLOPS", "vs_baseline": 2.0}


def test_golden_failure_exits_1_and_still_prints_the_headline(
        monkeypatch, capsys):
    monkeypatch.setattr(spmv_ref, "verify", lambda *a, **kw: (False, 1, 1.0))
    assert bench.main(QUICK) == 1
    out = capsys.readouterr().out
    assert "[file: rmat13] Verification: FAIL (max rel err 1.00e+00)" in out
    _headline(out)


def test_default_device_without_a_card_raises_before_any_work(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_work(*a, **kw):
        raise AssertionError("generated a matrix")

    for gen in ("rmat_matrix", "web_google_like"):
        monkeypatch.setattr(synthetic, gen, no_work)
    for argv in (["--quick"], [], ["--quick", "--device", "cuda:0"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            bench.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.run_spmv_benchmark(None)


@pytest.fixture(scope="module")
def rmat13():
    return synthetic.rmat_matrix(scale=13, edge_factor=8, seed=3)


@pytest.mark.parametrize("impl", ["sell-xla", "csr"])
def test_quick_result_matches_the_jax_harness(impl, rmat13):
    """On bench.py's --quick matrix the JAX harness and the port's give
    the same counts, geometry and verdict (times aside: the clocks
    differ)."""
    j = jharness.run_spmv_benchmark(
        j_rmat(scale=13, edge_factor=8, seed=3), name="rmat13",
        impl=impl, iters=2, chip="cpu")
    t = harness.run_spmv_benchmark(rmat13, name="rmat13", impl=impl,
                                   iters=2, device="cpu")
    keys = ("name", "impl", "nnz", "padded_nnz", "iters", "verified",
            "nrows", "ncols", "preproc_first_s")
    assert {k: getattr(t, k) for k in keys} == \
        {k: getattr(j, k) for k in keys}
    assert t.verified is True


def test_quick_routed_padded_nnz_is_the_jax_pack_s(rmat13):
    """impl sell-routed: padded_nnz is the JAX pack's T * 1024 (compared
    through the packs, so that no interpret-mode run is needed), and the
    hub-column gate fires in both packs (K7 runs on the card)."""
    from cvr_tpu_torch.formats.sell_routed import sell_pack_routed

    t = harness.run_spmv_benchmark(rmat13, name="rmat13",
                                   impl="sell-routed", iters=2,
                                   device="cpu")
    jsr = j_pack_routed(j_rmat(scale=13, edge_factor=8, seed=3).to_csr())
    assert t.verified and t.padded_nnz == jsr.T * 1024
    assert (sell_pack_routed(rmat13.to_csr()).hot is not None) \
        and jsr.hot is not None


# --- cvr_tpu_torch.entry ----------------------------------------------------


def _same(a, b, path):
    """Deep equality: arrays bit for bit (dtype and shape too), packed
    artifacts field by field."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if f.name not in SKIP:
                _same(getattr(a, f.name), getattr(b, f.name),
                      f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _capture_upload(mp, module, got):
    """Record the pack ``module.to_device_routed`` uploads."""
    real = module.to_device_routed

    def upload(sr, *a, **kw):
        got["sr"] = sr
        return real(sr, *a, **kw)

    mp.setattr(module, "to_device_routed", upload)


@pytest.fixture(scope="module")
def entries():
    """Both packages' entry(): (pack, x, y) each; the JAX one's y by its
    routed SpMV in Pallas interpret mode."""
    import cvr_tpu.ops.spmv_routed as jsr_mod

    jgot, tgot = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        _capture_upload(mp, jsr_mod, jgot)
        _capture_upload(mp, tentry, tgot)
        jfn, jargs = _reference("__graft_entry__").entry()
        tfn, targs = tentry.entry(device="cpu")
    jy = np.asarray(jfn(*jargs))
    ty = tfn(*targs).numpy()
    return ((jgot["sr"], np.asarray(jargs[1]), jy),
            (tgot["sr"], targs[1].numpy(), ty), targs)


def test_entry_pack_and_x_are_the_jax_entry_s(entries):
    (jsr, jx, _), (tsr, tx, _), (sd, x) = entries
    _same(tsr, jsr, "sr")
    assert tsr.hot is None and jsr.hot is None
    _same(tx, jx, "x")
    assert x.device.type == "cpu" and sd.w8.device.type == "cpu"


def test_entry_spmv_matches_the_jax_entry_s(entries):
    """fn(*args) within 1e-6 of the row scale of the JAX entry's y and of
    the float64 golden."""
    (_, jx, jy), (tsr, tx, ty), _ = entries
    csr = synthetic.rmat_matrix(scale=12, edge_factor=8, seed=0).to_csr()
    scale = spmv_row_scale(csr, tx)
    assert ty.shape == jy.shape == (4096,) and ty.dtype == np.float32
    ok, nbad, maxrel = verify(ty, jy, rtol=1e-6, row_scale=scale)
    assert ok, (nbad, maxrel)
    ok, nbad, maxrel = verify(ty, spmv_golden_numpy(csr, tx), rtol=1e-6,
                              row_scale=scale)
    assert ok, (nbad, maxrel)


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.main(["entry"])


def test_entry_reexports_dryrun_multichip():
    from cvr_tpu_torch.parallel.dryrun import dryrun_multichip

    assert tentry.dryrun_multichip is dryrun_multichip
    assert sorted(tentry.__all__) == ["dryrun_multichip", "entry"]


@pytest.mark.parametrize("argv,n", [([], 8), (["dryrun"], 8),
                                    (["dryrun", "4"], 4), (["2"], 8)])
def test_entry_main_runs_the_dry_run(argv, n, monkeypatch):
    """As __graft_entry__'s __main__: any mode but "entry" runs
    dryrun_multichip(N), N the second argument, 8 without one."""
    seen = []
    monkeypatch.setattr(tentry, "dryrun_multichip", seen.append)
    assert tentry.main(argv) == 0
    assert seen == [n]


def test_entry_main_runs_one_flagship_spmv(monkeypatch, capsys):
    """``entry``: fn(*args), synchronize, "entry(): OK (rows,)"."""
    real = tentry.entry
    monkeypatch.setattr(tentry, "entry", lambda: real(device="cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert tentry.main(["entry"]) == 0
    assert capsys.readouterr().out == "entry(): OK (4096,)\n"
