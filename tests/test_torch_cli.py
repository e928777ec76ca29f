"""The port's command line, case for case against tests/test_cli.py (the
JAX package's), with --device cpu; then what the JAX CLI's command lines
reach in the port (--save-packed / --load-packed for every SpMV format,
the format and impl aliases, --c and --sigma, --threads on every
subcommand, compare over the SpMM formats) and the two deliberate
differences: a loaded artifact that fails its golden exits 1, and compare
goes on past a format's refusal only.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cli.py -q
"""

import argparse

import numpy as np
import pytest

from cvr_tpu.cli import build_parser as j_build_parser

import cvr_tpu_torch.bench.harness as harness
from cvr_tpu_torch import cli
from cvr_tpu_torch.cli import main
from cvr_tpu_torch.formats.coo import COOMatrix
from cvr_tpu_torch.formats.sell import sell_pack
from cvr_tpu_torch.io.mmio import write_matrix_market
from cvr_tpu_torch.utils import memarena
from torch_cases import banded, fem, powerlaw, road

from conftest import make_random_coo

CPU = ["--device", "cpu"]


def _write(path, coo):
    write_matrix_market(path, coo)
    return str(path)


@pytest.fixture
def mtx(tmp_path):
    j = make_random_coo(300, 300, density=0.03, seed=21)
    return _write(tmp_path / "m.mtx", COOMatrix(rows=j.rows, cols=j.cols,
                                                vals=j.vals, shape=j.shape))


# --- tests/test_cli.py, case for case ---------------------------------------


def test_info(mtx, capsys):
    assert main(["info", mtx, *CPU]) == 0
    out = capsys.readouterr().out
    assert "rows: 300" in out and "sell-pack:" in out


def test_spmv(mtx, capsys):
    assert main(["spmv", mtx, "--iters", "3", "--c", "128", *CPU]) == 0
    out = capsys.readouterr().out
    assert "Pre-processing Time" in out
    assert "SpMV Execution Time" in out
    assert "Verification: PASS" in out


def test_spmv_csr(mtx, capsys):
    assert main(["spmv", mtx, "--iters", "2", "--format", "csr", *CPU]) == 0
    assert "Throughput" in capsys.readouterr().out


def test_spmm(mtx, capsys):
    assert main(["spmv", mtx, "--iters", "2", "--rhs", "8", "--c", "128",
                 *CPU]) == 0
    assert "SpMM Execution Time" in capsys.readouterr().out


def test_save_load_packed(mtx, tmp_path, capsys):
    packed = str(tmp_path / "m.packed.npz")
    assert main(["spmv", mtx, "--iters", "2", "--c", "128", "--save-packed",
                 packed, *CPU]) == 0
    capsys.readouterr()
    assert main(["spmv", mtx, "--iters", "2", "--load-packed", packed,
                 *CPU]) == 0
    out = capsys.readouterr().out
    assert "loaded artifact" in out and "Verification: PASS" in out


def test_compare(mtx, capsys):
    assert main(["compare", mtx, "--iters", "2", *CPU]) == 0
    assert "Best:" in capsys.readouterr().out


def test_threads_flag_accepted(mtx):
    # the reference's command line: --threads parses and is ignored
    assert main(["info", mtx, "--threads", "68", *CPU]) == 0


# --- the JAX CLI's command lines in the port ---------------------------------


@pytest.mark.parametrize("argv", [
    ["info", "m.mtx", "--iters", "2"],
    ["info", "m.mtx", "--threads", "68", "--pattern-values", "ones"],
    ["spmv", "m.mtx", "--format", "routed", "--c", "128", "--threads", "68"],
    ["spmv", "m.mtx", "--format", "window", "--sigma", "64"],
    ["spmv", "m.mtx", "--save-packed", "a.npz", "--no-verify"],
    ["spmv", "m.mtx", "--load-packed", "a.npz", "--format", "sell-routed"],
    ["compare", "m.mtx", "--rhs", "8", "--c", "128", "--threads", "68"],
])
def test_reference_command_lines_parse(argv):
    """Every command line the JAX CLI parses, the port's parses to the
    same values (the port adds --device)."""
    want = vars(j_build_parser().parse_args(argv))
    got = vars(cli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    want.pop("fn"), got.pop("fn")
    assert got == want


def test_main_warms_the_arena_where_first_touch_is_slow(mtx, monkeypatch):
    """cli.main calls memarena.warm_if_lazy() before the command, as the
    JAX CLI does (its probe decides; a bare-metal host does nothing)."""
    calls = []
    monkeypatch.setattr(memarena, "warm_if_lazy", lambda: calls.append(1))
    assert main(["info", mtx, *CPU]) == 0
    assert calls == [1]
    assert isinstance(memarena.lazy_backed(probe_mb=1), bool)


@pytest.mark.parametrize("fmt, make, kind", [
    ("auto", lambda: banded(3000, 9), "dia"),
    ("auto", lambda: road(n=1 << 14), "bell"),
    ("routed", lambda: powerlaw(n=2000), "sell-routed"),
    ("sell-routed", lambda: powerlaw(n=2000), "sell-routed"),
    ("window", lambda: fem(n=1 << 12, deg=10, bw=100), "sell-window"),
    ("dia", lambda: banded(3000, 9), "dia"),
    ("bell", lambda: road(n=1 << 14), "bell"),
    ("sell", lambda: powerlaw(n=2000), "sell"),
    ("csr", lambda: powerlaw(n=2000), "sell"),
], ids=["auto_dia", "auto_bell", "routed", "sell-routed", "window", "dia",
        "bell", "sell", "csr"])
def test_save_then_load_each_format(fmt, make, kind, tmp_path, capsys):
    """--save-packed writes the format's artifact after the verified run;
    --load-packed (the kind sniffed from the keys) runs it with
    pre-processing 0 and the load and upload seconds on a line before."""
    _, tcoo = make()
    m = _write(tmp_path / "m.mtx", tcoo)
    p = str(tmp_path / "m.npz")
    assert main(["spmv", m, "--format", fmt, "--save-packed", p, "--iters",
                 "2", *CPU]) == 0
    assert f"packed artifact saved to {p}" in capsys.readouterr().out
    assert cli.sniff_packed(p) == kind
    assert main(["spmv", m, "--load-packed", p, "--iters", "2", *CPU]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    at = next(i for i, s in enumerate(lines) if "loaded artifact" in s)
    assert f"[format: {kind}] load " in lines[at - 1]
    assert "upload" in lines[at - 1]
    assert "Pre-processing Time: 0.000 ms (loaded artifact)" in lines[at]
    assert "SpMV Execution Time" in lines[at + 1]
    assert "Verification: PASS" in out


def test_sigma_and_c_reach_the_sell_pack(tmp_path, capsys):
    """--c and --sigma reach the harness's SELL pack (impl "sell-xla"),
    and --save-packed's."""
    _, tcoo = powerlaw(n=2000)
    r = harness.run_spmv_benchmark(tcoo, impl="sell-xla", iters=1, C=128,
                                   sigma=64, device="cpu")
    want = sell_pack(tcoo.to_csr(), C=128, sigma=64)
    assert r.verified and r.padded_nnz == want.padded_nnz
    m = _write(tmp_path / "m.mtx", tcoo)
    p = str(tmp_path / "m.npz")
    assert main(["spmv", m, "--format", "sell", "--c", "128", "--sigma",
                 "64", "--save-packed", p, "--iters", "1", *CPU]) == 0
    z = np.load(p)
    assert (int(z["C"]), int(z["sigma"])) == (128, 64)
    assert np.array_equal(z["perm"], want.perm)


@pytest.mark.parametrize("cmd", ["spmv", "compare"])
def test_sigma_and_c_reach_the_spmm_sell_pack(cmd, tmp_path, monkeypatch,
                                              capsys):
    """``spmv --rhs 8 --format sell --c 128 --sigma 64`` (and compare's
    ``sell`` row) packs the SELL planes at C 128 and sigma 64, as the JAX
    package's CLI does; without the flags, C 1024 and sigma 0."""
    import cvr_tpu_torch.formats.sell as tsell

    packs = []

    def recording(*a, **kw):
        packs.append(original(*a, **kw))
        return packs[-1]

    original = tsell.sell_pack
    monkeypatch.setattr(tsell, "sell_pack", recording)
    _, tcoo = powerlaw(n=2000)
    m = _write(tmp_path / "m.mtx", tcoo)
    fmt = ["--format", "sell"] if cmd == "spmv" else []
    assert main([cmd, m, "--rhs", "8", *fmt, "--c", "128", "--sigma", "64",
                 "--iters", "1", *CPU]) == 0
    assert (packs[-1].C, packs[-1].sigma) == (128, 64)
    want = original(tcoo.to_csr(), C=128, sigma=64)
    assert np.array_equal(packs[-1].perm, want.perm)
    assert "Verification: PASS" in capsys.readouterr().out
    assert cli.spmm_pick("sell", tcoo, 8)[1].C == 1024
    assert cli.spmm_pick("csr", tcoo, 8)[1].sigma == 0


@pytest.mark.parametrize("alias, impl", [("routed", "sell-routed"),
                                         ("window", "sell-window")])
def test_harness_takes_the_impl_aliases(alias, impl):
    _, tcoo = fem(n=1 << 12, deg=10, bw=100)
    a = harness.run_spmv_benchmark(tcoo, impl=alias, iters=1, device="cpu")
    b = harness.run_spmv_benchmark(tcoo, impl=impl, iters=1, device="cpu")
    assert a.verified and a.impl == alias and a.padded_nnz == b.padded_nnz


def test_load_packed_refusals(mtx, tmp_path, capsys):
    """A file of another matrix's shape exits 1; an SpMM plan, which the
    SpMV cannot run, exits 2."""
    p = str(tmp_path / "other.npz")
    _, tcoo = powerlaw(n=2000)
    m = _write(tmp_path / "o.mtx", tcoo)
    assert main(["spmv", m, "--format", "sell", "--save-packed", p,
                 "--iters", "1", *CPU]) == 0
    assert main(["spmv", mtx, "--load-packed", p, *CPU]) == 1
    assert "shape mismatch" in capsys.readouterr().out
    from cvr_tpu_torch.ops.spmm_lane import save_lane, spmm_lane_pack

    save_lane(spmm_lane_pack(tcoo.to_csr()), p)
    assert main(["spmv", m, "--load-packed", p, *CPU]) == 2
    assert "SpMM artifact" in capsys.readouterr().err


# --- the two deliberate differences -------------------------------------------


def test_loaded_artifact_failing_its_golden_exits_1(tmp_path, capsys):
    """The JAX CLI returns 0 after printing Verification: FAIL for a loaded
    artifact (cvr_tpu/cli.py:206-221); the port exits 1, as its spmv
    does."""
    _, tcoo = banded(3000, 9)
    m = _write(tmp_path / "m.mtx", tcoo)
    p = str(tmp_path / "m.npz")
    assert main(["spmv", m, "--format", "dia", "--save-packed", p,
                 "--iters", "1", *CPU]) == 0
    z = dict(np.load(p))
    z["bands"] = z["bands"] * np.float32(1.5)  # not the matrix any more
    np.savez_compressed(p, **z)
    capsys.readouterr()
    assert main(["spmv", m, "--load-packed", p, "--iters", "1", *CPU]) == 1
    assert "Verification: FAIL" in capsys.readouterr().out
    assert main(["spmv", m, "--load-packed", p, "--iters", "1",
                 "--no-verify", *CPU]) == 0


def test_compare_goes_on_past_refusals(tmp_path, capsys):
    """Each format that refuses the matrix prints the reference's
    "[impl] failed: ..." line and the comparison goes on: the SpMV impls
    (DIA and BELL refuse a power-law matrix) and the SpMM formats (BSR,
    DIA and BELL refuse it)."""
    _, tcoo = powerlaw(n=2000)
    m = _write(tmp_path / "m.mtx", tcoo)
    assert main(["compare", m, "--iters", "1", *CPU]) == 0
    out = capsys.readouterr().out
    assert "[dia] failed: DiaInfeasible: " in out
    assert "[bell] failed: BellInfeasible: " in out
    for impl in ("csr", "sell-xla", "sell-routed", "sell-window"):
        assert f"[threads: {impl}] SpMV Execution Time" in out
    assert out.count("SpMV Execution Time") == 4 and "Best: " in out
    assert main(["compare", m, "--iters", "1", "--rhs", "8", *CPU]) == 0
    out = capsys.readouterr().out
    assert [s.split(":", 2)[:2] for s in out.splitlines()
            if "] failed: " in s] == [
        ["[bsr] failed", " BsrInfeasible"], ["[dia] failed", " DiaInfeasible"],
        ["[bell] failed", " BellInfeasible"]]
    assert out.count("SpMM Execution Time") == 5
    assert out.count("Verification: PASS") == 5


def test_compare_ends_on_any_other_error(mtx, monkeypatch, capsys):
    """An error that is not a format's refusal (a kernel that does not
    build or launch) ends compare with it, and a result that fails its
    golden makes the exit code 1: nothing hides the device or the
    kernel."""
    run = harness.run_spmv_benchmark

    def launch_fails(coo, impl="sell-xla", **kw):
        if impl == "sell-routed":
            raise RuntimeError("the kernel did not launch")
        return run(coo, impl=impl, **kw)

    monkeypatch.setattr(harness, "run_spmv_benchmark", launch_fails)
    with pytest.raises(RuntimeError, match="did not launch"):
        main(["compare", mtx, "--iters", "1", *CPU])
    assert "[sell-routed] failed" not in capsys.readouterr().out

    def wrong(coo, impl="sell-xla", **kw):
        r = run(coo, impl=impl, **kw)
        r.verified = r.verified and impl != "sell-window"
        return r

    monkeypatch.setattr(harness, "run_spmv_benchmark", wrong)
    assert main(["compare", mtx, "--iters", "1", *CPU]) == 1
    monkeypatch.undo()

    def spmm_fails(args, coo, refusals=()):
        if args.format == "lane":
            raise RuntimeError("the kernel did not build")
        return cli.SpmmRun(rc=1 if args.format == "pmm" else 0)

    monkeypatch.setattr(cli, "_spmm", spmm_fails)
    with pytest.raises(RuntimeError, match="did not build"):
        main(["compare", mtx, "--rhs", "8", *CPU])
    monkeypatch.setattr(cli, "_spmm", lambda args, coo, refusals=():
                        cli.SpmmRun(rc=1 if args.format == "pmm" else 0))
    assert main(["compare", mtx, "--rhs", "8", *CPU]) == 1


def test_compare_namespace_reaches_spmm(mtx, monkeypatch):
    """compare --rhs K hands _spmm the command line with each format in
    turn, in the JAX CLI's order."""
    seen = []

    def record(args, coo, refusals=()):
        assert isinstance(args, argparse.Namespace) and args.rhs == 8
        assert cli.BsrInfeasible in refusals
        seen.append(args.format)
        return cli.SpmmRun(rc=0)

    monkeypatch.setattr(cli, "_spmm", record)
    assert main(["compare", mtx, "--rhs", "8", *CPU]) == 0
    assert seen == ["bsr", "dia", "bell", "lane", "pmm", "routed", "window",
                    "sell"]
