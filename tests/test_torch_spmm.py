"""The port's SpMM end to end on the CPU: ``spmm`` on every artifact type
(and its device form) against the JAX package's ``spmm`` and the float64
golden at the row-scaled 1e-6 contract; ``cli spmv --rhs K`` with its
report, its verify and its errors; the bench harness's default
(``sell-xla`` in both packages) and the CLI's ``--format sell``; and no
jax in the new modules.
"""

import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cvr_tpu.ops.spmm_pmm as jpmm
from cvr_tpu.bench.harness import run_spmv_benchmark as j_run_spmv_benchmark
from cvr_tpu.formats import pack_auto as j_pack_auto
from cvr_tpu.formats.bsr import bsr_pack as j_bsr_pack
from cvr_tpu.formats.sell import sell_pack as j_sell_pack
from cvr_tpu.ops.spmm_lane import spmm_lane_pack as j_spmm_lane_pack
from cvr_tpu.ops.spmv import spmm as j_spmm

from cvr_tpu_torch import cli
from cvr_tpu_torch.bench.harness import run_spmv_benchmark
from cvr_tpu_torch.formats import bsr as tbsr
from cvr_tpu_torch.formats import pack_auto
from cvr_tpu_torch.formats.bell import BellMatrix
from cvr_tpu_torch.formats.dia import DiaMatrix
from cvr_tpu_torch.formats.sell import SellMatrix, sell_pack
from cvr_tpu_torch.formats.sell_routed import SellRouted
from cvr_tpu_torch.formats.sell_window import SellWindow
from cvr_tpu_torch.io.mmio import write_matrix_market
from cvr_tpu_torch.ops import kernels, spmm_lane, spmm_pmm
from cvr_tpu_torch.ops.spmv import spmm, upload
from torch_cases import banded, fem, fsm, powerlaw, rgg

REPO = Path(__file__).resolve().parent.parent


def _golden(tcoo, X):
    csr = tcoo.to_csr()
    gold = np.zeros((csr.shape[0], X.shape[1]))
    scale = np.zeros_like(gold)
    v = csr.vals.astype(np.float64)[:, None]
    Xg = X.astype(np.float64)[csr.cols]
    np.add.at(gold, csr.row_ids(), v * Xg)
    np.add.at(scale, csr.row_ids(), np.abs(v) * np.abs(Xg))
    return gold, scale


def _close(got, want, scale, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= 1e-6 * scale + 1e-30).all(), (what, float(
        (err / (scale + 1e-30)).max()))


def _bsr():
    jcoo, tcoo = banded(3000, 9)
    jb = j_bsr_pack(jcoo.to_csr())
    return jcoo, tcoo, jb, tbsr.from_reference(jb)


def _lane():
    jcoo, tcoo = powerlaw(n=3000, avg_nnz=8, seed=1)
    jl = j_spmm_lane_pack(jcoo.to_csr())
    return jcoo, tcoo, jl, spmm_lane.from_reference(jl)


def _pmm():
    jcoo, tcoo = fsm(n=1 << 12)
    jp = jpmm.pmm_plan(jcoo.rows, jcoo.cols, jcoo.vals, jcoo.shape)
    return jcoo, tcoo, jp, spmm_pmm.from_reference(jp)


def _packed(kind):
    def make(build):
        def run():
            jcoo, tcoo = build()
            A, jA = pack_auto(tcoo.to_csr()), j_pack_auto(jcoo.to_csr())
            assert isinstance(A, kind)
            return jcoo, tcoo, jA, A
        return run
    return make


def _sell():
    jcoo, tcoo = powerlaw(n=4000, avg_nnz=12, seed=9)
    A, jA = sell_pack(tcoo.to_csr(), C=1024), j_sell_pack(jcoo.to_csr(),
                                                           C=1024)
    assert A.n_splits > 0  # the scatter-add combine
    return jcoo, tcoo, jA, A


def _csr():
    jcoo, tcoo = powerlaw(n=2000, seed=4)
    return jcoo, tcoo, jcoo.to_csr(), tcoo.to_csr()


# artifact: (maker of (jax coo, port coo, jax artifact, port artifact), K)
ARTIFACTS = {
    "bsr": (_bsr, 17),
    "lane": (_lane, 33),
    "pmm": (_pmm, 33),
    "dia": (_packed(DiaMatrix)(lambda: banded(3000, 27)), 130),
    "bell": (_packed(BellMatrix)(rgg), 5),
    "sell_window": (_packed(SellWindow)(lambda: fem(n=1 << 13)), 3),
    "sell_routed": (_packed(SellRouted)(lambda: powerlaw(n=3000, seed=3)),
                    5),
    "sell": (_sell, 5),
    "csr": (_csr, 5),
}


@pytest.mark.parametrize("case", sorted(ARTIFACTS))
def test_spmm_dispatch_matches_reference(case, monkeypatch):
    # the reference's PMM kernel in interpret mode: a short pair segment
    monkeypatch.setattr(jpmm, "SEG", 256)
    make, K = ARTIFACTS[case]
    jcoo, tcoo, jA, A = make()
    X = np.random.default_rng(K).standard_normal(
        (tcoo.shape[1], K)).astype(np.float32)
    kernels.reset_launches()
    Y = spmm(A, X, device="cpu").numpy()
    # CPU tensors: every pass ran its plain version, no kernel launched
    assert not any(kernels.launches().values())
    gold, scale = _golden(tcoo, X)
    _close(Y, gold, scale, "golden")
    _close(Y, j_spmm(jA, X), scale, "JAX spmm")
    if case != "csr":  # the device form gives the same Y, X as a tensor
        sd = upload(A, "cpu")
        np.testing.assert_array_equal(
            spmm(sd, torch.from_numpy(X)).numpy(), Y)
    if case == "bsr":  # the torch-ops path, as the reference's "bsr-xla"
        _close(spmm(A, X, impl="bsr-xla", device="cpu").numpy(),
               j_spmm(jA, X, impl="bsr-xla"), scale, "bsr-xla")


def test_spmm_rejects_other_types():
    with pytest.raises(TypeError, match="unsupported matrix type"):
        spmm(np.eye(3), np.ones((3, 2)), device="cpu")


def _mtx(tmp_path, name, tcoo):
    p = tmp_path / f"{name}.mtx"
    write_matrix_market(p, tcoo)
    return str(p)


@pytest.mark.parametrize("fmt,make,K,picked", [
    ("auto", lambda: banded(3000, 9), 8, "bsr"),
    ("auto", lambda: powerlaw(n=3000), 8, "sell-routed"),
    ("auto", lambda: powerlaw(n=3000), 130, "pmm"),
    ("lane", lambda: powerlaw(n=3000), 17, "lane"),
    ("dia", lambda: banded(3000, 9), 5, "dia"),
    ("sell-window", lambda: fem(n=1 << 12), 3, "sell-window"),
    ("csr", lambda: powerlaw(n=2000), 5, "sell"),
], ids=["auto_bsr", "auto_routed", "auto_pmm", "lane", "dia", "sell-window",
        "csr"])
def test_cli_spmm_reports_and_verifies(fmt, make, K, picked, tmp_path,
                                       capsys):
    _, tcoo = make()
    path = _mtx(tmp_path, "m", tcoo)
    assert cli.main(["spmv", path, "--rhs", str(K), "--format", fmt,
                     "--device", "cpu", "--iters", "2"]) == 0
    out = capsys.readouterr().out
    for tag in (f"[rhs: {K}] [format: {picked}] Pre-processing Time",
                f"[rhs: {K}] SpMM Execution Time",
                f"[rhs: {K}] Throughput", "Verification: PASS"):
        assert tag in out, tag
    args = cli.build_parser().parse_args(
        ["spmv", path, "--rhs", str(K), "--format", fmt, "--device", "cpu",
         "--iters", "1"])
    run = cli._spmm(args, tcoo)
    assert run.rc == 0 and run.fmt == picked and run.verified
    assert run.max_rel_err < 1e-6 and run.spmm_s > 0


def test_cli_spmm_errors(tmp_path, capsys):
    """--format bsr without --rhs, and --format bsr where the bricks are
    refused, exit 2 as in the JAX CLI; --rhs defaults to 1."""
    _, tcoo = powerlaw(n=2000)
    path = _mtx(tmp_path, "pl", tcoo)
    assert cli.build_parser().parse_args(["spmv", path]).rhs == 1
    for fmt in ("bsr", "lane", "pmm"):
        assert cli.main(["spmv", path, "--format", fmt, "--device",
                         "cpu"]) == 2
        assert "SpMM format" in capsys.readouterr().err
    assert cli.main(["spmv", path, "--format", "bsr", "--rhs", "8",
                     "--device", "cpu", "--iters", "1"]) == 2
    assert "brick fill" in capsys.readouterr().err


def test_harness_defaults_to_sell_xla_as_the_jax_harness(tmp_path, capsys):
    """run_spmv_benchmark(coo) takes the plain SELL path in both packages,
    and cli spmv --format sell reaches it."""
    for fn in (run_spmv_benchmark, j_run_spmv_benchmark):
        assert inspect.signature(fn).parameters["impl"].default == "sell-xla"
    _, tcoo = powerlaw(n=3000, seed=3)
    r = run_spmv_benchmark(tcoo, name="pl", iters=2, device="cpu")
    csr = tcoo.to_csr()
    assert r.impl == "sell-xla" and r.verified and r.device == "cpu"
    # the plain SELL planes' padding, not the routed stream's
    assert r.padded_nnz == sell_pack(csr).padded_nnz
    assert isinstance(sell_pack(csr), SellMatrix)
    path = _mtx(tmp_path, "pl", tcoo)
    assert cli.main(["spmv", path, "--format", "sell", "--device", "cpu",
                     "--iters", "2"]) == 0
    assert "Verification: PASS" in capsys.readouterr().out


def test_spmm_modules_and_chip_smoke_leave_jax_unloaded():
    code = (
        "import sys, importlib\n"
        "for m in ('cvr_tpu_torch.formats.bsr', 'cvr_tpu_torch.ops.spmm_bsr',\n"
        "          'cvr_tpu_torch.ops.spmm_lane', 'cvr_tpu_torch.ops.spmm_pmm',\n"
        "          'cvr_tpu_torch.ops.bsr_kernels',\n"
        "          'cvr_tpu_torch.ops.lane_kernels',\n"
        "          'cvr_tpu_torch.ops.pmm_kernels', 'cvr_tpu_torch.ops.spmv',\n"
        "          'cvr_tpu_torch.cli', 'chip_smoke'):\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'cvr_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
