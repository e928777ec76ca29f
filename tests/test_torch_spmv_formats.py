"""The port's format dispatch end to end on the CPU: ``spmv`` on every
artifact ``pack_auto`` returns (and their device forms) against the JAX
package's ``spmv`` and the float64 golden at the row-scaled 1e-6
contract; the bench harness's format impls and the CLI's ``--format``
(``auto`` by default, as in the JAX CLI); no CPU fallback for tensors
elsewhere than on the CPU; and no jax in the port or chip_smoke.py.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cvr_tpu
from cvr_tpu.formats import pack_auto as j_pack_auto
from cvr_tpu.formats.sell import sell_pack as j_sell_pack
from cvr_tpu.formats.sell_window import sell_pack_window as j_pack_window

from cvr_tpu_torch import cli
from cvr_tpu_torch.bench.harness import run_spmv_benchmark
from cvr_tpu_torch.formats import pack_auto
from cvr_tpu_torch.formats.bell import BellMatrix
from cvr_tpu_torch.formats.dia import DiaMatrix
from cvr_tpu_torch.formats.sell import sell_pack
from cvr_tpu_torch.formats.sell_routed import SellRouted
from cvr_tpu_torch.formats.sell_window import SellWindow, sell_pack_window
from cvr_tpu_torch.io.mmio import write_matrix_market
from cvr_tpu_torch.ops import bell_kernels as bk
from cvr_tpu_torch.ops import dia_kernels as dk
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops import window_kernels as wk
from cvr_tpu_torch.ops.spmv import spmv, upload
from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify
from torch_cases import WINDOW_CASES, banded, fem, powerlaw, rgg, road

REPO = Path(__file__).resolve().parent.parent

# matrix, the format pack_auto picks (None: SELL-W packed directly)
CASES = {
    "dia": (lambda: banded(3000, 27), DiaMatrix),
    "bell": (rgg, BellMatrix),
    "bell_spill": (road, BellMatrix),
    "window_D2": (fem, SellWindow),
    "window_W2048": (WINDOW_CASES["W2048_wrl15"][0], None),
    "routed": (lambda: powerlaw(n=5000, seed=3), SellRouted),
}


def _check(y, csr, x, y_ref=None):
    scale = spmv_row_scale(csr, x)
    ok, nbad, maxrel = verify(y, spmv_golden_numpy(csr, x), rtol=1e-6,
                              row_scale=scale)
    assert ok, f"golden: {nbad} bad rows, max rel {maxrel}"
    if y_ref is not None:
        ok, nbad, maxrel = verify(y, y_ref, rtol=1e-6, row_scale=scale)
        assert ok, f"JAX spmv: {nbad} bad rows, max rel {maxrel}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_spmv_dispatch_matches_reference(case):
    make, kind = CASES[case]
    jcoo, tcoo = make()
    csr = tcoo.to_csr()
    x = np.random.default_rng(7).standard_normal(csr.shape[1]).astype(np.float32)
    if kind is None:
        A, jA = sell_pack_window(csr), j_pack_window(jcoo.to_csr())
        assert A.W == 2048 and A.D == 1
    else:
        A, jA = pack_auto(csr), j_pack_auto(jcoo.to_csr())
        assert isinstance(A, kind)
    kernels.reset_launches()
    y = spmv(A, x, device="cpu").numpy()
    # CPU tensors: every pass ran its plain version, no kernel launched
    assert not any(kernels.launches().values())
    _check(y, csr, x, np.asarray(cvr_tpu.spmv(jA, x)))
    # the device form gives the same y, x as a tensor
    sd = upload(A, "cpu")
    np.testing.assert_array_equal(spmv(sd, torch.from_numpy(x)).numpy(), y)


@pytest.mark.parametrize("fmt", ["sell", "csr"])
def test_spmv_plain_formats_match_reference(fmt):
    """The plain SELL planes (pack_auto's answer above the routed cap)
    and CSR, against the JAX package's SELL-XLA and CSR paths."""
    jcoo, tcoo = powerlaw(n=4000, avg_nnz=12, seed=9)
    csr = tcoo.to_csr()
    x = np.random.default_rng(3).standard_normal(csr.shape[1]).astype(np.float32)
    if fmt == "sell":
        A, jA = sell_pack(csr, C=1024), j_sell_pack(jcoo.to_csr(), C=1024)
        assert A.n_splits > 0  # the scatter-add combine
    else:
        A, jA = csr, jcoo.to_csr()
    _check(spmv(A, x, device="cpu").numpy(), csr, x,
           np.asarray(cvr_tpu.spmv(jA, x)))


def test_spmv_rejects_other_types():
    with pytest.raises(TypeError, match="unsupported matrix type"):
        spmv(np.eye(3), np.ones(3), device="cpu")


@pytest.mark.parametrize("wrapper,args", [
    (dk.dia_spmv, lambda t: (t((2, 8)), t((2,), torch.int64), t((8,)))),
    (bk.bell_gather_mac, lambda t: (t((1, 8, 128), torch.int16),
                                    t((1, 8, 128)), t((64,)), 0, 0, 64)),
    (wk.window_reduce, lambda t: (
        t((8, 128, 128), torch.int16), t((8, 128, 128)), t((128,), torch.int32),
        t((1,), torch.int32), t((64,)), t((1,), torch.int32),
        t((1,), torch.int32), t((1,), torch.int32), 1, 2, 4, 8)),
], ids=["dia_spmv", "bell_gather_mac", "window_reduce"])
def test_wrappers_take_no_plain_path_off_the_cpu(wrapper, args):
    """Given tensors that are not on the CPU, a wrapper launches its kernel
    or raises: it never runs the plain version (meta tensors stand in for
    a card here)."""
    def t(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    kernels.reset_launches()
    with pytest.raises(ValueError, match=wrapper.__name__):
        wrapper(*args(t))
    assert wrapper.launches == 0


@pytest.mark.parametrize("impl,make", [
    ("auto", lambda: banded(3000, 9)),
    ("auto", road),
    ("auto", fem),
    ("dia", lambda: banded(3000, 9)),
    ("bell", rgg),
    ("sell-window", lambda: WINDOW_CASES["segw2"][0]()),
], ids=["auto_dia", "auto_bell", "auto_window", "dia", "bell", "sell-window"])
def test_harness_format_impls_cpu(impl, make, capsys):
    _, tcoo = make()
    r = run_spmv_benchmark(tcoo, name="m", impl=impl, iters=2, device="cpu")
    assert r.verified and r.device == "cpu" and r.spmv_s > 0
    if impl == "sell-window":
        assert r.padded_nnz == sell_pack_window(tcoo.to_csr()).padded_nnz
    r.print_report()
    out = capsys.readouterr().out
    for tag in ("Pre-processing Time", "SpMV Execution Time", "Throughput",
                "Verification: PASS"):
        assert tag in out


def test_cli_defaults_to_auto_as_the_jax_cli(tmp_path, capsys):
    assert cli.build_parser().parse_args(["spmv", "m.mtx"]).format == "auto"
    _, tcoo = road(n=1 << 14)
    p = tmp_path / "road.mtx"
    write_matrix_market(p, tcoo)
    assert cli.main(["spmv", str(p), "--device", "cpu", "--iters", "2"]) == 0
    assert "Verification: PASS" in capsys.readouterr().out
    for fmt in ("bell", "sell-routed"):
        assert cli.main(["spmv", str(p), "--device", "cpu", "--iters", "2",
                         "--format", fmt]) == 0
        assert "Verification: PASS" in capsys.readouterr().out


def test_new_modules_and_chip_smoke_leave_jax_unloaded():
    code = (
        "import sys, importlib\n"
        "for m in ('cvr_tpu_torch.formats', 'cvr_tpu_torch.formats.dia',\n"
        "          'cvr_tpu_torch.formats.bell',\n"
        "          'cvr_tpu_torch.formats.sell_window',\n"
        "          'cvr_tpu_torch.ops.kernels', 'cvr_tpu_torch.ops.spmv',\n"
        "          'cvr_tpu_torch.ops.spmv_dia', 'cvr_tpu_torch.ops.spmv_bell',\n"
        "          'cvr_tpu_torch.ops.spmv_window', 'chip_smoke'):\n"
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
