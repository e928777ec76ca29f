"""The port's routed SpMV slice end to end, against the JAX package's
``spmv_routed`` (Pallas interpret mode) and the float64 golden, at the
row-scaled 1e-6 contract; plus the bench harness and the CLI on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

import cvr_tpu.ops.pallas_route as jpr
from cvr_tpu.formats.sell_routed import sell_pack_routed as j_pack_routed
from cvr_tpu.io.mmio import read_matrix_market as j_read
from cvr_tpu.ops.spmv_routed import spmv_routed as j_spmv
from cvr_tpu.ops.spmv_routed import to_device_routed as j_to_device

import cvr_tpu_torch.ops.route_planes as tpr
from cvr_tpu_torch import cli
from cvr_tpu_torch.bench.harness import run_spmv_benchmark
from cvr_tpu_torch.formats.sell_routed import sell_pack_routed as t_pack_routed
from cvr_tpu_torch.io.mmio import read_matrix_market as t_read
from cvr_tpu_torch.io.mmio import write_matrix_market
from cvr_tpu_torch.ops import route_kernels as rk
from cvr_tpu_torch.ops.spmv_ref import spmv_golden_numpy, spmv_row_scale, verify
from cvr_tpu_torch.ops.spmv_routed import spmv_routed, to_device_routed
from torch_cases import CASES, FIXTURES, fsm, powerlaw, rmat, tall_sparse


def _port_spmv(tcoo, x, split_len=None, hot="off"):
    tsr = t_pack_routed(tcoo.to_csr(), split_len=split_len, hot=hot)
    rk.reset_launches()
    y = spmv_routed(to_device_routed(tsr, "cpu"), torch.from_numpy(x)).numpy()
    # CPU tensors: every pass ran its plain version, no kernel launched
    assert all(w.launches == 0 for w, _, _ in rk.KERNELS.values())
    return tsr, y


def _check(jcoo, tcoo, split_len=None, hot="off"):
    x = np.random.default_rng(7).standard_normal(tcoo.shape[1]).astype(np.float32)
    tsr, y = _port_spmv(tcoo, x, split_len, hot)
    jsr = j_pack_routed(jcoo.to_csr(), split_len=split_len, hot=hot)
    y_jax = np.asarray(jax.jit(j_spmv)(j_to_device(jsr), x))
    csr = tcoo.to_csr()
    scale = spmv_row_scale(csr, x)
    ok, nbad, maxrel = verify(y, spmv_golden_numpy(csr, x), rtol=1e-6,
                              row_scale=scale)
    assert ok, f"golden: {nbad} bad rows, max rel {maxrel}"
    ok, nbad, maxrel = verify(y, y_jax, rtol=1e-6, row_scale=scale)
    assert ok, f"JAX spmv_routed: {nbad} bad rows, max rel {maxrel}"
    return tsr, y


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.name)
def test_fixture_matches_reference(path):
    _check(j_read(path), t_read(path))


@pytest.mark.parametrize(
    "case", sorted(set(CASES) - {"rmat_T2048", "multisegment"})
)
def test_slice_matches_reference(case):
    make, split_len = CASES[case]
    tsr, y = _check(*make(), split_len=split_len)
    if case == "empty_rows_cols":
        assert tsr.ymask.shape[0] and (y[tsr.ymask == 0] == 0).all()


def test_slice_multi_group_matches_reference(monkeypatch):
    monkeypatch.setattr(jpr, "YB", 2)
    monkeypatch.setattr(tpr, "YB", 2)
    tsr, _ = _check(*rmat(12, 8, 4))
    assert len(tsr.ycall_rows) >= 2


@pytest.mark.parametrize("case", ["powerlaw_forced", "fsm_auto"])
def test_slice_with_hot_planes_matches_reference(monkeypatch, case):
    """The hub-column hybrid end to end: a power-law pack with the hybrid
    forced on (the reference's CVR_HOT=1) and a small fsm-like pack whose
    gate fires by itself."""
    if case == "powerlaw_forced":
        monkeypatch.setenv("CVR_HOT", "1")
        jcoo, tcoo = powerlaw(n=20000, avg_nnz=8, seed=5)
    else:
        jcoo, tcoo = fsm(n=1 << 17)
    tsr, _ = _check(jcoo, tcoo, hot="auto")
    assert tsr.hot is not None and tsr.nnz == tcoo.nnz
    if case == "fsm_auto":
        assert tsr.hot.regions.shape[0] > 0


def test_slice_over_1024_y_tiles_matches_reference():
    """Just over 1,048,576 rows: the y-route of 2048 tiles (K5, K2, K6,
    K5) against the JAX package's and the golden."""
    tsr, _ = _check(*tall_sparse())
    assert tsr.y_ra["Tp"] == 2048 and tsr.y_ra["mid_planes"]["kind"] == "rec"


@pytest.mark.parametrize("case", ["rmat_T2048", "multisegment"])
def test_large_stream_against_golden(case):
    """T >= 2048 tiles (the recursive middle) and a two-segment x table,
    torch only: the JAX interpret-mode pipeline is too slow at this size."""
    _, tcoo = CASES[case][0]()
    x = np.random.default_rng(1).standard_normal(tcoo.shape[1]).astype(np.float32)
    tsr, y = _port_spmv(tcoo, x)
    csr = tcoo.to_csr()
    ok, nbad, maxrel = verify(y, spmv_golden_numpy(csr, x), rtol=1e-6,
                              row_scale=spmv_row_scale(csr, x))
    assert ok, f"{nbad} bad rows, max rel {maxrel}"
    if case == "rmat_T2048":
        assert tsr.T >= 2048 and tsr.mid["kind"] == "rec"


@pytest.mark.parametrize("impl", ["sell-routed", "csr"])
def test_harness_cpu_run(impl, capsys):
    _, tcoo = powerlaw(n=2000, seed=4)
    r = run_spmv_benchmark(tcoo, name="pl", impl=impl, iters=2, device="cpu")
    assert r.verified and r.device == "cpu" and r.spmv_s > 0
    r.print_report()
    out = capsys.readouterr().out
    for tag in ("Pre-processing Time", "SpMV Execution Time", "Throughput",
                "Verification: PASS"):
        assert tag in out


def test_harness_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tcoo = powerlaw(n=500, seed=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_spmv_benchmark(tcoo, device="cuda")


def test_cli_spmv_and_info(tmp_path, capsys):
    _, tcoo = powerlaw(n=1500, seed=6)
    p = tmp_path / "m.mtx"
    write_matrix_market(p, tcoo)
    assert cli.main(["spmv", str(p), "--device", "cpu", "--iters", "2"]) == 0
    assert "Verification: PASS" in capsys.readouterr().out
    assert cli.main(["info", str(p)]) == 0
    assert "sell-pack: C=1024" in capsys.readouterr().out
