"""The port's host layer against the JAX package's, array for array.

cvr_tpu_torch carries its own jax-free ingest, CSR, SELL and SELL-R pack
over the shared native library; for the same input it must build exactly
the arrays cvr_tpu builds (hot-column hybrid off).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import cvr_tpu.ops.pallas_route as jpr
from cvr_tpu.formats.sell import sell_pack as j_sell_pack
from cvr_tpu.formats.sell_routed import sell_pack_routed as j_pack_routed
from cvr_tpu.io.mmio import read_matrix_market as j_read
from cvr_tpu.ops.route import apply_route_numpy as j_apply_route

import cvr_tpu_torch.ops.route_planes as tpr
from cvr_tpu_torch.formats.sell import sell_pack as t_sell_pack
from cvr_tpu_torch.formats.sell_routed import (
    _FIELDS,
    from_reference,
    sell_pack_routed as t_pack_routed,
)
from cvr_tpu_torch.io.mmio import (
    MatrixMarketError,
    read_matrix_market as t_read,
    write_matrix_market as t_write,
)
from cvr_tpu_torch.ops.route import apply_route_numpy, plan_route
from torch_cases import CASES, FIXTURES, banded, powerlaw, rmat

REPO = Path(__file__).resolve().parent.parent


def _same(a, b, path="sr"):
    """Deep equality of artifacts: arrays bit for bit, dicts key by key."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _check_pack(jcoo, tcoo, split_len=None):
    jcsr, tcsr = jcoo.to_csr(), tcoo.to_csr()
    _same(vars(jcsr), vars(tcsr), "csr")
    jsr = j_pack_routed(jcsr, split_len=split_len, hot="off")
    tsr = t_pack_routed(tcsr, split_len=split_len, hot="off")
    for k in _FIELDS:
        if k not in ("convert_time", "convert_phases"):
            _same(getattr(jsr, k), getattr(tsr, k), k)
    # the reference artifact carried across is the port's, field for field
    rsr = from_reference(jsr)
    for k in _FIELDS:
        if k not in ("convert_time", "convert_phases"):
            _same(getattr(rsr, k), getattr(tsr, k), k)
    return tsr


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.name)
def test_fixture_ingest_and_pack_match_reference(path):
    jcoo, tcoo = j_read(path), t_read(path)
    _same(vars(jcoo), vars(tcoo), "coo")
    _check_pack(jcoo, tcoo)


@pytest.mark.parametrize("case", sorted(CASES))
def test_routed_pack_matches_reference(case):
    make, split_len = CASES[case]
    tsr = _check_pack(*make(), split_len=split_len)
    if case == "rmat_split16":
        assert tsr.extra_src.shape[0] > 0
    if case == "empty_rows_cols":
        assert tsr.ymask.shape[0] > 0
    if case == "uniform_w16":
        assert tsr.regions.shape[0] > 0 and tsr.nslA > 0
    if case == "rmat_T2048":
        assert tsr.T >= 2048 and tsr.mid["kind"] == "rec"
    if case == "multisegment":
        assert tsr.n_segs >= 2


def test_routed_pack_multi_group_matches_reference(monkeypatch):
    # YB read at call time in both packages: several reduce groups at a
    # CPU-test size
    monkeypatch.setattr(jpr, "YB", 2)
    monkeypatch.setattr(tpr, "YB", 2)
    tsr = _check_pack(*rmat(12, 8, 4))
    assert len(tsr.ycall_rows) >= 2


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_sell_pack_matches_reference(native):
    jcoo, tcoo = powerlaw(seed=5)
    jcsr, tcsr = jcoo.to_csr(), tcoo.to_csr()
    jsm = j_sell_pack(jcsr, use_native=native)
    tsm = t_sell_pack(tcsr, use_native=native)
    for k in ("vals_plane", "cols_plane", "slice_offsets", "slot_slice",
              "perm", "seg_offset", "row_rank", "lane_lengths", "shape",
              "nnz", "C", "sigma", "split_len", "n_splits"):
        _same(getattr(jsm, k), getattr(tsm, k), k)


def test_synthetic_generators_match_reference():
    for j, t in (rmat(9, 6, 3), banded(500, 7, 1)):
        _same(vars(j), vars(t), "coo")


def test_plan_route_executes_the_permutation():
    perm = np.random.default_rng(0).permutation(2 * 1024 + 300)
    plan = plan_route(perm)
    v = np.arange(perm.shape[0], dtype=np.float32)
    np.testing.assert_array_equal(apply_route_numpy(plan, v), v[perm])
    # the reference's executor reads the port's planes the same way
    np.testing.assert_array_equal(j_apply_route(plan, v), v[perm])


def test_route_arrays_and_emit_codes_match_reference():
    perm = np.random.default_rng(1).permutation(1024 * 1024 - 5000)
    _same(jpr.route_arrays_from_perm(perm), tpr.route_arrays_from_perm(perm))
    emit = np.full(4096, -1, dtype=np.int32)
    rng = np.random.default_rng(2)
    ends = np.sort(rng.choice(4096, 700, replace=False))
    emit[ends] = np.arange(700) % 512
    _same(jpr.group_emit_encode(emit), tpr.group_emit_encode(emit))


def test_mmio_roundtrip_and_truncated(tmp_path):
    _, tcoo = powerlaw(n=200, seed=9)
    p = tmp_path / "m.mtx"
    t_write(p, tcoo)
    back = t_read(p)
    np.testing.assert_array_equal(back.to_dense(), tcoo.to_dense())
    lines = p.read_text().splitlines(keepends=True)
    p.write_text("".join(lines[: len(lines) // 2]))
    with pytest.raises(MatrixMarketError):
        t_read(p, use_native=False)


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, pkgutil, importlib, cvr_tpu_torch\n"
        "for m in pkgutil.walk_packages(cvr_tpu_torch.__path__, 'cvr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'cvr_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
