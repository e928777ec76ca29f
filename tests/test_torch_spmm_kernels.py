"""The plain versions of K11-K14 against the JAX package's callers of the
Pallas kernels they replace, at CPU-test sizes, the JAX side in interpret
mode: ``spmm_dia_pallas`` (and ``spmm_dia_xla`` beyond its halo),
``bsr_spmm_pallas``, ``spmm_lane`` and ``spmm_pmm`` (one segment, and
several with ``SEG`` at 64).  Both packages run the same planes: the
reference's artifacts carried across with ``from_reference``.  Sums are
held to 1e-6 of the row scale |A| |X| (float64): the orders of summation
differ.  Each wrapper, given CPU tensors, runs its plain version and
launches nothing; given tensors elsewhere, it raises.
"""

import jax
import numpy as np
import pytest
import torch

import cvr_tpu.ops.spmm_pmm as jpmm
from cvr_tpu.formats.bsr import bsr_pack as j_bsr_pack
from cvr_tpu.formats.dia import dia_pack as j_dia_pack
from cvr_tpu.ops.pallas_bsr import bsr_spmm_pallas
from cvr_tpu.ops.pallas_dia import spmm_dia_pallas
from cvr_tpu.ops.spmm_bsr import to_device_bsr as j_to_device_bsr
from cvr_tpu.ops.spmm_lane import spmm_lane as j_spmm_lane
from cvr_tpu.ops.spmm_lane import spmm_lane_pack as j_spmm_lane_pack
from cvr_tpu.ops.spmm_lane import to_device_lane as j_to_device_lane
from cvr_tpu.ops.spmv_dia import spmm_dia_xla
from cvr_tpu.ops.spmv_dia import to_device_dia as j_to_device_dia

from cvr_tpu_torch.formats import bsr as tbsr
from cvr_tpu_torch.formats.dia import dia_pack
from cvr_tpu_torch.ops import bsr_kernels as bk
from cvr_tpu_torch.ops import dia_kernels as dk
from cvr_tpu_torch.ops import kernels
from cvr_tpu_torch.ops import lane_kernels as lk
from cvr_tpu_torch.ops import pmm_kernels as pk
from cvr_tpu_torch.ops import spmm_bsr, spmm_lane, spmm_pmm
from cvr_tpu_torch.ops.spmv_dia import to_device_dia
from torch_cases import (
    banded,
    diagonals,
    empty_blocks,
    fsm,
    powerlaw,
    random_rect,
    rmat,
)


def _X(ncols, K, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (ncols, K)).astype(np.float32)


def _close(got, want, tcoo, X):
    """|got - want| <= 1e-6 * (|A| @ |X|) entry by entry."""
    csr = tcoo.to_csr()
    scale = np.zeros((csr.shape[0], X.shape[1]))
    np.add.at(scale, csr.row_ids(),
              np.abs(csr.vals.astype(np.float64))[:, None]
              * np.abs(X.astype(np.float64))[csr.cols])
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape == scale.shape
    err = np.abs(got - want)
    assert (err <= 1e-6 * scale + 1e-30).all(), float((err / scale).max())


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launches()
    yield
    # CPU tensors: every wrapper ran its plain version
    assert not any(kernels.launches().values())


@pytest.mark.parametrize("case,K", [
    ("banded27", 5), ("banded27", 130), ("asymmetric", 17), ("wide", 33),
])
def test_dia_spmm_plain_matches_pallas(case, K):
    """Reach below the reference kernel's 1024-row halo, <= 128
    diagonals; negative offsets, one beyond 128, a wide matrix."""
    jcoo, tcoo = {
        "banded27": lambda: banded(3000, 27),
        "asymmetric": lambda: diagonals(3000, 3000, (-300, -5, 0, 7, 129,
                                                     600)),
        "wide": lambda: diagonals(3000, 20_000, (0, 2, 500)),
    }[case]()
    X = _X(tcoo.shape[1], K)
    jd = j_to_device_dia(j_dia_pack(jcoo.to_csr()))
    td = to_device_dia(dia_pack(tcoo.to_csr()), "cpu")
    got = dk.dia_spmm(td.bands, td.offsets, torch.from_numpy(X)).numpy()
    _close(got, jax.jit(spmm_dia_pallas)(jd, X), tcoo, X)


def test_dia_spmm_plain_matches_xla_beyond_the_halo():
    """A reach above 1024 rows, where the reference leaves its kernel for
    the XLA form; K11 and its plain version serve every reach."""
    jcoo, tcoo = diagonals(4000, 4000, (-2500, -1, 0, 1, 1800))
    X = _X(4000, 9)
    jd = j_to_device_dia(j_dia_pack(jcoo.to_csr()))
    with pytest.raises(ValueError, match="halo"):
        spmm_dia_pallas(jd, X)
    td = to_device_dia(dia_pack(tcoo.to_csr()), "cpu")
    got = dk.dia_spmm(td.bands, td.offsets, torch.from_numpy(X)).numpy()
    _close(got, jax.jit(spmm_dia_xla)(jd, X), tcoo, X)


@pytest.mark.parametrize("case,K", [
    ("banded", 17), ("banded", 130), ("random_rect", 5),
    ("empty_blocks", 33), ("empty_blocks", 1),
])
def test_bsr_spmm_plain_matches_pallas(case, K):
    jcoo, tcoo = {
        "banded": lambda: banded(2000, 9),
        "random_rect": random_rect,
        "empty_blocks": empty_blocks,
    }[case]()
    jbm = j_bsr_pack(jcoo.to_csr(), min_fill=0.0)
    X = _X(tcoo.shape[1], K)
    dev = spmm_bsr.to_device_bsr(tbsr.from_reference(jbm), "cpu")
    got = bk.bsr_spmm(*spmm_bsr.kernel_args(dev, torch.from_numpy(X)))
    want = np.asarray(bsr_spmm_pallas(j_to_device_bsr(jbm), X))
    _close(got.numpy(), want, tcoo, X)
    # the torch-ops path ("bsr-xla") is the same function
    np.testing.assert_array_equal(
        spmm_bsr.spmm_bsr(dev, torch.from_numpy(X)).numpy(), got.numpy())
    if case == "empty_blocks":  # rows of the empty row blocks are zeros
        assert not got[:128].any() and not got[640:].any()


@pytest.mark.parametrize("case,K", [
    ("powerlaw", 5), ("powerlaw", 130), ("rmat_split16", 33),
    ("empty_blocks", 17),
])
def test_lane_reduce_plain_matches_spmm_lane(case, K):
    """The port's spmm_lane (K13's plain version and the first-segment
    gather and extra scatter-add) against the reference's spmm_lane."""
    jcoo, tcoo, split_len = {
        "powerlaw": lambda: (*powerlaw(n=3000, avg_nnz=8, seed=1), None),
        "rmat_split16": lambda: (*rmat(11, 8, 5), 16),
        "empty_blocks": lambda: (*empty_blocks(), None),
    }[case]()
    jlp = j_spmm_lane_pack(jcoo.to_csr(), split_len=split_len)
    X = _X(tcoo.shape[1], K)
    sd = spmm_lane.to_device_lane(spmm_lane.from_reference(jlp), "cpu")
    got = spmm_lane.spmm_lane(sd, torch.from_numpy(X)).numpy()
    _close(got, np.asarray(j_spmm_lane(j_to_device_lane(jlp), X)), tcoo, X)
    # K13's slot sums: slots no slice fills (and the zero slot) are zeros
    ys = lk.lane_reduce(*spmm_lane.kernel_args(sd, torch.from_numpy(X)))
    assert not ys[-1024:].any()


@pytest.mark.parametrize("case,K,seg", [
    ("fsm", 32, 512), ("fsm", 130, 512), ("fsm", 16, 64),
    ("random_rect", 5, 512), ("empty_blocks", 8, 16), ("powerlaw", 1, 512),
])
def test_pmm_spmm_plain_matches_spmm_pmm(case, K, seg, monkeypatch):
    """Against the reference's spmm_pmm with SEG pairs per kernel call
    (its TPU scalar-memory limit): at 64 (16 for the 56 pairs of
    empty_blocks) the pair stream runs as several segments whose boundary
    row tiles the reference adds on the host."""
    monkeypatch.setattr(jpmm, "SEG", seg)
    jcoo, tcoo = {
        "fsm": lambda: fsm(n=1 << 12),
        "random_rect": lambda: random_rect(700, 900, 0.01),
        "empty_blocks": empty_blocks,
        "powerlaw": lambda: powerlaw(n=3000),
    }[case]()
    plan = jpmm.pmm_plan(jcoo.rows, jcoo.cols, jcoo.vals, jcoo.shape)
    jdev = jpmm.to_device_pmm(plan)
    if seg < 512:
        assert len(jdev.segs) >= 3
    X = _X(tcoo.shape[1], K)
    dev = spmm_pmm.to_device_pmm(spmm_pmm.from_reference(plan), "cpu")
    got = spmm_pmm.spmm_pmm(dev, torch.from_numpy(X)).numpy()
    _close(got, np.asarray(jpmm.spmm_pmm(jdev, X)), tcoo, X)
    # every element slot of the plan names its entry once
    assert int((dev.col >= 0).sum()) == tcoo.nnz


@pytest.mark.parametrize("wrapper,args", [
    (dk.dia_spmm, lambda t: (t((2, 8)), t((2,), torch.int64), t((8, 3)))),
    (bk.bsr_spmm, lambda t: (t((1, 128, 128)), t((1,), torch.int32),
                             t((1,), torch.int32), t((2,), torch.int64),
                             t((128, 3)), 100)),
    (lk.lane_reduce, lambda t: (t((1024,), torch.int32), t((1, 1024)),
                                t((2,), torch.int32), t((2,), torch.int32),
                                t((64, 3)))),
    (pk.pmm_spmm, lambda t: (t((128,), torch.int32), t((128,)),
                             t((128,), torch.int32), t((2,), torch.int64),
                             t((64, 3)), 100)),
], ids=["dia_spmm", "bsr_spmm", "lane_reduce", "pmm_spmm"])
def test_wrappers_take_no_plain_path_off_the_cpu(wrapper, args):
    """Given tensors that are not on the CPU, a wrapper launches its kernel
    or raises: it never runs the plain version (meta tensors stand in for
    a card here)."""
    def t(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match=wrapper.__name__):
        wrapper(*args(t))
    assert wrapper.launches == 0
