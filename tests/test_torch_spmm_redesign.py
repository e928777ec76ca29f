"""The arithmetic of K11 (dia_spmm) and K12 (bsr_spmm) as the H100 kernels
do it, on the CPU, where neither kernel runs.

K11 walks its diagonals in windows that ``dia_windows`` plans on the host:
the plan is held to its budget and to pack order, and the sum taken window
by window, as the kernel stages X, equals the plain version and the JAX
package's ``spmm_dia_pallas`` / ``spmm_dia_xla``.  K12 multiplies with
3xTF32 on the tensor cores; its arithmetic is emulated here in torch (the
round-to-nearest-away TF32 split done on the floats' bits, each mma's exact
product sum rounded toward zero to float32 as the tensor core rounds) and
held to 1e-6 of the row scale against the JAX package's ``bsr_spmm_pallas``
(Pallas in interpret mode) and float64; one TF32 pass misses that.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvr_tpu.formats.bsr import bsr_pack as j_bsr_pack
from cvr_tpu.formats.dia import dia_pack as j_dia_pack
from cvr_tpu.ops.pallas_bsr import bsr_spmm_pallas
from cvr_tpu.ops.pallas_dia import spmm_dia_pallas
from cvr_tpu.ops.spmm_bsr import to_device_bsr as j_to_device_bsr
from cvr_tpu.ops.spmv_dia import spmm_dia_xla
from cvr_tpu.ops.spmv_dia import to_device_dia as j_to_device_dia

from cvr_tpu_torch.formats import bsr as tbsr
from cvr_tpu_torch.formats.dia import dia_pack
from cvr_tpu_torch.ops import dia_kernels as dk
from cvr_tpu_torch.ops import spmm_bsr
from cvr_tpu_torch.ops.spmv_dia import to_device_dia
from test_torch_spmm_kernels import _X, _close
from torch_cases import banded, diagonals, empty_blocks, random_rect

WIDE_REACH = (-2500, -1, 0, 1, 1800)
DIA_CASES = {
    "banded27": lambda: banded(3000, 27),
    "asymmetric": lambda: diagonals(3000, 3000, (-300, -5, 0, 7, 129, 600)),
    "wide": lambda: diagonals(3000, 20_000, (0, 2, 500)),
    "wide_reach": lambda: diagonals(4000, 4000, WIDE_REACH),
}
BSR_CASES = {
    "banded": lambda: banded(2000, 9),
    "random_rect": random_rect,
    "empty_blocks": empty_blocks,
}


# --------------------------------------------------------------------------
# K11: the window plan and the sum window by window
# --------------------------------------------------------------------------


@pytest.mark.parametrize("offsets,budget,nwin", [
    (range(-13, 14), dk.WINDOW_BYTES, 1),
    (WIDE_REACH, dk.WINDOW_BYTES, 3),
    ((-300, -5, 0, 7, 129, 600), dk.WINDOW_BYTES, None),
    ((0, 2, 500), dk.WINDOW_BYTES, None),
    (range(-13, 14), dk.window_bytes(range(-13, -4)), None),
    (np.unique(np.random.default_rng(3).integers(-3000, 3000, 40)),
     dk.WINDOW_BYTES, None),
    ((), dk.WINDOW_BYTES, 0),
], ids=["band27", "wide_reach", "asymmetric", "wide", "band27_small_budget",
        "scattered40", "none"])
def test_dia_windows_cover_each_diagonal_once(offsets, budget, nwin):
    """Windows are consecutive runs of the pack order that cover every
    diagonal once; each fits the budget and stops only where the next
    diagonal would not fit."""
    offs = list(offsets)
    starts = dk.dia_windows(offs, budget=budget)
    assert starts.dtype == np.int32 and starts[0] == 0
    assert starts[-1] == len(offs) and (np.diff(starts) > 0).all()
    if nwin is not None:
        assert len(starts) - 1 == nwin
    for a, b in zip(starts[:-1], starts[1:]):
        assert dk.window_bytes(offs[a:b]) <= budget
        if b < len(offs):
            assert dk.window_bytes(offs[a:b + 1]) > budget


@pytest.mark.parametrize("case,several", [
    ("banded27", False), ("wide_reach", True),
])
def test_dia_windows_of_the_packs(case, several):
    """banded(3000, 27) is one window: 154 X rows by 64 columns and 27
    band rows, 52 KB; the wide reach (offsets -2500 .. 1800) is several."""
    _, tcoo = DIA_CASES[case]()
    sd = to_device_dia(dia_pack(tcoo.to_csr()), "cpu")
    windows, nwin, smem = dk.window_plan(sd.offsets)
    assert (nwin > 1) == several
    assert np.array_equal(windows.numpy(), dk.dia_windows(sd.offsets))
    assert smem <= dk.WINDOW_BYTES
    if case == "banded27":
        assert smem == (154 * 64 + 27 * 128) * 4


def test_window_plan_kept_on_the_offsets():
    """The upload makes the plan once; a write to the offsets remakes it."""
    _, tcoo = DIA_CASES["banded27"]()
    sd = to_device_dia(dia_pack(tcoo.to_csr()), "cpu")
    first = dk.window_plan(sd.offsets)
    assert dk.window_plan(sd.offsets)[0] is first[0]
    assert first[1] == 1
    sd.offsets[-1] = 5000  # a reach past one window
    assert dk.window_plan(sd.offsets)[1] == 2


def _dia_windowed(bands, offsets, X, starts):
    """Y as K11 sums it: per tile of TM rows and K tile of KT columns, per
    window, the window's X rows staged (zero outside [0, ncols)), then each
    diagonal of the window in pack order, 8 consecutive rows a thread
    reading staged rows ``row + off - omin``.  Products rounded before the
    add, as the plain version does them (the kernel's fmaf rounds once)."""
    nd, nrows = bands.shape
    ncols, K = X.shape
    TM, KT = dk.TM, dk.KT
    ntiles = -(-nrows // TM)
    bandsp = F.pad(bands, (0, ntiles * TM - nrows)).view(nd, ntiles, TM)
    r0 = torch.arange(ntiles)[:, None] * TM
    offs = [int(o) for o in offsets]
    Y = torch.empty((ntiles * TM, K))
    for k0 in range(0, K, KT):
        Xk = X[:, k0:k0 + KT]
        acc = torch.zeros((ntiles, TM, Xk.shape[1]))
        for a, b in zip(starts[:-1], starts[1:]):
            omin, omax = min(offs[a:b]), max(offs[a:b])
            g = r0 + omin + torch.arange(TM + omax - omin)[None, :]
            inside = ((g >= 0) & (g < ncols))[..., None]
            xs = torch.where(inside, Xk[g.clamp(0, ncols - 1)], 0.0)
            for d in range(a, b):
                local = offs[d] - omin
                acc = acc + bandsp[d][..., None] * xs[:, local:local + TM]
        Y[:, k0:k0 + KT] = acc.reshape(ntiles * TM, -1)
    return Y[:nrows]


@pytest.mark.parametrize("case,K,budget", [
    ("banded27", 5, None), ("banded27", 130, None),
    ("banded27", 17, dk.window_bytes(range(-13, -4))),
    ("asymmetric", 17, None), ("wide", 33, None),
    ("wide_reach", 9, None), ("wide_reach", 130, None),
])
def test_windowed_sum_matches_plain_and_reference(case, K, budget):
    """Summed window by window in the kernel's order, Y equals the plain
    version bit for bit (same order, same roundings) and is within 1e-6 of
    the row scale of the JAX package's spmm_dia_pallas, or of its XLA form
    beyond the Pallas kernel's halo (the wide reach)."""
    jcoo, tcoo = DIA_CASES[case]()
    X = _X(tcoo.shape[1], K)
    td = to_device_dia(dia_pack(tcoo.to_csr()), "cpu")
    starts = dk.dia_windows(td.offsets, budget=budget or dk.WINDOW_BYTES)
    if budget is not None:
        assert len(starts) > 2  # the small budget splits the band
    Xt = torch.from_numpy(X)
    got = _dia_windowed(td.bands, td.offsets, Xt, starts)
    assert torch.equal(got, dk.dia_spmm_plain(td.bands, td.offsets, Xt))
    jd = j_to_device_dia(j_dia_pack(jcoo.to_csr()))
    ref = spmm_dia_xla if case == "wide_reach" else spmm_dia_pallas
    _close(got.numpy(), jax.jit(ref)(jd, X), tcoo, X)


# --------------------------------------------------------------------------
# K12: 3xTF32, emulated
# --------------------------------------------------------------------------


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to the nearest TF32 value (10 mantissa bits),
    ties away from zero: add half of the dropped 13 bits' range to the
    magnitude and clear them.  Float bits are sign and magnitude, so the
    integer add moves the magnitude whatever the sign."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mma(d, a, x):
    """One mma.sync m16n8k8 f32.tf32.tf32.f32 over a batch: d + a @ x with
    the TF32 products and their sum exact (float64 here) and the result
    rounded toward zero to float32."""
    exact = d.double() + torch.bmm(a.double(), x.double())
    r = exact.float()
    away = r.double().abs() > exact.abs()
    return torch.where(away, torch.nextafter(r, torch.zeros_like(r)), r)


def _bsr_tf32(vals, brick_row, brick_col, row_start, X, nrows, passes=3):
    """Y as K12 computes it: per row block its bricks in stream order, per
    brick its k-steps of 8 columns in order; each k-step a partial from 0
    through the tensor core, A_lo X_hi, then A_hi X_lo, then A_hi X_hi
    (``passes=1``: A_hi X_hi alone, one TF32 pass), added to the float32
    accumulator."""
    B = tbsr.B
    nrb = row_start.shape[0] - 1
    ncols, K = X.shape
    ncb = -(-ncols // B)
    gx = F.pad(X, (0, 0, 0, ncb * B - ncols)).view(ncb, B, K)[
        brick_col.long()]
    ahi, xhi = _tf32_rna(vals), _tf32_rna(gx)
    alo, xlo = _tf32_rna(vals - ahi), _tf32_rna(gx - xhi)
    acc = torch.zeros((nrb, B, K))
    count = row_start.diff()
    for p in range(int(count.max()) if nrb else 0):
        rbs = torch.nonzero(count > p).flatten()
        b = row_start[rbs] + p
        for s in range(0, B, 8):
            a_hi, a_lo = ahi[b, :, s:s + 8], alo[b, :, s:s + 8]
            x_hi, x_lo = xhi[b, s:s + 8], xlo[b, s:s + 8]
            d = torch.zeros((b.shape[0], B, K))
            if passes == 3:
                d = _mma(d, a_lo, x_hi)
                d = _mma(d, a_hi, x_lo)
            d = _mma(d, a_hi, x_hi)
            acc[rbs] = acc[rbs] + d
    return acc.reshape(nrb * B, K)[:nrows]


def _golden(tcoo, X):
    csr = tcoo.to_csr()
    Y = np.zeros((csr.shape[0], X.shape[1]))
    np.add.at(Y, csr.row_ids(), csr.vals.astype(np.float64)[:, None]
              * X.astype(np.float64)[csr.cols])
    return Y


def test_tf32_rna_rounds_to_nearest_away():
    """The emulated cvt.rna against rounding in float64: the low 13 bits
    cleared, the nearest TF32 value taken, ties away from zero."""
    one = 1.0
    ties = [one + 2.0**-11, -(one + 2.0**-11), 3 + 2.0**-10]
    near = [one + 2.0**-11 - 2.0**-23, one + 2.0**-11 + 2.0**-23]
    rng = np.random.default_rng(11)
    v = np.concatenate([ties, near, rng.standard_normal(10_000),
                        rng.standard_normal(1000) * 1e-30,
                        rng.standard_normal(1000) * 1e30]).astype(np.float32)
    got = _tf32_rna(torch.from_numpy(v)).numpy()
    assert not (got.view(np.int32) & 0x1FFF).any()
    v64 = v.astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(v64))) - 10)
    want = np.sign(v64) * np.floor(np.abs(v64) / ulp + 0.5) * ulp
    np.testing.assert_array_equal(got.astype(np.float64), want)
    np.testing.assert_array_equal(
        got[:5], np.float32([one + 2.0**-10, -(one + 2.0**-10),
                             3 + 2.0**-9, one, one + 2.0**-10]))


def _bsr_case(case, K):
    jcoo, tcoo = BSR_CASES[case]()
    jbm = j_bsr_pack(jcoo.to_csr(), min_fill=0.0)
    X = _X(tcoo.shape[1], K)
    dev = spmm_bsr.to_device_bsr(tbsr.from_reference(jbm), "cpu")
    return jbm, tcoo, X, spmm_bsr.kernel_args(dev, torch.from_numpy(X))


@pytest.mark.parametrize("K", [1, 5, 17, 130])
@pytest.mark.parametrize("case", ["banded", "random_rect", "empty_blocks"])
def test_3xtf32_matches_pallas_and_float64(case, K):
    """K12's 3xTF32 product, emulated, within 1e-6 of the row scale of the
    reference's bsr_spmm_pallas (HIGHEST precision, interpret mode) and of
    the float64 product."""
    jbm, tcoo, X, args = _bsr_case(case, K)
    got = _bsr_tf32(*args).numpy()
    _close(got, np.asarray(bsr_spmm_pallas(j_to_device_bsr(jbm), X)),
           tcoo, X)
    _close(got, _golden(tcoo, X), tcoo, X)
    if case == "empty_blocks":  # rows of the empty row blocks are zeros
        assert not got[:128].any() and not got[640:].any()


@pytest.mark.parametrize("case", ["banded", "random_rect", "empty_blocks"])
def test_single_tf32_pass_misses_the_contract(case):
    """One TF32 pass (A_hi X_hi) keeps about three decimal digits: it
    misses 1e-6 of the row scale, which is why K12 takes three."""
    _, tcoo, X, args = _bsr_case(case, 17)
    with pytest.raises(AssertionError), np.errstate(invalid="ignore"):
        _close(_bsr_tf32(*args, passes=1).numpy(), _golden(tcoo, X), tcoo, X)
