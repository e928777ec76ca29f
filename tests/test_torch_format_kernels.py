"""The plain versions of K8-K10 against the JAX package's functions they
replace, at CPU-test sizes: the DIA roll kernel (Pallas, interpret mode)
and its XLA form, the BELL gather-multiply (the flat form the reference
itself runs off the TPU, and its Pallas kernel in interpret mode at the
smallest geometry) and the SELL-W window reduce (Pallas, interpret mode,
one call per reduce group).  Sums are held to 1e-6 of the row scale
(the plain version on |values| and |x|): the orders of summation differ.
"""

import jax
import numpy as np
import pytest
import torch

import cvr_tpu.ops.pallas_window as jpw
from cvr_tpu.formats.bell import bell_pack as j_bell_pack
from cvr_tpu.formats.dia import dia_pack as j_dia_pack
from cvr_tpu.formats.sell_window import sell_pack_window as j_pack_window
from cvr_tpu.ops.pallas_bell import _bell_call, _bell_gather_mac_jnp, ncand_of
from cvr_tpu.ops.pallas_dia import spmv_dia_pallas
from cvr_tpu.ops.pallas_window import window_reduce as j_window_reduce
from cvr_tpu.ops.spmv_dia import spmv_dia_xla
from cvr_tpu.ops.spmv_dia import to_device_dia as j_to_device_dia
from cvr_tpu.ops.spmv_window import _x_table
from cvr_tpu.ops.spmv_window import to_device_window as j_to_device_window

import cvr_tpu_torch.ops.route_planes as tpr
from cvr_tpu_torch.formats.bell import bell_pack
from cvr_tpu_torch.formats.dia import dia_pack
from cvr_tpu_torch.formats.sell_window import sell_pack_window
from cvr_tpu_torch.ops import bell_kernels as bk
from cvr_tpu_torch.ops import dia_kernels as dk
from cvr_tpu_torch.ops import window_kernels as wk
from cvr_tpu_torch.ops.spmv_bell import gather_args, to_device_bell
from cvr_tpu_torch.ops.spmv_dia import to_device_dia
from cvr_tpu_torch.ops.spmv_window import reduce_args, to_device_window
from torch_cases import WINDOW_CASES, banded, diagonals, rgg, road


def _x(n, seed=7):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _close(got, want, scale):
    got, want, scale = (np.asarray(a, dtype=np.float64)
                        for a in (got, want, scale))
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= 1e-6 * scale + 1e-30).all(), float((err / scale).max())


@pytest.mark.parametrize("case", ["banded27", "asymmetric", "wide"])
def test_dia_spmv_plain_matches_reference(case):
    jcoo, tcoo = {
        "banded27": lambda: banded(3000, 27),
        "asymmetric": lambda: diagonals(3000, 3000, (-300, -5, 0, 7, 129, 1000)),
        "wide": lambda: diagonals(3000, 200_000, (0, 2, 5000, 150_000)),
    }[case]()
    x = _x(tcoo.shape[1])
    jd = j_to_device_dia(j_dia_pack(jcoo.to_csr()))
    td = to_device_dia(dia_pack(tcoo.to_csr()), "cpu")
    xt = torch.from_numpy(x)
    dk.dia_spmv.launches = 0
    got = dk.dia_spmv(td.bands, td.offsets, xt).numpy()
    assert dk.dia_spmv.launches == 0  # CPU tensors: the plain version
    scale = dk.dia_spmv_plain(td.bands.abs(), td.offsets, xt.abs()).numpy()
    _close(got, jax.jit(spmv_dia_pallas)(jd, x), scale)
    _close(got, jax.jit(spmv_dia_xla)(jd, x), scale)


@pytest.mark.parametrize("case", ["rgg", "road_spill"])
def test_bell_gather_mac_plain_matches_reference(case):
    """At a pack's own planes, against ``_bell_gather_mac_jnp`` on the
    reference's x table (pre zero rows, x[:n_keep], zeros)."""
    jcoo, tcoo = rgg() if case == "rgg" else road()
    bm = bell_pack(tcoo.to_csr())
    jbm = j_bell_pack(jcoo.to_csr())
    x = _x(tcoo.shape[1])
    li, vals, xt, d, pre, n_keep = gather_args(to_device_bell(bm, "cpu"),
                                               torch.from_numpy(x))
    X = bm.R_sub + bm.TBb * 8
    table = np.zeros(X * 128, dtype=np.float32)
    table[pre * 128 : pre * 128 + n_keep] = x[:n_keep]
    want = _bell_gather_mac_jnp(jbm.li, jbm.vals, table.reshape(X, 128),
                                jbm.d)
    got = bk.bell_gather_mac(li, vals, xt, d, pre, n_keep).numpy()
    scale = bk.bell_gather_mac_plain(li, vals.abs(), xt.abs(), d, pre,
                                     n_keep).numpy()
    _close(got, want, scale)


def test_bell_gather_mac_plain_matches_pallas_interpret():
    """Against the Pallas BELL kernel itself (interpret mode, ~2 s to
    compile here) at its smallest geometry: R_sub 64, TBb 8, k 2, window
    offsets over all ncand 128-column blocks."""
    k, R_sub, TBb, reach = 2, 64, 8, 64
    cr = -(-reach // 128)
    pre = 8
    d, ncand = pre - cr, ncand_of(reach)
    rng = np.random.default_rng(0)
    li = rng.integers(0, ncand * 128, (k, R_sub, 128)).astype(np.int16)
    vals = rng.standard_normal((k, R_sub, 128)).astype(np.float32)
    table = rng.standard_normal((R_sub + TBb * 8, 128)).astype(np.float32)
    table[:pre] = 0.0  # the x table's zero rows before x
    want = _bell_call(k, ncand, d, R_sub, TBb, True)(li, vals, table)
    x = torch.from_numpy(table.reshape(-1)[pre * 128 :].copy())
    lit, vt = torch.from_numpy(li), torch.from_numpy(vals)
    n = x.shape[0]
    got = bk.bell_gather_mac(lit, vt, x, d, pre, n).numpy()
    scale = bk.bell_gather_mac_plain(lit, vt.abs(), x.abs(), d, pre, n)
    _close(got, want, scale.numpy())


def _window_reference(jsw, x):
    """ys (8, nslices, 128): the reference's window_reduce per reduce
    group, as its spmv_window calls it (zero-width groups give zeros)."""
    sd = j_to_device_window(jsw)
    x3 = _x_table(sd, x)
    parts = []
    for j, (r0, nr) in enumerate(sd.ycall_rows):
        nsl = min(jpw.YB, sd.nslices - j * jpw.YB)
        if nr == 0:
            parts.append(np.zeros((8, nsl, 128), np.float32))
            continue
        parts.append(np.asarray(j_window_reduce(
            sd.emit[r0 : r0 + nr], sd.w10[r0 : r0 + nr],
            sd.seg_blk[r0 // jpw.CH : (r0 + nr) // jpw.CH],
            sd.gemit[r0 // 8 : (r0 + nr) // 8], sd.li[:, r0 : r0 + nr],
            sd.vals_ss[:, r0 : r0 + nr], x3, nsl, sd.W, sd.segw, sd.G,
            wrl=sd.wrl,
        )))
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("case,yb", [
    ("banded_D2_wrl7", 512),
    ("W2048_wrl15", 512),
    ("segw2", 512),
    ("rectangular", 512),
    ("empty_rows", 2),
])
def test_window_reduce_plain_matches_reference(case, yb, monkeypatch):
    """D 1 and 2, W 1024 and 2048 with wrl below W/128, four x segments,
    a rectangular matrix, and zero-width slices and reduce groups over
    several reduce calls (YB 2)."""
    monkeypatch.setattr(jpw, "YB", yb)
    monkeypatch.setattr(tpr, "YB", yb)
    make, segw = WINDOW_CASES[case]
    jcoo, tcoo = make()
    kw = {} if segw is None else {"segw": segw}
    jsw = j_pack_window(jcoo.to_csr(), **kw)
    sw = sell_pack_window(tcoo.to_csr(), **kw)
    x = _x(tcoo.shape[1])
    args = reduce_args(to_device_window(sw, "cpu"), torch.from_numpy(x))
    got = wk.window_reduce(*args).numpy()
    li, vals, w10, seg_blk, xt, *rest = args
    scale = wk.window_reduce_plain(li, vals.abs(), w10, seg_blk, xt.abs(),
                                   *rest).numpy()
    _close(got, _window_reference(jsw, x), scale)
    if case == "empty_rows":
        assert len(sw.ycall_rows) > 2 and (sw.ycall_rows[:, 1] == 0).any()
