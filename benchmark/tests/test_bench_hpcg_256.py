"""The ``hpcg_256`` configuration's ``expect``, from HPCG's formula and
without making the matrix: an nx x ny x nz grid has nx ny nz rows and
(3nx - 2)(3ny - 2)(3nz - 2) stored entries (the formula is held to the
generator in ``test_bench_generators.py``)."""

from __future__ import annotations

from benchmark import matrix as mx
from benchmark import spec


def test_hpcg_256_expects_the_formulas_rows_and_entries():
    cfg = spec.config(spec.load(), "hpcg_256")
    assert mx.params(cfg) == {"generator": "hpcg27", "nx": 256, "ny": 256,
                              "nz": 256}
    nx, ny, nz = (cfg[k] for k in ("nx", "ny", "nz"))
    assert cfg["expect"] == {
        "rows": nx * ny * nz,
        "nnz": (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)}
    assert cfg["expect"] == {"rows": 256 ** 3, "nnz": 766 ** 3}
    assert (cfg["dtype"], cfg["tf32"], cfg["artifact"]) == (
        "float32", False, "saved")
