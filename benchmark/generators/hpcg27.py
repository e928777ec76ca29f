"""The HPCG benchmark's problem (hpcg-benchmark.org, the reference code's
``src/GenerateProblem_ref.cpp``): the 27-point stencil on an nx x ny x nz
grid, one row a grid point, rows in the order z, y, x with x fastest.
Row (iz, iy, ix) holds 26.0 on the diagonal and -1.0 for each of its 26
neighbours that lies inside the grid.  Its neighbours come as the
reference enumerates them, z, then y, then x each over -1, 0, 1, which is
increasing column order, so the arrays come out in CSR order unsorted.
"""

import numpy as np

PARAMS = ("nx", "ny", "nz")
TINY = {"nx": 8, "ny": 8, "nz": 8}


def make(nx, ny, nz):
    n = nx * ny * nz
    if n >= 1 << 31:
        raise ValueError(f"{nx} x {ny} x {nz} rows do not fit int32")
    row = np.arange(n, dtype=np.int32).reshape(nz, ny, nx)
    z, y, x = (np.arange(k).reshape(s) for k, s in
               ((nz, (nz, 1, 1)), (ny, (1, ny, 1)), (nx, (1, 1, nx))))
    cols = np.empty((n, 27), dtype=np.int32)
    inside = np.empty((n, 27), dtype=bool)
    k = 0
    for sz in (-1, 0, 1):
        for sy in (-1, 0, 1):
            for sx in (-1, 0, 1):
                inside[:, k] = (((0 <= z + sz) & (z + sz < nz))
                                & ((0 <= y + sy) & (y + sy < ny))
                                & ((0 <= x + sx) & (x + sx < nx))).ravel()
                cols[:, k] = (row + (sz * ny * nx + sy * nx + sx)).ravel()
                k += 1
    counts = inside.sum(axis=1)
    inside = inside.ravel()
    cols = cols.ravel()[inside]
    del inside
    rows = np.repeat(np.arange(n, dtype=np.int32), counts)
    vals = np.where(cols == rows, np.float32(26.0), np.float32(-1.0))
    return rows, cols, vals, n
