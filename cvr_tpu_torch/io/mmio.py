"""MatrixMarket (.mtx) reader / writer.

Header semantics follow the MatrixMarket spec (object/format/field/
symmetry).  1-based indices become 0-based; values are parsed at float64
precision before the cast; pattern matrices get deterministic values
(``"mod13"``: val = entry_index % 13, or ``"ones"``); symmetric,
skew-symmetric and hermitian matrices are expanded by mirroring the
off-diagonal entries.  Plain coordinate files go through the native
parser when it is available.
"""

from __future__ import annotations

import gzip
import io as _io
from pathlib import Path

import numpy as np

from cvr_tpu_torch.formats.coo import COOMatrix

_VALID_FIELDS = ("real", "integer", "pattern", "complex")
_VALID_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


class MatrixMarketError(ValueError):
    pass


def _open_text(path: Path):
    if path.suffix == ".gz":
        return gzip.open(path, "rt")
    return open(path, "rt")


def _parse_header(line: str) -> tuple[str, str, str, str]:
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket":
        raise MatrixMarketError(f"bad MatrixMarket banner: {line!r}")
    _, obj, fmt, field, symmetry = (p.lower() for p in parts)
    if obj != "matrix":
        raise MatrixMarketError(f"unsupported object {obj!r}")
    if fmt not in ("coordinate", "array"):
        raise MatrixMarketError(f"unsupported format {fmt!r}")
    if field not in _VALID_FIELDS:
        raise MatrixMarketError(f"unsupported field {field!r}")
    if symmetry not in _VALID_SYMMETRIES:
        raise MatrixMarketError(f"unsupported symmetry {symmetry!r}")
    return obj, fmt, field, symmetry


def read_matrix_market(
    path: str | Path,
    *,
    pattern_values: str = "mod13",
    dtype=np.float32,
    index_dtype=np.int32,
    use_native: bool | None = None,
) -> COOMatrix:
    """Read a MatrixMarket file into a COOMatrix (0-based, unsorted).

    pattern_values: "mod13" or "ones".  Complex matrices keep the real
    part.  The native parser serves plain coordinate files; gzip, 'array'
    format and non-f32 dtypes take the Python path.
    """
    from cvr_tpu_torch import _native

    path = Path(path)
    if use_native is None:
        use_native = (
            path.suffix != ".gz"
            and dtype == np.float32
            and index_dtype == np.int32
            and pattern_values in ("mod13", "ones")
        )
    if use_native and _native.available():
        try:
            return _read_native(path, pattern_values)
        except _native.NativeError:
            pass  # e.g. 'array' format: the Python parser handles it

    with _open_text(path) as f:
        header = f.readline()
        _, fmt, field, symmetry = _parse_header(header)
        line = f.readline()
        while line and (line.startswith("%") or not line.strip()):
            line = f.readline()
        if not line:
            raise MatrixMarketError("missing size line")
        size = line.split()

        if fmt == "array":
            return _read_array(f, size, field, symmetry, dtype, index_dtype)

        if len(size) != 3:
            raise MatrixMarketError(f"bad coordinate size line: {line!r}")
        nrows, ncols, nnz = (int(s) for s in size)

        ncols_per_line = {"pattern": 2, "real": 3, "integer": 3, "complex": 4}[field]
        data = np.loadtxt(
            f, dtype=np.float64, comments="%", max_rows=nnz, ndmin=2
        )
        if data.shape[0] != nnz:
            raise MatrixMarketError(
                f"expected {nnz} entries, file has {data.shape[0]}"
            )
        if data.size and data.shape[1] < ncols_per_line:
            raise MatrixMarketError(
                f"field {field!r} needs {ncols_per_line} columns per entry, "
                f"file has {data.shape[1]}"
            )

    rows = data[:, 0].astype(index_dtype) - 1
    cols = data[:, 1].astype(index_dtype) - 1
    # out-of-range indices from an untrusted file must die here, not as
    # out-of-bounds writes in the native pack passes
    if data.size and (
        rows.min() < 0
        or cols.min() < 0
        or rows.max() >= nrows
        or cols.max() >= ncols
    ):
        raise MatrixMarketError(
            "entry index out of the header's range "
            f"(nrows={nrows}, ncols={ncols})"
        )
    if field == "pattern":
        if pattern_values == "mod13":
            vals = (np.arange(nnz, dtype=np.int64) % 13).astype(np.float64)
        elif pattern_values == "ones":
            vals = np.ones(nnz, dtype=np.float64)
        else:
            raise ValueError(f"unknown pattern_values {pattern_values!r}")
    else:
        vals = data[:, 2].astype(np.float64)  # complex: keep real part

    if symmetry != "general":
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows = np.concatenate([rows, cols[off]])
        cols_m = np.concatenate([cols, data[off, 0].astype(index_dtype) - 1])
        vals = np.concatenate([vals, sign * vals[off]])
        cols = cols_m

    return COOMatrix(
        rows=rows,
        cols=cols,
        vals=vals.astype(dtype),
        shape=(nrows, ncols),
    )


def _read_native(path: Path, pattern_values: str) -> COOMatrix:
    """Native-parser path: raw triples from C++, symmetry expansion here."""
    from cvr_tpu_torch import _native

    rows, cols, vals, nrows, ncols, field, symmetry = _native.mtx_read_native(
        path, pattern_mode=0 if pattern_values == "mod13" else 1
    )
    if symmetry != "general":
        off = rows != cols
        sign = np.float32(-1.0 if symmetry == "skew-symmetric" else 1.0)
        rows, cols = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
        )
        vals = np.concatenate([vals, sign * vals[off]])
    return COOMatrix(rows=rows, cols=cols, vals=vals, shape=(nrows, ncols))


def _read_array(f, size, field, symmetry, dtype, index_dtype) -> COOMatrix:
    """Dense 'array' format: column-major list of values -> COO of nonzeros."""
    if len(size) != 2:
        raise MatrixMarketError("bad array size line")
    nrows, ncols = (int(s) for s in size)
    if field == "pattern":
        raise MatrixMarketError("array + pattern is not a valid combination")
    vals = np.loadtxt(f, dtype=np.float64, comments="%", ndmin=2)
    vals = vals[:, 0]  # complex: keep real part
    if symmetry == "general":
        if vals.size != nrows * ncols:
            raise MatrixMarketError("array entry count mismatch")
        dense = vals.reshape((ncols, nrows)).T  # column-major on disk
    else:
        # lower triangle stored column by column
        dense = np.zeros((nrows, ncols), dtype=np.float64)
        k = 0
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        for j in range(ncols):
            n_in_col = nrows - j
            col = vals[k : k + n_in_col]
            dense[j:, j] = col
            dense[j, j:] = sign * col
            if symmetry == "skew-symmetric":
                dense[j, j] = 0.0
            k += n_in_col
    rr, cc = np.nonzero(dense)
    return COOMatrix(
        rows=rr.astype(index_dtype),
        cols=cc.astype(index_dtype),
        vals=dense[rr, cc].astype(dtype),
        shape=(nrows, ncols),
    )


def write_matrix_market(path: str | Path, coo: COOMatrix) -> None:
    """Write a COOMatrix as a general real coordinate MatrixMarket file."""
    with open(Path(path), "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{coo.shape[0]} {coo.shape[1]} {coo.nnz}\n")
        buf = _io.StringIO()
        np.savetxt(
            buf,
            np.column_stack(
                [coo.rows + 1, coo.cols + 1, coo.vals.astype(np.float64)]
            ),
            fmt="%d %d %.17g",
        )
        f.write(buf.getvalue())
