"""SuiteSparse collection loader over a local cache.

Matrices are resolved from a local cache directory only: neither the
development host nor the machine with the card has a network, so, unlike
the JAX package's loader, this one never downloads; a matrix missing from
the cache raises FileNotFoundError with the JAX package's text.
"""

from __future__ import annotations

import os
from pathlib import Path

from cvr_tpu_torch.formats.coo import COOMatrix
from cvr_tpu_torch.io.mmio import read_matrix_market

DEFAULT_CACHE = Path(
    os.environ.get("CVR_TPU_CACHE", Path.home() / ".cache" / "cvr_tpu")
)


def load_suitesparse(
    name: str,
    group: str = "SNAP",
    cache_dir: str | Path | None = None,
    **read_kwargs,
) -> COOMatrix:
    """Load ``group/name`` of the SuiteSparse collection from the cache:
    ``<cache>/<name>.mtx``, then ``<cache>/<name>/<name>.mtx`` (the layout
    of an unpacked collection archive).  ``read_kwargs`` reach
    read_matrix_market."""
    cache = Path(cache_dir) if cache_dir else DEFAULT_CACHE
    for candidate in (cache / f"{name}.mtx", cache / name / f"{name}.mtx"):
        if candidate.exists():
            return read_matrix_market(candidate, **read_kwargs)
    raise FileNotFoundError(
        f"{name}.mtx not found in cache {cache} and download failed "
        f"(no download: {group}/{name} is read from the cache only). "
        "Place the .mtx file in the cache directory."
    )
