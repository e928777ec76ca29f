"""Fixtures of the benchmark's tests: a copy of the benchmark whose
configurations are cut to a size the CPU runs in a second, and the
``chip`` marker of the tests that need a CUDA card (they skip inside the
test where there is none).

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmark import matrix as mx
from benchmark import spec


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "chip: needs a CUDA card; skips inside the test without one")


def make_root(tmp: Path) -> Path:
    """A checkout's BENCHMARK.json and benchmark/ files under ``tmp``,
    each configuration cut to test size by its generator's ``TINY`` and
    its ``expect`` made to match."""
    root = tmp / "root"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "tests",
                                                  "__pycache__"))
    manifest = spec.load()
    for c in manifest["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        cfg.update(mx.generator(cfg["generator"]).TINY)
        m = mx.make(cfg)
        cfg["expect"] = {"rows": m.n, "nnz": m.nnz}
        (root / c["file"]).write_text(json.dumps(cfg))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="session")
def shared_cache(tmp_path_factory) -> Path:
    """A matrix and artifact cache that the runs of one test session
    share, so that each cell packs once."""
    return tmp_path_factory.mktemp("cache")


@pytest.fixture
def cuda():
    """Skip unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
