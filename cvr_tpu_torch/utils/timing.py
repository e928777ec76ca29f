"""Wall-clock phase timing for the converters (host side).

Pre-processing time is a first-class reported metric, so every converter
accumulates its named phases in a PhaseTimer.  Device time is measured
elsewhere, with CUDA events (cvr_tpu_torch/bench/harness.py).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class PhaseTimer:
    """Accumulates wall-clock time per named phase."""

    phases: dict[str, float] = field(default_factory=dict)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    @property
    def total(self) -> float:
        return sum(self.phases.values())
