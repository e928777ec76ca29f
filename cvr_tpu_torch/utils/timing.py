"""Wall-clock timing for the host side: a start/stop Timer and the
PhaseTimer the converters accumulate their named phases in.

Pre-processing time is a first-class reported metric, so every converter
accumulates its named phases in a PhaseTimer.  Device time is measured
elsewhere, with CUDA events (cvr_tpu_torch/bench/harness.py).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Timer:
    """A simple start/stop wall-clock timer (seconds); ``elapsed``
    accumulates over start/stop pairs, and the timer is a context
    manager."""

    elapsed: float = 0.0
    _t0: float | None = None

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("Timer.stop() without start()")
        self.elapsed += time.perf_counter() - self._t0
        self._t0 = None
        return self.elapsed

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


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

    def report(self) -> str:
        """One line per phase in ms, then the total."""
        lines = [f"  {k:<24s} {v * 1e3:10.3f} ms" for k, v in self.phases.items()]
        lines.append(f"  {'total':<24s} {self.total * 1e3:10.3f} ms")
        return "\n".join(lines)
