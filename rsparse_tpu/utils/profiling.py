"""Tracing & profiling.

The reference has no profiler (SURVEY §5) — its closest artifacts are
per-iteration loss lines (R/model_WRMF.R:324-330) and trace tables attached
as attributes (R/SoftALS.R:145-147).  Here tracing is first-class:

- :func:`trace` wraps ``jax.profiler`` so any fit can emit a TensorBoard-
  loadable device trace;
- :class:`FitTrace` is the structured per-phase record models populate
  (iteration, phase, loss, start and wall time on the host's
  ``time.perf_counter`` clock) — returned data, not an attribute bolted
  onto a matrix.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import jax

from ..config import logger


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a jax.profiler device trace into ``log_dir`` (no-op when
    ``log_dir`` is None)."""
    if not log_dir:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("profiler trace written to %s", log_dir)


@dataclass
class FitTrace:
    """Structured per-phase fit telemetry."""

    records: List[Dict[str, Any]] = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, iteration: int, name: str) -> Iterator[Dict[str, Any]]:
        t0 = time.perf_counter()
        rec: Dict[str, Any] = {"iter": iteration, "phase": name,
                               "start_s": t0}
        try:
            yield rec
        finally:
            rec["wall_s"] = time.perf_counter() - t0
            self.records.append(rec)

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out.setdefault(r["phase"], 0.0)
            out[r["phase"]] += r.get("wall_s", 0.0)
        return out

    def __iter__(self):
        return iter(self.records)

    def __len__(self):
        return len(self.records)
