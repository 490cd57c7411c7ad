"""Tracing, timing, and throughput accounting.

The reference's observability is chrono timers around alignment calls and
printf breadcrumbs (testing.cpp:132-138, main_alignment.cpp:12-21). Here:
phase timers with structured JSON logging, GCUPS accounting, and an
optional ``jax.profiler`` trace context for device timeline capture.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time


def gcups(cells: int, seconds: float) -> float:
    """Billions of DP cell updates per second."""
    return cells / seconds / 1e9 if seconds > 0 else float("inf")


def log_event(kind: str, stream=None, **fields):
    """One structured JSON log line to stderr (or ``stream``)."""
    rec = {"event": kind, "ts": time.time(), **fields}
    print(json.dumps(rec), file=stream or sys.stderr, flush=True)


class PhaseTimer:
    """Accumulates wall time per named phase.

    >>> t = PhaseTimer()
    >>> with t.phase("fill"): ...
    >>> t.totals  # {"fill": seconds}
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, stream=None):
        for name in self.totals:
            log_event("phase", stream=stream, name=name,
                      total_s=round(self.totals[name], 6),
                      calls=self.counts[name])


@contextlib.contextmanager
def device_trace(out_dir: str):
    """``jax.profiler`` trace context writing a device/host timeline to
    ``out_dir`` (viewable in XProf/TensorBoard). No-op on failure so
    production runs never die on profiler issues."""
    import jax

    started = False
    try:
        jax.profiler.start_trace(out_dir)
        started = True
    except Exception as e:  # noqa: BLE001
        log_event("trace_start_failed", error=str(e))
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception as e:  # noqa: BLE001
                log_event("trace_stop_failed", error=str(e))
