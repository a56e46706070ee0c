"""Phase timers for the engines and the chip script (port of
``repro.obs.profile``).

``PhaseProfiler`` holds wall-clock accumulators for the numpy engine's
per-round phases (plan / serve / transmit / fold).  It reads the host
clock and never synchronizes the card, so a phase holds device time only
where the engine already waits for a tier's result.  Zero cost when off:
the engines hold ``None`` and never touch a clock.  ``summarize()`` is the
reporting format.

The reference's ``aot_split`` (the compile-vs-steady split of a jitted
entry point) has no counterpart yet: it comes with the compiled round
loop (ROADMAP A.9).
"""
from __future__ import annotations

import time
from contextlib import contextmanager

__all__ = ["PhaseProfiler", "DEFAULT"]


class PhaseProfiler:
    """Named wall-clock accumulators (total seconds + call counts)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + float(seconds)
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextmanager
    def phase(self, name: str):
        """``with prof.phase("plan"): ...`` — one timed region."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def __bool__(self) -> bool:  # "does it hold samples"
        return bool(self.totals)

    def summarize(self) -> dict:
        """Per-phase ``{total_s, calls, mean_ms}`` plus the grand total."""
        out = {}
        for name in self.totals:
            t, c = self.totals[name], self.counts[name]
            out[name] = {"total_s": round(t, 6), "calls": c,
                         "mean_ms": round(t / max(c, 1) * 1e3, 4)}
        if out:
            out["total_s"] = round(sum(self.totals.values()), 6)
        return out

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


# a process-wide profiler for callers that do not thread one through
DEFAULT = PhaseProfiler()
