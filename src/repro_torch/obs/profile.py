"""Phase timers for the engines and the chip script (port of
``repro.obs.profile``).

``PhaseProfiler`` holds wall-clock accumulators for the numpy engine's
per-round phases (plan / serve / transmit / fold).  It reads the host
clock and never synchronizes the card, so a phase holds device time only
where the engine already waits for a tier's result.  Zero cost when off:
the engines hold ``None`` and never touch a clock.  ``summarize()`` is the
reporting format.

``aot_split`` is the counterpart of the reference's compile-vs-steady
split: it warms a step up and captures it as a CUDA graph (the round
engine's, ``serving/engine_torch.py``), so capture time stays apart from
the steady state.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch

__all__ = ["PhaseProfiler", "DEFAULT", "aot_split"]


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


@torch.inference_mode()
def aot_split(fn, *state: torch.Tensor, profiler: PhaseProfiler | None = None):
    """Warm up ``fn()`` and capture it as a CUDA graph; time both.

    ``fn()`` takes no arguments and updates the tensors ``state`` in place
    (a round step on static buffers).  The warm-up call runs eagerly and
    makes whatever ``fn`` builds on its first call (constants, output
    buffers); ``state`` is then restored, so the capture and its replays
    start from the caller's state.  Returns ``(replayable, seconds)``: on
    the card ``replayable`` replays the graph (a capture that fails raises;
    there is no eager fallback), on the CPU it is ``fn`` itself and
    ``seconds`` the time of its warm-up call.  With ``profiler`` the
    seconds are also added under ``"compile"``.
    """
    t0 = time.perf_counter()
    saved = [t.clone() for t in state]
    cuda = any(t.is_cuda for t in state)
    if cuda:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
    else:
        fn()
    for t, v in zip(state, saved):
        t.copy_(v)
    if cuda:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        torch.cuda.synchronize()
        replay = graph.replay
    else:
        replay = fn
    dt = time.perf_counter() - t0
    if profiler is not None:
        profiler.add("compile", dt)
    return replay, dt


# a process-wide profiler for callers that do not thread one through
DEFAULT = PhaseProfiler()
