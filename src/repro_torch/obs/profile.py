"""Spans, phase timers and counters for the engines and the chip script
(port of ``repro.obs.profile``, which keeps the timers only).

``PhaseProfiler`` logs the numpy engine's spans: each round is a root span
``round`` whose children are the loop's steps (``MultiStreamServer`` names
them), each with its round id, parent, start and end on
``time.perf_counter``.  Every span but the round also adds to the
per-phase accumulators that ``summarize()`` reports in the reference's
format, and ``count`` keeps named counts per round.  While a
``torch.profiler`` records, each span also opens a ``record_function``
range ``serving.<name>``, so the spans share the device trace's clock.
The profiler reads the host clock and never synchronizes the card, so a
span holds device time only where the engine already waits for a result.
With the profiler off the engines call ``NULL_PROFILER`` (``NullProfiler``)
in its place, whose methods do nothing: it reads no clock and opens no
range.

``model_range`` gives a model's forward its own ranges (``vit.rope``,
``vit.attn``) on the same terms: a ``record_function`` while a span holds
a ``serving.*`` range, else a context that does nothing, so that a trace
taken without the loop's profiler holds no range the model adds.

``aot_split`` is the counterpart of the reference's compile-vs-steady
split: it warms a step up and captures it as a CUDA graph (the round
engine's, ``serving/engine_torch.py``), so capture time stays apart from
the steady state.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["PhaseProfiler", "NullProfiler", "NULL_PROFILER", "Span", "aot_split", "model_range",
           "ROUND", "RANGE_PREFIX"]

ROUND = "round"  # the root span of each round
RANGE_PREFIX = "serving."  # a span's ``record_function`` range: this and its name
_NO_RANGE = nullcontext()
# Spans of any PhaseProfiler that hold a ``record_function`` range now.  A
# process-wide count, as torch's own profiler state is: the engines call a
# model through a plain ``forward(x)`` callable, which carries no profiler.
_ranges_open = 0


def model_range(name: str):
    """``torch.profiler.record_function(name)`` while a ``PhaseProfiler``
    span holds a range under a recording ``torch.profiler`` (the serving
    loop profiled), else a reusable context that does nothing."""
    if _ranges_open and _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_RANGE


class Span(NamedTuple):
    """One timed region: ``round`` is the id of the round it ran in (-1
    outside any), ``parent`` the index in the log of the span around it
    (-1 for a root), ``start`` and ``end`` ``time.perf_counter`` seconds."""

    name: str
    round: int
    parent: int
    start: float
    end: float


class PhaseProfiler:
    """Named wall-clock accumulators (total seconds + call counts), the
    span log and per-round counters."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.spans: list[Span | None] = []  # in start order; None while a span is open
        self.counters: dict[str, dict[int, int]] = {}  # name -> {round id: count}
        self.n_rounds = 0
        self._open: list[tuple] = []  # (log index, name, start, profiler range, is a round)
        self._round = -1

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + float(seconds)
        self.counts[name] = self.counts.get(name, 0) + 1

    def open(self, name: str) -> None:
        """Open a span inside the innermost open one; ``close`` ends it."""
        self._push(name, False)

    def _push(self, name: str, is_round: bool) -> None:
        global _ranges_open
        rng = None
        if _autograd_profiler._is_profiler_enabled:
            rng = torch.profiler.record_function(RANGE_PREFIX + name)
            rng.__enter__()
            _ranges_open += 1
        self._open.append((len(self.spans), name, time.perf_counter(), rng, is_round))
        self.spans.append(None)

    def close(self) -> None:
        """End the innermost open span and log it."""
        global _ranges_open
        t1 = time.perf_counter()
        i, name, t0, rng, is_round = self._open.pop()
        if rng is not None:
            rng.__exit__(None, None, None)
            _ranges_open -= 1
        self.spans[i] = Span(name, self._round, self._open[-1][0] if self._open else -1, t0, t1)
        if is_round:
            self._round = -1
        else:
            self.add(name, t1 - t0)

    def switch(self, name: str) -> None:
        """End the innermost open span and open ``name`` beside it."""
        self.close()
        self.open(name)

    def open_round(self) -> None:
        """Open the root span of the next round, whose id is ``n_rounds``.
        It is logged but not added to the accumulators, which keep the
        disjoint phases inside it."""
        self._round = self.n_rounds
        self.n_rounds += 1
        self._push(ROUND, True)

    def close_all(self) -> None:
        """End every open span, innermost first (a loop left by an exception)."""
        while self._open:
            self.close()

    @contextmanager
    def phase(self, name: str):
        """``with prof.phase("plan"): ...`` — one timed span."""
        self.open(name)
        try:
            yield
        finally:
            self.close()

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` of the open round."""
        per = self.counters.setdefault(name, {})
        per[self._round] = per.get(self._round, 0) + n

    def self_times(self) -> list[float]:
        """Each closed span's seconds less its children's, in log order."""
        out = [s.end - s.start if s is not None else 0.0 for s in self.spans]
        for s in self.spans:
            if s is not None and s.parent >= 0:
                out[s.parent] -= s.end - s.start
        return out

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
        """Drop every sample; not while a span is open."""
        if self._open:
            raise RuntimeError(f"reset with {len(self._open)} span(s) open")
        self.totals.clear()
        self.counts.clear()
        self.spans.clear()
        self.counters.clear()
        self.n_rounds = 0


class NullProfiler:
    """``PhaseProfiler``'s recording methods, each a no-op: what the
    engines and the planner call when nothing profiles them.  It reads no
    clock, opens no ``record_function`` range and keeps nothing."""

    __slots__ = ()

    def add(self, name: str, seconds: float) -> None:
        pass

    def open(self, name: str) -> None:
        pass

    def close(self) -> None:
        pass

    def switch(self, name: str) -> None:
        pass

    def open_round(self) -> None:
        pass

    def close_all(self) -> None:
        pass

    def phase(self, name: str):
        return _NO_RANGE

    def count(self, name: str, n: int = 1) -> None:
        pass


NULL_PROFILER = NullProfiler()


@torch.inference_mode()
def aot_split(fn, *state: torch.Tensor, profiler: PhaseProfiler | NullProfiler = NULL_PROFILER):
    """Warm up ``fn()`` and capture it as a CUDA graph; time both.

    ``fn()`` takes no arguments and updates the tensors ``state`` in place
    (a round step on static buffers).  The warm-up call runs eagerly and
    makes whatever ``fn`` builds on its first call (constants, output
    buffers); ``state`` is then restored, so the capture and its replays
    start from the caller's state.  Returns ``(replayable, seconds)``: on
    the card ``replayable`` replays the graph (a capture that fails raises;
    there is no eager fallback), on the CPU it is ``fn`` itself and
    ``seconds`` the time of its warm-up call.  The seconds are also added
    to ``profiler`` under ``"compile"``.
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
    profiler.add("compile", dt)
    return replay, dt
