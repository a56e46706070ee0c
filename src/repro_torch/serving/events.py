"""Vectorized event model for multi-stream serving
(port of ``repro.serving.events``; host numpy, copied).

Two struct-of-arrays event containers replace the per-frame Python loop the
single-stream engine used:

  * ``ArrivalSchedule`` — the (S, N) matrix of frame-arrival times for S
    streams over N global frame slots, plus a validity mask. Lockstep
    replay (``interleaved``) fills every slot: streams run at the same
    frame rate, phase-staggered (camera clocks are not synchronized), so
    within a round the S*B arrivals interleave on the shared uplink
    instead of landing as S simultaneous bursts.  ``churn`` adds dynamic
    fleets: per-stream join slots and ragged lengths, so clients can be
    admitted and retired mid-run; slots outside a stream's lifetime are
    masked invalid (arrival = +inf).  ``rounds`` yields every round
    including the trailing partial batch — nothing is silently truncated.

  * ``EscalationBatch`` — one round's gathered low-confidence frames across
    every stream: (stream, slot, t_ready, payload, res) as flat
    numpy arrays. The scheduler permutes it (uplink order) and the edge
    fabric transmits it in one call — each row is routed to its stream's
    cell uplink and then to a slow-tier replica (``EdgeFabric.transmit``) —
    and the engine scatters the slow-tier answers back with boolean masks,
    no per-frame control flow.

``select_escalations`` is the vectorized gate: for each stream s it picks
the K_s lowest-confidence frames below theta_s, using one argsort over the
whole (S, B) confidence matrix.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class ArrivalSchedule:
    arrival: np.ndarray  # (S, N) seconds; +inf where the slot is invalid
    deadline: float  # per-frame window T
    valid: Optional[np.ndarray] = None  # (S, N) bool; None = every slot valid

    @classmethod
    def interleaved(cls, n_streams: int, n_frames: int, frame_rate: float,
                    deadline: float, stagger: bool = True) -> "ArrivalSchedule":
        """Lockstep fleet: S streams at the same rate; stream s
        phase-shifted by s*gamma/S."""
        gamma = 1.0 / frame_rate
        base = np.arange(n_frames, dtype=np.float64) * gamma  # (N,)
        phase = (np.arange(n_streams, dtype=np.float64) * gamma / max(n_streams, 1)
                 if stagger else np.zeros(n_streams))
        return cls(arrival=phase[:, None] + base[None, :], deadline=float(deadline))

    @classmethod
    def churn(cls, n_streams: int, n_frames: int, frame_rate: float, deadline: float,
              *, join=0, length=None, stagger: bool = True) -> "ArrivalSchedule":
        """Dynamic fleet: stream s joins at global slot ``join[s]`` and
        leaves after ``length[s]`` frames (ragged lifetimes).  With
        join=0 and length=n_frames this degenerates to ``interleaved`` —
        the lockstep-equivalence anchor the regression tests pin.
        """
        join = np.broadcast_to(np.asarray(join, dtype=np.int64), (n_streams,))
        length = (np.full(n_streams, n_frames, dtype=np.int64) if length is None
                  else np.broadcast_to(np.asarray(length, dtype=np.int64), (n_streams,)))
        if (join < 0).any() or (length < 0).any():
            raise ValueError("join slots and lengths must be >= 0")
        if (join + length > n_frames).any():
            raise ValueError("stream lifetime exceeds the schedule horizon")
        gamma = 1.0 / frame_rate
        base = np.arange(n_frames, dtype=np.float64) * gamma
        phase = (np.arange(n_streams, dtype=np.float64) * gamma / max(n_streams, 1)
                 if stagger else np.zeros(n_streams))
        slots = np.arange(n_frames)[None, :]
        valid = (slots >= join[:, None]) & (slots < (join + length)[:, None])
        arrival = np.where(valid, phase[:, None] + base[None, :], np.inf)
        return cls(arrival=arrival, deadline=float(deadline), valid=valid)

    @property
    def n_streams(self) -> int:
        return self.arrival.shape[0]

    @property
    def n_frames(self) -> int:
        return self.arrival.shape[1]

    @property
    def valid_mask(self) -> np.ndarray:
        return (np.ones(self.arrival.shape, dtype=bool) if self.valid is None
                else self.valid)

    @property
    def frames_per_stream(self) -> np.ndarray:
        return self.valid_mask.sum(axis=1)

    @property
    def horizon(self) -> float:
        """Last possible reply time: final valid arrival plus the deadline."""
        if self.valid is None:
            return float(self.arrival.max()) + self.deadline
        if not self.valid.any():
            return 0.0
        return float(self.arrival[self.valid].max()) + self.deadline

    def rounds(self, batch_size: int):
        """Yield (start_slot, arrivals (S, b), valid (S, b)) per round.

        Every slot is covered: the last round may be a partial batch
        (b < batch_size) — the engines process it instead of dropping it.
        """
        valid = self.valid_mask
        for start in range(0, self.n_frames, batch_size):
            sl = slice(start, start + batch_size)
            yield start, self.arrival[:, sl], valid[:, sl]


@dataclass
class EscalationBatch:
    """One round's cross-stream escalations, struct-of-arrays."""

    stream: np.ndarray  # (E,) int — owning stream
    slot: np.ndarray  # (E,) int — index within the round's batch
    t_ready: np.ndarray  # (E,) when the frame is ready to transmit
    payload: np.ndarray  # (E,) upload bytes at the planned resolution
    res: np.ndarray  # (E,) int — planned upload resolution (pixels)

    def __len__(self) -> int:
        return len(self.stream)

    def permuted(self, order: np.ndarray) -> "EscalationBatch":
        return EscalationBatch(self.stream[order], self.slot[order],
                               self.t_ready[order], self.payload[order], self.res[order])


def select_escalations(conf_sb: np.ndarray, theta: np.ndarray, capacity: np.ndarray):
    """Vectorized per-stream gate over an (S, B) confidence matrix.

    For each stream s, select up to ``capacity[s]`` frames with
    ``conf < theta[s]``, lowest confidence first — the same rule the jit
    cascade's masked top-k applies, but across S streams at once.
    Invalid slots must carry ``conf = +inf`` so they never gate.

    Returns (stream_idx, slot_idx) flat arrays of the selected frames.
    """
    conf_sb = np.asarray(conf_sb)
    theta = np.asarray(theta, dtype=np.float64).reshape(-1, 1)  # (S, 1)
    cap = np.asarray(capacity, dtype=np.int64).reshape(-1, 1)
    order = np.argsort(conf_sb, axis=1, kind="stable")  # ascending conf
    gate_sorted = np.take_along_axis(conf_sb < theta, order, axis=1)
    take = gate_sorted & (np.cumsum(gate_sorted, axis=1) <= cap)
    s_idx, j_idx = np.nonzero(take)
    return s_idx, order[s_idx, j_idx]
