"""PolicyRunner: the glue between a decision policy and a live stream
(port of ``repro.policy.runner``).  The runner owns what deployment
measures — the EWMA bandwidth estimate and the link/deadline constants —
and hands the policy an ``Env`` snapshot at every ``plan``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

from repro_torch.policy.base import OffloadPolicy
from repro_torch.policy.registry import make_policy
from repro_torch.policy.types import Env, Frame, Plan


@dataclass
class BandwidthEstimator:
    alpha: float = 0.3
    estimate_bps: float = 1e6

    def observe(self, payload_bytes: float, seconds: float):
        if seconds > 1e-9:
            self.estimate_bps = (1 - self.alpha) * self.estimate_bps + self.alpha * (payload_bytes / seconds)


class PolicyRunner:
    """Drives one ``OffloadPolicy`` for one stream."""

    def __init__(self, policy, *, resolutions: tuple, acc_server: tuple,
                 deadline: float, latency: float, server_time: float,
                 size_of: Callable, bw: BandwidthEstimator | None = None):
        self.policy: OffloadPolicy = make_policy(policy)
        self.resolutions = tuple(resolutions)
        self.acc_server = tuple(acc_server)
        self.deadline = deadline
        self.latency = latency
        self.server_time = server_time
        self.size_of = size_of
        self.bw = bw if bw is not None else BandwidthEstimator()
        self._sizes = tuple(float(size_of(r)) for r in self.resolutions)

    @property
    def backlog(self) -> list[Frame]:
        return self.policy.backlog

    def env(self) -> Env:
        return Env(
            # floor at 1 byte/s: a dead link must plan "all local", not
            # divide by zero inside the DP
            bandwidth=max(self.bw.estimate_bps, 1.0),
            latency=self.latency,
            server_time=self.server_time,
            deadline=self.deadline,
            acc_server=self.acc_server,
        )

    def add_frame(self, arrival: float, conf: float):
        self.policy.observe([Frame(arrival, float(conf), self._sizes)])

    def plan(self, now: float) -> Plan:
        return self.policy.plan(now, self.env())

    def consume(self, frame_indices: Iterable[int]) -> int:
        return self.policy.consume(frame_indices)
