"""Value types of the offload decision plane (port of ``repro.policy.types``).

A policy observes ``Frame``s, plans against an ``Env`` (the network and
deadline regime at that instant) and answers with a ``Plan``.  Host numpy,
as in the reference.  The fleet types (``EnvBatch``/``PlanBatch``) wait
for the multi-stream slice.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Frame:
    arrival: float  # seconds
    conf: float  # calibrated confidence = expected fast-tier accuracy
    sizes: tuple[float, ...]  # payload bytes per resolution (ascending res)
    fid: int = -1  # caller-side frame id; -1 = unset


@dataclass(frozen=True)
class Env:
    bandwidth: float  # uplink bytes/s
    latency: float  # network latency L (s)
    server_time: float  # T^o (s)
    deadline: float  # T (s), per-frame window
    acc_server: tuple[float, ...]  # A^o_r per resolution (ascending res)


@dataclass
class Plan:
    """Result of a planning pass over a policy's backlog."""

    theta: float  # confidence threshold for offloading
    resolution: int  # r° — resolution index for the next offload
    offloads: list[tuple[int, int]]  # (backlog/frame index, resolution index)
    total_gain: float  # sum of (A^o_r - p_i) over planned offloads
    base_acc: float  # sum of p_i (all local)
    n_frames: int = 0

    @property
    def mean_acc(self) -> float:
        return (self.base_acc + self.total_gain) / max(self.n_frames, 1)


def plan_from_chain(chain: list[tuple[int, int]], frames, gain: float, m: int) -> Plan:
    """Assemble a ``Plan`` from a planner's offload chain: theta is the max
    confidence among planned offloads and r° the resolution of the frame
    attaining it (ties toward the earliest frame, chosen by index)."""
    base = sum(f.conf for f in frames)
    k = len(frames)
    if not chain:
        return Plan(theta=0.0, resolution=m - 1, offloads=[], total_gain=0.0,
                    base_acc=base, n_frames=k)
    i_star, r_star = max(chain, key=lambda ij: (frames[ij[0]].conf, -ij[0]))
    return Plan(theta=frames[i_star].conf, resolution=r_star, offloads=sorted(chain),
                total_gain=gain, base_acc=base, n_frames=k)
