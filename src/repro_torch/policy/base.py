"""The ``OffloadPolicy`` protocol and backlog base classes
(port of ``repro.policy.base``).

A policy watches locally-classified frames accumulate (``observe``), is
asked which of them to send and at which resolution (``plan``), and is
told which frames left the device (``consume``).
"""
from __future__ import annotations

from typing import Iterable, Protocol, Sequence, runtime_checkable

from repro_torch.policy.types import Env, Frame, Plan, plan_from_chain


@runtime_checkable
class OffloadPolicy(Protocol):
    """Structural interface every offload policy implements."""

    backlog: list[Frame]

    def observe(self, frames: Sequence[Frame]) -> None:
        """Append locally-classified frames to the decision backlog."""
        ...

    def plan(self, now: float, env: Env) -> Plan:
        """Decide (theta, r°, offload set) over the backlog at ``now``;
        ``Plan.offloads`` indexes the backlog as it stands on return."""
        ...

    def consume(self, indices: Iterable[int]) -> int:
        """Remove frames that left the device (backlog indices of the most
        recent ``plan``); returns the number removed."""
        ...


class BacklogPolicy:
    """Base: a bounded backlog with the index-stable observe/consume dance
    (``consume`` runs before the next ``observe``)."""

    #: prune frames whose deadline window has expired before planning
    prune_expired: bool = True

    def __init__(self, max_backlog: int | None = 64):
        self.backlog: list[Frame] = []
        self.max_backlog = max_backlog

    def observe(self, frames: Sequence[Frame]) -> None:
        self.backlog.extend(frames)
        if self.max_backlog is not None and len(self.backlog) > self.max_backlog:
            self.backlog = self.backlog[-self.max_backlog :]

    def plan(self, now: float, env: Env) -> Plan:
        if self.prune_expired:
            self.backlog = [f for f in self.backlog if f.arrival + env.deadline > now]
        return self._plan(now, env)

    def _plan(self, now: float, env: Env) -> Plan:
        raise NotImplementedError

    def plan_many(self, now, state, env):
        """Batched fleet path: plan S independent backlogs at once.

        Default falls back to looping ``_plan`` per stream (``state`` must
        already be pruned — ``FleetRunner`` does this); vectorized policies
        override.  See ``policy/fleet.py``.
        """
        from repro_torch.policy.fleet import looped_plan_many

        return looped_plan_many(self, now, state, env)

    def consume(self, indices: Iterable[int]) -> int:
        drop = {int(i) for i in indices}
        kept = [f for i, f in enumerate(self.backlog) if i not in drop]
        removed = len(self.backlog) - len(kept)
        self.backlog = kept
        return removed


class OneShotPolicy(BacklogPolicy):
    """Base for policies that decide each frame once at arrival: whatever
    ``plan`` does not offload stays local, so ``consume`` clears the backlog."""

    def consume(self, indices: Iterable[int]) -> int:
        removed = len(self.backlog)
        self.backlog = []
        return removed


def empty_plan(frames: Sequence[Frame], m: int) -> Plan:
    return plan_from_chain([], frames, 0.0, m)
