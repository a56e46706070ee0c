"""The paper's §IV-D deployment loop under its historical name (port of
``repro.core.policy``).

``AdaptiveController`` is a ``PolicyRunner`` hardwired to the ``cbo``
policy, with the old constructor and the ``backlog`` / ``add_frame`` /
``plan(now)`` / ``consume`` surface.  New code uses ``repro_torch.policy``.
"""
from __future__ import annotations

from typing import Callable, Iterable

from repro_torch.policy.policies import CBOPolicy
from repro_torch.policy.runner import BandwidthEstimator, PolicyRunner
from repro_torch.policy.types import Frame

__all__ = ["AdaptiveController", "BandwidthEstimator"]


class AdaptiveController(PolicyRunner):
    """Deprecated alias: a ``PolicyRunner`` hardwired to the ``cbo`` policy.

    Keeps the pre-policy-plane constructor signature and the ``backlog`` /
    ``add_frame`` / ``plan(now)`` / ``consume`` surface.
    """

    def __init__(self, resolutions: tuple, acc_server: tuple, deadline: float,
                 latency: float, server_time: float, size_of: Callable,
                 bw: BandwidthEstimator | None = None,
                 backlog: Iterable[Frame] | None = None, max_backlog: int = 64):
        super().__init__(
            CBOPolicy(max_backlog=max_backlog),
            resolutions=resolutions,
            acc_server=acc_server,
            deadline=deadline,
            latency=latency,
            server_time=server_time,
            size_of=size_of,
            bw=bw,
        )
        self.max_backlog = max_backlog
        if backlog:
            self.policy.observe(list(backlog))
