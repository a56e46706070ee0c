"""The offload decision plane (port of ``repro.policy``): the
single-stream ``PolicyRunner``, the batched fleet ``FleetRunner`` and the
offline §V evaluation ``replay_trace``.

Importing the package registers the built-in policies.
"""
from repro_torch.policy.base import BacklogPolicy, OffloadPolicy, OneShotPolicy
from repro_torch.policy.fleet import FleetRunner, FleetState
from repro_torch.policy.frontier import cbo_plan, cbo_plan_many, optimal_schedule
from repro_torch.policy.policies import (
    CBOPolicy,
    GreedyRatePolicy,
    LocalPolicy,
    OptimalPolicy,
    ServerPolicy,
    ThresholdPolicy,
)
from repro_torch.policy.registry import available_policies, make_policy, register, resolve_policies
from repro_torch.policy.replay import ReplayResult, replay_trace
from repro_torch.policy.runner import BandwidthEstimator, PolicyRunner
from repro_torch.policy.types import ActionTable, Env, EnvBatch, Frame, Plan, PlanBatch, plan_from_chain

__all__ = [
    "FleetRunner",
    "FleetState",
    "EnvBatch",
    "PlanBatch",
    "ActionTable",
    "cbo_plan_many",
    "OffloadPolicy",
    "BacklogPolicy",
    "OneShotPolicy",
    "register",
    "make_policy",
    "available_policies",
    "resolve_policies",
    "CBOPolicy",
    "OptimalPolicy",
    "ThresholdPolicy",
    "LocalPolicy",
    "ServerPolicy",
    "GreedyRatePolicy",
    "PolicyRunner",
    "BandwidthEstimator",
    "replay_trace",
    "ReplayResult",
    "cbo_plan",
    "optimal_schedule",
    "Frame",
    "Env",
    "Plan",
    "plan_from_chain",
]
