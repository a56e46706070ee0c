"""String-keyed policy registry (port of ``repro.policy.registry``)."""
from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, type] = {}


def register(name: str) -> Callable[[type], type]:
    """Class decorator: register an ``OffloadPolicy`` under ``name``."""

    def deco(cls: type) -> type:
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"policy name {name!r} already registered to {_REGISTRY[name]!r}")
        _REGISTRY[name] = cls
        cls.policy_name = name
        return cls

    return deco


def make_policy(name_or_policy, **cfg):
    """Build a policy from a registry name; an instance passes through
    unchanged (then ``cfg`` must be empty)."""
    if not isinstance(name_or_policy, str):
        if cfg:
            raise TypeError("cfg kwargs only apply when constructing by name")
        return name_or_policy
    try:
        cls = _REGISTRY[name_or_policy]
    except KeyError:
        raise KeyError(
            f"unknown policy {name_or_policy!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    return cls(**cfg)


def available_policies() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_policies(spec, n_streams: int) -> list:
    """One policy instance per stream from a registry name, a factory
    ``stream_idx -> policy | name``, or (one stream only) an instance."""
    if isinstance(spec, str):
        return [make_policy(spec) for _ in range(n_streams)]
    if callable(spec) and not isinstance(spec, type) and not hasattr(spec, "plan"):
        return [make_policy(spec(s)) for s in range(n_streams)]
    if n_streams != 1:
        raise ValueError(
            "a single policy instance cannot serve multiple streams (shared "
            "backlog); pass a registry name or a per-stream factory"
        )
    return [make_policy(spec)]
