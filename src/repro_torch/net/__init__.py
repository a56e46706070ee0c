"""The edge fabric: network topology for fleet-scale serving (port of ``repro.net``).

  * ``fabric``    — ``EdgeFabric`` / ``Cell``: the topology object the
                    serving engine routes escalations through;
  * ``replicas``  — ``ReplicaPool``: K slow-tier replicas, per-replica
                    serial queues or continuous batching;
  * ``placement`` — ``Placement``: round_robin / jsq / least_land
                    replica assignment (+ ``assign_looped`` reference);
  * ``traces``    — ``BandwidthTrace`` replay + synthetic LTE / WiFi /
                    regime-shift generators.

``EdgeFabric.degenerate(uplink)`` (1 cell, 1 replica, constant bandwidth)
reproduces the single-uplink pipeline bit-for-bit.
"""
from repro_torch.net.fabric import Cell, EdgeFabric
from repro_torch.net.placement import PLACEMENT_POLICIES, Placement, assign_looped
from repro_torch.net.replicas import ReplicaPool
from repro_torch.net.traces import BandwidthTrace, lte_trace, regime_shift_trace, wifi_trace

__all__ = ["Cell", "EdgeFabric", "ReplicaPool", "Placement", "PLACEMENT_POLICIES", "assign_looped",
           "BandwidthTrace", "lte_trace", "wifi_trace", "regime_shift_trace"]
