"""Split-computation offloading: ship intermediate features, not frames
(port of ``repro.split``).

Besides returning the fast tier's answer or uploading the frame at
resolution r, a device may run the first k blocks, quantize the
activation to int8, ship that, and let the server finish the remaining
blocks.  Under a constrained uplink the feature payload is often smaller
than any acceptable frame, and the server pays only for the suffix.

  * ``points`` — the partition-point catalog per model family (ViT /
    ResNet / Swin configs) with activation shapes and int8 wire bytes;
  * ``costs``  — device-prefix / server-suffix compute costs and
    ``build_action_table``, which turns a catalog into the planner's
    ``policy.types.ActionTable``.
"""
from repro_torch.split.points import (
    CutCatalog,
    CutPoint,
    activation_payload_nbytes,
    catalog_for,
    qtensor_nbytes,
)
from repro_torch.split.costs import (
    DEFAULT_NPU_PEAK,
    SplitCost,
    build_action_table,
    split_costs,
)

__all__ = [
    "CutCatalog",
    "CutPoint",
    "SplitCost",
    "DEFAULT_NPU_PEAK",
    "activation_payload_nbytes",
    "build_action_table",
    "catalog_for",
    "qtensor_nbytes",
    "split_costs",
]
