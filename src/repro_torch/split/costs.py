"""Device-prefix / server-suffix compute costs for split offloading (port
of ``repro.split.costs``).

The device runs the prefix at the NPU's int8 peak (mobile NPUs quantize
anyway: the premise of the paper's fast tier).  Two numbers per cut:

  * ``t_dev``    — absolute device-prefix seconds (the prefix FLOPs over
    ``device_peak``), which the planner *adds* to a frame's arrival before
    its upload can start;
  * ``srv_frac`` — suffix FLOPs / total FLOPs, which *scales* whatever
    server time the serving stack currently believes (flat ``T^o`` or the
    occupancy-calibrated estimate), so split costs compose with server-time
    calibration.

``build_action_table`` packs frame actions (index == resolution index,
byte for byte the ``payload_sizes`` table) and one action per catalog cut
into ``policy.types.ActionTable`` for the frontier DP and the engine.

Both times are ``launch/roofline.py::roofline_terms(flops, 0, 0,
peak=...).bound_s``: with no bytes and no collectives the bound is the
compute term, as in the reference.  The default ``server_peak`` stays the
reference's, ``TPU_V5E_PEAK_FLOPS_BF16``, so that ``t_srv_peak`` equals
the reference's bit for bit: it is a TPU v5e figure, not an H100 one
(the roofline module's own peaks are the H100's).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.netsim import payload_sizes
from repro_torch.launch.roofline import roofline_terms
from repro_torch.policy.types import ActionTable
from repro_torch.split.points import CutCatalog

# Mobile-NPU int8 peak (order of a Hexagon/ANE-class accelerator, ~7 TOPS).
# The absolute value only sets the device-prefix timescale; sweeps override.
DEFAULT_NPU_PEAK = 7e12
# The reference's default server peak (its launch/roofline.py): TPU v5e
# bf16.  Kept for parity of ``t_srv_peak`` only; not an H100 number.
TPU_V5E_PEAK_FLOPS_BF16 = 197e12


@dataclass(frozen=True)
class SplitCost:
    """Costs for one cut point."""

    cut_id: int
    t_dev: float  # device prefix seconds at the NPU peak
    srv_frac: float  # fraction of full-model server time the suffix costs
    t_srv_peak: float  # suffix seconds at ``server_peak`` (the reference's TPU v5e figure)


def split_costs(catalog: CutCatalog, *, device_peak: float = DEFAULT_NPU_PEAK,
                server_peak: float = TPU_V5E_PEAK_FLOPS_BF16) -> tuple:
    """Roofline costs for every cut in the catalog."""
    out = []
    for p in catalog:
        t_dev = roofline_terms(p.prefix_flops, 0.0, 0.0, peak=device_peak).bound_s
        t_srv = roofline_terms(p.suffix_flops, 0.0, 0.0, peak=server_peak).bound_s
        out.append(SplitCost(cut_id=p.cut_id, t_dev=t_dev,
                             srv_frac=p.suffix_fraction, t_srv_peak=t_srv))
    return tuple(out)


def build_action_table(catalog: Optional[CutCatalog], *,
                       resolutions: Sequence[int],
                       size_of,
                       acc_server: Sequence[float],
                       device_peak: float = DEFAULT_NPU_PEAK,
                       acc_drop: float = 0.0):
    """Pack frames + cuts into the planner's ``ActionTable``.

    Frame actions occupy indices ``[0, m)`` with action index == resolution
    index and bytes from ``payload_sizes(size_of, resolutions)`` — exactly
    the legacy table, so an empty/None catalog reproduces the frame-only
    system bit-for-bit.  Each cut becomes one extra action: payload = int8
    feature bytes, evaluated at full resolution (the device prefix sees the
    native input), accuracy = top-resolution server accuracy minus
    ``acc_drop`` (int8 feature degradation; 0 unless calibrated).
    """
    res = np.asarray(list(resolutions))
    frame_sizes = payload_sizes(size_of, res).astype(np.float64)
    table = ActionTable.frames_only(sizes=frame_sizes,
                                    acc=np.asarray(acc_server, dtype=np.float64))
    if catalog is None or len(catalog) == 0:
        return table
    costs = split_costs(catalog, device_peak=device_peak)
    m = len(res)
    return ActionTable(
        kind=np.concatenate([table.kind, np.ones(len(costs), dtype=np.int8)]),
        res=np.concatenate([table.res, np.full(len(costs), m - 1, dtype=np.int64)]),
        cut=np.concatenate([table.cut, np.arange(len(costs), dtype=np.int64)]),
        sizes=np.concatenate([table.sizes, catalog.payload_bytes()]),
        acc=np.concatenate([table.acc,
                            np.full(len(costs), float(acc_server[-1]) - acc_drop)]),
        t_dev=np.concatenate([table.t_dev,
                              np.array([c.t_dev for c in costs], dtype=np.float64)]),
        srv_frac=np.concatenate([table.srv_frac,
                                 np.array([c.srv_frac for c in costs], dtype=np.float64)]),
        names=table.names + tuple(p.name for p in catalog),
    )
