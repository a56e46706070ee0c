"""The comparison that decides ``correct``.

The program's outputs in a sample of served rounds are held against the
plain reference computed afresh from the same frames, weights and seeds:

``fast_logits``  the fast tier's logits: the largest difference from the
                 reference's, over the largest reference logit;
``conf``         the fused gate's calibrated confidences: the largest
                 difference from Platt's confidence of the same side's
                 fast logits computed in float64, relative to it;
``plan``         rounds whose threshold, capacity or resolution, in any
                 stream, is not the reference planner's;
``gate``         rounds whose escalated frames are not those the
                 reference's plan admits, lowest confidence first, or
                 whose slow-tier call holds another number of rows;
``fabric``       rounds whose frames landed in time, or whose latencies,
                 are not those of the reference's uplinks and replicas;
``slow_logits``  the slow tier's logits on each escalated frame, at its
                 planned resolution: as ``fast_logits``;
``served``       frames whose answer is not the largest logit of the tier
                 that answered it (the fast tier's, or the slow tier's
                 where an escalation landed in time);
``merge``        the program's counts of served answers equal to the
                 labels (each round's, and its metrics' over the clip),
                 of escalations landed and of deadline misses, against
                 the counts its answers give under the reference's masks.

The logits are judged against the reference; the confidences and the
answers against the same side's logits, so that a near tie of two
classes, which rounding may break either way, is no failure.  The plan,
the gate and the fabric are replayed clip by clip from the clip's start
(``reference/fleet.py``) on the program's confidences, which ``conf``
holds to its logits, and the reference's slow tier runs on the frames
and at the resolutions of that replay.  The ``control`` outputs are the
reference's in a lower precision, judged the same way in the program's
place.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench.reference.cascade import degrade, platt_confidence
from perfbench.reference.fleet import Replay


@dataclass
class Outputs:
    """One round's outputs on one side: logits and answers of both tiers,
    the calibrated confidences; the slow rows in the gate's order."""

    fast_logits: torch.Tensor
    conf: torch.Tensor
    fast_preds: torch.Tensor
    slow_logits: torch.Tensor | None
    slow_preds: torch.Tensor | None


@dataclass
class Round:
    """One served round as the program reported it: its start slot, the
    plan (theta, cap, res_idx per stream), the masks (valid, esc, ok), the
    latencies and the per-stream count of answers equal to the labels;
    ``want`` is the reference's replay of the same round."""

    start: int
    theta: np.ndarray
    cap: np.ndarray
    res_idx: np.ndarray
    valid: np.ndarray
    esc: np.ndarray
    ok: np.ndarray
    lat: np.ndarray
    correct: np.ndarray
    out: Outputs | None = None
    platt: tuple = (0.0, 0.0)
    want: dict = field(default_factory=dict)
    ref: dict = field(default_factory=dict)  # "reference" or "control" -> Outputs

    def program_conf(self) -> np.ndarray:
        return self.out.conf.float().cpu().numpy().reshape(self.valid.shape)


def replay(rounds: list[Round], config: dict, traffic: dict, uplink_seeds: list) -> None:
    """The reference's plan, gate and fabric for one clip's rounds, in
    order from the clip's start, into each round's ``want``."""
    fleet = Replay(config, traffic, uplink_seeds)
    for rnd in rounds:
        rnd.want = fleet.round(rnd.start, rnd.valid, rnd.program_conf())


def reference_outputs(rnd: Round, frames: np.ndarray, fast_fn, slow_fn, resolutions, platt, device,
                      modes: tuple[str, str]) -> Outputs:
    """The reference's outputs for one round, the fast tier at
    ``modes[0]`` precision and the slow tier at ``modes[1]``, on the
    frames and at the resolutions of the reference's replay."""
    S, b = rnd.valid.shape
    x = torch.as_tensor(np.ascontiguousarray(frames[:, rnd.start:rnd.start + b]), device=device)
    x = x.reshape(S * b, *frames.shape[2:])
    fl = fast_fn(x, modes[0])
    conf = platt_confidence(fl, *platt, dtype=torch.bfloat16 if modes[0] == "bf16" else torch.float64)
    s_idx, j_idx = rnd.want["s_idx"], rnd.want["j_idx"]
    sl = sp = None
    if len(s_idx):
        xe = x[torch.as_tensor(s_idx * b + j_idx, device=device)]
        res = np.asarray(resolutions)[rnd.want["res_idx"][s_idx]]
        for r in np.unique(res):
            sel = torch.as_tensor(np.flatnonzero(res == r), device=device)
            xe[sel] = degrade(xe[sel], int(r))
        sl = slow_fn(xe, modes[1])
        sp = sl.argmax(-1)
    return Outputs(fl, conf, fl.argmax(-1), sl, sp)


def _served(rnd: Round, side: Outputs) -> np.ndarray:
    """(S, b) served classes on ``side``: the slow tier's answer where the
    reference's escalation landed in time (the slow rows in the gate's
    order), the fast tier's otherwise."""
    S, b = rnd.valid.shape
    final = side.fast_preds.view(S, b).cpu().numpy().copy()
    s_idx, j_idx = rnd.want["s_idx"], rnd.want["j_idx"]
    if len(s_idx):
        land = rnd.want["ok"][s_idx, j_idx]
        final[s_idx[land], j_idx[land]] = side.slow_preds.cpu().numpy()[land]
    return final


def readings(rounds: list[Round], labels: np.ndarray, side: str = "program") -> dict:
    """The numbers above over ``rounds``, for the program's outputs or,
    with ``side="control"``, for the control's in the program's place."""
    fast_err = fast_scale = slow_err = slow_scale = conf_err = 0.0
    served = plan = gate = fabric = merge = n_slow = 0
    for rnd in rounds:
        ref, want = rnd.ref["reference"], rnd.want
        got = rnd.out if side == "program" else rnd.ref[side]
        b = rnd.valid.shape[1]
        fast_err = max(fast_err, float((got.fast_logits.float() - ref.fast_logits).abs().max()))
        fast_scale = max(fast_scale, float(ref.fast_logits.abs().max()))
        want_conf = platt_confidence(got.fast_logits, *rnd.platt)
        conf_err = max(conf_err, float(((got.conf.double() - want_conf).abs() / want_conf).max()))
        served += int((got.fast_preds != got.fast_logits.argmax(-1)).sum())
        plan += int(not all(np.array_equal(getattr(rnd, k), want[k]) for k in ("theta", "cap", "res_idx")))
        fabric += int(not (np.array_equal(rnd.ok, want["ok"]) and np.array_equal(rnd.lat, want["lat"])))
        n_esc = len(want["s_idx"])
        got_rows = 0 if got.slow_logits is None else got.slow_logits.shape[0]
        if not np.array_equal(rnd.esc, want["esc"]) or got_rows != n_esc:
            gate += 1
            continue
        if n_esc:
            slow_err = max(slow_err, float((got.slow_logits.float() - ref.slow_logits).abs().max()))
            slow_scale = max(slow_scale, float(ref.slow_logits.abs().max()))
            served += int((got.slow_preds != got.slow_logits.argmax(-1)).sum())
            n_slow += n_esc
        if side == "program":
            final = _served(rnd, got)
            rnd.served_correct = ((final == labels[:, rnd.start:rnd.start + b]) & rnd.valid).sum(axis=1)
            merge += int(np.abs(rnd.served_correct - rnd.correct).sum())
    out = {"fast_logits": fast_err / max(fast_scale, 1e-30), "conf": conf_err,
           "slow_logits": slow_err / max(slow_scale, 1e-30) if n_slow else None,
           "served": served, "plan": plan, "gate": gate, "fabric": fabric}
    if side == "program":
        out["merge"] = merge
    return out


def tally(rounds: list[Round], reported: dict) -> int:
    """How far a clip's metrics (``reported``: per-stream ``n_correct``,
    ``n_offloaded``, ``n_deadline_miss``) lie from the sums of its rounds'
    answers under the reference's masks; rounds whose gate failed count in
    ``gate``."""
    if any(not hasattr(r, "served_correct") for r in rounds):
        return 0
    want = {"n_correct": sum(r.served_correct for r in rounds),
            "n_offloaded": sum((r.want["esc"] & r.want["ok"]).sum(axis=1) for r in rounds),
            "n_deadline_miss": sum((r.want["esc"] & ~r.want["ok"]).sum(axis=1) for r in rounds)}
    return int(sum(np.abs(np.asarray(reported[k]) - want[k]).sum() for k in want))


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[tuple[str, float | None, float]]]:
    """``correct`` and the (name, number, limit) rows: every number at or
    under its limit; a number that could not be read (no escalated frame
    in the sample) fails."""
    rows = [(name, numbers.get(name), float(limits[name])) for name in limits]
    ok = all(v is not None and v <= lim for _, v, lim in rows)
    return ok, rows
