"""Frame-lifecycle tracing: span events for the escalation path (port of
``repro.obs.trace``; host numpy, copied).

Every escalated frame walks the same pipeline:

    planned -> queued-at-cell -> uploaded -> placed -> (batched) ->
    served -> landed | missed

``FrameTracer`` records one structured record per escalation, carrying
the cell, replica and batch ids the fabric assigned (the numpy round loop
only: it needs the fabric's per-row detail on the host).
``export_chrome_trace`` renders the records as Chrome trace-event JSON,
which https://ui.perfetto.dev or chrome://tracing opens: per stream /
cell / replica track, where a miss spent its deadline (radio queueing,
wire time, replica queueing, or service).
"""
from __future__ import annotations

import json

import numpy as np

__all__ = ["FrameTracer", "export_chrome_trace"]


class FrameTracer:
    """Per-escalation lifecycle records with cell/replica/batch ids."""

    def __init__(self):
        self.frames: list = []  # one dict per escalated frame

    def record_round(self, *, stream, slot, arrival, t_ready, cell, up_start,
                     up_end, replica, service, done, batch_id, land, ok,
                     deadline: float) -> None:
        """Fold one round's fabric detail in (row-aligned arrays, the
        fabric's transmission order)."""
        stream = np.asarray(stream)
        n = len(stream)
        if n == 0:
            return
        slot = np.asarray(slot)
        arrival = np.asarray(arrival, dtype=np.float64)
        srv_start = np.asarray(done, dtype=np.float64) - np.asarray(
            service, dtype=np.float64)
        for i in range(n):
            self.frames.append({
                "stream": int(stream[i]), "slot": int(slot[i]),
                "cell": int(np.asarray(cell)[i]),
                "replica": int(np.asarray(replica)[i]),
                "batch": int(np.asarray(batch_id)[i]),
                "arrival": float(arrival[i]),
                "t_ready": float(np.asarray(t_ready)[i]),
                "up_start": float(np.asarray(up_start)[i]),
                "up_end": float(np.asarray(up_end)[i]),
                "srv_start": float(srv_start[i]),
                "done": float(np.asarray(done)[i]),
                "land": float(np.asarray(land)[i]),
                "ok": bool(np.asarray(ok)[i]),
                "deadline": float(arrival[i]) + float(deadline),
            })

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    def miss_attribution(self) -> dict:
        """Where missed frames spent their budget: dominant wait per miss
        (``radio`` = cell queue + wire vs ``slow_tier`` = replica queue +
        service), plus mean seconds per phase over the misses."""
        misses = [f for f in self.frames if not f["ok"]]
        out = {"misses": len(misses), "radio": 0, "slow_tier": 0,
               "mean_radio_s": 0.0, "mean_slow_s": 0.0}
        if not misses:
            return out
        radio = np.asarray([f["up_end"] - f["t_ready"] for f in misses])
        slow = np.asarray([f["done"] - f["up_end"] for f in misses])
        out["radio"] = int((radio >= slow).sum())
        out["slow_tier"] = int((radio < slow).sum())
        out["mean_radio_s"] = round(float(radio.mean()), 6)
        out["mean_slow_s"] = round(float(slow.mean()), 6)
        return out

    # -- export ------------------------------------------------------------ #

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (``{"traceEvents": [...]}``).

        Track layout: pid 1 = client streams (one tid per stream), pid 2 =
        radio cells, pid 3 = slow-tier replicas.  Durations are "X"
        complete events with microsecond timestamps; land/miss outcomes are
        "i" instants on the stream track.
        """
        us = 1e6
        ev = [
            {"ph": "M", "name": "process_name", "pid": 1,
             "args": {"name": "client streams"}},
            {"ph": "M", "name": "process_name", "pid": 2,
             "args": {"name": "radio cells"}},
            {"ph": "M", "name": "process_name", "pid": 3,
             "args": {"name": "slow-tier replicas"}},
        ]

        def span(name, pid, tid, t0, t1, args=None, cat="frame"):
            if t1 < t0:  # numerical guard; spans are non-negative by design
                t1 = t0
            e = {"ph": "X", "name": name, "cat": cat, "pid": pid, "tid": tid,
                 "ts": t0 * us, "dur": (t1 - t0) * us}
            if args:
                e["args"] = args
            return e

        for f in self.frames:
            fid = f"s{f['stream']}#{f['slot']}"
            args = {"frame": fid, "cell": f["cell"], "replica": f["replica"],
                    "batch": f["batch"], "deadline": f["deadline"]}
            s = f["stream"]
            # stream track: device prefix, then the end-to-end offload span
            ev.append(span("device", 1, s, f["arrival"], f["t_ready"], args))
            ev.append(span("offload" + ("" if f["ok"] else " [miss]"),
                           1, s, f["t_ready"], f["land"], args))
            # cell track: head-of-line queueing then the wire time
            ev.append(span("queued@cell", 2, f["cell"], f["t_ready"],
                           f["up_start"], args))
            ev.append(span("upload", 2, f["cell"], f["up_start"],
                           f["up_end"], args))
            # replica track: placement queueing then (batched) service
            ev.append(span("queued@replica", 3, f["replica"], f["up_end"],
                           f["srv_start"], args))
            name = ("serve" if f["batch"] < 0
                    else f"serve[batch {f['batch']}]")
            ev.append(span(name, 3, f["replica"], f["srv_start"], f["done"],
                           args))
            ev.append({"ph": "i", "name": "landed" if f["ok"] else "MISSED",
                       "pid": 1, "tid": s, "ts": f["land"] * us, "s": "t",
                       "args": args})
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        """Write the Chrome trace-event JSON to ``path``; returns it."""
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh, indent=1)
            fh.write("\n")
        return path


def export_chrome_trace(tracer: FrameTracer, path: str) -> str:
    """Module-level mirror of ``FrameTracer.export_chrome_trace``."""
    return tracer.export_chrome_trace(path)
