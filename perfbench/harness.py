"""The benchmark of the multi-stream CBO cascade, driven as data.

A cell of ``BENCHMARK.json`` names a configuration
(``perfbench/configs/<config>.json``: the two tiers, their precision, the
serving and fabric settings, the limits of the output check) and a
traffic mix (``perfbench/traffic/<traffic>.json``: streams, frames, frame
rate, cells and their uplinks).  A tier's model kind is a module of
``perfbench/tiers/``; a metric is a reader in ``perfbench/metrics/``.

One run: set-up (the kernels built or loaded, the weights drawn from the
seed on the device and loaded into the program's models, the fast tier
quantized by the program, the frame pool made on the host, the cell's
shapes warmed up and one whole clip served), then a window of clips
served back to back, a closed loop.  A clip is a fresh ``EdgeFabric``
(uplinks seeded from the run's seed and the clip's index) and a fresh
``MultiStreamServer`` serving the pool once.  With ``trace`` the tiers,
the planner and the fabric are timed from outside during the window, and
one clip more runs under ``torch.profiler``.  Once the window has closed
and the program is freed, the plain reference judges a sample of the
served rounds (``reference/judge.py``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from perfbench import trace as tracing
from perfbench.counts import frame_flops
from perfbench.reference import judge
from perfbench.reference.cascade import qdq
from perfbench.reference.models import precision
from perfbench.tiers import tier_module
from perfbench.video import VideoDataConfig, make_dataset
from perfbench.weights import draw, sub_seed

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class WindowClosed(Exception):
    """Raised from the round hook at the first round end past the window."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """(the benchmark, the cell, its configuration, its traffic) by name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if not cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[0]
    config = load_json(root / "perfbench" / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "perfbench" / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def cell_metrics(bench: dict, cell: str, group: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in bench[group] if cell in m.get("workloads", [cell])]


def metric_reader(name: str, root: Path = ROOT):
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules) -> list[str]:
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


@dataclass
class Record:
    """What the metric readers read: every round of the window (wall ms,
    frames, and with ``trace`` the tiers' event ms and the planner's and
    fabric's host ms), the window's length, the set-up time, and the
    profiler slice (``trace.Slice``) or None."""

    setup_s: float = 0.0
    window_s: float = 0.0
    rounds: list = field(default_factory=list)
    slice: object = None

    @property
    def frames(self) -> int:
        return sum(r["n_frames"] for r in self.rounds)


class Tap:
    """A tier as the server calls it: the model, with its outputs kept for
    the sampled clips and, when timing, CUDA events (host clocks on the
    CPU) and a profiler range around each call."""

    def __init__(self, model, name: str, bench: "Bench"):
        self.model, self.name, self.bench = model, name, bench

    def __call__(self, x):
        b = self.bench
        if not b.timing:
            y = self.model(x)
        else:
            with torch.profiler.record_function(f"perfbench.{self.name}"):
                t = b.clock()
                y = self.model(x)
                b.calls.append((self.name, b.round_index, x.shape[0], t, b.clock()))
        if b.sample is not None:
            b.sample.current[f"{self.name}_logits"] = y
        return y


class Bench:
    """One run of one cell: ``setup``, ``window``, ``profile``, ``judge``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str = "cuda", timing: bool = False):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.timing = timing
        self.fast_kind, self.slow_kind = tier_module(config["fast"]["kind"]), tier_module(config["slow"]["kind"])
        self.record = Record()
        self.calls, self.round_index, self.sample = [], 0, None
        self.samples: list = []
        self.phases: dict = {}

    # -- clocks -------------------------------------------------------------- #

    def clock(self):
        if self.device.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def elapsed_ms(self, t0, t1) -> float:
        return t0.elapsed_time(t1) if self.device.type == "cuda" else (t1 - t0) * 1e3

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # -- set-up -------------------------------------------------------------- #

    def setup(self):
        from repro_torch.core import cascade
        from repro_torch.quant.quantize import qdq_tree
        from repro_torch.serving import engine

        cfg, tr = self.config, self.traffic
        lap = _Laps(self.phases)
        torch.backends.cudnn.allow_tf32 = cfg["math"]["cudnn_tf32"]
        torch.backends.cuda.matmul.allow_tf32 = cfg["math"]["matmul_tf32"]
        if self.device.type == "cuda":
            self._build_kernels()
        lap("kernels")
        fast_state = draw(self.fast_kind.leaves(cfg["fast"]), sub_seed(self.seed, 1), self.device)
        self.fast = self.fast_kind.port(cfg["fast"], self.device)
        self.fast.load_state_dict(qdq_tree(fast_state, bits=cfg["fast"]["quant_bits"]))
        del fast_state
        slow_state = draw(self.slow_kind.leaves(cfg["slow"]), sub_seed(self.seed, 2), self.device)
        self.slow = self.slow_kind.port(cfg["slow"], self.device)
        self.slow.load_state_dict(slow_state)
        del slow_state
        self.sync()
        lap("weights")
        self.frames, self.labels = make_pool(tr, cfg["fast"], self.seed)
        lap("pool")
        self.serve = self.serve_config()
        self._patch(engine, cascade)
        self.fast_tap, self.slow_tap = Tap(self.fast, "fast", self), Tap(self.slow, "slow", self)
        self._warm_up(cascade)
        lap("warm_up")
        self.serve_clip(-1)
        self.sync()
        lap("first_clip")

    def serve_config(self):
        from repro_torch.serving.engine import ServeConfig

        sv = self.config["serve"]
        return ServeConfig(deadline=sv["deadline"], frame_rate=self.traffic["frame_rate"],
                           resolutions=tuple(sv["resolutions"]), acc_server=tuple(sv["acc_server"]),
                           batch_size=sv["batch_size"], fast_time=sv["fast_time"], calib_time=sv["calib_time"],
                           server_time=sv["server_time"], use_fused=sv["use_fused"], platt_ab=tuple(sv["platt_ab"]))

    def _build_kernels(self):
        """The calib gate's library, and the flash kernel's where the slow
        tier launches it: built on a checkout's first run, loaded after."""
        from repro_torch.kernels.build import build_all
        from repro_torch.kernels.flash_attention import kernel as flash
        from repro_torch.kernels.fused_calib_gate import kernel as gate

        uses_flash = "flash_attention" in self.slow_kind.kernels(self.config["slow"])
        build_all([gate.LIBRARY] + ([flash.LIBRARY] if uses_flash else []))

    def _patch(self, engine, cascade):
        """Keep the fast pass's answers and confidences and the slow pass's
        answers of the sampled clips: the engine's own calls, wrapped."""
        bench = self
        fast_pass, slow_pass = cascade.fast_pass, cascade.slow_pass_multires

        def fast_pass_kept(*args, **kw):
            preds, conf = fast_pass(*args, **kw)
            if bench.sample is not None:
                bench.sample.current.update(fast_preds=preds, conf=conf)
            return preds, conf

        def slow_pass_kept(*args, **kw):
            preds = slow_pass(*args, **kw)
            if bench.sample is not None:
                bench.sample.current["slow_preds"] = preds
            return preds

        engine.fast_pass, engine.slow_pass_multires = fast_pass_kept, slow_pass_kept

    @torch.inference_mode()
    def _warm_up(self, cascade):
        """The fast tier at the round's S·b frames, the slow tier at every
        batch size the rounds can send it (1 … S·b)."""
        S, b = self.frames.shape[0], self.serve.batch_size
        x = torch.as_tensor(self.frames[:, :b].reshape(S * b, *self.frames.shape[2:]), device=self.device)
        cascade.fast_pass(self.fast, None, x, use_fused=self.serve.use_fused, platt_ab=self.serve.platt_ab)
        for n in range(1, S * b + 1):
            self.slow(x[:n])
        self.sync()

    # -- serving ------------------------------------------------------------- #

    def fabric(self, clip: int):
        from repro_torch.core.netsim import Uplink, mbps
        from repro_torch.net import EdgeFabric, ReplicaPool
        from repro_torch.slowtier import ContinuousBatching, LinearBatch

        fb, tr, T = self.config["fabric"], self.traffic, self.serve.server_time
        bt = fb["batching"]
        batching = ContinuousBatching(LinearBatch(base=bt["base"], per_item=bt["per_item"]),
                                      window_s=bt["window_s"], max_batch=bt["max_batch"])
        pool = ReplicaPool(len(fb["replica_time_factors"]), [f * T for f in fb["replica_time_factors"]],
                           serial=True, batching=batching)
        ups = [Uplink(bandwidth_bps=mbps(tr["bw_mbps"]), latency=tr["latency_s"], server_time=T,
                      jitter=tr["jitter"], seed=seed) for seed in self.uplink_seeds(clip)]
        return EdgeFabric(ups, pool, n_streams=tr["streams"], placement=fb["placement"])

    def uplink_seeds(self, clip: int) -> list[int]:
        """Each cell's jitter seed in clip ``clip``."""
        return [sub_seed(self.seed, 4, clip + 1, c) for c in range(self.traffic["n_cells"])]

    def serve_clip(self, clip: int, deadline: float = float("inf")):
        """Serve the pool once on a fresh fabric and server; the round hook
        marks each round's end and closes the window at ``deadline``."""
        from repro_torch.serving.engine import MultiStreamServer

        server = MultiStreamServer(self.serve, self.fast_tap, self.slow_tap, None, None,
                                   n_streams=self.traffic["streams"], fabric=self.fabric(clip),
                                   policy=self.config["serve"]["policy"], backend=self.config["serve"]["backend"],
                                   device=self.device)
        if self.timing:
            server.fleet.plan_all = self._host_timed(server.fleet.plan_all, "plan")
            server.fabric.transmit = self._host_timed(server.fabric.transmit, "transmit")
        bench, rounds = self, []
        last = [time.perf_counter()]

        def hook(rec):
            t = time.perf_counter()
            rounds.append({"wall_ms": (t - last[0]) * 1e3, "n_frames": int(rec["valid"].sum()),
                           "index": bench.round_index})
            last[0] = t
            if bench.sample is not None:
                bench.sample.close(rec)
            bench.round_index += 1
            if t >= deadline:
                raise WindowClosed

        server.round_hook = hook
        if self.sample is not None:
            self.sample.metrics = server.metrics
        try:
            server.process_streams(self.frames, self.labels)
            closed = False
        except WindowClosed:
            closed = True
        return rounds, last[0], closed

    def _host_timed(self, fn, name: str):
        bench = self

        def timed(*args, **kw):
            with torch.profiler.record_function(f"perfbench.{name}"):
                t = time.perf_counter()
                out = fn(*args, **kw)
                bench.calls.append((name, bench.round_index, 0, t, time.perf_counter()))
            return out

        return timed

    def window(self, seconds: float, n_sample: int):
        """Clips back to back until the first round that ends ``seconds``
        after the start; a reservoir of ``n_sample`` clips, drawn from the
        seed, keeps its outputs for the check."""
        rng = np.random.default_rng(sub_seed(self.seed, 5))
        rec = self.record
        t0 = time.perf_counter()
        deadline, clip, t_end = t0 + seconds, 0, t0
        while True:
            slot = clip if clip < n_sample else int(rng.integers(0, clip + 1))
            self.sample = Sample(self.serve.platt_ab, clip) if slot < n_sample else None
            if self.sample is not None:
                self.samples[slot:slot + 1] = [self.sample]
            rounds, t_end, closed = self.serve_clip(clip, deadline)
            rec.rounds += rounds
            clip += 1
            if closed:
                break
        self.sample = None
        self.sync()
        rec.window_s = t_end - t0
        self.next_clip = clip
        if self.timing:
            self._fold_calls()

    def _fold_calls(self):
        """Per round: the tiers' event ms, the planner's and fabric's host ms."""
        per = {r["index"]: r for r in self.record.rounds}
        for r in per.values():
            r.update(fast_ms=0.0, slow_ms=0.0, plan_ms=0.0, fabric_ms=0.0)
        key = {"fast": "fast_ms", "slow": "slow_ms", "plan": "plan_ms", "transmit": "fabric_ms"}
        for name, idx, _, t0, t1 in self.calls:
            if idx in per:
                ms = (t1 - t0) * 1e3 if name in ("plan", "transmit") else self.elapsed_ms(t0, t1)
                per[idx][key[name]] += ms
        self.calls = []

    def profile(self, tries: int = 3):
        """One clip under ``torch.profiler``; a trace with no device events
        or with kernels missing is taken again, up to ``tries`` times."""
        expect = {"calib_gate": ("round", 1)}
        for tier in (self.fast_kind, self.slow_kind):
            side = "fast" if tier is self.fast_kind else "slow"
            for name, per_call in tier.kernels(self.config[side]).items():
                expect[name] = (side, per_call)
        flops = {side: frame_flops(tier, self.config[side])
                 for side, tier in (("fast", self.fast_kind), ("slow", self.slow_kind))}
        for _ in range(tries):
            self.calls = []
            first = self.round_index
            with torch.profiler.profile(activities=tracing.activities(self.device)) as prof:
                with torch.profiler.record_function(tracing.SLICE):
                    rounds, _, _ = self.serve_clip(self.next_clip)
                    self.sync()
            self.next_clip += 1
            calls = [c for c in self.calls if c[1] >= first]
            sl = tracing.read(prof, rounds, calls, expect, flops, self.slow_kind, self.config["slow"])
            self.calls = []
            if sl is not None:
                self.record.slice = sl
                return sl
        return None

    # -- the check ------------------------------------------------------------ #

    def free_program(self):
        for name in ("fast", "slow", "fast_tap", "slow_tap"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_fns(self):
        """The reference's two tiers on weights drawn again from the seed,
        the fast tier's quantized by the reference itself."""
        cfg = self.config
        fast_state = qdq(draw(self.fast_kind.leaves(cfg["fast"]), sub_seed(self.seed, 1), self.device),
                         bits=cfg["fast"]["quant_bits"])
        slow_state = draw(self.slow_kind.leaves(cfg["slow"]), sub_seed(self.seed, 2), self.device)
        fast_ref, slow_ref = self.fast_kind.reference(cfg["fast"]), self.slow_kind.reference(cfg["slow"])

        @torch.inference_mode()
        def fast_fn(x, mode):
            with precision(mode):
                return fast_ref(fast_state, x).float()

        @torch.inference_mode()
        def slow_fn(x, mode):
            with precision(mode):
                return slow_ref(slow_state, x).float()

        return fast_fn, slow_fn

    def sampled_rounds(self) -> list:
        return [r for s in self.samples for r in s.rounds]

    def judge(self, control: bool = False) -> dict:
        """The reference's outputs of the sampled rounds, and the readings
        of the program's; with ``control`` also the control's, the
        reference in the precision the configuration names below its own
        (``{"program": ..., "control": ...}``)."""
        fast_fn, slow_fn = self.reference_fns()
        for smp in self.samples:
            judge.replay(smp.rounds, self.config, self.traffic, self.uplink_seeds(smp.clip))
        rounds = self.sampled_rounds()
        sides = {"reference": ("f32", "f32")}
        if control:
            sides["control"] = (self.config["control"]["fast"], self.config["control"]["slow"])
        for rnd in rounds:
            for side, modes in sides.items():
                rnd.ref[side] = judge.reference_outputs(rnd, self.frames, fast_fn, slow_fn, self.serve.resolutions,
                                                        self.serve.platt_ab, self.device, modes)
        out = {"program": judge.readings(rounds, self.labels)}
        out["program"]["merge"] += sum(judge.tally(smp.rounds, smp.reported()) for smp in self.samples)
        if control:
            out["control"] = judge.readings(rounds, self.labels, side="control")
        return out


class _Laps:
    """Seconds of each set-up phase since the previous one, into ``phases``."""

    def __init__(self, phases: dict):
        self.phases, self.t = phases, time.perf_counter()

    def __call__(self, name: str):
        t = time.perf_counter()
        self.phases[name] = round(t - self.t, 3)
        self.t = t


class Sample:
    """The outputs of one sampled clip, round by round, and its server's
    metrics."""

    def __init__(self, platt: tuple, clip: int):
        self.rounds, self.current, self.metrics, self.platt, self.clip = [], {}, None, platt, clip

    def reported(self) -> dict:
        per = self.metrics.per_stream
        return {k: np.asarray([getattr(m, k) for m in per]) for k in ("n_correct", "n_offloaded", "n_deadline_miss")}

    def close(self, rec: dict):
        c, self.current = self.current, {}
        out = judge.Outputs(c["fast_logits"], c["conf"], c["fast_preds"], c.get("slow_logits"),
                            c.get("slow_preds"))
        self.rounds.append(judge.Round(start=int(rec["start"]), theta=rec["theta"], cap=rec["cap"],
                                       res_idx=rec["res_idx"], valid=rec["valid"], esc=rec["esc"],
                                       ok=rec["ok"], lat=rec["lat"], correct=np.asarray(rec["correct"]), out=out,
                                       platt=self.platt))


def make_pool(traffic: dict, fast_cfg: dict, seed: int):
    """(S, N, R, R, 3) float32 frames and (S, N) labels from the seed."""
    S, N, per = traffic["streams"], traffic["frames_per_stream"], traffic["frames_per_video"]
    data = make_dataset(VideoDataConfig(n_classes=fast_cfg["n_classes"], img_res=fast_cfg["img_res"],
                                        frames_per_video=per), -(-S * N // per), seed=sub_seed(seed, 3))
    frames = data["frames"][: S * N].reshape(S, N, *data["frames"].shape[1:])
    return frames, data["labels"][: S * N].reshape(S, N)



def run(config: dict, traffic: dict, metrics: list[dict], *, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None, root: Path = ROOT) -> dict:
    """One run: the result's fields, the numbers compared and their limits."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(config, traffic, seed, device=device, timing=trace)
    bench.setup()
    bench.record.setup_s = time.perf_counter() - t_start
    cuda = bench.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    bench.window(seconds, traffic["sample_clips"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if trace:
        bench.profile()
    values = {}
    for m in metrics:
        v = metric_reader(m["name"], root)(bench.record)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    bench.free_program()
    numbers = bench.judge()["program"]
    ok, rows = judge.verdict(numbers, config["limits"])
    n_checked = sum(int(r.valid.sum()) for r in bench.sampled_rounds())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    sl = bench.record.slice
    if trace and sl is not None:
        device_info.update(busy_s=sl.busy_s, window_s=sl.window_s)
    out = {"correct": bool(ok), "attempted": bench.record.frames, "failed": 0 if ok else n_checked,
           "metrics": values, "device": device_info}
    if trace and sl is not None:
        out["breakdown"] = {"device_ops": sl.device_ops, "idle_gaps": sl.idle_gaps}
    out["setup_phases_s"] = bench.phases
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return out
