#!/usr/bin/env python3
"""Design variants of the port's int8-KV decode kernel, timed in one process.

    python3 scripts/torch_kv_decode_variants.py [--old-source FILE] [--path4]

Needs an NVIDIA GPU and ``nvcc``.  Each variant is the shipped source
``src/repro_torch/kernels/int8_kv_decode/csrc/int8_kv_decode.cu`` with the
text patches listed below, built into ``build/kv_decode_variants/<name>/``
(one ``nvcc`` each, all started together).  At the shapes of
``chip_smoke.KV_CASES`` (path 4's decode shape among them), each variant
is checked against ``decode_attention_ref`` (``chip_smoke.DECODE_TOL``; a design variant that misses it is reported,
the shipped and old kernels raise) and timed by device time from the profiler
(``chip_smoke.device_ms``), in the order shipped, variants, variants
reversed, shipped, beside SDPA on a bf16 cache dequantized beforehand.  The
patches are written against the source as it stands; if it changes, a
patch that no longer applies raises.

``--old-source FILE`` adds the two-kernel design that this one replaced
(split kernel plus merge kernel, 128-token tiles copied by plain loads,
int8 converted by I2F), built from FILE, e.g. the output of
``git show 9a1ac95:src/repro_torch/kernels/int8_kv_decode/csrc/int8_kv_decode.cu``
saved under ``build/``.  With ``--path4`` as well, ``chip_smoke.lm_phase``
(StableLM-12B, 8 x 2048-token prefill, 32 decode steps) runs with the
shipped kernel, the old one and the shipped one again, for the kernel's
share of a decode step, decode tokens/s and the idle share in one process.

Variants (the probes compute a wrong result on purpose, to split the time,
and are not checked):
  shipped       a ring of 3 cp.async stages of 64 tokens;
  stages2       2 stages (one tile in flight while one is computed);
  stages4       4 stages;
  issue_mid     the next copies issued after the scores, not before them;
  issue_late    the next copies issued after P.V;
  probe_noconv  int8 words reinterpreted as fp16 pairs without conversion
                (two LOP3 in place of two PRMT and two HSUB2);
  probe_nopv    no P.V products (the compiler then drops V's loads and
                conversion too; scores, softmax and merge kept);
  probe_noscores  no q.k products (scores of 0);
  probe_nomerge   the last block of a (b, kv head) resets its counter and
                  does not merge;
  probe_noload    no tile is copied (the shared memory is computed on as
                  it lies);
  probe_loadonly  neither q.k nor P.V products: the ring, softmax and merge.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src/repro_torch/kernels/int8_kv_decode/csrc/int8_kv_decode.cu"
OUT = ROOT / "build" / "kv_decode_variants"

STAGES2 = [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")]
STAGES4 = [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")]
NOCONV = [("""  const uint32_t x = __byte_perm(u, 0x6464u, 0x4140u), y = __byte_perm(u, 0x6464u, 0x4342u);
  asm("sub.rn.f16x2 %0, %1, %2;\\n" : "=r"(lo) : "r"(x), "r"(0x64806480u));
  asm("sub.rn.f16x2 %0, %1, %2;\\n" : "=r"(hi) : "r"(y), "r"(0x64806480u));""",
           """  lo = u & 0x3bff3bffu;
  hi = (u >> 1) & 0x3bff3bffu;""")]
NOPV = [("for (int part = 2; part >= 0; --part) mma_f16(acc[mb]",
         "for (int part = 2; part >= 0 && mb < 0; --part) mma_f16(acc[mb]")]
NOLOAD = [("    if (i < n_tiles) {\n      unsigned char* st", "    if (false) {\n      unsigned char* st")]
NOSCORES = [("        mma_f16(sc, a, bq[part].x, bq[part].y);\n        if (c + 1 < nch)",
             "        if (c < 0) mma_f16(sc, a, bq[part].x, bq[part].y);\n        if (c + 1 < 0)")]
NOMERGE = [("  if (!*last) return;", "  if (*last && tid == 0) counters[bk] = 0;\n  return;")]

ISSUE_MID = [("    issue(i + STAGES - 1);        // into tile i - 1's stage\n", ""),
             ("    const bool vA = tokA < n_valid, vB = tokB < n_valid;\n",
              "    issue(i + STAGES - 1);\n    const bool vA = tokA < n_valid, vB = tokB < n_valid;\n")]
ISSUE_LATE = [("    issue(i + STAGES - 1);        // into tile i - 1's stage\n", ""),
              ("        for (int part = 2; part >= 0; --part) mma_f16(acc[mb], a, bp[part][0], bp[part][1]);\n      }\n    }\n",
               "        for (int part = 2; part >= 0; --part) mma_f16(acc[mb], a, bp[part][0], bp[part][1]);\n      }\n    }\n"
               "    issue(i + STAGES - 1);\n")]

VARIANTS = {
    "shipped": [],
    "stages2": STAGES2,
    "stages4": STAGES4,
    "issue_mid": ISSUE_MID,
    "issue_late": ISSUE_LATE,
    "probe_noconv": NOCONV,
    "probe_nopv": NOPV,
    "probe_noscores": NOSCORES,
    "probe_nomerge": NOMERGE,
    "probe_noload": NOLOAD,
    "probe_loadonly": NOSCORES + NOPV,
}
PROBES = {"probe_noconv", "probe_nopv", "probe_noscores", "probe_nomerge", "probe_noload",
          "probe_loadonly"}

def variant_source(patches) -> str:
    src = SOURCE.read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"patch does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def old_kernel(lib, n_sms: int):
    """A wrapper for the two-kernel design's C interface (workspaces for m,
    l and acc; 128-token tiles; about four blocks a SM), counting launches."""
    import torch

    def call(q, k_q, k_s, v_q, v_s):
        B, H, D = q.shape
        S, KH = k_q.shape[1], k_q.shape[2]
        G = H // KH
        n_tiles = -(-S // 128)
        want = max(1, min(n_tiles, -(-4 * n_sms // (B * KH))))
        per = -(-n_tiles // want)
        n = -(-n_tiles // per)
        out = torch.empty_like(q)
        m_ws, l_ws = (torch.empty((B * KH * n, G), device=q.device) for _ in range(2))
        acc_ws = torch.empty((B * KH * n, G, D), device=q.device)
        err = lib.load().int8_kv_decode_launch(
            q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
            out.data_ptr(), m_ws.data_ptr(), l_ws.data_ptr(), acc_ws.data_ptr(),
            0 if q.dtype == torch.float32 else 1, B, H, KH, S, D, n, per, 1.0 / math.sqrt(D),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"old int8_kv_decode launch failed with cudaError {err}")
        call.launches += 1
        return out

    call.launches = 0
    return call


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels.build import CudaLibrary, build_all
    from repro_torch.kernels.int8_kv_decode import kernel as kv
    from repro_torch.kernels.int8_kv_decode import ops as kv_ops
    from repro_torch.kernels.int8_kv_decode.ref import decode_attention_ref

    ap = argparse.ArgumentParser()
    ap.add_argument("--old-source", type=Path, default=None)
    ap.add_argument("--path4", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    libs = {}
    for name, patches in VARIANTS.items():
        path = OUT / name / "int8_kv_decode.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(variant_source(patches))
        libs[name] = CudaLibrary(path, kv.LIBRARY.symbols)
    old = None
    if args.old_source is not None:
        _P, _I = ctypes.c_void_p, ctypes.c_int
        old = CudaLibrary(args.old_source.resolve(),
                          {"int8_kv_decode_launch": [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P]})
    build_all(list(libs.values()) + ([old] if old else []))
    for name, lib in list(libs.items()) + ([("old", old)] if old else []):
        entry = None
        for line in lib.ptxas_log.splitlines():
            if "Compiling entry" in line:
                entry = "ILi10E13__nv_bfloat16" in line
            elif entry and ("registers" in line or "spill" in line):
                print(f"  {name:12s} bf16 D<=160 ptxas: {line.strip()}")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    old_fn = old_kernel(old, n_sms) if old else None

    def run(name):
        if name == "old":
            return old_fn
        kv.LIBRARY = libs[name]
        kv.launch_plan.cache_clear()
        return kv.int8_kv_decode

    names = list(libs) + (["old"] if old else [])
    order = names + names[::-1]
    g = torch.Generator(device="cuda").manual_seed(1)
    for _, B, S, KH, G, D, tname in chip_smoke.KV_CASES:
        dtype = getattr(torch, tname)
        q = torch.randn(B, KH * G, D, generator=g, device="cuda").to(dtype)
        kq, vq = (torch.randint(-127, 128, (B, S, KH, D), generator=g, device="cuda", dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(B, S, generator=g, device="cuda") * 0.015 + 0.005 for _ in range(2))
        ref = decode_attention_ref(q, kq, ks, vq, vs).float()
        rtol, atol = chip_smoke.DECODE_TOL[tname]
        times = {name: [] for name in names}
        for name in order:
            fn = run(name)
            if name not in PROBES:
                # every launch leaves the arrival counters at zero
                stale = [int(c.count_nonzero()) for c in kv._COUNTERS.values()]
                chip_smoke.check(not any(stale), f"{name}: {stale} counters not zero before the call")
                out = fn(q, kq, ks, vq, vs).float()
                ok = bool(((out - ref).abs() <= atol + rtol * ref.abs()).all())
                msg = f"{name} at {(B, S, KH, G, D)} {tname}: err {float((out - ref).abs().max())}"
                if name in ("shipped", "old"):
                    chip_smoke.check(ok, msg)
                elif not ok and len(times[name]) == 0:
                    print(f"  WRONG RESULT: {msg}")
            times[name].append(chip_smoke.device_ms(lambda: fn(q, kq, ks, vq, vs)))
            if name in ("shipped", "stages2", "stages4") and len(times[name]) == 1:
                plan = kv.launch_plan(0, dtype, D)
                print(f"  {name} plan at {(B, S, KH, G, D)} {tname}: {plan.blocks_per_sm} blocks a SM,"
                      f" {plan.smem_bytes} B shared, {plan.stages} stages,"
                      f" {plan.blocks_per_sm * (plan.stages - 1) * plan.tile_bytes} B in flight a SM")
        qd = q.to(torch.bfloat16)[:, :, None, :]
        kd = (kq.float() * ks[:, :, None, None]).to(torch.bfloat16).transpose(1, 2)
        vd = (vq.float() * vs[:, :, None, None]).to(torch.bfloat16).transpose(1, 2)
        sdpa = chip_smoke.device_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, enable_gqa=True))
        bound, _ = chip_smoke.decode_bound(B, S, KH, G, D, q.element_size())
        print(f"{(B, S, KH, G, D)} {tname}: SDPA (bf16 cache) device {chip_smoke._us(sdpa)},"
              f" bound {chip_smoke._us(bound)}")
        for name, ts in times.items():
            print(f"  {name:12s} device " + " / ".join(chip_smoke._us(t) for t in ts))

    if args.path4 and old_fn is not None:
        for name in ("shipped", "old", "shipped"):
            fn = run(name)
            kv_ops.int8_kv_decode = fn
            # the other kernels are not reached: counters that stay at 0
            others = {k: SimpleNamespace(launches=0) for k in ("calib_gate", "flash_attention", "int8_matmul")}
            print(f"path 4 with the {name} kernel:")
            chip_smoke.lm_phase({**others, "int8_kv_decode": fn},
                                ("decode_split", "decode_merge") if name == "old"
                                else ("int8_kv_decode_kernel",))
            torch.cuda.empty_cache()
        kv_ops.int8_kv_decode = kv.int8_kv_decode
    return 0


if __name__ == "__main__":
    sys.exit(main())
