"""The calib-gate kernel's dtypes, launch plan and arithmetic, on the CPU.

The CUDA kernel (``csrc/calib_gate.cu``) runs only on a GPU
(``test_torch_cuda.py``).  Here:

- the plain version on bfloat16 and float16 logits is held to the Pallas
  kernel in interpret mode and to the JAX plain version on the same
  numpy-seeded values (both widen to float32, as the CUDA kernel does), at
  ``tests/test_torch_kernels.py``'s tolerances (rtol 1e-5, atol 1e-6);
- ``split_plan`` is held to the kernel's limits, and the kernel's index map
  (row, cluster rank, thread, vector, head and tail), written out in numpy
  with the vector width, split bound and chunk sizes read from the ``.cu``,
  reads every element of every row exactly once;
- the kernel's arithmetic (each chunk's max, one rescale, one exp a logit;
  the max-first merges across lanes, warps and the cluster) is written out
  in float32 numpy and held to the plain version within ``CALIB_ATOL``
  (1e-6, ``chip_smoke.py``'s limit on the card) with gates equal; a
  stand-in fault, merging without the rescale, must miss that limit.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_calib_gate.kernel import calib_gate as jax_calib_gate
from repro.kernels.fused_calib_gate.ref import calib_gate_ref as jax_calib_gate_ref
from repro_torch.kernels.fused_calib_gate import kernel as cg_kernel
from repro_torch.kernels.fused_calib_gate.ref import calib_gate_ref

CU = (Path(cg_kernel.__file__).parent / "csrc" / "calib_gate.cu").read_text()
CALIB_ATOL = 1e-6
# test_torch_kernels.py's Platt rows, held to the JAX package at its tolerances
JAX_PLATT = [(-6.0, 2.0, 0.7), (-1.0, 0.0, 0.5), (-10.0, 5.0, 0.9)]
# and the steepest row of the cuda tests and chip_smoke.py, held to CALIB_ATOL
PLATT = JAX_PLATT + [(-20.0, 5.0, 0.3)]
N_SMS = 132  # an H100 SXM
LOG2E = np.float32(1.4426950408889634)
NEG = np.float32(-1e30)


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


VEC_BYTES, MAX_SPLITS, MAX_THREADS = (_const(n) for n in ("VEC_BYTES", "MAX_SPLITS", "MAX_THREADS"))
KERNEL_VPTS = tuple(sorted(int(v) for v in re.findall(r"return calib_gate_kernel<DT, (\d+)>;", CU)))


def _logits(B, V, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((B, V)) * scale).astype(np.float32)


def _as(x: np.ndarray, dtype: str):
    """(numpy float32 values exact in ``dtype``, the torch tensor, the JAX array)."""
    t = torch.as_tensor(x).to(getattr(torch, dtype))
    exact = t.float().numpy()
    return exact, t, jnp.asarray(exact, dtype=getattr(jnp, dtype))


# ------------------------------ dtypes --------------------------------------- #

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("B,V", [(8, 4096), (4, 32768)])
def test_plain_version_on_16_bit_logits_matches_pallas_kernel(dtype, B, V):
    exact, t, j = _as(_logits(B, V, seed=B + V), dtype)
    for a, b, theta in JAX_PLATT:
        ck, gk = jax_calib_gate(j, a, b, theta, bb=B, bv=2048, interpret=True)
        cr, gr = jax_calib_gate_ref(j, a, b, theta)
        ct, gt = calib_gate_ref(t, a, b, theta)
        assert ct.dtype == torch.float32 and gt.dtype == torch.bool
        np.testing.assert_allclose(ct.numpy(), np.asarray(ck), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cr), rtol=1e-5, atol=1e-6)
        assert np.array_equal(gt.numpy(), np.asarray(gk))
        assert np.array_equal(gt.numpy(), np.asarray(gr))
        # widening first changes nothing: the values are exact in float32
        assert torch.equal(ct, calib_gate_ref(torch.as_tensor(exact), a, b, theta)[0])


# ------------------------------ launch plan ---------------------------------- #

def test_plan_constants_match_kernel_source():
    assert (VEC_BYTES, MAX_SPLITS, MAX_THREADS) == (cg_kernel.VEC_BYTES, cg_kernel.MAX_SPLITS, cg_kernel.MAX_THREADS)
    assert KERNEL_VPTS == cg_kernel.VPTS
    assert "__launch_bounds__(MAX_THREADS)" in CU


def _check_plan(plan, B, V, eb):
    s, threads, vpt = plan
    assert 1 <= s <= MAX_SPLITS and s & (s - 1) == 0
    assert vpt in KERNEL_VPTS
    assert 32 <= threads <= MAX_THREADS and threads % 32 == 0
    assert B * s <= 0x7FFFFFFF


@pytest.mark.parametrize("eb", [2, 4])
def test_split_plan_within_kernel_limits(eb):
    for B in (1, 2, 7, 8, 16, 37, 128, 256, 5000):
        for V in (1, 3, 7, 1000, 1001, 4096, 32768, 100352, 152064, 1 << 20):
            plan = cg_kernel.split_plan(B, V, eb, N_SMS)
            _check_plan(plan, B, V, eb)
            # the rows' blocks exceed one wave only unsplit
            assert plan.splits == 1 or B * plan.splits <= N_SMS
            for s in (1, 2, 4, 8, 16):
                _check_plan(cg_kernel.split_plan(B, V, eb, N_SMS, splits=s), B, V, eb)
            for v in KERNEL_VPTS:
                _check_plan(cg_kernel.split_plan(B, V, eb, N_SMS, vpt=v), B, V, eb)


def test_split_plan_at_the_phase_2_shapes():
    plan = cg_kernel.split_plan
    assert plan(16, 1000, 4, N_SMS) == (1, 256, 1)  # one vector a thread covers a row
    assert plan(128, 1000, 4, N_SMS) == (1, 256, 1)
    assert plan(37, 1001, 2, N_SMS) == (1, 128, 1)
    assert plan(128, 4096, 4, N_SMS) == (1, 512, 2)
    assert plan(256, 102400, 4, N_SMS) == (1, 512, 4)  # 256 rows fill the card unsplit;
    assert plan(256, 102400, 2, N_SMS) == (1, 512, 2)  # 16 elements a thread a chunk
    assert plan(8, 152064, 4, N_SMS) == (16, 320, 8)
    assert plan(8, 100352, 2, N_SMS) == (16, 416, 2)
    assert plan(1, 152064, 4, N_SMS) == (16, 320, 8)
    assert plan(16, 152064, 4, N_SMS).splits == 8  # 16 x 16 blocks would be two waves


def test_split_plan_halves_a_cluster_that_does_not_fit():
    """While fewer than B clusters of the plan fit on the card at once, the
    split is halved (a cluster of 16 must fit in one GPC)."""
    fits = {16: 7, 8: 30, 4: 62, 2: 132}
    seen = []

    def max_clusters(p):
        seen.append(p)
        return fits[p.splits]

    plan = cg_kernel.split_plan(8, 152064, 4, N_SMS, max_clusters)
    assert plan.splits == 8 and [p.splits for p in seen] == [16, 8]
    assert cg_kernel.split_plan(7, 152064, 4, N_SMS, max_clusters).splits == 16
    assert cg_kernel.split_plan(8, 152064, 4, N_SMS, lambda p: 0).splits == 1


def _row_layout(base: int, V: int, eb: int, splits: int):
    """The kernel's cut of a row at byte address ``base``: (head, n_vec,
    tail, [(lo, hi) a rank]), as ``calib_gate_kernel`` computes it."""
    ve = VEC_BYTES // eb
    head = min(((-base) % VEC_BYTES) // eb, V)
    n_vec = (V - head) // ve
    tail = head + n_vec * ve
    per = (n_vec + splits - 1) >> (splits.bit_length() - 1)
    ranges = []
    for rank in range(splits):
        lo = min(rank * per, n_vec)
        ranges.append((lo, min(lo + per, n_vec)))
    return head, n_vec, tail, ranges


def _tile_vectors(t0, hi, threads, vpt):
    """(vpt, threads) vector indices of one chunk and whether each is in range;
    a load past the range is clamped to hi - 1."""
    idx = t0 + np.arange(vpt)[:, None] * threads + np.arange(threads)[None, :]
    return np.minimum(idx, hi - 1), idx < hi


def _reads(base: int, V: int, eb: int, plan) -> np.ndarray:
    """How many times each element of one row is taken (unmasked)."""
    splits, threads, vpt = plan
    ve = VEC_BYTES // eb
    head, n_vec, tail, ranges = _row_layout(base, V, eb, splits)
    if n_vec:
        assert (base + head * eb) % VEC_BYTES == 0  # the body's vector loads are aligned
    assert V - tail < ve and head < ve and head + (V - tail) <= threads
    counts = np.zeros(V, np.int64)
    tid = np.arange(threads)
    e = np.where(tid < head, tid, tail + (tid - head))
    assert (np.minimum(e, V - 1) >= 0).all()
    np.add.at(counts, e[e < V], 1)  # rank 0's head and tail
    for lo, hi in ranges:
        for t0 in range(lo, hi, vpt * threads):
            idx, ok = _tile_vectors(t0, hi, threads, vpt)
            assert (idx >= lo).all() and (idx < hi).all()
            elems = head + idx[ok][:, None] * ve + np.arange(ve)
            np.add.at(counts, elems.ravel(), 1)
    return counts


@pytest.mark.parametrize("eb", [2, 4])
@pytest.mark.parametrize("V", [1, 3, 7, 1000, 1001, 4096, 100352, 152064])
def test_index_map_reads_every_element_once(V, eb):
    B = 3
    plans = {cg_kernel.split_plan(B, V, eb, N_SMS), cg_kernel.split_plan(1, V, eb, N_SMS)}
    plans |= {cg_kernel.split_plan(B, V, eb, N_SMS, splits=s) for s in (2, 16)}
    plans |= {cg_kernel.split_plan(B, V, eb, N_SMS, vpt=v) for v in (1, 8)}
    for plan in plans:
        assert plan.splits <= 16
        for base0 in (0, eb, VEC_BYTES - eb):  # an aligned base and two misaligned ones
            for row in range(B):
                counts = _reads(base0 + row * V * eb, V, eb, plan)
                assert (counts == 1).all(), (plan, base0, row, np.flatnonzero(counts != 1)[:5])


# ------------------------------ arithmetic ----------------------------------- #

def _exp_diff(x, m):
    with np.errstate(invalid="ignore", over="ignore"):
        return np.exp2((np.float32(x) - np.float32(m)) * LOG2E).astype(np.float32)


def _warp_merge(m, s, rescale=True):
    """Lanes (..., 32) -> (m, s) of the warp: the max (exact in any order),
    then each sum rescaled to it and the sums added by xor shuffles."""
    lanes = np.arange(32)
    wm = m.copy()
    for off in (16, 8, 4, 2, 1):
        wm = np.maximum(wm, wm[..., lanes ^ off])
    s = s * _exp_diff(m, wm) if rescale else s.copy()
    for off in (16, 8, 4, 2, 1):
        s = (s + s[..., lanes ^ off]).astype(np.float32)
    return wm[..., 0], s[..., 0]


def _emulate_row(x: np.ndarray, plan, base: int = 0, rescale=True):
    """One row through the kernel's arithmetic in float32: (m, s)."""
    splits, threads, vpt = plan
    V, eb = x.size, 4
    ve = VEC_BYTES // eb
    head, n_vec, tail, ranges = _row_layout(base, V, eb, splits)
    body = x[head:tail].reshape(n_vec, ve)
    parts = []
    for rank, (lo, hi) in enumerate(ranges):
        m = np.full(threads, NEG, np.float32)
        s = np.zeros(threads, np.float32)
        for t0 in range(lo, hi, vpt * threads):
            idx, ok = _tile_vectors(t0, hi, threads, vpt)
            xs = np.where(ok[..., None], body[idx], np.float32(-np.inf))  # (vpt, threads, ve)
            xs = xs.transpose(1, 0, 2).reshape(threads, vpt * ve)  # element i of a chunk: vector i // ve
            mn = np.maximum(m, xs.max(axis=1))
            cs = np.zeros((threads, 4), np.float32)
            for i in range(xs.shape[1]):
                cs[:, i % 4] += _exp_diff(xs[:, i], mn)
            s = (s * _exp_diff(m, mn) + ((cs[:, 0] + cs[:, 1]) + (cs[:, 2] + cs[:, 3]))).astype(np.float32)
            m = mn
        tid = np.arange(threads)
        e = np.where(tid < head, tid, tail + (tid - head))
        xe = np.where((rank == 0) & (e < V), x[np.minimum(e, V - 1)], np.float32(-np.inf))
        mn = np.maximum(m, xe)
        s = (s * _exp_diff(m, mn) + _exp_diff(xe, mn)).astype(np.float32)
        m = mn
        m, s = _warp_merge(m.reshape(-1, 32), s.reshape(-1, 32), rescale)
        if m.size > 1:
            m, s = _warp_merge(np.pad(m, (0, 32 - m.size), constant_values=NEG),
                               np.pad(s, (0, 32 - s.size)), rescale)
        parts.append((np.ravel(m)[0], np.ravel(s)[0]))
    if splits > 1:
        pm, ps = (np.array([p[i] for p in parts], np.float32) for i in (0, 1))
        return _warp_merge(np.pad(pm, (0, 32 - splits), constant_values=NEG),
                           np.pad(ps, (0, 32 - splits)), rescale)
    return parts[0]


def _emulate(x: np.ndarray, plan, a, b, theta, rescale=True):
    s = np.array([_emulate_row(row, plan, base=r * x.shape[1] * 4, rescale=rescale)[1]
                  for r, row in enumerate(x)], np.float32)
    conf = (np.float32(1) / np.maximum(s, np.float32(1e-30))).astype(np.float32)
    with np.errstate(over="ignore"):
        calib = (np.float32(1) / (np.float32(1) + np.exp(np.float32(a) * conf + np.float32(b)))).astype(np.float32)
    return calib, calib < theta


def _rows(V: int, seed: int) -> np.ndarray:
    """Random rows, x50 rows, and the extreme rows of chip_smoke.py: all
    -inf, all 1e4, all -1e4, half at -1e4, -1e4 beside x50 values."""
    x = _logits(8, V, seed)
    x[1] *= 50 / 3
    x[2] = -np.inf
    x[3] = 1e4
    x[4] = -1e4
    x[5, ::2] = -1e4
    x[6, : V // 2] = -1e4
    x[6, V // 2:] *= 50 / 3
    x[7, V // 3] = 40.0  # one dominant logit: conf near 1
    return x


EMULATED = [(1003, None, None), (1000, None, None), (4096, None, 1), (24000, 4, None), (24000, 16, None),
            (24000, 16, 8)]


@pytest.mark.parametrize("V,splits,vpt", EMULATED)
def test_kernel_arithmetic_matches_plain_version(V, splits, vpt):
    x = _rows(V, seed=V)
    plan = cg_kernel.split_plan(x.shape[0], V, 4, N_SMS, splits=splits, vpt=vpt)
    for a, b, theta in PLATT:
        calib, gate = _emulate(x, plan, a, b, theta)
        cr, gr = calib_gate_ref(torch.as_tensor(x), a, b, theta)
        assert np.isfinite(calib).all()
        np.testing.assert_allclose(calib, cr.numpy(), rtol=0, atol=CALIB_ATOL)
        assert np.array_equal(gate, gr.numpy())


def test_merge_without_rescale_is_caught():
    """A stand-in fault: lanes, warps and cluster ranks merged by adding
    their sums without rescaling them to the common max."""
    x = _rows(24000, seed=5)
    plan = cg_kernel.split_plan(x.shape[0], 24000, 4, N_SMS, splits=4)
    missed = 0
    for a, b, theta in PLATT:
        calib, gate = _emulate(x, plan, a, b, theta, rescale=False)
        cr, gr = calib_gate_ref(torch.as_tensor(x), a, b, theta)
        missed += np.abs(calib - cr.numpy()).max() > CALIB_ATOL or not np.array_equal(gate, gr.numpy())
    assert missed == len(PLATT)
