"""The port's int8-KV decode attention against the JAX reference's kernel.

On the CPU the port runs the kernel's plain version
(``decode_attention_ref``), held here to the Pallas kernel in interpret
mode and to the JAX plain version on the same numpy inputs, within 2e-5
(rtol and atol; the softmax summed in another order, the reference
sweep's own tolerance).  The CUDA kernel itself runs only on a GPU
(``test_torch_cuda.py``); here it is shown that its wrapper is never
faked on the CPU, and its arithmetic is emulated in numpy: the int8 to
fp16 widening bit for bit, the m16n8k16 fragments of q·K and P·V with
q's and P's fp16 parts (exact or within 2^-24), the split plan, and the
in-kernel merge of per-split partials (within the f32 limit).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.int8_kv_decode.kernel import int8_kv_decode as jax_int8_kv_decode
from repro.kernels.int8_kv_decode.ref import decode_attention_ref as jax_decode_attention_ref
from repro_torch.kernels.int8_kv_decode import kernel as kv_kernel
from repro_torch.kernels.int8_kv_decode.kernel import split_plan
from repro_torch.kernels.int8_kv_decode.ops import decode_attention
from repro_torch.kernels.int8_kv_decode.ref import decode_attention_ref

TOL = 2e-5


def _inputs(B, S, KH, G, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, KH * G, D)).astype(np.float32),
            rng.integers(-127, 128, (B, S, KH, D)).astype(np.int8),
            rng.uniform(0.005, 0.02, (B, S)).astype(np.float32),
            rng.integers(-127, 128, (B, S, KH, D)).astype(np.int8),
            rng.uniform(0.005, 0.02, (B, S)).astype(np.float32))


def _port(args, dtype=torch.float32):
    q, kq, ks, vq, vs = (torch.as_tensor(a) for a in args)
    return decode_attention_ref(q.to(dtype), kq, ks, vq, vs)


def _jax(args):
    return tuple(jnp.asarray(a) for a in args)


# tests/test_kernels_decode.py's sweep (MQA, GQA, MHA-ish, G=4), and
# StableLM-12B's head geometry (KH 8, G 4, D 160) at S 1024
@pytest.mark.parametrize("B,S,KH,G,D,bs", [
    (1, 512, 1, 1, 64, 256),
    (2, 1024, 4, 3, 64, 256),
    (2, 512, 8, 1, 128, 512),
    (1, 2048, 2, 4, 64, 512),
    (2, 1024, 8, 4, 160, 512),
])
def test_decode_ref_matches_pallas_and_jax_ref(B, S, KH, G, D, bs):
    args = _inputs(B, S, KH, G, D, seed=S + KH)
    pallas = np.asarray(jax_int8_kv_decode(*_jax(args), bs=bs, interpret=True))
    jref = np.asarray(jax_decode_attention_ref(*_jax(args)))
    out = _port(args)
    assert out.shape == (B, KH * G, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), jref, rtol=TOL, atol=TOL)


def test_decode_ref_bf16_q_matches_jax_ref():
    """A bf16 q: f32 arithmetic, one bf16 rounding of the output."""
    args = _inputs(2, 256, 2, 4, 160, seed=5)
    q = jnp.asarray(args[0]).astype(jnp.bfloat16)
    jref = np.asarray(jax_decode_attention_ref(q, *_jax(args[1:])).astype(jnp.float32))
    out = _port(args, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), jref, rtol=1e-2, atol=1e-2)


def test_decode_ref_matches_dequantize_first():
    """The fold is the model's dequantize-first attention
    (``test_kernels_decode.py::test_matches_model_fold_path``)."""
    B, S, KH, G, D = 2, 256, 2, 2, 32
    q, kq, ks, vq, vs = (torch.as_tensor(a) for a in _inputs(B, S, KH, G, D, seed=7))
    kf = kq.float() * ks[:, :, None, None]
    vf = vq.float() * vs[:, :, None, None]
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(B, KH, G, D), kf) / np.sqrt(D)
    ref = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, -1), vf).reshape(B, KH * G, D)
    torch.testing.assert_close(decode_attention_ref(q, kq, ks, vq, vs), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S", [2047, 1, 300])
def test_decode_ref_ragged_s_matches_jax_ref(S):
    """S that the Pallas wrapper does not tile, against the JAX plain version."""
    args = _inputs(2, S, 8, 4, 160, seed=S)
    jref = np.asarray(jax_decode_attention_ref(*_jax(args)))
    np.testing.assert_allclose(_port(args).numpy(), jref, rtol=TOL, atol=TOL)


def test_decode_ref_extreme_scales_finite():
    """``test_extreme_scales_stable``'s scales: K 1e-8, V 10."""
    q, kq, _, vq, _ = _inputs(1, 256, 1, 2, 32, seed=0)
    ks = np.full((1, 256), 1e-8, np.float32)
    vs = np.full((1, 256), 10.0, np.float32)
    args = (q, kq, ks, vq, vs)
    out = _port(args)
    assert torch.isfinite(out).all()
    pallas = np.asarray(jax_int8_kv_decode(*_jax(args), bs=128, interpret=True))
    np.testing.assert_allclose(out.numpy(), pallas, rtol=TOL, atol=TOL)


def test_decode_attention_cpu_takes_plain_version():
    """On a CPU tensor the dispatch runs the plain version and launches nothing."""
    q, kq, ks, vq, vs = (torch.as_tensor(a) for a in _inputs(2, 64, 2, 4, 32, seed=11))
    before = kv_kernel.int8_kv_decode.launches
    assert torch.equal(decode_attention(q, kq, ks, vq, vs), decode_attention_ref(q, kq, ks, vq, vs))
    assert kv_kernel.int8_kv_decode.launches == before


def test_cuda_wrapper_refuses_cpu_tensor():
    """The kernel wrapper is never faked by the plain version: a CPU tensor
    raises before anything is built or counted."""
    q, kq, ks, vq, vs = (torch.as_tensor(a) for a in _inputs(1, 16, 1, 2, 32, seed=0))
    before = kv_kernel.int8_kv_decode.launches
    with pytest.raises(ValueError, match="CUDA kernel"):
        kv_kernel.int8_kv_decode(q, kq, ks, vq, vs)
    assert kv_kernel.int8_kv_decode.launches == before


@pytest.mark.parametrize("bps", [1, 3, 4])
@pytest.mark.parametrize("bkh,S,sms", [(64, 2048, 132), (1, 512, 132), (16, 1, 132),
                                       (80, 1024, 132), (16, 2047, 132), (4, 100000, 132)])
def test_split_plan_covers_every_tile_once(bkh, S, sms, bps):
    """Every 64-token tile lies in exactly one split and no split is empty;
    where S allows (at most sqrt(``MERGE_RATIO`` x tiles) splits), the grid
    holds at least half of the one wave of ``bps`` blocks per SM that it
    aims at (the splits take equal whole numbers of tiles) and never more
    than that wave, in at most ``MAX_SPLITS`` splits."""
    n, per = split_plan(bkh, S, sms, bps)
    tiles = -(-S // kv_kernel.TILE)
    useful = math.isqrt(kv_kernel.MERGE_RATIO * tiles)
    assert n * per >= tiles and (n - 1) * per < tiles
    assert 2 * bkh * n >= min(bps * sms, bkh * min(tiles, useful))
    assert n == 1 or bkh * n <= bps * sms
    assert n <= min(useful, kv_kernel.MAX_SPLITS) or n == 1


def test_split_plan_at_the_path_shape():
    """Path 4's (B·KH, S) = (64, 2048) at 3 blocks a SM on 132 SMs: 6 splits
    of 6 tiles (the last of 2), 384 blocks in one wave of 396."""
    assert split_plan(64, 2048, 132, 3) == (6, 6)


# ---- the CUDA kernel's arithmetic, emulated in numpy ------------------------ #

def _byte_perm(x, y, s):
    """CUDA's ``__byte_perm(x, y, s)`` on uint32 arrays: byte i of the result
    is byte ``(s >> 4i) & 7`` of the 8 bytes y:x."""
    x, y = np.asarray(x, np.uint64), np.uint64(y)
    pool = x | (y << np.uint64(32))
    out = np.zeros_like(x)
    for i in range(4):
        sel = np.uint64((s >> (4 * i)) & 7)
        out |= ((pool >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _i8x4_to_h2x2(words):
    """The kernel's ``i8x4_to_h2x2``: sign bits flipped, bytes 0, 1 and 2, 3
    put under the fp16 exponent of 1024 by PRMT (0x64xx), then one f16x2
    subtraction of 1152 each; returns the four values as float16."""
    u = np.asarray(words, np.uint32) ^ np.uint32(0x80808080)
    lo, hi = _byte_perm(u, 0x6464, 0x4140), _byte_perm(u, 0x6464, 0x4342)
    pairs = np.stack([lo, hi], axis=-1).view(np.float16)  # (..., 4): bytes 0, 1, 2, 3
    return pairs - np.float16(1152)


def test_int8_to_fp16_pairs_exact_for_every_int8():
    """All 256 int8 values, in every byte position, come out bit for bit as
    ``astype(np.float16)`` (the scores' A operand)."""
    vals = np.arange(-128, 128, dtype=np.int8)
    for pos in range(4):
        b = np.zeros((256, 4), np.int8)
        b[:, pos] = vals
        b[:, (pos + 1) % 4] = vals[::-1]
        got = _i8x4_to_h2x2(b.view(np.uint32)[:, 0])
        assert got.dtype == np.float16
        np.testing.assert_array_equal(got.view(np.uint16), b.astype(np.float16).view(np.uint16))


def _warp_scores(k16, q, parts):
    """One warp's scores as the kernel computes them, on the m16n8k16 fragment
    layout of PTX's mma.sync: A from 32-bit words of the K rows (fragment
    column 2t + i <-> dim 4t + i, 2t + 8 + i <-> 4t + 2 + i), B from q scaled
    by 2^e into [2^14, 2^15) and split into ``parts`` fp16 parts; products
    summed in float64 (the tensor cores' exact products, summed in f32 on the
    card).  Returns S (16 tokens, 8 rows) before the scale 2^-e."""
    D = k16.shape[1]
    G = q.shape[0]
    qmax = float(np.abs(q).max())
    e2 = 0 if qmax == 0 else int(np.clip(14 - np.frexp(np.float32(qmax))[1] + 1, -126, 126))
    qs = np.zeros((8, D), np.float64)
    qs[:G] = q.astype(np.float64) * 2.0 ** e2
    split, r = [], qs.astype(np.float32)
    for _ in range(parts):
        h = r.astype(np.float16)
        split.append(h)
        r = (r - h.astype(np.float32)).astype(np.float32)
    S = np.zeros((16, 8))
    for c in range(D // 16):
        A = np.zeros((16, 16), np.float64)
        B = np.zeros((16, 8), np.float64)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for row in (g, g + 8):
                word = k16[row, 16 * c + 4 * t:16 * c + 4 * t + 4].view(np.uint32)[0]
                v = _i8x4_to_h2x2(word).astype(np.float64)
                A[row, 2 * t:2 * t + 2] = v[0:2]
                A[row, 2 * t + 8:2 * t + 10] = v[2:4]
            dims = 16 * c + 4 * t + np.arange(4)
            bq = sum(h[g, dims].astype(np.float64) for h in split)
            B[2 * t:2 * t + 2, g] = bq[0:2]
            B[2 * t + 8:2 * t + 10, g] = bq[2:4]
        S += A @ B
    return S, 2.0 ** -e2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("G,D", [(1, 16), (4, 160), (7, 128), (8, 256), (2, 64)])
def test_tensor_core_scores_are_exact(dtype, G, D):
    """The scores' fragments, fp16 widening and q's fp16 parts give q . k to
    f32 precision: exactly (as float64 sums) for a bf16 q with one part, and
    within 2^-24 of |q| . |k| for an f32 q with three."""
    rng = np.random.default_rng(G * D)
    k16 = rng.integers(-128, 128, (16, D)).astype(np.int8)
    q = rng.standard_normal((G, D)).astype(np.float32)
    if dtype == "bfloat16":
        q = torch.as_tensor(q).to(torch.bfloat16).float().numpy()
    S, down = _warp_scores(k16, q, 1 if dtype == "bfloat16" else 3)
    exact = k16.astype(np.float64) @ q.astype(np.float64).T
    got = S[:, :G] * down
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, exact)
    else:
        bound = 2.0 ** -24 * (np.abs(k16).astype(np.float64) @ np.abs(q).astype(np.float64).T)
        assert (np.abs(got - exact) <= bound).all()
    assert (S[:, G:] == 0).all()


def _f16x3(x):
    """``split_f16x3``: hi, mid and lo, each x's remainder rounded to fp16."""
    parts, r = [], np.asarray(x, np.float32)
    for _ in range(3):
        h = r.astype(np.float16)
        parts.append(h)
        r = (r - h.astype(np.float32)).astype(np.float32)
    return parts


def test_f16x3_split_of_p_is_exact():
    """P' = p·v_s·2^k lies in [0, 2^15): its three fp16 parts add up to the
    f32 value exactly from 1 up, and within 2^-25 below (the parts reach
    fp16's subnormals), 2^-40 of the largest P' the scale allows."""
    rng = np.random.default_rng(0)
    x = (2.0 ** rng.uniform(-30, 15, 200000)).astype(np.float32)
    total = sum(h.astype(np.float64) for h in _f16x3(x))
    big = x >= 1.0
    assert np.array_equal(total[big], x[big].astype(np.float64))
    assert (np.abs(total - x) <= 2.0 ** -25).all()


def _warp_pv(v16, pt):
    """One warp's P·V as the kernel computes it on the m16n8k16 fragments:
    A = V^T from the 16 tokens' rows (row g8 <-> dim 4(g8 >> 1) + 2(g8 & 1)
    of each 16-dim block, row g8 + 8 <-> that + 1; a lane's pairs gathered
    from one 32-bit word of each of tokens 2t, 2t + 1, 2t + 8, 2t + 9 by
    PRMT, widened to fp16), B = P^T (``pt``: 8 rows x 16 tokens) scaled by
    2^k so that max v_s lands in [2^14, 2^15) and split into three fp16
    parts; products summed in float64, then scaled back.  Returns out^T
    (D, 8)."""
    D = v16.shape[1]
    vmax = float(pt.max())
    k = int(np.clip(14 - (np.frexp(np.float32(vmax))[1] - 1), -126, 126))
    bq = sum(h.astype(np.float64) for h in _f16x3(pt.astype(np.float32) * np.float32(2.0 ** k)))
    words = v16.view(np.uint32)  # (16 tokens, D / 4)
    out = np.zeros((D, 8))
    for mb in range(D // 16):
        A = np.zeros((16, 16))
        B = np.zeros((16, 8))
        rows = np.zeros(16, int)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            dsel = 2 * (g & 1)
            sel = dsel | (4 + dsel) << 4 | (dsel + 1) << 8 | (5 + dsel) << 12
            w = words[:, 4 * mb + (g >> 1)]
            x = _i8x4_to_h2x2(_byte_perm(w[2 * t], w[2 * t + 1], sel)).astype(np.float64)
            y = _i8x4_to_h2x2(_byte_perm(w[2 * t + 8], w[2 * t + 9], sel)).astype(np.float64)
            A[g, 2 * t:2 * t + 2] = x[0:2]
            A[g + 8, 2 * t:2 * t + 2] = x[2:4]
            A[g, 2 * t + 8:2 * t + 10] = y[0:2]
            A[g + 8, 2 * t + 8:2 * t + 10] = y[2:4]
            rows[g] = 16 * mb + 4 * (g >> 1) + dsel
            rows[g + 8] = rows[g] + 1
            B[2 * t:2 * t + 2, g] = bq[g, 2 * t:2 * t + 2]
            B[2 * t + 8:2 * t + 10, g] = bq[g, 2 * t + 8:2 * t + 10]
        out[rows] += A @ B
    return out * 2.0 ** -k


@pytest.mark.parametrize("D", [16, 64, 128, 160, 256])
def test_tensor_core_pv_is_exact(D):
    """P·V's fragments, the fp16 widening of V and P's scaled fp16 parts give
    sum_j p_j v_s,j v_j to f32 precision (within 2^-24 of sum |p v_s v|)."""
    rng = np.random.default_rng(D)
    v16 = rng.integers(-128, 128, (16, D)).astype(np.int8)
    pt = (rng.uniform(0, 1, (8, 16)) * rng.uniform(0.005, 0.02, 16)).astype(np.float32)
    got = _warp_pv(v16, pt)
    exact = v16.astype(np.float64).T @ pt.astype(np.float64).T
    bound = 2.0 ** -24 * (np.abs(v16).astype(np.float64).T @ pt.astype(np.float64).T)
    assert (np.abs(got - exact) <= bound).all()


def _split_partials(q, kq, ks, vq, vs, n_splits, per, tile):
    """Each block's (m, l, acc) as the kernel computes it, in f32: tiles of
    ``tile`` tokens, a block-wide running max per query row, p·v_s before
    P·V, exp-sums and accumulators rescaled by e^(m_old - m_new)."""
    B, H, D = q.shape
    S, KH = kq.shape[1], kq.shape[2]
    G, f32 = H // KH, np.float32
    scale = f32(1.0 / np.sqrt(D))
    qg = q.reshape(B, KH, G, D).astype(f32)
    n_tiles = -(-S // tile)
    m = np.full((n_splits, B, KH, G), -1e30, f32)
    l = np.zeros((n_splits, B, KH, G), f32)
    acc = np.zeros((n_splits, B, KH, G, D), f32)
    for sp in range(n_splits):
        for t in range(sp * per, min((sp + 1) * per, n_tiles)):
            lo, hi = t * tile, min((t + 1) * tile, S)
            k = kq[:, lo:hi].astype(f32)  # (B, T, KH, D)
            s = np.einsum("bkgd,btkd->bkgt", qg, k) * ks[:, None, None, lo:hi] * scale
            m_new = np.maximum(m[sp], s.max(-1))
            p = np.exp(s - m_new[..., None]).astype(f32)
            corr = np.exp(m[sp] - m_new).astype(f32)
            m[sp] = m_new
            l[sp] = l[sp] * corr + p.sum(-1)
            pv = p * vs[:, None, None, lo:hi]
            acc[sp] = acc[sp] * corr[..., None] + np.einsum("bkgt,btkd->bkgd", pv,
                                                            vq[:, lo:hi].astype(f32))
    return m, l, acc


def _merge(m, l, acc):
    """The last block's merge: M = max m_i, L = sum l_i e^(m_i - M),
    out = sum acc_i e^(m_i - M) / max(L, 1e-30)."""
    M = m.max(0)
    w = np.exp(m - M).astype(np.float32)
    L = (l * w).sum(0)
    return (acc * w[..., None]).sum(0) / np.maximum(L, np.float32(1e-30))[..., None]


@pytest.mark.parametrize("n_splits", [1, 2, 8, 66])
def test_in_kernel_merge_matches_plain_version(n_splits):
    """Per-split partials, merged as the last block merges them, against
    ``decode_attention_ref`` within the f32 limit; S ends in a ragged tile."""
    per = 2
    tile = kv_kernel.TILE
    S = (n_splits - 1) * per * tile + tile + 17
    B, KH, G, D = 2, 2, 4, 32
    args = _inputs(B, S, KH, G, D, seed=n_splits)
    n_tiles = -(-S // tile)
    assert -(-n_tiles // per) == n_splits
    out = _merge(*_split_partials(*args, n_splits, per, tile)).reshape(B, KH * G, D)
    np.testing.assert_allclose(out, _port(args).numpy(), rtol=TOL, atol=TOL)


def test_in_kernel_merge_at_the_path_plan():
    """StableLM-12B's head geometry under the split plan of path 4's shape
    (6 splits of 6 tiles at S 2048), one sequence, against the plain version."""
    n_splits, per = split_plan(64, 2048, 132, 3)
    args = _inputs(1, 2048, 8, 4, 160, seed=3)
    out = _merge(*_split_partials(*args, n_splits, per, kv_kernel.TILE)).reshape(1, 32, 160)
    np.testing.assert_allclose(out, _port(args).numpy(), rtol=TOL, atol=TOL)
