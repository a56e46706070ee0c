"""The int8 matmul's plain version and dispatch against the JAX reference.

The same numpy inputs go through ``repro.kernels.int8_matmul`` (its Pallas
kernel in interpret mode, its jnp oracle and its ops) and through the
port's ``repro_torch.kernels.int8_matmul``.  Everything here is exact:
quantization rounds half to even in float32 on both sides, the int32 sums
are exact, and the epilogue is the same two float32 multiplies, so float32
outputs are compared bit for bit and bfloat16 outputs after the same one
rounding.  The CUDA kernel itself is held to this plain version on the
card (``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st
from repro.kernels.int8_matmul import ops as jops
from repro.kernels.int8_matmul import ref as jref
from repro.kernels.int8_matmul.kernel import int8_matmul as jax_int8_matmul
from repro.quant.quantize import quantize_tensor as jax_quantize_tensor
from repro_torch.kernels.int8_matmul import kernel as tkernel
from repro_torch.kernels.int8_matmul import ops as tops
from repro_torch.kernels.int8_matmul import ref as tref
from repro_torch.quant.quantize import quantize_tensor

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _f32(a) -> np.ndarray:
    """JAX array or torch tensor -> float32 numpy (bf16 widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, dtype=np.float32)


def _quantized_pair(M, K, N, seed):
    x, w = _normal((M, K), seed), _normal((K, N), seed + 1, scale=0.5)
    jx = jref.quantize_rows(jnp.asarray(x)) + jref.quantize_cols(jnp.asarray(w))
    tx = tref.quantize_rows(torch.as_tensor(x)) + tref.quantize_cols(torch.as_tensor(w))
    return jx, tx


@pytest.mark.parametrize("shape", [(16, 300), (37, 100), (1, 7), (5, 1)])
def test_quantize_rows_and_cols_bit_equal(shape):
    x = _normal(shape, seed=sum(shape), scale=3.0)
    x[0, 0] = 0.0
    for jfn, tfn in ((jref.quantize_rows, tref.quantize_rows),
                     (jref.quantize_cols, tref.quantize_cols)):
        jq, js = jfn(jnp.asarray(x))
        tq, ts = tfn(torch.as_tensor(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert tq.shape == jq.shape and ts.shape == js.shape
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_rounds_half_to_even_and_guards_zero_rows():
    # amax 127 -> scale 1: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2; a zero row keeps scale 1e-8/127
    x = np.array([[127.0, 0.5, 1.5, -2.5], [0.0, 0.0, 0.0, 0.0]], dtype=np.float32)
    tq, ts = tref.quantize_rows(torch.as_tensor(x))
    jq, js = jref.quantize_rows(jnp.asarray(x))
    assert tq[0].tolist() == [127, 0, 2, -2] and tq[1].tolist() == [0, 0, 0, 0]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# tests/test_kernels.py::test_int8_matmul_sweep's shapes and blocks
@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (128, 256, 128, 128, 128, 128),
    (256, 512, 384, 128, 128, 256),
    (512, 1024, 256, 256, 256, 512),
    (128, 128, 128, 64, 64, 64),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_matmul_ref_bit_equal_to_pallas_and_jnp(M, K, N, bm, bn, bk, dtype):
    jdt, tdt = DTYPES[dtype]
    (jxq, jxs, jwq, jws), (txq, txs, twq, tws) = _quantized_pair(M, K, N, seed=M + K + N)
    got = tref.int8_matmul_ref(txq, txs, twq, tws, tdt)
    assert got.dtype == tdt and got.shape == (M, N)
    pallas = jax_int8_matmul(jxq, jxs, jwq, jws, bm=bm, bn=bn, bk=bk, out_dtype=jdt, interpret=True)
    np.testing.assert_array_equal(_f32(got), _f32(pallas))
    np.testing.assert_array_equal(_f32(got), _f32(jref.int8_matmul_ref(jxq, jxs, jwq, jws, jdt)))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_matmul_ref_ragged_bit_equal(dtype):
    """(37, 100, 77): no tiling divides it; the port's kernel masks it, the
    Pallas kernel would assert, so hold the plain version to the jnp oracle."""
    jdt, tdt = DTYPES[dtype]
    (jxq, jxs, jwq, jws), (txq, txs, twq, tws) = _quantized_pair(37, 100, 77, seed=5)
    got = tref.int8_matmul_ref(txq, txs, twq, tws, tdt)
    np.testing.assert_array_equal(_f32(got), _f32(jref.int8_matmul_ref(jxq, jxs, jwq, jws, jdt)))
    acc = tref.int8_acc_ref(txq, twq)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jxq, np.int64) @ np.asarray(jwq, np.int64))


def test_int8_acc_ref_exact_at_the_extremes():
    # every product at ±127², K = 4096: 66,064,384 is past float32's 2^24
    # but exact in the float64 route
    xq = torch.full((3, 4096), 127, dtype=torch.int8)
    wq = torch.full((4096, 2), -127, dtype=torch.int8)
    assert tref.int8_acc_ref(xq, wq).unique().tolist() == [-127 * 127 * 4096]


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 4), st.integers(1, 4), st.integers(1, 4))
def test_int8_matmul_property(mi, ki, ni):
    """Mirrors tests/test_kernels.py::test_int8_matmul_property, bit for bit."""
    M, K, N = 64 * mi, 64 * ki, 64 * ni
    (jxq, jxs, jwq, jws), (txq, txs, twq, tws) = _quantized_pair(M, K, N, seed=M * K + N)
    pallas = jax_int8_matmul(jxq, jxs, jwq, jws, bm=64, bn=64, bk=64, interpret=True)
    np.testing.assert_array_equal(tref.int8_matmul_ref(txq, txs, twq, tws).numpy(), np.asarray(pallas))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantized_matmul_matches_reference_ops(dtype):
    jdt, tdt = DTYPES[dtype]
    x, w = _normal((48, 96), 11), _normal((96, 40), 12)
    want = jops.quantized_matmul(jnp.asarray(x), jnp.asarray(w), out_dtype=jdt, use_kernel="ref")
    for use_kernel in ("ref", "auto"):  # on the CPU "auto" takes the plain version too
        got = tops.quantized_matmul(torch.as_tensor(x), torch.as_tensor(w), out_dtype=tdt,
                                    use_kernel=use_kernel)
        np.testing.assert_array_equal(_f32(got), _f32(want))
    np.testing.assert_array_equal(
        _f32(tref.matmul_ref(torch.as_tensor(x), torch.as_tensor(w), tdt)), _f32(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantized_dense_apply_matches_reference_ops(dtype):
    """A (K, N) weight quantized per output column (``axis=0`` on both
    sides) applied to (2, 5, K) activations."""
    jdt, tdt = DTYPES[dtype]
    x, w = _normal((2, 5, 64), 21), _normal((64, 24), 22, scale=0.1)
    jq = jax_quantize_tensor(jnp.asarray(w), axis=0)
    tq = quantize_tensor(torch.as_tensor(w), axis=0)
    assert tuple(tq.scale.shape) == (1, 24)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    want = jops.quantized_dense_apply(jq, jnp.asarray(x), out_dtype=jdt, use_kernel="ref")
    got = tops.quantized_dense_apply(tq, torch.as_tensor(x), out_dtype=tdt, use_kernel="ref")
    assert tuple(got.shape) == (2, 5, 24)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    # a flat (N,) scale is the same weight
    flat = type(tq)(tq.values, tq.scale.reshape(-1))
    np.testing.assert_array_equal(
        _f32(tops.quantized_dense_apply(flat, torch.as_tensor(x), out_dtype=tdt)), _f32(want))


def test_quantized_dense_apply_rejects_a_per_input_row_scale():
    """``quantize_tensor(w, axis=-1)`` of a (K, N) weight scales each input
    row, (K, 1); the reference reshapes that into a (1, K) per-column scale
    (wrong, or a broadcast error when K != N).  The port raises."""
    w = torch.as_tensor(_normal((64, 32), 3))
    per_row = quantize_tensor(w, axis=1)
    assert tuple(per_row.scale.shape) == (64, 1)
    with pytest.raises(ValueError, match="per-output-column"):
        tops.quantized_dense_apply(per_row, torch.as_tensor(_normal((4, 64), 4)))


def test_dispatch_rejects_what_it_cannot_take():
    xq, xs, wq, ws = tref.quantize_rows(torch.ones(4, 8)) + tref.quantize_cols(torch.ones(8, 3))
    with pytest.raises(ValueError, match="use_kernel"):
        tops.quantized_matmul(torch.ones(4, 8), torch.ones(8, 3), use_kernel="pallas")
    before = tkernel.int8_matmul.launches
    with pytest.raises(ValueError, match="CUDA kernel"):  # the wrapper never takes a CPU tensor
        tkernel.int8_matmul(xq, xs, wq, ws)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tkernel.int8_matmul_acc(xq, wq)
    assert tkernel.int8_matmul.launches == before


# ---- the CUDA kernel's data movement, emulated in numpy -------------------- #
# The constants (K tile, PRMT selectors, block tiles) are read from the
# kernel's source, so the emulation follows it; the swizzles, ldmatrix,
# the mma.m16n8k32 fragment layouts (PTX ISA) and the epilogue's column map
# are written out here as the kernel's comments state them.

CU = (Path(tkernel.__file__).parent / "csrc" / "int8_matmul.cu").read_text()


def _cu_const(name: str) -> int:
    return int(re.search(rf"\b{name} = (0x[0-9a-fA-F]+|\d+)u?;", CU).group(1), 0)


CU_BK = _cu_const("BK")
PRMT = {n: _cu_const(n) for n in ("PRMT_PAIR_LO", "PRMT_PAIR_HI", "PRMT_HALF_LO", "PRMT_HALF_HI")}
# (MI, WM, WN, KW) of each block tile, by its name in kernel.CONFIGS
CU_TILES = {name: tuple(int(v) for v in vals) for name, *vals in
            re.findall(r"using Tile(\d+x\d+) = Tile<(\d+), (\d+), (\d+), (\d+)>;", CU)}
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3


def _a_off(r, c):
    """Byte offset of 16-byte chunk c of row r in a staged A tile."""
    chunks = CU_BK // 16
    return r * CU_BK + ((c ^ ((r // (8 // chunks)) % chunks)) << 4)


def _b_off(r, n, bn):
    """Byte offset of byte n of K row r in a staged B tile BN bytes wide."""
    return (r * bn + n) ^ (((r >> 2) & 3) << 5)


def _byte_perm(x, y, s):
    """CUDA's ``__byte_perm(x, y, s)`` on uint32 arrays: byte i of the
    result is byte ``(s >> 4i) & 7`` of the 8 bytes y:x."""
    pool = np.asarray(x, np.uint64) | (np.asarray(y, np.uint64) << np.uint64(32))
    out = np.zeros_like(pool)
    for i in range(4):
        sel = np.uint64((s >> (4 * i)) & 7)
        out |= ((pool >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _words(smem, addr):
    """32-bit little-endian words of shared memory at byte addresses."""
    b = smem[np.asarray(addr)[..., None] + np.arange(4)].astype(np.uint32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _ldmatrix_x4(smem, row_addr):
    """ldmatrix.m8n8.x4.b16: lane 8i + r gives the address of row r of
    matrix i (16 bytes); register i of lane L holds bytes 4(L%4) .. +3 of
    row L/4 of matrix i.  Returns (32 lanes, 4) uint32."""
    regs = np.empty((32, 4), np.uint32)
    for i in range(4):
        regs[:, i] = _words(smem, row_addr[8 * i + G] + 4 * T)
    return regs


def _b_frags(smem, k0, wn, bn):
    """The kernel's b_frags: four 32-bit loads of rows k0 + 4t + j at
    columns wn + 4g, then the 4 x 4 byte transpose by its selectors."""
    w = [_words(smem, _b_off(k0 + 4 * T + j, wn + 4 * G, bn)) for j in range(4)]
    lo01, hi01 = _byte_perm(w[0], w[1], PRMT["PRMT_PAIR_LO"]), _byte_perm(w[0], w[1], PRMT["PRMT_PAIR_HI"])
    lo23, hi23 = _byte_perm(w[2], w[3], PRMT["PRMT_PAIR_LO"]), _byte_perm(w[2], w[3], PRMT["PRMT_PAIR_HI"])
    return [_byte_perm(lo01, lo23, PRMT["PRMT_HALF_LO"]), _byte_perm(lo01, lo23, PRMT["PRMT_HALF_HI"]),
            _byte_perm(hi01, hi23, PRMT["PRMT_HALF_LO"]), _byte_perm(hi01, hi23, PRMT["PRMT_HALF_HI"])]


def _s8(words):
    """(32,) or (32, n) uint32 -> the int8 bytes, (32, [n,] 4), byte 0 first."""
    return np.asarray(words, np.uint32).view(np.int8).reshape(*np.shape(words), 4).astype(np.int64)


def _mma_m16n8k32(a_regs, b0, b1):
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 on per-lane fragments (PTX
    ISA layouts): a_i holds row g + 8 (i % 2), columns 4t + 16 (i / 2) + j;
    b0 / b1 hold rows 4t + j / 16 + 4t + j of column g; c_r is row
    g + 8 (r / 2), column 2t + r % 2.  Returns (32, 4) int64."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    a, bb0, bb1 = _s8(a_regs), _s8(b0), _s8(b1)
    for i in range(4):
        for j in range(4):
            A[G + 8 * (i % 2), 4 * T + 16 * (i // 2) + j] = a[:, i, j]
    for j in range(4):
        B[4 * T + j, G] = bb0[:, j]
        B[16 + 4 * T + j, G] = bb1[:, j]
    C = A @ B
    return np.stack([C[G + 8 * (r // 2), 2 * T + r % 2] for r in range(4)], axis=1)


def _emulate_kernel(xq, wq, tile):
    """The kernel's int32 product for block tile (MI, WM, WN, KW):
    K tiles of BK bytes staged with zero-fill through the swizzles, every
    warp's k32 steps on emulated fragments, the accumulators placed by the
    epilogue's map (physical column wn + 8t + c <- tile c % 4, register
    2 * half + c / 4).  The K warps' sums are exact int32 additions in any
    order, so they are summed here without them."""
    MI, WM, WN = tile[:3]
    BM, BN = 16 * MI * WM, 32 * WN
    M, K = xq.shape
    N = wq.shape[1]
    Mp, Np, Kp = -(-M // BM) * BM, -(-N // BN) * BN, max(CU_BK, -(-K // CU_BK) * CU_BK)
    x = np.zeros((Mp, Kp), np.int8)
    w = np.zeros((Kp, Np), np.int8)
    x[:M, :K], w[:K, :N] = xq, wq
    out = np.zeros((M, N), np.int64)
    ra, ca = np.meshgrid(np.arange(BM), np.arange(CU_BK // 16), indexing="ij")
    rb, cb = np.meshgrid(np.arange(CU_BK), np.arange(BN // 16), indexing="ij")
    for m0 in range(0, Mp, BM):
        for n0 in range(0, Np, BN):
            acc = np.zeros((WM * WN, MI, 4, 32, 4), np.int64)
            for k0 in range(0, Kp, CU_BK):
                sa = np.zeros(BM * CU_BK, np.uint8)
                sb = np.zeros(CU_BK * BN, np.uint8)
                sa[_a_off(ra, ca)[..., None] + np.arange(16)] = (
                    x[m0:m0 + BM, k0:k0 + CU_BK].view(np.uint8).reshape(BM, -1, 16))
                sb[_b_off(rb, 16 * cb, BN)[..., None] + np.arange(16)] = (
                    w[k0:k0 + CU_BK, n0:n0 + BN].view(np.uint8).reshape(CU_BK, -1, 16))
                for warp in range(WM * WN):
                    wm, wn = (warp // WN) * 16 * MI, (warp % WN) * 32
                    for s in range(CU_BK // 32):
                        b = [_b_frags(sb, 32 * s, wn, BN), _b_frags(sb, 32 * s + 16, wn, BN)]
                        for mi in range(MI):
                            a = _ldmatrix_x4(sa, _a_off(wm + 16 * mi + (LANE & 15), 2 * s + (LANE >> 4)))
                            for ni in range(4):
                                acc[warp, mi, ni] += _mma_m16n8k32(a, b[0][ni], b[1][ni])
            for warp in range(WM * WN):
                wm, wn = (warp // WN) * 16 * MI, (warp % WN) * 32
                for mi in range(MI):
                    for half in range(2):
                        rows = m0 + wm + 16 * mi + G + 8 * half
                        for c in range(8):
                            cols = n0 + wn + 8 * T + c
                            ok = (rows < M) & (cols < N)
                            out[rows[ok], cols[ok]] = acc[warp, mi, c % 4, LANE[ok], 2 * half + c // 4]
    return out


def test_kernel_constants_read_from_the_source():
    assert (CU_BK, _cu_const("STAGES")) == (tkernel.BK, tkernel.STAGES)
    assert set(CU_TILES) == {cfg.name for cfg in tkernel.CONFIGS}
    for cfg in tkernel.CONFIGS:
        MI, WM, WN, KW = CU_TILES[cfg.name]
        assert (16 * MI * WM, 32 * WN, 32 * WM * WN * KW) == (cfg.bm, cfg.bn, cfg.threads)


@pytest.mark.parametrize("bn", [32, 64, 128])
def test_staging_swizzles_are_bijective_aligned_and_conflict_free(bn):
    """Every 16-byte chunk of a staged tile has its own aligned slot; every
    ldmatrix phase (8 rows of one 8 x 16-byte matrix) reaches 8 different
    16-byte bank groups; every warp-wide 32-bit B load reaches 32 banks."""
    chunks = CU_BK // 16
    r, c = np.meshgrid(np.arange(128), np.arange(chunks), indexing="ij")
    a = _a_off(r, c).ravel()
    assert len(set(a.tolist())) == a.size and (a % 16 == 0).all() and a.max() < 128 * CU_BK
    r, n = np.meshgrid(np.arange(CU_BK), np.arange(0, bn, 16), indexing="ij")
    b = _b_off(r, n, bn).ravel()
    assert len(set(b.tolist())) == b.size and (b % 16 == 0).all() and b.max() < CU_BK * bn
    for s in range(CU_BK // 32):
        for m16 in range(0, 128, 16):
            rows = _a_off(m16 + (LANE & 15), 2 * s + (LANE >> 4))
            for phase in range(4):
                assert len(set(((rows[8 * phase:8 * phase + 8] // 16) % 8).tolist())) == 8
        for wn in range(0, bn, 32):
            for k0 in (32 * s, 32 * s + 16):
                for j in range(4):
                    banks = (_b_off(k0 + 4 * T + j, wn + 4 * G, bn) // 4) % 32
                    assert len(set(banks.tolist())) == 32


def test_byte_transpose_gives_the_relabelled_b_fragments():
    """Lane (g, t)'s b[ni] holds B[k0 + 4t + j][wn + 4g + ni], j = 0..3:
    m16n8k32's B fragment for logical column g of tile ni, physical column
    4g + ni."""
    rng = np.random.default_rng(0)
    for bn in (32, 64, 128):
        tile = rng.integers(-128, 128, (CU_BK, bn)).astype(np.int8)
        smem = np.zeros(CU_BK * bn, np.uint8)
        r, n = np.meshgrid(np.arange(CU_BK), np.arange(0, bn, 16), indexing="ij")
        smem[_b_off(r, n, bn)[..., None] + np.arange(16)] = tile.view(np.uint8).reshape(CU_BK, -1, 16)
        for wn in range(0, bn, 32):
            for k0 in range(0, CU_BK, 16):
                frags = _b_frags(smem, k0, wn, bn)
                for ni in range(4):
                    want = np.stack([tile[k0 + 4 * T + j, wn + 4 * G + ni] for j in range(4)], axis=1)
                    np.testing.assert_array_equal(_s8(frags[ni]), want)


@pytest.mark.parametrize("tile", ["16x32", "32x64", "128x128"])
@pytest.mark.parametrize("M,K,N,seed", [(16, 64, 32, 1), (37, 100, 77, 2), (130, 200, 144, 3), (5, 0, 7, 4)])
def test_kernel_emulation_matches_int8_acc_ref(tile, M, K, N, seed):
    """The emulated kernel, random and ragged tiles (extreme values
    included), against the plain version bit for bit, and its float32
    epilogue ((float(acc) · x_scale) · w_scale, rounded once a product)."""
    rng = np.random.default_rng(seed)
    xq = rng.integers(-128, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-128, 128, (K, N)).astype(np.int8)
    xq[:, :3] = -128
    got = _emulate_kernel(xq, wq, CU_TILES[tile])
    want = tref.int8_acc_ref(torch.as_tensor(xq), torch.as_tensor(wq))
    np.testing.assert_array_equal(got, want.numpy())
    xs = rng.uniform(1e-3, 1e-1, (M, 1)).astype(np.float32)
    ws = rng.uniform(1e-3, 1e-1, (1, N)).astype(np.float32)
    y = (got.astype(np.float32) * xs) * ws
    np.testing.assert_array_equal(y, tref.int8_matmul_ref(torch.as_tensor(xq), torch.as_tensor(xs),
                                                          torch.as_tensor(wq), torch.as_tensor(ws)).numpy())


def test_fragment_map_fault_is_caught():
    """A stand-in fault (the two half selectors swapped, so columns 4g and
    4g + 1, and 4g + 2 and 4g + 3, trade places) gives a plausible but
    permuted product, which the comparison rejects."""
    rng = np.random.default_rng(5)
    xq = rng.integers(-128, 128, (16, 64)).astype(np.int8)
    wq = rng.integers(-128, 128, (64, 32)).astype(np.int8)
    saved = dict(PRMT)
    try:
        PRMT["PRMT_HALF_LO"], PRMT["PRMT_HALF_HI"] = saved["PRMT_HALF_HI"], saved["PRMT_HALF_LO"]
        got = _emulate_kernel(xq, wq, CU_TILES["16x32"])
    finally:
        PRMT.update(saved)
    want = tref.int8_acc_ref(torch.as_tensor(xq), torch.as_tensor(wq)).numpy()
    assert not np.array_equal(got, want)
    # plausible: each 4-column group holds the right columns, pairwise swapped
    np.testing.assert_array_equal(got[:, [1, 0, 3, 2]], want[:, :4])


# ---- the launch plan -------------------------------------------------------- #

PLAN_SHAPES = ([(32 * b, 512, 512) for b in (1, 2, 4, 8, 16, 32)]
               + [(1, 512, 512), (16, 512, 512), (37, 100, 77), (64, 4100, 72), (33, 16384, 40),
                  (1024, 4096, 4096), (3168, 768, 2304), (3168, 768, 3072), (3168, 3072, 768),
                  (1, 1, 1), (4, 131072, 8), (5, 0, 7)])


@pytest.mark.parametrize("M,K,N", PLAN_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_tile_plan_covers_the_product_exactly_once(M, K, N, aligned):
    """Every output element lies in exactly one output tile, one block
    each; the byte-load tile is taken for operands that are not 16-byte
    aligned."""
    n_sms = 132
    plan = tkernel.tile_plan(M, N, K, n_sms, aligned)
    cfg = tkernel.CONFIGS[plan.config]
    assert (plan.bm, plan.bn) == (cfg.bm, cfg.bn)
    assert aligned or plan.config == tkernel.NARROW
    tiles_n = -(-N // plan.bn)
    assert plan.n_tiles == -(-M // plan.bm) * tiles_n
    count = np.zeros((M, N), np.int64)
    for tile in range(plan.n_tiles):
        m0, n0 = (tile // tiles_n) * plan.bm, (tile % tiles_n) * plan.bn
        count[m0:m0 + plan.bm, n0:n0 + plan.bn] += 1
    assert (count == 1).all()


# the sweep's tile by M, the fastest one measured on an H100 (PERF.md §6)
# but at M = 256, where 32 x 64 was 0.03 us faster
SWEEP_TILES = {1: "16x32", 32: "16x32", 64: "16x32", 128: "16x32", 256: "16x32", 512: "32x64", 1024: "32x64"}


@pytest.mark.parametrize("M,K,N", [(32 * b, 512, 512) for b in (1, 2, 4, 8, 16, 32)] + [(1, 512, 512)])
def test_tile_plan_picks_the_sweeps_measured_tile(M, K, N):
    plan = tkernel.tile_plan(M, N, K, 132)
    assert tkernel.CONFIGS[plan.config].name == SWEEP_TILES[M]


@pytest.mark.parametrize("M,K,N", [(64, 4100, 72), (33, 16384, 40), (4, 131072, 8), (32, 4096, 128)])
@pytest.mark.parametrize("n_sms", [132, 114])
def test_tile_plan_takes_the_smallest_tile_within_its_blocks_a_sm(M, K, N, n_sms):
    """16 x 32, else 32 x 64, whichever has at most SMALL_TILE_BLOCKS_A_SM
    blocks a SM, else 128 x 128; a long K does not change the choice."""
    plan = tkernel.tile_plan(M, N, K, n_sms)
    limit = tkernel.SMALL_TILE_BLOCKS_A_SM * n_sms
    tiles = [-(-M // c.bm) * -(-N // c.bn) for c in tkernel.CONFIGS]
    want = next((c for c in (tkernel.NARROW, 1) if tiles[c] <= limit), 0)
    assert plan.config == want and plan.n_tiles == tiles[want]
    assert plan == tkernel.tile_plan(M, N, 512, n_sms)


def test_tile_plan_takes_the_large_tile_at_large_shapes():
    for M, K, N in [(1024, 4096, 4096), (3168, 768, 2304), (3168, 768, 3072), (3168, 3072, 768)]:
        plan = tkernel.tile_plan(M, N, K, 132)
        assert (plan.bm, plan.bn) == (128, 128)
