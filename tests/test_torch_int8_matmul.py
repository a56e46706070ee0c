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
