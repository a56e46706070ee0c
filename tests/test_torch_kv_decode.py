"""The port's int8-KV decode attention against the JAX reference's kernel.

On the CPU the port runs the kernel's plain version
(``decode_attention_ref``), held here to the Pallas kernel in interpret
mode and to the JAX plain version on the same numpy inputs, within 2e-5
(rtol and atol; the softmax summed in another order, the reference
sweep's own tolerance).  The CUDA kernel itself runs only on a GPU
(``test_torch_cuda.py``); here it is shown that its wrapper is never
faked on the CPU.
"""
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


@pytest.mark.parametrize("bkh,S,sms", [(64, 2048, 132), (1, 512, 132), (16, 1, 132),
                                       (80, 1024, 132), (16, 2047, 132), (4, 100000, 132)])
def test_split_plan_covers_every_tile_once(bkh, S, sms):
    """Every 128-token tile lies in exactly one split and no split is
    empty; where S allows, the grid holds at least half of the four blocks
    per SM it aims at (the splits take equal whole numbers of tiles)."""
    n, per = split_plan(bkh, S, sms)
    tiles = -(-S // kv_kernel.TILE)
    assert n * per >= tiles and (n - 1) * per < tiles
    assert 2 * bkh * n >= min(4 * sms, bkh * tiles)
