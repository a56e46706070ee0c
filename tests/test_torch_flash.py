"""The port's attention against the JAX reference's flash-attention kernel.

On the CPU the port runs the kernel's plain version (``attention_ref``),
held here to the Pallas kernel in interpret mode and to the JAX plain
version on the same numpy inputs: within 2e-5 in float32 (the softmax
summed in another order; the reference sweep's own tolerance) and 3e-2
in bfloat16 (one bf16 rounding of the output).  The CUDA kernel itself
runs only on a GPU (``test_torch_cuda.py``); here it is shown that its
wrapper is never faked on the CPU.

The bf16 CUDA kernel runs on the tensor cores and rounds the
probabilities to bf16 before P·V, where the reference multiplies them in
f32.  ``_tensor_core_numerics`` writes that arithmetic out in torch (64-key
tiles, online softmax in f32, P rounded to bf16, f32 sums) and holds it to
the reference within the kernel's stated bf16 limit, (rtol, atol) =
(8e-3, 5e-3): rtol covers one bf16 step of the output (at most 2^-7 of
it) where the two f32 values straddle a rounding boundary; atol covers
the P rounding, at most 2^-8 of each term p·v of a row, of random sign.
The limit must also reject a stand-in fault, q cut to 5 of its 7 mantissa
bits.

The f32 CUDA kernel runs on the tensor cores in three TF32 products per
product (3xTF32).  ``_tf32x3_numerics`` writes that arithmetic out in
torch: each operand x split into big = x rounded to TF32 (10 mantissa
bits, to nearest with ties away from zero, as ``cvt.rna.tf32.f32``) and
small = x - big cut to TF32 (the tensor cores read a register's upper 19
bits), small·big' + big·small' summed before big·big', small·small'
dropped; key tiles of 32, the online softmax in base 2, P split like any
operand.  It holds that arithmetic to the reference within the f32 limit,
(rtol, atol) = (0, 2e-5), and shows that the limit rejects a 1xTF32
stand-in fault: q rounded to TF32, what a kernel that dropped q's small
part would compute.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import attention_ref

F32_TOL = 2e-5
BF16_TOL = 3e-2
TC_TOL = (8e-3, 5e-3)  # (rtol, atol) of the bf16 tensor-core kernel; see the docstring


def _qkv(B, Sq, Sk, H, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, H, D)).astype(np.float32))


def _port(q, k, v, causal, dtype=torch.float32):
    return attention_ref(*(torch.as_tensor(a).to(dtype) for a in (q, k, v)), causal=causal)


# the reference's test_flash_attention_sweep shapes and tilings
@pytest.mark.parametrize("B,S,H,D,bq,bk", [
    (1, 256, 2, 64, 128, 128),
    (2, 512, 4, 64, 128, 256),
    (2, 384, 2, 128, 128, 128),
    (1, 1024, 1, 64, 256, 512),
])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_pallas_sweep(B, S, H, D, bq, bk, causal):
    q, k, v = _qkv(B, S, S, H, D, seed=S + H)
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              bq=bq, bk=bk, interpret=True)
    out = _port(q, k, v, causal)
    assert out.shape == (B, S, H, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_TOL, atol=F32_TOL)


def test_attention_ref_matches_pallas_at_deit_shape():
    """DeiT-B's attention, 198 tokens: the Pallas wrapper takes it as one block."""
    q, k, v = _qkv(2, 198, 198, 12, 64, seed=198)
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                              bq=198, bk=198, interpret=True)
    np.testing.assert_allclose(_port(q, k, v, False).numpy(), np.asarray(ref), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("Sq,Sk,causal", [(100, 300, True), (300, 100, True), (1, 1, False),
                                          (1, 1, True), (1, 37, True)])
def test_attention_ref_matches_jax_ref_ragged(Sq, Sk, causal):
    """Sq != Sk, with the causal mask aligned top-left, and S = 1: shapes
    the Pallas wrapper does not tile, so against the JAX plain version."""
    q, k, v = _qkv(2, Sq, Sk, 3, 64, seed=Sq * Sk)
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(_port(q, k, v, causal).numpy(), np.asarray(ref), rtol=F32_TOL, atol=F32_TOL)


def test_attention_ref_bf16_matches_pallas():
    q, k, v = _qkv(2, 256, 256, 2, 64, seed=7)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    ref = jax_flash_attention(qb, kb, vb, causal=True, bq=128, bk=128, interpret=True)
    out = _port(q, k, v, True, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=BF16_TOL, atol=BF16_TOL)


def test_attention_ref_takes_strided_views():
    """q, k, v as views into one fused projection, as the ViT passes them."""
    rng = np.random.default_rng(3)
    qkv = torch.as_tensor(rng.standard_normal((2, 50, 3, 4, 64)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    ref = attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), causal=False)
    assert torch.equal(attention_ref(q, k, v, causal=False), ref)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_cpu_takes_plain_version(causal):
    """On a CPU tensor the dispatch runs the plain version and launches nothing."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(2, 40, 40, 2, 64, seed=11))
    before = fa_kernel.flash_attention.launches
    assert torch.equal(attention(q, k, v, causal=causal), attention_ref(q, k, v, causal=causal))
    assert fa_kernel.flash_attention.launches == before


def test_cuda_wrapper_refuses_cpu_tensor():
    """The kernel wrapper is never faked by the plain version: a CPU tensor
    raises before anything is built or counted."""
    q = torch.zeros(1, 8, 2, 64)
    before = fa_kernel.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa_kernel.flash_attention(q, q, q, causal=False)
    assert fa_kernel.flash_attention.launches == before


def _tensor_core_numerics(q, k, v, causal, bk=64):
    """The bf16 kernel's arithmetic in torch: 64-key tiles, scores and the
    online softmax in f32 (base 2), l summed over the f32 probabilities, P
    rounded to bf16 before P·V, the output acc / max(l, 1e-30) in q's dtype."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qf, kf, vf = (t.to(torch.float32).transpose(1, 2) for t in (q, k, v))
    scale_log2 = math.log2(math.e) / math.sqrt(D)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros(B, H, Sq, 1)
    acc = torch.zeros(B, H, Sq, D)
    for k0 in range(0, Sk, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = (qf @ kt.transpose(-1, -2)) * scale_log2
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + kt.shape[2])[None, :] > torch.arange(Sq)[:, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).to(torch.float32) @ vt
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


def _within(got, want, tol):
    rtol, atol = tol
    return bool(((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all())


# chip_smoke.py's bf16 cases cut to a small size: the f(batch) sweep's
# attention(q, q, q) at b = 1 and 2 (of 32), DeiT-B's shape at one frame,
# head dims 16 and 128, ragged Sq != Sk both ways and S = 1
@pytest.mark.parametrize("B,Sq,Sk,H,D,causal,same", [
    (1, 256, 256, 4, 64, True, True),
    (2, 256, 256, 4, 64, True, True),
    (2, 256, 256, 2, 64, True, False),
    (1, 198, 198, 12, 64, False, False),
    (1, 16, 16, 1, 16, False, False),
    (2, 70, 70, 3, 16, True, False),
    (1, 384, 384, 2, 128, True, False),
    (1, 100, 300, 2, 64, True, False),
    (1, 300, 100, 2, 128, True, False),
    (2, 1, 1, 3, 128, True, False),
])
def test_tensor_core_numerics_within_bf16_limit(B, Sq, Sk, H, D, causal, same):
    q, k, v = _qkv(B, Sq, Sk, H, D, seed=Sq * 3 + Sk + D)
    if same:
        k = v = q
    qb, kb, vb = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = _tensor_core_numerics(qb, kb, vb, causal)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Sq, H, D)
    assert _within(got, attention_ref(qb, kb, vb, causal=causal), TC_TOL)
    bq, bk = (128 if Sq % 128 == 0 else Sq), (128 if Sk % 128 == 0 else Sk)
    pallas = jax_flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), causal=causal,
                                 bq=bq, bk=bk, interpret=True)
    assert _within(got, torch.as_tensor(np.asarray(pallas, np.float32)), TC_TOL)
    if Sk > 1:  # with one key the output is v, whatever q is
        cut = (qb.view(torch.int16) & ~3).view(torch.bfloat16)
        assert not _within(_tensor_core_numerics(cut, kb, vb, causal),
                           attention_ref(qb, kb, vb, causal=causal), TC_TOL)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, on the f32 bits: the value ``cvt.rna.tf32.f32`` leaves in a
    register's upper 19 bits."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, ((x - big).view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b in three TF32 products, the cross terms first."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def _tf32x3_numerics(q, k, v, causal):
    """The f32 kernel's arithmetic in torch: key tiles of 32, scores as
    3xTF32 products of q and k, the online softmax in f32 base 2
    with l summed over the f32 probabilities, P·V as 3xTF32 products, the
    output acc / max(l, 1e-30)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    bk = 32
    qf, kf, vf = (t.transpose(1, 2) for t in (q, k, v))
    scale_log2 = math.log2(math.e) / math.sqrt(D)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros(B, H, Sq, 1)
    acc = torch.zeros(B, H, Sq, D)
    for k0 in range(0, Sk, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = _mm_3xtf32(qf, kt.transpose(-1, -2))
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + kt.shape[2])[None, :] > torch.arange(Sq)[:, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, p = torch.exp2((m - m_new) * scale_log2), torch.exp2(s * scale_log2 - m_new * scale_log2)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _mm_3xtf32(p, vt)
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2)


def test_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + one_ulp / 2, 1 + one_ulp / 2 - 2 ** -23, -(1 + one_ulp / 2), 1 + 3 * one_ulp / 2, 3.0])
    assert _tf32(x).tolist() == [1 + one_ulp, 1.0, -(1 + one_ulp), 1 + 2 * one_ulp, 3.0]
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    big, small = _split(x)
    assert torch.equal(_tf32(big), big) and torch.equal(_tf32(small), small)
    assert bool(((big + small - x).abs() <= x.abs() * 2.0 ** -21).all())


# tests/test_torch_cuda.py's f32 cases cut to size: DeiT-B's shape at one
# frame, the reference sweep's shapes causal and not, head dims 16 and 128
# (a last key tile of 6), ragged Sq != Sk both ways and S = 1
@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", [
    (1, 198, 198, 12, 64, False),
    (1, 256, 256, 2, 64, True), (1, 256, 256, 2, 64, False),
    (1, 512, 512, 2, 64, True), (1, 512, 512, 2, 64, False),
    (1, 384, 384, 2, 128, True), (1, 384, 384, 2, 128, False),
    (1, 1024, 1024, 1, 64, True), (1, 1024, 1024, 1, 64, False),
    (5, 18, 18, 4, 16, False), (2, 70, 70, 3, 16, True), (1, 198, 198, 3, 16, False),
    (1, 198, 198, 3, 128, False),
    (1, 100, 300, 2, 64, True), (1, 300, 100, 2, 128, True), (1, 100, 300, 2, 128, True),
    (1, 1, 1, 1, 64, False), (2, 1, 1, 3, 128, True),
])
def test_tf32x3_numerics_within_f32_limit(B, Sq, Sk, H, D, causal):
    q, k, v = (torch.as_tensor(a) for a in _qkv(B, Sq, Sk, H, D, seed=Sq * 7 + Sk + D))
    got = _tf32x3_numerics(q, k, v, causal)
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, D)
    want = attention_ref(q, k, v, causal=causal)
    assert _within(got, want, (0.0, F32_TOL))
    bq, bk = (128 if Sq % 128 == 0 else Sq), (128 if Sk % 128 == 0 else Sk)
    pallas = jax_flash_attention(*(jnp.asarray(a.numpy()) for a in (q, k, v)), causal=causal,
                                 bq=bq, bk=bk, interpret=True)
    assert _within(got, torch.as_tensor(np.asarray(pallas)), (0.0, F32_TOL))
    if Sk > 1:  # with one key the output is v, whatever q is
        assert not _within(_tf32x3_numerics(_tf32(q), k, v, causal), want, (0.0, F32_TOL))
