"""The port's attention against the JAX reference's flash-attention kernel.

On the CPU the port runs the kernel's plain version (``attention_ref``),
held here to the Pallas kernel in interpret mode and to the JAX plain
version on the same numpy inputs: within 2e-5 in float32 (the softmax
summed in another order; the reference sweep's own tolerance) and 3e-2
in bfloat16 (one bf16 rounding of the output).  The CUDA kernel itself
runs only on a GPU (``test_torch_cuda.py``); here it is shown that its
wrapper is never faked on the CPU.
"""
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
