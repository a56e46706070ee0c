"""The port's fused calib-gate op against the JAX reference kernel.

On the CPU the port runs the kernel's plain version (``calib_gate_ref``),
held here to the Pallas kernel in interpret mode and to the JAX plain
version on the same numpy inputs.  The CUDA kernel itself runs only on a
GPU: its tests, in ``test_torch_cuda.py``, are marked ``cuda`` and skip
elsewhere; here it is shown that the wrapper is never faked on the CPU.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_calib_gate.kernel import calib_gate as jax_calib_gate
from repro.kernels.fused_calib_gate.ref import calib_gate_ref as jax_calib_gate_ref
from repro_torch.kernels.fused_calib_gate import kernel as cg_kernel
from repro_torch.kernels.fused_calib_gate.ops import calibrated_gate
from repro_torch.kernels.fused_calib_gate.ref import calib_gate_ref

PLATT = [(-6.0, 2.0, 0.7), (-1.0, 0.0, 0.5), (-10.0, 5.0, 0.9)]


def _logits(B, V, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((B, V)) * scale).astype(np.float32)


# the reference's test_calib_gate_sweep shapes and tilings
@pytest.mark.parametrize("B,V,bb,bv", [
    (64, 1024, 64, 256),
    (128, 4096, 64, 1024),
    (256, 8192, 128, 2048),
])
def test_calib_gate_sweep(B, V, bb, bv):
    x = _logits(B, V, seed=B + V)
    for a, b, theta in PLATT:
        ck, gk = jax_calib_gate(jnp.asarray(x), a, b, theta, bb=bb, bv=bv, interpret=True)
        cr, gr = jax_calib_gate_ref(jnp.asarray(x), a, b, theta)
        ct, gt = calib_gate_ref(torch.as_tensor(x), a, b, theta)
        assert ct.dtype == torch.float32 and gt.dtype == torch.bool
        np.testing.assert_allclose(ct.numpy(), np.asarray(ck), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cr), rtol=1e-5, atol=1e-6)
        assert np.array_equal(gt.numpy(), np.asarray(gk))
        assert np.array_equal(gt.numpy(), np.asarray(gr))


def test_calib_gate_extreme_logits_stable():
    """The reference's extreme case (half the row at -1e4, the rest x50),
    plus rows the port must also keep finite: all -inf and all ±1e4."""
    x = np.concatenate([np.full((8, 512), -1e4, np.float32), _logits(8, 512, seed=0, scale=50.0)], 1)
    ck, _ = jax_calib_gate(jnp.asarray(x), -6.0, 2.0, 0.5, bb=8, bv=256, interpret=True)
    ct, _ = calib_gate_ref(torch.as_tensor(x), -6.0, 2.0, 0.5)
    assert torch.isfinite(ct).all()
    np.testing.assert_allclose(ct.numpy(), np.asarray(ck), rtol=1e-5, atol=1e-6)

    edge = np.stack([np.full(16, -np.inf, np.float32), np.full(16, 1e4, np.float32),
                     np.full(16, -1e4, np.float32)])
    ck, _ = jax_calib_gate(jnp.asarray(edge), -6.0, 2.0, 0.5, bb=3, bv=16, interpret=True)
    ct, _ = calib_gate_ref(torch.as_tensor(edge), -6.0, 2.0, 0.5)
    assert torch.isfinite(ct).all()
    np.testing.assert_allclose(ct.numpy(), np.asarray(ck), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,V", [(16, 10), (37, 1001), (1, 1)])
def test_calibrated_gate_cpu_takes_plain_version(B, V):
    """On a CPU tensor the dispatch runs the plain version and launches nothing."""
    x = torch.as_tensor(_logits(B, V, seed=7))
    before = cg_kernel.calib_gate.launches
    c, g = calibrated_gate(x, -6.0, 2.0, 0.4)
    cr, gr = calib_gate_ref(x, -6.0, 2.0, 0.4)
    assert torch.equal(c, cr) and torch.equal(g, gr)
    assert cg_kernel.calib_gate.launches == before


def test_cuda_wrapper_refuses_cpu_tensor():
    """The kernel wrapper is never faked by the plain version: a CPU tensor
    raises before anything is built or counted."""
    before = cg_kernel.calib_gate.launches
    with pytest.raises(ValueError, match="CUDA kernel"):
        cg_kernel.calib_gate(torch.zeros(4, 8), -6.0, 2.0, 0.5)
    assert cg_kernel.calib_gate.launches == before


def test_cuda_kernel_tests_skip_without_a_card():
    """The CUDA-marked tests run the kernel or skip; without a card they
    must skip (not pass on the plain version)."""
    path = os.path.join(os.path.dirname(__file__), "test_torch_cuda.py")
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-rs", "-p", "no:cacheprovider",
                          "-p", "no:randomly", path], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    if torch.cuda.is_available():
        assert " passed" in out.stdout and " skipped" not in out.stdout, out.stdout
    else:
        assert " skipped" in out.stdout and " passed" not in out.stdout, out.stdout
        assert "needs an NVIDIA GPU" in out.stdout


@pytest.mark.parametrize("V,threads", [(1, 32), (10, 32), (1000, 256), (1001, 256),
                                        (4096, 512), (152064, 512)])
def test_threads_per_row(V, threads):
    """Threads a block when 256 float32 rows fill an H100 unsplit: enough
    to cover a row in one chunk of the fewest vectors a thread, at most
    512."""
    plan = cg_kernel.split_plan(256, V, 4, 132)
    assert plan.splits == 1 and plan.threads == threads
