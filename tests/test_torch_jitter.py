"""Counter-mode jitter: ``core.threefry`` against ``jax.random`` on the CPU.

The threefry words, ``PRNGKey``/``fold_in`` keys and 32-bit draws are
integer arithmetic and must be equal.  The normal is checked on every one
of the 2^23 uniforms a draw can give (only the top 23 bits of a draw
count): the port's float32 expansion (XLA's ``log1p`` and ``erf_inv``,
each polynomial step one exact fused multiply-add, the square root
correctly rounded) equals XLA's compiled ``jax.random.normal`` bit for
bit.  The jitter factors are then held to the reference's
``_counter_jitter_factors`` over seeds 0-63 x seconds 0-4095, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.netsim as jnet
import repro_torch.core.netsim as tnet
from repro_torch.core import threefry as tf


def _bits_equal(a, b) -> bool:
    return np.array_equal(np.asarray(a, np.float32).view(np.int32), np.asarray(b, np.float32).view(np.int32))


@jax.jit
def _jax_normal_of_bits(bits):
    """``jax.random.normal``'s float path from 32 random bits (``_uniform``
    then ``sqrt(2) * erf_inv``), as the library composes it."""
    f = jax.lax.bitcast_convert_type((bits >> 9) | np.uint32(0x3F800000), jnp.float32) - 1.0
    lo = jnp.float32(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = jnp.maximum(lo, f * (jnp.float32(1.0) - lo) + lo)
    return jnp.float32(np.sqrt(2.0)) * jax.lax.erf_inv(u)


def test_keys_and_bits_equal_jax():
    rng = np.random.default_rng(0)
    seeds = [0, 1, 7, 12345, 2**31 - 1] + rng.integers(0, 2**31, 27).tolist()
    data = np.r_[0, 1, 4095, 2**31 - 1, rng.integers(0, 2**31, 60)].astype(np.int32)
    for seed in seeds:
        jkey = jax.random.PRNGKey(seed)
        key = tf.prng_key(seed, device="cpu")
        np.testing.assert_array_equal(key.numpy(), np.asarray(jax.random.key_data(jkey)))
        jk = np.asarray(jax.vmap(lambda d: jax.random.fold_in(jkey, d))(jnp.asarray(data)))
        tk = tf.fold_in(key, torch.as_tensor(data))
        np.testing.assert_array_equal(tk.numpy(), jk)
        jbits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, dtype=jnp.uint32))(jk))
        np.testing.assert_array_equal(tf.random_bits32(tk).numpy(), jbits.astype(np.int64))
    # negative data wraps modulo 2^32, as JAX's uint32 cast does
    neg = np.asarray([-1, -4096], dtype=np.int32)
    jk = np.asarray(jax.vmap(lambda d: jax.random.fold_in(jax.random.PRNGKey(3), d))(neg))
    np.testing.assert_array_equal(tf.fold_in(tf.prng_key(3, device="cpu"), torch.as_tensor(neg)).numpy(), jk)


def test_normal_on_every_uniform():
    bits = torch.arange(2**23, dtype=torch.int64) << 9
    ref = np.asarray(_jax_normal_of_bits(jnp.asarray(bits.numpy().astype(np.uint32))))
    assert _bits_equal(tf.normal_from_bits(bits).numpy(), ref)
    # the table is jax.random.normal: draws under real keys pick their entry
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(5), s))(jnp.arange(4096))
    normal = np.asarray(jax.vmap(lambda k: jax.random.normal(k, dtype=jnp.float32))(keys))
    draws = np.asarray(jax.vmap(lambda k: jax.random.bits(k, dtype=jnp.uint32))(keys))
    assert _bits_equal(normal, ref[draws >> 9])
    assert _bits_equal(tf.normal_f32(tf.fold_in(tf.prng_key(5, device="cpu"), torch.arange(4096))).numpy(), normal)


def test_sqrt_is_correctly_rounded():
    # the w >= 5 branch's square root, where torch's float32 sqrt on the CPU
    # is off by 1 ulp now and then: float64 and one rounding
    w = torch.from_numpy(np.random.default_rng(1).uniform(5.0, 17.0, 1 << 20).astype(np.float32))
    assert _bits_equal(tf._sqrt(w).numpy(), np.sqrt(w.numpy().astype(np.float64)))


@pytest.mark.parametrize("jitter", [0.2, 0.3])
def test_counter_jitter_factors_match_reference(jitter):
    secs = np.arange(4096)
    for seed in range(64):
        ref = jnet._counter_jitter_factors(seed, secs, jitter)
        got = tf.counter_jitter_factors(seed, secs, jitter, device="cpu")
        assert got.dtype == torch.float32
        assert _bits_equal(got.numpy(), ref), seed


def test_threefry_defaults_to_the_card():
    """Without a device, a key and the factors of host seconds land on the
    card (or raise where there is none); a tensor of seconds keeps its own."""
    secs = torch.arange(8)
    assert tf.counter_jitter_factors(3, secs, 0.3).device == secs.device
    assert tf.prng_key(3, device="cpu").device == torch.device("cpu")
    if not torch.cuda.is_available():  # no device means the card, never the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            tf.prng_key(3)
        with pytest.raises(RuntimeError, match="CUDA"):
            tf.counter_jitter_factors(3, np.arange(8), 0.3)


def test_counter_uplink_factors_cached_and_float32():
    up = tnet.Uplink(bandwidth_bps=1e6, latency=0.05, server_time=0.037, jitter=0.25, seed=9,
                     jitter_mode="counter")
    ref = jnet.Uplink(bandwidth_bps=1e6, latency=0.05, server_time=0.037, jitter=0.25, seed=9,
                      jitter_mode="counter")
    t = np.array([0.5, 3.0, 3.9, 1e4, 2.0, 0.1])
    np.testing.assert_array_equal(up.bandwidth_at(t), ref.bandwidth_at(t))
    np.testing.assert_array_equal(up._jit_keys, ref._jit_keys)
    np.testing.assert_array_equal(up._jit_vals, up._jit_vals.astype(np.float32).astype(np.float64))
    with pytest.raises(ValueError, match="jitter_mode"):
        tnet.Uplink(bandwidth_bps=1e6, latency=0.05, server_time=0.037, jitter_mode="xla")

