"""Counter-mode random bits: JAX's threefry-2x32 generator on torch tensors.

The reference's ``Uplink(jitter_mode="counter")`` and its compiled round
loop draw one standard normal a second from ``fold_in(PRNGKey(seed),
second)``, so the host and the device see the same per-second channel.
This module computes the same bits with torch operations that run on any
device:

  * uint32 words are held in int64 tensors and masked with ``& 0xFFFFFFFF``
    after every add and shift (torch's uint32 has few CUDA operations);
  * a key is an int64 tensor whose last axis holds its two words;
  * ``normal_f32`` reproduces ``jax.random.normal(key, dtype=float32)`` as
    XLA compiles it for the CPU: 23 bits of ``bits0 ^ bits1`` become a
    uniform in [-1, 1), then ``sqrt(2) * erf_inv(u)`` with Giles' float32
    polynomial, ``w = -log1p(-u*u)``.  XLA's ``log1p`` is Cephes' rational
    below ``sqrt(2) - 1`` and Cephes' ``logf`` of ``1 + x`` above, and XLA
    contracts each polynomial step ``a * b + c`` into one fused
    multiply-add.  Every one of those operations is written here from
    integer operations and correctly rounded float operations (``+ - * /``,
    ``fma_f32``, and ``sqrt`` taken in float64: torch's float32 ``sqrt``
    on the CPU is not always correctly rounded), so the CPU and the card
    give the same bits, and they equal the reference's for every one of the
    2^23 uniforms (``tests/test_torch_jitter.py`` checks all of them).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits32", "normal_f32",
           "normal_from_bits", "counter_jitter_factors", "jitter_factors", "fma_f32"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

# erf_inv (Giles, float32): coefficients for w < 5 (on w - 2.5) and above
# (on sqrt(w) - 3), highest degree first
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# Cephes log1p rational for |x| < sqrt(2) - 1, highest degree first
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# Cephes logf on [sqrt(1/2) - 1, sqrt(2) - 1]
_LOGF_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
           1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
           3.3333331174E-1)
_LOGF_Q1, _LOGF_Q2 = -2.12194440e-4, 0.693359375
_SQRTHF = 0.707106781186547524


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``key`` (``key[..., 0]``, ``key[..., 1]``); all int64 holding uint32,
    broadcast together.  Returns the two output words."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x = [(x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x[0], x[1]


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32-bit words,
    on ``device`` (the card unless the caller passes the CPU)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64,
                        device=resolve_device(device))


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for every element of ``data``
    (integers, taken modulo 2^32 as JAX casts them to uint32): the hash of
    the counter ``(0, data)``.  Returns keys of shape ``data.shape + (2,)``."""
    data = data.to(torch.int64) & _M32
    w0, w1 = threefry2x32(key, torch.zeros_like(data), data)
    return torch.stack([w0, w1], dim=-1)


def random_bits32(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.bits(key, dtype=uint32)`` of shape (): the XOR of the
    two words of the hash of counter (0, 0), per key."""
    zero = torch.zeros_like(key[..., 0])
    w0, w1 = threefry2x32(key, zero, zero)
    return w0 ^ w1


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for float32 tensors with one rounding, as a fused
    multiply-add gives it: the product is exact in float64 (24 x 24 bits),
    the float64 sum is rounded to odd (TwoSum's error term says which way
    the nearest rounding went) and then to float32, which is the correctly
    rounded result since 53 >= 24 + 2."""
    p = a.double() * b.double()
    q = c.double()
    s = p + q
    bb = s - p
    err = (p - (s - bb)) + (q - bb)
    even = (s.view(torch.int64) & 1) == 0
    odd = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype))
    return torch.where((err != 0) & even, odd, s).to(torch.float32)


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    """``((c0 x + c1) x + c2) ...`` with every step one fused multiply-add."""
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = fma_f32(p, x, torch.full_like(x, c))
    return p


def _logf(x: torch.Tensor) -> torch.Tensor:
    """Cephes ``logf`` for normal positive float32 ``x``: mantissa in
    [sqrt(1/2), sqrt(2)) shifted by -1, a degree-8 polynomial in it, and
    the exponent times ln 2 in two parts."""
    b = x.view(torch.int32)
    e = (((b >> 23) & 0xFF) - 126).to(torch.float32)
    m = ((b & ~0x7F800000) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    low = m < _SQRTHF
    e = torch.where(low, e - 1.0, e)
    m = torch.where(low, (m - 1.0) + m, m - 1.0)
    x2 = m * m
    x3 = x2 * m
    p = _LOGF_P
    y = fma_f32(m, torch.full_like(m, p[0]), torch.full_like(m, p[1]))
    y1 = fma_f32(m, torch.full_like(m, p[3]), torch.full_like(m, p[4]))
    y2 = fma_f32(m, torch.full_like(m, p[6]), torch.full_like(m, p[7]))
    y = fma_f32(y, m, torch.full_like(m, p[2]))
    y1 = fma_f32(y1, m, torch.full_like(m, p[5]))
    y2 = fma_f32(y2, m, torch.full_like(m, p[8]))
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, torch.full_like(m, _LOGF_Q1) * e)
    t = fma_f32(torch.full_like(m, -0.5), x2, m) + y
    return fma_f32(torch.full_like(m, _LOGF_Q2), e, t)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: Cephes' rational for |x| < sqrt(2) - 1,
    ``logf(1 + x)`` elsewhere (for x > -1)."""
    x2 = x * x
    small = x + fma_f32(torch.full_like(x, -0.5), x2,
                        (x * x2) * (_horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)))
    large = _logf(1.0 + x)
    return torch.where(x.abs() < 0.41421356237309504880, small, large)


def normal_f32(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal(key, dtype=float32)`` of shape (), per key."""
    return normal_from_bits(random_bits32(key))


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """The standard normal JAX makes of 32 random bits (int64 holding
    uint32); only the top 23 bits count."""
    return _erf_inv_normal(_uniform(bits))


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(minval=nextafter(-1, 0), maxval=1)``: 23 bits
    as the mantissa of a float in [1, 2), shifted and scaled by 2 (exact)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return torch.clamp_min(f * 2.0 + lo, lo)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: taken in float64 and rounded
    once (torch's float32 ``sqrt`` on the CPU is off by 1 ulp on ~0.7 %
    of the ``w >= 5`` branch's inputs; XLA's and the card's are exact)."""
    return torch.sqrt(x.double()).to(torch.float32)


def _erf_inv_normal(u: torch.Tensor) -> torch.Tensor:
    """``sqrt(2) * erf_inv(u)``, XLA's float32 expansion."""
    w = -_log1p(-u * u)
    lt = w < 5.0
    z = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
    # one Horner pass, each step's coefficient picked by the branch (XLA's form)
    p = torch.where(lt, _ERFINV_LO[0], _ERFINV_HI[0]).to(torch.float32)
    for lo, hi in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = fma_f32(p, z, torch.where(lt, lo, hi).to(torch.float32))
    r = torch.where(u.abs() == 1.0, u * torch.inf, p * u)
    return r * float(np.float32(math.sqrt(2.0)))


def counter_jitter_factors(seed: int, seconds, jitter: float, device=None) -> torch.Tensor:
    """Per-second jitter factors ``clip(1 + jitter * normal(fold_in(
    PRNGKey(seed), second)), 0.2, 2.0)`` in float32: the reference's
    ``_counter_jitter_factors`` (whose ``1 + jitter * n`` is two roundings),
    on ``seconds``' own device when it is a tensor, else on ``device`` (the
    card unless the caller passes the CPU).  ``seconds`` are integers, cast
    to int32 as the reference casts them."""
    if not torch.is_tensor(seconds):
        seconds = torch.as_tensor(np.asarray(seconds, dtype=np.int64),
                                  device=resolve_device(device))
    key = prng_key(seed, device=seconds.device)
    return jitter_factors(key, seconds, jitter)


def jitter_factors(key: torch.Tensor, seconds: torch.Tensor, jitter: float) -> torch.Tensor:
    """``counter_jitter_factors`` under a key already on ``seconds``' device
    (the round engine keeps one a cell in its carry)."""
    n = normal_f32(fold_in(key, seconds.to(torch.int32)))
    return (1.0 + float(np.float32(jitter)) * n).clamp(0.2, 2.0)
