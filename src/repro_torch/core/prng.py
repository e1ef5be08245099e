"""JAX's threefry2x32 key stream, in its partitionable mode, on torch tensors.

The reference drivers draw every random number through ``jax.random``
(``split`` → ``normal``); the port reproduces those draws so that the
same key gives the same chunk choices.  A key is an int64 tensor of shape
``[..., 2]`` holding two uint32 words; ``split``, ``fold_in``,
``random_bits``, ``uniform``, ``bernoulli`` and ``normal`` take a batch of keys
(``[Q, 2]``) as well as one, and row q of a batched call equals the call
on ``key[q]`` bit for bit (threefry is elementwise, so the key words
broadcast against the counters, as ``jax.vmap`` does).  Every word is kept in an int64 and
masked with ``& 0xFFFFFFFF`` after each add and shift, so the same code
runs unchanged on the CPU and on CUDA (neither has a usable uint32).

Counterparts in JAX 0.9 (``jax/_src/prng.py``, ``jax/_src/random.py``):

* ``threefry2x32``  ← ``_threefry2x32_lowering`` (20 rounds, key schedule)
* ``split``         ← ``_threefry_split_foldlike`` (partitionable mode)
* ``fold_in``       ← ``threefry_fold_in``
* ``random_bits``   ← ``_threefry_random_bits_partitionable`` (32-bit)
* ``randint``       ← ``_randint`` (int32: two 32-bit draws, uint32 span)
* ``uniform``       ← ``_uniform``
* ``bernoulli``     ← ``_bernoulli`` (``mode="low"``)
* ``normal``        ← ``_normal_real``: ``√2 · erfinv(u)`` with XLA's
  float32 ErfInv polynomial and XLA CPU's own ``log1p``, each evaluated
  with the fused multiply-adds XLA's backend contracts (``numerics``).
  Integer outputs are bit-exact; normals too wherever those contraction
  sites hold (see tests/test_torch_prng.py for the measured agreement).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.numerics import fma32, sqrt32

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block function on broadcastable int64 word tensors."""
    ks2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, ks2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device: str | torch.device | None = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[seed >> 32, seed & M]``."""
    device = resolve(device)
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit JAX's default int32 seed")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _counts(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _words(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two key words of ``key[..., 2]``, each shaped ``[..., 1]`` to
    broadcast against a trailing counter axis."""
    return key[..., 0:1], key[..., 1:2]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: int64[..., num, 2] for keys [..., 2]."""
    lo = _counts(num, key.device)
    b0, b1 = threefry2x32(*_words(key), torch.zeros_like(lo), lo)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for keys [..., 2]."""
    x0 = torch.zeros((1,), dtype=torch.int64, device=key.device)
    x1 = torch.full((1,), int(data) & _M32, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(*_words(key), x0, x1)
    return torch.cat([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits``: ``hi ^ lo`` of threefry over the flat
    index (high count word 0).  int64 tensor of uint32 values, shaped
    ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    lo = _counts(math.prod(shape), key.device)
    b0, b1 = threefry2x32(*_words(key), torch.zeros_like(lo), lo)
    return (b0 ^ b1).reshape(key.shape[:-1] + shape)


_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def _mul32(a, b: int) -> torch.Tensor:
    """``a · b mod 2^32`` for uint32 words ``a`` (int64 tensor) and ``b``
    (an int below 2^32), in 16-bit halves: the whole product overflows int64."""
    return (((((a >> 16) * b) & 0xFFFF) << 16) + (a & 0xFFFF) * b) & _M32


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``: int32
    ``key.shape[:-1] + shape``.  As JAX 0.9's ``_randint``: the bounds
    clipped to int32; keys ``k1, k2 = split(key)``; two 32-bit draws
    ``hi, lo``; in uint32, ``span = maxval - minval`` (1 when ``maxval <=
    minval``, one more when ``maxval`` is past int32's maximum, 0 for the
    whole range), ``multiplier = (2^16 mod span)^2 mod span`` and the
    offset ``((hi mod span)·multiplier + lo mod span) mod span``, each
    product and sum wrapping at 2^32 (a remainder by 0 is its dividend,
    as in XLA); the result ``minval + offset`` wrapped to int32."""
    out_of_range = maxval > _I32_MAX
    lo_b = min(max(int(minval), _I32_MIN), _I32_MAX)
    hi_b = min(max(int(maxval), _I32_MIN), _I32_MAX)
    if hi_b <= lo_b:
        span = 1
    else:
        span = (hi_b - lo_b) & _M32
        if out_of_range:
            span = (span + 1) & _M32

    def rem(x):
        return x % span if span else x

    k = split(key, 2)
    higher, lower = random_bits(k[..., 0, :], shape), random_bits(k[..., 1, :], shape)
    mult = rem(2**16)
    mult = rem((mult * mult) & _M32)
    offset = rem((_mul32(rem(higher), mult) + rem(lower)) & _M32)
    return (((lo_b + offset - _I32_MIN) & _M32) + _I32_MIN).to(torch.int32)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """Mantissa trick: float32 in [1, 2) from the top 23 bits, minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32).  ``floats * (max - min) + min`` is
    one contracted FMA in XLA; ``max - min`` is rounded to float32 first."""
    lo = _f32(minval)
    span = _f32(np.float32(maxval) - np.float32(minval))
    u = fma32(_bits_to_unit(random_bits(key, shape)), span, lo)
    return torch.clamp_min(u, lo)


# XLA CPU's log1p (elemental IR emitter + its inlined float32 log), with the
# multiply-adds LLVM contracts marked by fma32.
_LOG_P = (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1,
)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
_SQRTHF = 0.707106781186547524
_LOG1P_NUM = (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1,
)
_LOG1P_DEN = (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1,
)


def _f32(v: float) -> float:
    """``v`` rounded to the nearest float32, as a Python float."""
    return float(np.float32(v))


def _xla_log_f32(t: torch.Tensor) -> torch.Tensor:
    """Natural log of positive finite float32 ``t`` as XLA CPU computes it."""
    t = torch.clamp_min(t, _f32(1.17549435e-38))            # min normal
    bits = t.view(torch.int32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    e = ((bits >> 23) - 127).float() + 1.0
    small = m < _f32(_SQRTHF)
    e = e - small.float()
    y = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    z = y * y
    y3 = z * y
    # Cephes' degree-8 polynomial, split by LLVM into three interleaved
    # chains that meet at y³
    p = [_f32(c) for c in _LOG_P]
    q1 = fma32(fma32(y, p[0], p[1]), y, p[2])
    q2 = fma32(fma32(y, p[3], p[4]), y, p[5])
    q3 = fma32(fma32(y, p[6], p[7]), y, p[8])
    r = fma32(q1, y3, q2)
    s = fma32(r, y3, q3)
    u = fma32(s, y3, e * _f32(_LOG_Q1))
    v = y - z * 0.5
    return (v + u) + e * _f32(_LOG_Q2)


def _xla_log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``log1p`` for finite ``x > -1``: a Cephes rational
    approximation for |x| < √2 − 1, ``log(1 + x)`` above."""
    large = _xla_log_f32(x + 1.0)
    x2 = x * x

    def horner(coeffs):
        acc = torch.full_like(x, _f32(coeffs[0]))
        for c in coeffs[1:]:
            acc = fma32(acc, x, _f32(c))
        return acc

    # the leading step is ``0·x + c0`` in XLA, whose product has two uses
    # and is not contracted; it equals c0 for finite x
    ratio = horner(_LOG1P_NUM) / horner(_LOG1P_DEN)
    small = x + ((x2 * -0.5) + (x * x2) * ratio)
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, large)


_ERFINV_LT5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_GE5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv (Giles' single-precision polynomial)."""
    w = -_xla_log1p_f32(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt32(w) - 3.0)
    # Python-float coefficients: no host-to-device copies
    coeffs = [(_f32(a), _f32(b)) for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = torch.where(lt, *coeffs[0])
    for a, b in coeffs[1:]:
        p = fma32(p, w, torch.where(lt, a, b))
    res = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, res)


def bernoulli(key, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli`` (its default ``mode="low"``): bool, the
    float32 uniform below ``p`` rounded to float32."""
    return uniform(key, shape) < _f32(p)


# the least uniform of ``jax.random.normal``: nextafter(-1, 0) in float32
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key, shape) -> torch.Tensor:
    """``jax.random.normal`` (float32): ``√2 · erfinv(u)``, u uniform on
    (NORMAL_LO, 1).  Keys [..., 2] give ``key.shape[:-1] + shape``."""
    u = uniform(key, shape, NORMAL_LO, 1.0)
    return erfinv_f32(u) * _f32(math.sqrt(2.0))
