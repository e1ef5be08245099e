"""The port's float32 arithmetic that must give one rounding on the CPU
and on CUDA (``repro_torch.numerics``), against exact rational arithmetic:
``fma32`` (XLA's fused multiply-adds; ``__fmaf_rn`` in the fused Thompson
kernel) and ``sqrt32`` (the correctly rounded square root; ``__fsqrt_rn``
in the kernel, ``sqrt`` in XLA).  Both are exact: no tolerance.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.numerics import fma32, sqrt32


def _round_f32(x: Fraction) -> np.float32:
    """``x`` rounded to the nearest float32, ties to even, from exact
    arithmetic (finite, normal range)."""
    lo = np.float32(float(x))                     # within an ulp of x
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - x), int(np.asarray(c).view(np.int32)) & 1))
    return np.float32(best)


def _midpoint_cases():
    """a·b + c = c ± (u/2)(1 − 2^-40) for c with an odd last bit and ulp u:
    the exact value sits 2^-41·u from a float32 midpoint, the float64 sum
    lands on the midpoint, and rounding that to float32 (ties to even)
    would pick the wrong neighbour."""
    out = []
    for c, u in ((2.0**23 + 1, 1.0), (2.0**23 + 3, 1.0), (2.0**22 + 0.5, 0.5), (-(2.0**23 + 1), 1.0),
                 (3.0 * 2.0**20 + 0.25, 0.25)):
        for sign in (1.0, -1.0):
            out.append((1 + 2.0**-20, sign * (1 - 2.0**-20) * u / 2, c))
    return out


@pytest.mark.parametrize("a,b,c", _midpoint_cases())
def test_fma32_rounds_once_at_float32_midpoints(a, b, c):
    a32, b32, c32 = np.float32(a), np.float32(b), np.float32(c)
    want = _round_f32(Fraction(float(a32)) * Fraction(float(b32)) + Fraction(float(c32)))
    got = fma32(torch.tensor([a32]), float(b32), float(c32)).numpy()[0]
    assert got.view(np.int32) == want.view(np.int32), (got, want)


@pytest.mark.parametrize("seed", range(3))
def test_fma32_equals_exact_rounding(seed):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(3000) * 4).astype(np.float32)
    b = (rng.standard_normal(3000) * 4).astype(np.float32)
    c = (rng.standard_normal(3000) * 16).astype(np.float32)
    got = fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(len(a)):
        want = _round_f32(Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i])))
        assert got[i].view(np.int32) == want.view(np.int32), i


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 100.0, 1e30])
def test_sqrt32_is_correctly_rounded(scale):
    """numpy's float32 sqrt is IEEE (correctly rounded); PyTorch's CPU sqrt
    is not on every input, which is why the port has sqrt32."""
    x = (np.random.default_rng(int(scale * 0) + 7).random(200_000) * scale).astype(np.float32)
    got = sqrt32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), np.sqrt(x).view(np.int32))


def test_sqrt32_edges():
    x = np.array([0.0, -0.0, 1.0, 4.0, np.inf, 1e-45, 3.4e38, 8.146327018737793], np.float32)
    got = sqrt32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), np.sqrt(x).view(np.int32))
    assert np.isnan(sqrt32(torch.tensor([-1.0, float("nan")])).numpy()).all()
