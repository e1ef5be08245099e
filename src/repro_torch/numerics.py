"""Float32 arithmetic that gives the same bits on the CPU and on CUDA.

The JAX reference is jitted, and XLA's CPU backend lets LLVM contract a
multiply feeding an add into one fused multiply-add (FMA, a single
rounding).  To reproduce its results bit for bit the port evaluates each
such site as an exact FMA, and every other operation as the plain IEEE
float32 operation.  PyTorch exposes no float32 FMA, so ``fma32`` builds
it from float64: the product of two float32 values is exact in float64,
the float64 sum rounds once, and the one case where rounding that sum to
float32 could round twice (a float64 sum sitting exactly halfway between
two float32 neighbours while the exact sum is not) is nudged toward the
exact sum first.  Every step is correctly rounded IEEE arithmetic, so CPU
and CUDA agree bit for bit.

One more rule keeps the two devices equal: never divide a CUDA tensor by
a Python scalar.  PyTorch's CUDA division by a CPU scalar multiplies by
its reciprocal, which can differ from the division in the last bit.

And take square roots with ``sqrt32``: PyTorch's CPU ``sqrt`` is not
correctly rounded (about 0.6% of float32 and of float64 inputs come out one
ulp off), while CUDA's and XLA's are.
"""
from __future__ import annotations

import math

import torch

_LOW29 = (1 << 29) - 1   # float64 mantissa bits below float32's
_HALF29 = 1 << 28        # the pattern of an exact float32 midpoint


def fma32(a: torch.Tensor, b: torch.Tensor | float, c: torch.Tensor | float) -> torch.Tensor:
    """``a * b + c`` with one rounding to float32 (IEEE fused multiply-add).

    ``a`` is a float32 tensor; ``b`` and ``c`` are float32 tensors or
    Python floats that are exact in float32.  Valid for results in
    float32's normal range.
    """
    if isinstance(b, torch.Tensor):
        b = b.double()
    if isinstance(c, torch.Tensor):
        c = c.double()
    p = a.double() * b                 # exact: 24 + 24 bits < 53
    s = p + c                          # one float64 rounding
    bb = s - p                         # TwoSum: err is s's exact rounding error
    err = (p - (s - bb)) + (c - bb)
    tie = (s.view(torch.int64) & _LOW29) == _HALF29
    # err is below half of s's float64 ulp, so s + err rounds back to s:
    # step toward err's sign (err·inf, NaN only where err is 0 and unused)
    s = torch.where(tie & (err != 0), torch.nextafter(s, err * math.inf), s)
    return s.float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of float32 ``x`` (IEEE ``sqrt``),
    the same bits on the CPU and on CUDA.

    A float64 root rounded to float32 is within one float32 ulp; it is then
    moved to the neighbour whose rounding interval holds the root: the
    midpoints between neighbours have 25 significant bits, so their
    squares and the comparisons with ``x`` are exact in float64.  Zero,
    negative, infinite and NaN inputs keep ``torch.sqrt``'s result."""
    d = x.double()
    s = torch.sqrt(d).float()
    sd = s.double()
    up = torch.nextafter(s, torch.full_like(s, float("inf")))
    down = torch.nextafter(s, torch.zeros_like(s))
    hi = (sd + up.double()) * 0.5
    lo = (sd + down.double()) * 0.5
    fixed = torch.where(d > hi * hi, up, torch.where(d < lo * lo, down, s))
    return torch.where((d > 0) & torch.isfinite(d), fixed, s)
