"""repro_torch's Good–Turing machinery against ``repro.core.good_turing``,
on the CPU.

  * The analytic functions (estimator, π, E[R(n+1)], E[N¹], the estimate,
    the bias bounds, both variances, the Poisson rate, N¹ and the
    remaining value from counts) on the same float32 inputs: within 1e-6
    relative of JAX (sums and powers in another order; 1e-30 absolute
    below that).
  * ``tests/test_good_turing.py``'s properties of paper §3.1/§3.3, run on
    the port (property tests with ``deadline=None``).
  * ``simulate_counts`` draws from a generator seeded by the key, not
    JAX's binomial sampler, so it is held statistically as that file
    holds JAX's: the Monte-Carlo mean of N¹(n)/n within 10% of Σπᵢ(n), the
    remaining value within 0.02 of E[R(n+1)], and the per-instance counts'
    mean and variance those of Binomial(n, pᵢ).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import good_turing as jgt
from repro_torch.core import good_turing as gt
from repro_torch.core import prng

RTOL, ATOL = 1e-6, 1e-30


def _p(seed: int, size: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.exp(rng.normal(-5.0, 1.5, size)).clip(1e-6, 0.2).astype(np.float32)


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 7, 100, 2000])
@pytest.mark.parametrize("seed,size", [(0, 2), (1, 50), (2, 400)])
def test_analytic_functions_match_jax(seed, size, n):
    p = _p(seed, size)
    tp, jp, nf = torch.from_numpy(p), jnp.asarray(p), np.float32(n)
    for name in ("pi_first_at", "expected_new", "expected_n1", "expected_estimate", "variance_bound",
                 "exact_variance", "poisson_rate"):
        _close(getattr(gt, name)(tp, nf), getattr(jgt, name)(jp, jnp.float32(n)))
    tb, jb = gt.bias_bounds(tp, nf), jgt.bias_bounds(jp, jnp.float32(n))
    for f in tb._fields:
        np.testing.assert_allclose(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), rtol=RTOL, atol=1e-6,
                                   err_msg=f)
    counts = np.random.default_rng(seed).integers(0, 4, size).astype(np.int32)
    _close(gt.n1_from_counts(torch.from_numpy(counts)), jgt.n1_from_counts(jnp.asarray(counts)))
    _close(gt.remaining_value(tp, torch.from_numpy(counts)), jgt.remaining_value(jp, jnp.asarray(counts)))


@pytest.mark.parametrize("n1,n", [(0.0, 10.0), (0.0, 0.0), (3.0, 7.0), (5.0, 0.5)])
def test_estimator_matches_jax(n1, n):
    _close(gt.estimator(np.float32(n1), np.float32(n)), jgt.estimator(jnp.float32(n1), jnp.float32(n)))


def p_vectors(min_size=2, max_size=200):
    return st.lists(st.floats(1e-6, 0.2), min_size=min_size, max_size=max_size).map(
        lambda xs: torch.tensor(xs, dtype=torch.float32))


@settings(max_examples=60, deadline=None)
@given(p=p_vectors(), n=st.integers(1, 500))
def test_bias_is_nonnegative_and_bounded(p, n):
    """Theorem (Bias): 0 ≤ rel.err ≤ min(max pᵢ, √N(μ+σ))   (Eqs. 2-4)."""
    b = gt.bias_bounds(p, float(n))
    assert float(b.rel_err) >= -1e-6
    assert float(b.rel_err) <= float(b.max_p_bound) + 1e-6
    assert float(b.rel_err) <= float(b.moment_bound) + 1e-6


@settings(max_examples=40, deadline=None)
@given(p=p_vectors(), n=st.integers(1, 300))
def test_variance_bound(p, n):
    """Theorem (Variance): exact Var[N¹/n] ≤ E[N¹]/n²   (Eq. 8)."""
    assert float(gt.exact_variance(p, float(n))) <= float(gt.variance_bound(p, float(n))) + 1e-9


def test_estimator_matches_expectation_monte_carlo():
    """E[N¹(n)/n] ≈ Σπᵢ(n) and ≈ E[R(n+1)] up to the bias bound."""
    rng = np.random.default_rng(0)
    p = torch.tensor(np.exp(rng.normal(-6.0, 1.5, 400)).clip(1e-6, 0.15), dtype=torch.float32)
    n = 200
    keys = prng.split(prng.PRNGKey(1, device="cpu"), 300)
    est, rem = [], []
    for k in keys:
        seen, n_t = gt.simulate_counts(k, p, n)
        assert seen.dtype == torch.int32 and int(n_t) == n
        est.append(float(gt.n1_from_counts(seen)) / n)
        rem.append(float(gt.remaining_value(p, seen)))
    expected = float(gt.expected_estimate(p, n))
    assert abs(np.mean(est) - expected) / max(expected, 1e-9) < 0.1
    assert expected >= float(gt.expected_new(p, n))
    assert abs(np.mean(rem) - float(gt.expected_new(p, n))) < 0.02


def test_simulate_counts_is_binomial_and_keyed():
    p = torch.tensor([0.0, 0.01, 0.2, 0.5, 1.0], dtype=torch.float32)
    n = 100
    draws = torch.stack([gt.simulate_counts(k, p, n)[0] for k in prng.split(prng.PRNGKey(4, device="cpu"), 2000)])
    draws = draws.double()
    mean, var = draws.mean(0), draws.var(0)
    want_mean, want_var = n * p.double(), n * p.double() * (1 - p.double())
    assert torch.allclose(mean, want_mean, atol=0.05 * n * 0.05 + 1e-9, rtol=0.05)
    assert torch.allclose(var, want_var, atol=1e-9, rtol=0.15)
    k = prng.PRNGKey(9, device="cpu")
    assert torch.equal(gt.simulate_counts(k, p, n)[0], gt.simulate_counts(k, p, n)[0])


def test_poisson_rate_matches_variance_regime():
    p = torch.full((50,), 0.01)
    lam = float(gt.poisson_rate(p, 100.0))
    assert 0 < lam <= 50 * 0.01 * 100


def test_estimator_handles_zero_counts():
    assert float(gt.estimator(0.0, 10.0)) == 0.0
    assert float(gt.estimator(0.0, 0.0)) == 0.0
