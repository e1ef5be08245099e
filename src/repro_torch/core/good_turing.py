"""Good–Turing machinery of paper §3.1 and §3.3; counterpart of
``repro.core.good_turing``.

The estimator, its bias bounds (Theorem *Bias*), the variance bound
(Theorem *Variance*) and the Poisson characterisation of N¹(n), as
analysis utilities and as the invariants the property tests exercise.
Every function takes float32 tensors (or Python numbers) on any device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def _t(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` as a float32 tensor (on ``like``'s device)."""
    dev = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def estimator(n1, n) -> torch.Tensor:
    """R(n+1) ≈ N¹(n)/n   (Eq. 1 / Eq. 7)."""
    n1 = _t(n1)
    return n1 / torch.clamp_min(_t(n, n1), 1.0)


def pi_first_at(p: torch.Tensor, n) -> torch.Tensor:
    """π_i(n) = p_i (1-p_i)^(n-1): chance result i appears first at sample n."""
    return p * (1.0 - p) ** (_t(n, p) - 1.0)


def expected_new(p: torch.Tensor, n) -> torch.Tensor:
    """E[R(n+1)] = Σ_i p_i (1-p_i)^n — expected new results on sample n+1."""
    return torch.sum(p * (1.0 - p) ** _t(n, p))


def expected_n1(p: torch.Tensor, n) -> torch.Tensor:
    """E[N¹(n)] = n Σ_i π_i(n) = n Σ_i p_i (1-p_i)^(n-1)."""
    return _t(n, p) * torch.sum(pi_first_at(p, n))


def expected_estimate(p: torch.Tensor, n) -> torch.Tensor:
    """E[N¹(n)]/n = Σ_i π_i(n)."""
    return torch.sum(pi_first_at(p, n))


class BiasBounds(NamedTuple):
    """rel.err bounds of Theorem (Bias): 0 ≤ rel.err ≤ min(max_p, sqrtN_term)."""

    rel_err: torch.Tensor        # exact relative bias (needs ground-truth p)
    max_p_bound: torch.Tensor    # Eq. 3:  max_i p_i
    moment_bound: torch.Tensor   # Eq. 4:  sqrt(N) (mu_p + sigma_p)


def bias_bounds(p: torch.Tensor, n) -> BiasBounds:
    """The exact relative bias and both paper bounds:
    rel.err = (E[N¹(n)]/n − E[R(n+1)]) / (E[N¹(n)]/n)."""
    est = expected_estimate(p, n)
    truth = expected_new(p, n)
    rel_err = (est - truth) / torch.clamp_min(est, torch.finfo(est.dtype).tiny)
    num_results = _t(p.shape[0], p)
    mu = torch.mean(p)
    sigma = torch.std(p, correction=0)       # jnp.std: the population deviation
    return BiasBounds(
        rel_err=rel_err,
        max_p_bound=torch.max(p),
        moment_bound=torch.sqrt(num_results) * (mu + sigma),
    )


def variance_bound(p: torch.Tensor, n) -> torch.Tensor:
    """Theorem (Variance): Var[N¹(n)/n] ≤ E[N¹(n)]/n²  (under independence)."""
    return expected_n1(p, n) / torch.clamp_min(_t(n, p), 1.0) ** 2


def exact_variance(p: torch.Tensor, n) -> torch.Tensor:
    """Exact Var[N¹(n)/n] under independent Bernoulli instances:
    Σ_i π_i(n)(1−π_i(n)) / n²."""
    pi = pi_first_at(p, n)
    return torch.sum(pi * (1.0 - pi)) / torch.clamp_min(_t(n, p), 1.0) ** 2


def poisson_rate(p: torch.Tensor, n) -> torch.Tensor:
    """λ of the limiting Poisson law of N¹(n): λ = E[N¹(n)] = n·Σ_i π_i(n)
    (the exactly-once total; see the reference's note on §3.3's π_i)."""
    return _t(n, p) * torch.sum(pi_first_at(p, n))


def simulate_counts(key: torch.Tensor, p: torch.Tensor, num_samples: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo draw of each instance's sightings after ``num_samples``
    random frames, where each frame shows instance i independently with
    probability p_i: (times_seen i32[N], n i32[]).  One binomial draw an
    instance, from a generator seeded by ``key`` (int64[2]): statistically
    the reference's ``jax.random.binomial``, not its bits."""
    words = key.tolist()
    gen = torch.Generator(device=p.device)
    gen.manual_seed((int(words[0]) << 32 | int(words[1])) & (2**63 - 1))
    count = torch.full_like(p, float(num_samples))
    times_seen = torch.binomial(count, p, generator=gen).int()
    return times_seen, torch.tensor(num_samples, dtype=torch.int32, device=p.device)


def n1_from_counts(times_seen: torch.Tensor) -> torch.Tensor:
    return torch.sum(times_seen == 1).float()


def remaining_value(p: torch.Tensor, times_seen: torch.Tensor) -> torch.Tensor:
    """True R(n+1) = Σ_i [i ∉ seen] p_i given simulated sighting counts."""
    return torch.sum(torch.where(times_seen == 0, p, torch.zeros_like(p)))
