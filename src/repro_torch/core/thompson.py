"""Thompson sampling over Gamma beliefs (paper §3.3.1, Eq. 9-10).

Counterpart of ``repro.core.thompson``.  Three samplers:

  * ``"exact"``           — Gamma draws from ``torch._standard_gamma`` with a
    ``torch.Generator`` seeded from the key.  Its numbers differ from
    ``jax.random.gamma``; it is held to the reference only statistically.
  * ``"wilson_hilferty"`` — the cube-normal approximation on the port's
    JAX-compatible normals: the same chunk choices as JAX for the same key.
  * ``"pallas"``          — the fused round (``kernels.thompson``): from the
    key to the chunk ids in one launch on the card, the normals made in
    registers, with exhaustion encoded as an ``alpha < 0`` sentinel; the
    same choices as ``"wilson_hilferty"``.

``choose_chunks_batched`` is the multi-query choice: Q keys and Q rows of
statistics decided together, row q equal to ``choose_chunks`` on query q
(``"pallas"`` in one launch for all Q queries).

Divisions here are tensor by tensor: on CUDA, dividing by a Python scalar
becomes a multiply by its reciprocal and can differ in the last bit.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng
from repro_torch.core.state import SamplerState, point_estimate
from repro_torch.numerics import sqrt32


def gamma_params(state: SamplerState) -> tuple[torch.Tensor, torch.Tensor]:
    """(α, β) of Eq. 10: α = N¹ + α₀ clamped at α₀/2, β = n + β₀."""
    alpha = state.n1 + state.alpha0
    beta = state.n + state.beta0
    return torch.clamp_min(alpha, state.alpha0 * 0.5), beta


def wilson_hilferty(alpha: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """X ≈ α · max(1 − 1/(9α) + z/(3√α), 0)³ for X ~ Γ(α, 1), evaluated in
    the reference's operation order."""
    a9 = alpha * 9.0
    c = (1.0 - torch.ones_like(a9) / a9) + z / (sqrt32(alpha) * 3.0)
    c = torch.clamp_min(c, 0.0)
    return alpha * ((c * c) * c)


def _first_argmax(scores: torch.Tensor) -> torch.Tensor:
    """jnp.argmax: the first index of each row's maximum, as int32."""
    return torch.argmax(scores, dim=-1).int()


def draw_scores(key: torch.Tensor, state: SamplerState, *, cohorts: int = 1) -> torch.Tensor:
    """Gamma Thompson draws, f32[cohorts, M], from a generator seeded by
    ``key`` (statistically equivalent to the reference, not bit-equal)."""
    alpha, beta = gamma_params(state)
    # seeding reads the key to the host (a sync); "exact" is held only
    # statistically and is off the measured path, which runs "pallas"
    words = key.tolist()
    gen = torch.Generator(device=alpha.device)
    gen.manual_seed((int(words[0]) << 32 | int(words[1])) & (2**63 - 1))
    draws = torch._standard_gamma(alpha[None, :].expand(cohorts, -1).contiguous(), generator=gen)
    scores = draws / beta[None, :]
    return torch.where(state.exhausted()[None, :], torch.full_like(scores, -torch.inf), scores)


def draw_scores_wilson_hilferty(
    key: torch.Tensor, state: SamplerState, *, cohorts: int = 1
) -> torch.Tensor:
    """Approximate Thompson draws via the WH transform, f32[cohorts, M]
    (f32[Q, cohorts, M] for Q keys and Q rows of statistics)."""
    alpha, beta = gamma_params(state)
    z = prng.normal(key, (cohorts, alpha.shape[-1]))
    scores = wilson_hilferty(alpha[..., None, :], z) / beta[..., None, :]
    return torch.where(state.exhausted()[..., None, :], torch.full_like(scores, -torch.inf), scores)


def _kernel_inputs(key: torch.Tensor, state: SamplerState, cohorts: int):
    """(alpha, beta, z) of B1's choice, exhaustion as alpha = -1: what the
    fused round computes in registers."""
    alpha, beta = gamma_params(state)
    alpha = torch.where(state.exhausted(), torch.full_like(alpha, -1.0), alpha)
    return alpha, beta, prng.normal(key, (cohorts, alpha.shape[-1]))


def choose_chunks(
    key: torch.Tensor,
    state: SamplerState,
    *,
    cohorts: int = 1,
    method: str = "exact",
) -> torch.Tensor:
    """Algorithm 1 lines 5-8, batched (§3.7.1).  Returns i32[cohorts]."""
    if method == "exact":
        scores = draw_scores(key, state, cohorts=cohorts)
    elif method == "wilson_hilferty":
        scores = draw_scores_wilson_hilferty(key, state, cohorts=cohorts)
    elif method == "pallas":
        # deferred import: kernels.thompson.ref imports this module
        from repro_torch.kernels.thompson.ops import choose_round

        idx, _ = choose_round(key, state, cohorts)
        return idx
    else:
        raise ValueError(f"unknown Thompson method: {method!r}")
    return _first_argmax(scores)


def choose_chunks_batched(
    keys: torch.Tensor,
    state: SamplerState,
    *,
    cohorts: int = 1,
    method: str = "exact",
) -> torch.Tensor:
    """Leading-[Q] ``choose_chunks``: keys int64[Q, 2] and statistics with
    a leading [Q] on every field.  Returns i32[Q, cohorts]; row q equals
    ``choose_chunks(keys[q], state_q)``.  An all-exhausted row gives -1
    under ``"pallas"`` (the kernel's rule, ROADMAP C2) and 0 under the
    other methods (argmax of an all-equal row)."""
    if method == "exact":
        # one generator per query, seeded from its key on the host: "exact"
        # is held statistically and is off the measured path
        return torch.stack([
            choose_chunks(keys[q], _row(state, q), cohorts=cohorts, method=method)
            for q in range(keys.shape[0])
        ])
    if method == "wilson_hilferty":
        return _first_argmax(draw_scores_wilson_hilferty(keys, state, cohorts=cohorts))
    if method == "pallas":
        from repro_torch.kernels.thompson.ops import choose_round_batched

        idx, _ = choose_round_batched(keys, state, cohorts)
        return idx
    raise ValueError(f"unknown Thompson method: {method!r}")


def _row(state: SamplerState, q: int) -> SamplerState:
    return dataclasses.replace(state, n1=state.n1[q], n=state.n[q], frames=state.frames[q])


def greedy_chunks(state: SamplerState, *, cohorts: int = 1) -> torch.Tensor:
    """Greedy baseline: argmax of the point estimate, no posterior noise."""
    idx = _first_argmax(point_estimate(state))
    return idx.expand(cohorts)
