"""Per-chunk sampler statistics for ExSample (paper §3, Algorithm 1).

Counterpart of ``repro.core.state``.  Per chunk j:

  * ``n1[j]``     — N¹_j: results seen exactly once, first seen in chunk j.
  * ``n[j]``      — frames sampled from chunk j so far.
  * ``frames[j]`` — frames chunk j holds (for exhaustion masking).

Updates are additive, so they commute.  The scatter-adds are
``index_add_`` on a copy; on CUDA they use atomics, which stay exact
because every delta is an integer-valued float32 far below 2²⁴.

The multi-query carry holds Q rows of statistics (``[Q, M]`` on every
field).  There the updates take one chunk per query (``i[Q]``, or
``i[Q, K]``) and scatter into the flattened statistics at ``q·M + j``, so
no query's delta can land in another's row.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve

DEFAULT_ALPHA0: float = 0.1
DEFAULT_BETA0: float = 1.0


@dataclasses.dataclass(frozen=True)
class SamplerState:
    """Dense ExSample statistics over M chunks."""

    n1: torch.Tensor          # f32[M], or f32[Q, M] for Q queries
    n: torch.Tensor           # f32[M] / f32[Q, M]
    frames: torch.Tensor      # i32[M] / i32[Q, M]
    alpha0: float = DEFAULT_ALPHA0
    beta0: float = DEFAULT_BETA0

    @property
    def num_chunks(self) -> int:
        return self.n1.shape[-1]

    def exhausted(self) -> torch.Tensor:
        """bool[M] (bool[Q, M]) — True where every frame of the chunk has
        been sampled."""
        return self.n >= self.frames.to(self.n.dtype)

    def to(self, device) -> "SamplerState":
        return dataclasses.replace(
            self, n1=self.n1.to(device), n=self.n.to(device), frames=self.frames.to(device)
        )


def init_state(
    frames_per_chunk,
    *,
    alpha0: float = DEFAULT_ALPHA0,
    beta0: float = DEFAULT_BETA0,
    device: str | torch.device | None = None,
) -> SamplerState:
    """Fresh state: all-zero statistics (Algorithm 1 lines 2-3)."""
    device = resolve(device)
    frames = torch.as_tensor(frames_per_chunk, dtype=torch.int32).to(device)
    zeros = torch.zeros(frames.shape, dtype=torch.float32, device=device)
    return SamplerState(n1=zeros, n=zeros.clone(), frames=frames, alpha0=alpha0, beta0=beta0)


def _as_index(state: SamplerState, idx) -> torch.Tensor:
    """Chunk indices as flat positions in ``n1``/``n``: ``j`` for one
    query; ``q·M + j`` for Q queries, where ``idx`` has a leading ``[Q]``.
    Keeps ``idx``'s shape."""
    idx = torch.as_tensor(idx, device=state.n1.device).long()
    if state.n1.dim() == 1:
        return idx
    q, m = state.n1.shape
    rows = torch.arange(q, device=idx.device).reshape((q,) + (1,) * (idx.dim() - 1))
    return rows * m + idx


def _per_entry(v, idx: torch.Tensor, dtype) -> torch.Tensor:
    """``v`` broadcast over ``idx`` (trailing axes added to a per-query
    ``v``) and flattened; a Python number becomes a device fill rather
    than a host-to-device copy (which would synchronise)."""
    if isinstance(v, torch.Tensor):
        v = v.to(dtype)
        return v.reshape(v.shape + (1,) * (idx.dim() - v.dim())).expand(idx.shape).reshape(-1)
    return torch.full((idx.numel(),), float(v), dtype=dtype, device=idx.device)


def _scatter_add(t: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return t.clone().reshape(-1).index_add_(0, idx.reshape(-1), v).reshape(t.shape)


def apply_update(
    state: SamplerState,
    chunk_idx,
    d0,
    d1,
    *,
    samples=1,
) -> SamplerState:
    """Algorithm 1 lines 13-14: ``N¹[j] += d0 - d1``, ``n[j] += samples``.
    Colliding chunk indices accumulate.  With Q queries, ``chunk_idx``,
    ``d0``, ``d1`` and ``samples`` are per query (``[Q]``); ``samples``
    of 0 leaves a finished query's row as it was."""
    idx = _as_index(state, chunk_idx)
    dtype = state.n1.dtype
    n1 = _scatter_add(state.n1, idx, _per_entry(d0, idx, dtype) - _per_entry(d1, idx, dtype))
    n = _scatter_add(state.n, idx, _per_entry(samples, idx, dtype))
    return dataclasses.replace(state, n1=n1, n=n)


def apply_cross_chunk_decrement(state: SamplerState, home_chunk, count) -> SamplerState:
    """§3.4: a result first seen in ``home_chunk`` was re-found in another
    chunk — its contribution leaves N¹ of the home chunk.  With Q
    queries, ``home_chunk`` and ``count`` have a leading ``[Q]``."""
    idx = _as_index(state, home_chunk)
    cnt = _per_entry(count, idx, state.n1.dtype)
    return dataclasses.replace(state, n1=_scatter_add(state.n1, idx, -cnt))


def point_estimate(state: SamplerState) -> torch.Tensor:
    """(N¹+α₀)/(n+β₀); exhausted chunks score -inf."""
    est = (state.n1 + state.alpha0) / (state.n + state.beta0)
    return torch.where(state.exhausted(), torch.full_like(est, -torch.inf), est)
