"""Per-chunk, per-class Thompson priors accumulated across searches.

Counterpart of ``repro.index.priors``, numpy on the host as there.  Each
finished search records its per-chunk evidence; a later search of the
same class starts from it instead of from a uniform prior.

The injection touches ``n1`` only.  ``gamma_params`` reads
``alpha = n1 + alpha0`` and ``beta = n + beta0``, but ``n`` also sets the
random+ rank (which frame of a chunk comes next) and the exhaustion test
(``n >= frames``), so the sampled-frame sequence and exhaustion stay
exactly as a cold search's; only the Thompson scores shift.  With
``prior_weight == 0`` (or no evidence for the class) ``warm_sampler``
returns the sampler state it was given, the object itself, so the cold
path is the no-index path by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# class key of class-less evidence (the multi kinds record the whole carry)
_NONE_KEY = -1


def _key(class_id: Optional[int]) -> int:
    return _NONE_KEY if class_id is None else int(class_id)


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


class ChunkPriors:
    """Accumulated per-chunk evidence: one ``(n1_acc, n_acc)`` pair of
    float64 ``[M]`` arrays per query class (``None`` = class-agnostic).
    ``n1_acc`` sums new results per chunk and ``n_acc`` frames sampled per
    chunk, over every recorded search."""

    def __init__(self):
        self._n1: dict[int, np.ndarray] = {}
        self._n: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self._n1)

    def classes(self) -> list[Optional[int]]:
        return [None if k == _NONE_KEY else k for k in sorted(self._n1)]

    # ---- accumulate --------------------------------------------------------

    def record(self, class_id: Optional[int], n1_delta, n_delta) -> None:
        """Fold one search's per-chunk deltas (``[M]``, or ``[Q, M]``
        summed over the leading axes) into the class's accumulator.
        Deltas, not totals: the caller subtracts the state it started
        from, warm-start boost included, so injected priors are never
        recorded again as evidence."""
        k = _key(class_id)
        n1, n = _host64(n1_delta), _host64(n_delta)
        n1 = n1.reshape(-1, n1.shape[-1]).sum(axis=0)
        n = n.reshape(-1, n.shape[-1]).sum(axis=0)
        if k in self._n1:
            if self._n1[k].shape != n1.shape:
                raise ValueError(
                    f"chunk-count mismatch for class {class_id}: recorded "
                    f"{self._n1[k].shape[0]} chunks, got {n1.shape[0]}")
            self._n1[k] += n1
            self._n[k] += n
        else:
            self._n1[k] = n1.copy()
            self._n[k] = n.copy()

    def ingest(self, class_id: Optional[int], proxy_scores, weight: float = 1.0) -> None:
        """Ingest-time proxy evidence: a ``[M]`` score in [0, 1] enters the
        same accumulators as real evidence, ``weight`` pseudo-frames a
        chunk of which ``score × weight`` were pseudo-results."""
        scores = np.clip(_host64(proxy_scores), 0.0, 1.0)
        self.record(class_id, scores * weight, np.full_like(scores, weight))

    # ---- inject ------------------------------------------------------------

    def warm_alphas(self, class_id: Optional[int], num_chunks: int,
                    prior_weight: float) -> Optional[np.ndarray]:
        """float64 ``[M]`` boost for ``n1``, ``prior_weight × rate`` on the
        chunks with evidence (``rate`` the accumulated hit rate), or None
        when there is nothing to inject (no weight, no evidence for the
        class, or another repository's chunk count)."""
        if prior_weight <= 0:
            return None
        k = _key(class_id)
        if k not in self._n1:
            return None
        n1a, na = self._n1[k], self._n[k]
        if n1a.shape[0] != num_chunks:
            return None
        rate = np.clip(n1a, 0.0, None) / np.maximum(na, 1.0)
        return prior_weight * rate * (na > 0)

    def warm_sampler(self, state, class_id: Optional[int], prior_weight: float):
        """The class prior added to a ``SamplerState``'s ``n1``; returns
        ``(state', equivalent_frames)``, the second the total boost.  The
        float64 boost is rounded to ``n1``'s dtype and added on ``n1``'s
        device, as the reference's ``jnp.asarray(boost, n1.dtype)``.  With
        nothing to inject the input state itself comes back."""
        boost = self.warm_alphas(class_id, int(state.n1.shape[-1]), prior_weight)
        if boost is None or not float(boost.sum()) > 0.0:
            return state, 0.0
        new_n1 = state.n1 + torch.as_tensor(boost, dtype=state.n1.dtype, device=state.n1.device)
        return dataclasses.replace(state, n1=new_n1), float(boost.sum())

    # ---- serde (the npz payload of a RepositoryIndex snapshot) -------------

    def to_arrays(self) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {}
        for k in sorted(self._n1):
            out[f"n1_{k}"] = self._n1[k]
            out[f"n_{k}"] = self._n[k]
        return out

    @classmethod
    def from_arrays(cls, arrays) -> "ChunkPriors":
        p = cls()
        for name in arrays:
            if name.startswith("n1_"):
                k = int(name[len("n1_"):])
                p._n1[k] = np.asarray(arrays[name], np.float64)
                p._n[k] = np.asarray(arrays[f"n_{k}"], np.float64)
        return p
