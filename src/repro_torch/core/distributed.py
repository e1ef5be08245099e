"""The merge of per-worker sampler deltas (paper §3.7.1).

Counterpart of ``merge_deltas`` in ``repro.core.distributed``; the rest of
that module (the mesh's cohort choice and its collectives) comes with the
mesh slice of the port.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.state import SamplerState


def merge_deltas(state: SamplerState, delta_n1: torch.Tensor, delta_n: torch.Tensor) -> SamplerState:
    """``state`` plus per-worker delta statistics: ``delta_*`` are stacked
    ``[W, M]`` updates or a single ``[M]`` delta, summed over the worker
    axis.  The updates are additive, so the merge is exact in any
    interleaving."""
    d1 = torch.atleast_2d(delta_n1).sum(dim=0)
    dn = torch.atleast_2d(delta_n).sum(dim=0)
    return dataclasses.replace(state, n1=state.n1 + d1, n=state.n + dn)
