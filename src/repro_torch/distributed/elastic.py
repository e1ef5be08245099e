"""Elastic scaling of the search's data mesh: reshape without losing state.

Counterpart of ``repro.distributed.elastic`` for the search's half:
``plan_resize`` with an empty schema (the search shards no parameters, so
the check is the data-parallel batch divisibility that
``ElasticShardedRunner`` needs) and ``resize_chunk_stats``.  The
parameter half, ``apply_resize`` and ``_sharded_dims``, reads a model's
schema and sharding rules; it comes with the training slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_mesh: object
    new_mesh: object
    issues: tuple

    @property
    def feasible(self) -> bool:
        return not self.issues


def plan_resize(schema, new_mesh, *, global_batch: Optional[int] = None, old_mesh=None) -> ElasticPlan:
    """Validate a move onto ``new_mesh`` (a ``DataMesh``): the global batch
    must divide over its data-parallel shards.  ``schema`` must be empty
    (``{}``): sharded parameters come with the training slice."""
    if schema:
        raise NotImplementedError("plan_resize over model parameters comes with the training slice of the port; "
                                  "the search passes an empty schema")
    issues = []
    dp = new_mesh.size
    if global_batch is not None and global_batch % dp:
        issues.append(f"global_batch {global_batch} not divisible by dp={dp}")
    return ElasticPlan(old_mesh=old_mesh, new_mesh=new_mesh, issues=tuple(issues))


def resize_chunk_stats(n1, n, frames, new_shards: int):
    """Strip the padding of an earlier shard count, then re-pad the chunk
    statistics for ``new_shards``.

    ``pad_chunks`` appends dummy chunks with the exhausted fill n1 = 0,
    n = 1, frames = 0.  The trailing run of such columns is stripped first
    (a column of ``[Q, M]`` statistics only if it is the fill for every
    query), so the padding never stacks across successive resizes; an
    interior column that happens to match the fill stays.  On the last
    axis, as ``pad_chunks``; the results lie on ``n1``'s device."""
    if new_shards < 1:
        raise ValueError(f"new_shards must be >= 1, got {new_shards}")
    h_n1, h_n, h_frames = (torch.as_tensor(x).detach().cpu().numpy() for x in (n1, n, frames))
    dummy = (h_n1 == 0) & (h_n == 1) & (h_frames == 0)
    if dummy.ndim > 1:
        dummy = dummy.all(axis=tuple(range(dummy.ndim - 1)))
    m = h_n1.shape[-1]
    while m > 0 and dummy[m - 1]:
        m -= 1
    pad = (-m) % new_shards
    dev = torch.as_tensor(n1).device

    def f(x: np.ndarray, fill) -> torch.Tensor:
        out = np.concatenate([x[..., :m], np.full(x.shape[:-1] + (pad,), fill, x.dtype)], axis=-1)
        return torch.as_tensor(out, device=dev)

    return f(h_n1, 0), f(h_n, 1), f(h_frames, 0)
