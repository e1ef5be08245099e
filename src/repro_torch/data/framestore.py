"""Frame store: the random-access decode layer (paper §4.1).

Counterpart of ``repro.data.framestore``.  The paper re-encodes videos
with a keyframe every 20 frames to make random reads cheap; the store
models that access pattern over the synthetic repository: ``fetch``
returns the frame's embedding (``sim.frame_embedding``, the stand-in for
decoded pixels) and ``decode_cost`` the distance to the previous keyframe
plus one, in decode units.  ``ShardedFrameStore`` gives each host a
contiguous stripe of the frames.  No search driver reads them; a
deployment swaps a real decoder in behind the same interface.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol

import torch

from repro_torch.sim.oracle import frame_embedding
from repro_torch.sim.repository import Repository


class FrameStore(Protocol):
    """Interface every frame source implements."""

    def fetch(self, frame_ids: torch.Tensor) -> torch.Tensor:
        """f32[B, ...] frame payloads for i32[B] global frame ids."""
        ...

    def decode_cost(self, frame_ids: torch.Tensor) -> torch.Tensor:
        """f32[B] decode-unit cost a fetch (for the cost model)."""
        ...


def _ids(repo: Repository, frame_ids) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(frame_ids, device=repo.inst_feat.device))


@dataclasses.dataclass(frozen=True)
class SimFrameStore:
    """Embedding-backed store over a synthetic repository."""

    repo: Repository
    embed_dim: int
    patches: int = 0
    keyframe_every: int = 20

    def fetch(self, frame_ids) -> torch.Tensor:
        return torch.stack([frame_embedding(self.repo, f, dim=self.embed_dim, patches=self.patches)
                            for f in _ids(self.repo, frame_ids)])

    def decode_cost(self, frame_ids) -> torch.Tensor:
        off = torch.remainder(_ids(self.repo, frame_ids), self.keyframe_every)
        return (off + 1).float()


@dataclasses.dataclass(frozen=True)
class ShardedFrameStore:
    """Multi-host wrapper: each host owns a contiguous stripe of frames and
    fetches only local ids; a remote id gives a zero payload and a False
    mask bit, so a caller can tell it from a local zero embedding.  In the
    production layout the scheduler routes cohorts to the owner, so remote
    fetches stay off the hot path."""

    inner: SimFrameStore
    host_id: int
    num_hosts: int

    def _stripe(self) -> int:
        return -(-self.inner.repo.total_frames // self.num_hosts)

    def _local(self, ids: torch.Tensor) -> torch.Tensor:
        total, stripe = self.inner.repo.total_frames, self._stripe()
        lo = self.host_id * stripe
        return (ids >= lo) & (ids < min(lo + stripe, total))

    def local_mask(self, frame_ids) -> torch.Tensor:
        """bool[B]: True where this host owns the frame.  The last stripe
        may be short; ids past the repository's end are no host's."""
        return self._local(_ids(self.inner.repo, frame_ids))

    def fetch(self, frame_ids):
        """``(payload, local_mask)``: remote lanes zeroed and marked False."""
        ids = _ids(self.inner.repo, frame_ids)
        payload = self.inner.fetch(ids)
        mask = self._local(ids)
        return payload * mask.reshape(mask.shape + (1,) * (payload.dim() - 1)), mask

    def decode_cost(self, frame_ids) -> torch.Tensor:
        ids = _ids(self.inner.repo, frame_ids)
        return self.inner.decode_cost(ids) * self._local(ids)

    def owner_of(self, frame_ids) -> torch.Tensor:
        return torch.div(_ids(self.inner.repo, frame_ids), self._stripe(), rounding_mode="floor").int()
