"""Host-side data pipelines: prefetch, the training token stream, the
frame labelling order.

Counterpart of ``repro.data.pipeline``.  ``DeterministicTokenPipeline``
draws each batch as a pure function of (seed, step, data shard) with the
port's copy of JAX's key stream (``core.prng``): ``fold_in(fold_in(
PRNGKey(seed), step), shard)`` then ``randint`` over the vocabulary, the
same int32 tokens as the reference's, so a resume from step k needs no
state but the step and the two packages train on the same batches.
``PrefetchPipeline`` runs a fetch callable on one worker thread, ``depth``
results ahead; ``close`` stops and joins it, and a fetch that raises
raises again from ``next``.  ``ShuffledFramePipeline`` visits frames in the
global random+ order (``core.chunks.global_randomplus_order``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.chunks import global_randomplus_order
from repro_torch.device import resolve


@dataclasses.dataclass
class PrefetchPipeline:
    """Double-buffered fetch-ahead around ``fetch``: ``submit`` queues frame
    ids, ``next`` returns ``(ids, fetch(ids))`` in submission order."""

    fetch: Callable[[np.ndarray], object]
    depth: int = 2

    def __post_init__(self):
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._pending: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            ids = self._pending.get()
            if ids is None:
                return
            try:
                self._q.put((ids, self.fetch(ids), None))
            except Exception as exc:          # handed to the caller of next()
                self._q.put((ids, None, exc))

    def submit(self, frame_ids: np.ndarray) -> None:
        self._pending.put(np.asarray(frame_ids))

    def next(self, timeout: float | None = None) -> tuple[np.ndarray, object]:
        ids, out, exc = self._q.get(timeout=timeout)
        if exc is not None:
            raise exc
        return ids, out

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker (results not yet taken are dropped) and join it."""
        self._pending.put(None)
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            with contextlib.suppress(queue.Empty):
                self._q.get_nowait()          # a worker blocked on a full queue
            self._thread.join(0.01)


@dataclasses.dataclass(frozen=True)
class TrainBatchSpec:
    global_batch: int
    seq_len: int
    vocab: int


class DeterministicTokenPipeline:
    """Synthetic-corpus token batches with O(1) resumable state: step k's
    batch is ``batch_at(k)`` on any host, every time."""

    def __init__(self, spec: TrainBatchSpec, *, seed: int = 0, data_shard: int = 0,
                 num_shards: int = 1, device=None):
        if spec.global_batch % num_shards:
            raise ValueError("global_batch must divide by num_shards")
        self.spec = spec
        self.seed = seed
        self.data_shard = data_shard
        self.num_shards = num_shards
        self.device = resolve(device)
        self._local_batch = spec.global_batch // num_shards

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        """``{"tokens", "labels"}``, int32 [local batch, seq_len], the labels
        the tokens shifted by one."""
        key = prng.fold_in(prng.fold_in(prng.PRNGKey(self.seed, self.device), step), self.data_shard)
        tokens = prng.randint(key, (self._local_batch, self.spec.seq_len + 1), 0, self.spec.vocab)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ShuffledFramePipeline:
    """Epoch-free frame scheduler for surrogate labelling: frames in the
    global random+ order, ``batch`` a call, wrapping around."""

    def __init__(self, total_frames: int, batch: int, *, seed: int = 0):
        self.order = global_randomplus_order(total_frames, seed=seed)
        self.batch = batch
        self.cursor = 0

    def next_ids(self) -> np.ndarray:
        ids = np.take(self.order, np.arange(self.cursor, self.cursor + self.batch), mode="wrap")
        self.cursor += self.batch
        return ids

    def state_dict(self) -> dict:
        return {"cursor": self.cursor}

    def load_state_dict(self, d: dict) -> None:
        self.cursor = int(d["cursor"])
