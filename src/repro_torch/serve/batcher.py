"""Request batcher, and the multi-query drivers' dedup and detection cache.

Counterpart of ``repro.serve.batcher``:

  * the host half, ``RequestBatcher`` (with ``PendingFrame`` and
    ``Batch``): frame requests merged into fixed-size batches, padded
    with sentinel frames, a late frame joining a later batch (a cohort is
    never a barrier); plain numpy, as the reference's;
  * the device half, ``dedup_first_index``, ``DetectionCache``,
    ``init_detection_cache``, ``cache_lookup`` and ``cache_insert``.
    Detections are any tree of tensors the port's detectors return (a
    ``Detections`` NamedTuple, or a dict), each leaf with a leading batch
    axis;
  * the hash-sharded cache of the composed Q × shards driver (DESIGN.md
    §14): frame ``f`` lives only on shard ``f % S``, at local slot
    ``(f // S) % L`` with L = capacity / S.  That placement is the
    direct-mapped slot array reshaped ``[L, S]`` and transposed, so the
    contents, evictions and hits equal one direct-mapped cache of the same
    capacity.  ``shard_cache_layout`` / ``unshard_cache_layout`` are the two
    sides of that bijection, ``scatter_cache`` / ``gather_cache`` the same
    split into one cache a shard of a mesh, and ``sharded_cache_lookup`` /
    ``sharded_cache_insert`` the home shard's halves of a routed lookup and
    insert; ``reshard_cache_host`` re-places a cache into a new capacity
    when an elastic shrink changes the padded one.

One difference in form: the reference's ``cache_insert`` returns a new
cache; the port updates the cache's tensors in place and returns the
same object, because a repository-sized cache (``cache=-1``) holds about
1 GB at the paper's full-size datasets, too much to copy every round.
For the same reason every tensor of the cache keeps one row past its
capacity: the scratch row that absorbs the writes ``cache_insert``
drops (see there).  Lookups never reach it.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class PendingFrame:
    frame_id: int
    chunk_id: int
    cohort: int
    enqueue_round: int


@dataclasses.dataclass
class Batch:
    frame_ids: np.ndarray     # i64[B] (sentinel = -1 padding)
    chunk_ids: np.ndarray     # i64[B]
    valid: np.ndarray         # bool[B]
    cohorts: np.ndarray       # i64[B]


class RequestBatcher:
    """Frame requests into batches of ``batch_size`` slots, oldest first,
    the remainder padded with sentinel frames (-1).  A queue shorter than a
    batch is ready once its oldest frame has waited ``max_wait_rounds``
    calls of ``next_batch``."""

    def __init__(self, batch_size: int, *, max_wait_rounds: int = 0):
        self.batch_size = batch_size
        self.max_wait_rounds = max_wait_rounds
        self._queue: collections.deque[PendingFrame] = collections.deque()
        self._round = 0
        self.stats = {"batches": 0, "padded_slots": 0, "frames": 0}

    def submit(self, frame_ids: Iterable[int], chunk_ids: Iterable[int], cohort: int) -> None:
        for f, c in zip(frame_ids, chunk_ids):
            self._queue.append(PendingFrame(int(f), int(c), cohort, self._round))

    def ready(self) -> bool:
        if not self._queue:
            return False
        if len(self._queue) >= self.batch_size:
            return True
        return (self._round - self._queue[0].enqueue_round) >= self.max_wait_rounds

    def next_batch(self) -> Optional[Batch]:
        """Emit up to ``batch_size`` frames, padding the remainder; None
        (and no stats) when the queue is empty.  Every call is a round."""
        self._round += 1
        if not self._queue:
            return None
        take = min(self.batch_size, len(self._queue))
        items = [self._queue.popleft() for _ in range(take)]
        pad = self.batch_size - take
        self.stats["batches"] += 1
        self.stats["padded_slots"] += pad
        self.stats["frames"] += take
        return Batch(
            frame_ids=np.asarray([i.frame_id for i in items] + [-1] * pad, np.int64),
            chunk_ids=np.asarray([i.chunk_id for i in items] + [-1] * pad, np.int64),
            valid=np.asarray([True] * take + [False] * pad, bool),
            cohorts=np.asarray([i.cohort for i in items] + [-1] * pad, np.int64),
        )

    @property
    def occupancy(self) -> float:
        """Share of emitted slots that carried a real frame: ``1 −
        padding_fraction()``, so 1.0 before any batch."""
        return 1.0 - self.padding_fraction()

    def padding_fraction(self) -> float:
        """Share of emitted slots that were padding (0.0 before any batch)."""
        b = self.stats["batches"]
        if not b:
            return 0.0
        return self.stats["padded_slots"] / (b * self.batch_size)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensor leaves of a NamedTuple, tuple, dict or a
    single tensor, with the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def dedup_first_index(frame_ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """i32[B] — for each slot, the index of the first valid slot holding
    the same frame id (its representative); invalid slots map to
    themselves.  So every valid slot gathers detections of exactly its own
    frame, and ``first_idx[i] == i`` marks one representative per distinct
    valid frame.  O(B²) compare; B = Q·C cohort slots."""
    b = frame_ids.shape[0]
    idx = torch.arange(b, dtype=torch.int32, device=frame_ids.device)
    same = (frame_ids[:, None] == frame_ids[None, :]) & valid[None, :]
    first = torch.where(same, idx[None, :], torch.full_like(same, b, dtype=torch.int32)).amin(dim=1)
    return torch.where(valid & (first < b), first, idx)


@dataclasses.dataclass(frozen=True)
class DetectionCache:
    """Direct-mapped cache of raw detector output on the device.

    ``tag[s]`` holds the frame id cached in slot ``s`` (-1 = empty);
    ``store`` is the detector's output tree with a leading slot axis.
    Frames map to slots by ``frame % capacity``, so a capacity of at least
    the repository's frame count is exact.  Every tensor has
    ``capacity + 1`` rows; the last is ``cache_insert``'s scratch row.
    """

    tag: torch.Tensor   # i32[S + 1] — cached frame id, -1 = empty
    store: Any          # detection tree, each leaf [S + 1, ...]

    @property
    def capacity(self) -> int:
        return self.tag.shape[0] - 1


def init_detection_cache(det_struct: Any, capacity: int, device=None) -> DetectionCache:
    """Empty cache for a detector whose single-frame output looks like
    ``det_struct`` (a tree of tensors; only their shape, dtype and, unless
    ``device`` is given, device are read).  Allocated once, at full size."""
    if device is None:
        leaves = []
        tree_map(leaves.append, det_struct)
        device = leaves[0].device
    store = tree_map(lambda s: torch.zeros((capacity + 1,) + tuple(s.shape), dtype=s.dtype,
                                           device=device), det_struct)
    return DetectionCache(tag=torch.full((capacity + 1,), -1, dtype=torch.int32, device=device),
                          store=store)


def cache_lookup(cache: DetectionCache, frame_ids: torch.Tensor):
    """(hit bool[B], detections tree with leading [B]) for each frame.
    Sentinel slots (``frame_ids < 0``) never hit: -1 maps to slot
    capacity-1 and would otherwise equal an empty slot's tag -1."""
    slot = torch.remainder(frame_ids, cache.capacity).long()
    hit = (frame_ids >= 0) & (cache.tag[slot] == frame_ids)
    return hit, tree_map(lambda x: x[slot], cache.store)


def cache_insert(cache: DetectionCache, frame_ids: torch.Tensor, dets: Any,
                 mask: torch.Tensor) -> DetectionCache:
    """Insert ``dets`` (leading [B]) for the masked frames, in place.

    When two masked frames collide on one slot within a batch the first
    wins (``dedup_first_index`` over slots).  Every other write, and every
    sentinel frame (``frame_ids < 0``, which never inserts whatever
    ``mask`` says), goes to the scratch row ``capacity``: so no slot is
    written twice and no write's winner is left to the device's scatter
    order, which CUDA leaves unspecified."""
    s = cache.capacity
    slot = torch.remainder(frame_ids, s).long()
    valid = mask & (frame_ids >= 0)
    first = dedup_first_index(slot, valid)
    keep = valid & (first == torch.arange(slot.shape[0], dtype=torch.int32, device=slot.device))
    tgt = torch.where(keep, slot, torch.full_like(slot, s))
    cache.tag[tgt] = frame_ids.to(cache.tag.dtype)
    tree_map(lambda st, v: st.__setitem__(tgt, v.to(st.dtype)), cache.store, dets)
    return cache


# ---------------------------------------------------------------------------
# Hash-sharded cache: one logical copy across the mesh (DESIGN.md §14)
# ---------------------------------------------------------------------------
#
# With total capacity S·L, frame f lives on home shard ``f % S`` at local
# slot ``(f // S) % L``.  Writing r = f % (S·L) for the direct-mapped slot,
# the home is ``r % S`` and the local slot ``r // S``: the sharded layout is
# the direct-mapped slot array reshaped [L, S] and transposed to [S, L].
# Two frames collide under it iff f1 ≡ f2 (mod S·L), the direct-mapped
# cache's collision classes, so contents, evictions and hits are the same.


def _cache_local_cap(capacity: int, num_shards: int) -> int:
    if capacity % num_shards:
        raise ValueError(
            f"hash-sharded cache capacity {capacity} must be a multiple of {num_shards} shards — pad the "
            "capacity before init/warm (a non-divisible capacity would silently mis-place frames)")
    return capacity // num_shards


def _with_scratch(x: torch.Tensor, fill) -> torch.Tensor:
    """``x`` with one more row, the scratch row, filled with ``fill``."""
    return torch.cat([x, torch.full((1,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)])


def _cache_from_rows(tag: torch.Tensor, store: Any) -> DetectionCache:
    """A cache of the port's layout from ``[capacity, ...]`` rows: the
    scratch row appended (tag -1, zeros)."""
    return DetectionCache(tag=_with_scratch(tag, -1), store=tree_map(lambda x: _with_scratch(x, 0), store))


def _permute(cache: DetectionCache, fn) -> DetectionCache:
    cap = cache.capacity
    return _cache_from_rows(fn(cache.tag[:cap]), tree_map(lambda x: fn(x[:cap]), cache.store))


def shard_cache_layout(cache: DetectionCache, num_shards: int) -> DetectionCache:
    """A direct-mapped cache permuted into the hash-sharded global layout:
    row ``s·L + j`` holds direct-mapped slot ``j·S + s``, so rows
    ``[s·L, (s+1)·L)`` are shard s's home entries (frames with ``f % S ==
    s``) at local slot ``(f // S) % L``.  A pure transposition, undone by
    :func:`unshard_cache_layout`."""
    local = _cache_local_cap(cache.capacity, num_shards)
    return _permute(cache, lambda x: x.reshape((local, num_shards) + x.shape[1:]).transpose(0, 1)
                    .reshape(x.shape))


def unshard_cache_layout(cache: DetectionCache, num_shards: int) -> DetectionCache:
    """Inverse of :func:`shard_cache_layout`: back to the direct-mapped
    layout that ``cache_lookup``, the index's publish and the tests read."""
    local = _cache_local_cap(cache.capacity, num_shards)
    return _permute(cache, lambda x: x.reshape((num_shards, local) + x.shape[1:]).transpose(0, 1)
                    .reshape(x.shape))


def scatter_cache(cache: DetectionCache, mesh) -> list[DetectionCache]:
    """A direct-mapped cache split over ``mesh``: shard s's local cache,
    on its device, holds the rows ``[s·L, (s+1)·L)`` of
    :func:`shard_cache_layout` and a scratch row of its own.  One copy of
    the cache in all."""
    s_n = mesh.size
    local = _cache_local_cap(cache.capacity, s_n)
    cap = cache.capacity

    def part(x: torch.Tensor, s: int, dev) -> torch.Tensor:
        return x[:cap].reshape((local, s_n) + x.shape[1:])[:, s].to(dev)

    return [_cache_from_rows(part(cache.tag, s, d), tree_map(lambda x: part(x, s, d), cache.store))
            for s, d in enumerate(mesh.devices)]


def gather_cache(caches: list[DetectionCache], mesh) -> DetectionCache:
    """Inverse of :func:`scatter_cache`: the shards' local caches joined
    into one direct-mapped cache on ``mesh.device``."""
    local = caches[0].capacity

    def join(xs: list[torch.Tensor]) -> torch.Tensor:
        st = torch.stack([x[:local].to(mesh.device) for x in xs], dim=1)   # [L, S, ...]
        return st.reshape((local * len(xs),) + st.shape[2:])

    return _cache_from_rows(join([c.tag for c in caches]),
                            tree_map(lambda *xs: join(list(xs)), caches[0].store, *(c.store for c in caches[1:])))


def reshard_cache_host(cache: DetectionCache, new_capacity: int) -> DetectionCache:
    """Re-place a direct-mapped cache into a new capacity on the host:
    occupied entries go to ``frame % new_capacity`` in ascending frame-id
    order, the first occupant of a slot winning (``RepositoryIndex.warm``'s
    convention), so an elastic shrink that changes the padded capacity
    replays the same way.  The same object when the capacity already
    matches.  The result lies on the input's device."""
    if new_capacity == cache.capacity:
        return cache
    if new_capacity < 1:
        raise ValueError(f"new_capacity must be >= 1, got {new_capacity}")
    cap = cache.capacity
    tag = cache.tag[:cap].cpu().numpy()
    occupied = np.flatnonzero(tag >= 0)
    order = occupied[np.argsort(tag[occupied], kind="stable")]
    slots = tag[order].astype(np.int64) % new_capacity
    # the first of each slot in ascending frame order
    _, first = np.unique(slots, return_index=True)
    src, dst = order[first], slots[first]
    dev = cache.tag.device
    src_t, dst_t = torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev)

    def place(x: torch.Tensor, fill) -> torch.Tensor:
        out = torch.full((new_capacity + 1,) + x.shape[1:], fill, dtype=x.dtype, device=dev)
        out[dst_t] = x[src_t]
        return out

    return DetectionCache(tag=place(cache.tag, -1), store=tree_map(lambda x: place(x, 0), cache.store))


def _home_slot(frame_ids: torch.Tensor, num_shards: int, local: int):
    """(frames homed on which shard, their local slot); -1's slot is a
    valid row that no caller reads as a hit."""
    return (torch.remainder(frame_ids, num_shards),
            torch.remainder(torch.div(frame_ids, num_shards, rounding_mode="floor"), local).long())


def sharded_cache_lookup(cache_local: DetectionCache, frame_ids: torch.Tensor, shard_id: int, num_shards: int):
    """The home shard's half of the routed lookup: serve the probes homed
    here (``frame % S == shard_id``); every other probe, and every
    sentinel, misses (its gathered values are never read).  ``frame_ids``
    of any shape; returns (hit bool, detections with ``frame_ids``'s
    leading shape)."""
    home, slot = _home_slot(frame_ids, num_shards, cache_local.capacity)
    mine = (frame_ids >= 0) & (home == shard_id)
    hit = mine & (cache_local.tag[slot] == frame_ids)
    return hit, tree_map(lambda x: x[slot], cache_local.store)


def sharded_cache_insert(cache_local: DetectionCache, frame_ids: torch.Tensor, dets: Any, mask: torch.Tensor,
                         shard_id: int, num_shards: int) -> DetectionCache:
    """The home shard's half of the routed insert, in place: the masked
    frames of a flat ``[B]`` batch homed here go to their local slots, the
    first of a within-batch slot collision winning in batch order (the
    winner ``cache_insert`` picks over the same global batch); every other
    write goes to the scratch row."""
    local = cache_local.capacity
    home, slot = _home_slot(frame_ids, num_shards, local)
    valid = mask & (frame_ids >= 0) & (home == shard_id)
    first = dedup_first_index(slot, valid)
    keep = valid & (first == torch.arange(slot.shape[0], dtype=torch.int32, device=slot.device))
    tgt = torch.where(keep, slot, torch.full_like(slot, local))
    cache_local.tag[tgt] = frame_ids.to(cache_local.tag.dtype)
    tree_map(lambda st, v: st.__setitem__(tgt, v.to(st.dtype)), cache_local.store, dets)
    return cache_local
