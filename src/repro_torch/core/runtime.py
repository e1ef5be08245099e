"""Asynchronous search runtime: worker threads around Algorithm 1.

Counterpart of ``repro.core.runtime``: both async tiers and the elastic
mesh's runner.

  * :class:`AsyncSearchDriver`, one query: the driver owns the carry and
    issues cohorts of chunks chosen from its freshest statistics; N
    workers process a cohort each against a snapshot of the carry
    (``_process_cohort``, frame after frame) and hand back delta
    statistics and their ring; the driver merges them commutatively
    (``merge_deltas``, ``merge_matcher_checked``), at most once a cohort,
    and re-issues the cohorts of dead or straggling workers
    (``HeartbeatMonitor``).
  * :class:`AsyncMultiSearchDriver`, a leading-``[Q]`` carry: workers
    check out per-query cohort slots (a precomputed ``RoundChoice``),
    process whichever slots are in flight through one shared dedup,
    detection-cache lookup and detector call (``multi_round_process``),
    and the driver replaces each query's row by its post-round state.  At
    most one slot a query is in flight, so each query's trajectory equals
    its solo scan run at any worker count (deterministic detector).

Both spill ring evictions to a host ``ResultLog`` at merge boundaries.

:class:`ElasticShardedRunner` drives the composed mesh kind in bounded
slices of sync windows and shrinks the mesh when a worker's heartbeat
stops (DESIGN.md §14).

**One thread queues work at a time.**  A reference worker makes one
jitted call a cohort or batch; a port worker queues its cohort's or
batch's operations one by one from Python (~130 a frame, ~1,700 a slot
batch of 2 lanes at 50 cohorts).  Each operation releases and retakes
the interpreter lock, so threads queueing together hand it over at every
operation.  A worker therefore takes its snapshot and queues its work
under the driver's lock, the one ``_issue_ready`` and ``_merge`` hold,
and reads its results after releasing it.  On the card queueing is all
the lock covers: the device runs one worker's work while the next
queues its own.  The scheduling is the reference's: a worker's snapshot
may predate merges still to come, and merges land in completion order.

**On the card.**  Each worker thread runs on its own CUDA stream, and the
kernel wrappers launch on the calling thread's current stream.  A
worker's stream waits for the driver's stream before it reads a snapshot
or a batch; a worker synchronizes its stream before it hands a result
over, and the driver marks the result's tensors as used on its stream
(``record_stream``) before it reads them, so the caching allocator never
gives their memory back to a worker while the driver's reads are queued.
The kernels are built before the pool starts.

**The shared detection cache.**  The reference's worker reads an
immutable snapshot of the cache and only the driver's merge publishes
into it.  The port's cache is updated in place, so a worker never writes
it: it takes the lookup-only path of ``multi_round_process`` with the
cache's answer for its frames, looked up at the start of its batch under
the driver's lock and, on the card, queued on the driver's stream, the
stream every merge's ``cache_insert`` is queued on under the same lock.
A lookup therefore sees the cache between two whole merges, as a
reference worker sees its snapshot, and never a slot whose tag is
written but whose detections are not.

**A worker's exception** reaches the driver, which raises it from
``run()`` and ``service_tick()``.  (The reference's worker thread dies
with it and ``run()`` returns a partial carry after a 60 s wait; ROADMAP
C11.)
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import queue
import threading
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.chunks import ChunkIndex
from repro_torch.core.distributed import merge_deltas
from repro_torch.core.exsample import (
    ExSampleCarry,
    RoundAux,
    RoundChoice,
    SelectFn,
    _process_frame,
    detection_struct,
    multi_round_choose,
    multi_round_process,
    stack_carries,
)
from repro_torch.core.matcher import MatcherState, ResultLog, eviction_mask, merge_matcher_checked
from repro_torch.core.state import SamplerState
from repro_torch.core.thompson import choose_chunks
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.serve.batcher import cache_insert, cache_lookup, init_detection_cache

# the CUDA sources the async paths launch from (B1/B2's fused round, B3's fused step)
_SOURCES = ("thompson_choose", "iou_matrix")


class MatcherRingOverflow(RuntimeError):
    """A worker inserted at least ``capacity`` results between snapshot
    and merge: its own ring wrapped and overwrote entries before they
    could be merged, which no spill recovers.  Raised instead of silently
    under-counting.  Evictions on the destination side are recoverable
    and spill to the host ``ResultLog``."""


@dataclasses.dataclass
class _Failure:
    """A worker's exception, on its way to the driver."""

    worker_id: int
    error: BaseException


def _tensors(obj):
    """Every tensor in a tree of tensors, tuples, lists, dicts and
    dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _lane(c: ExSampleCarry, i: int) -> ExSampleCarry:
    """Row ``i`` of a leading-[Q] carry (views)."""
    def take(state):
        return dataclasses.replace(state, **{
            f.name: getattr(state, f.name)[i] for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)})

    return ExSampleCarry(sampler=take(c.sampler), matcher=take(c.matcher), key=c.key[i],
                         step=c.step[i], results=c.results[i])


class _Streams:
    """The driver's CUDA stream and the workers' streams; on the CPU
    every method is a no-op."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.driver = torch.cuda.current_stream(device) if self.cuda else None

    def new(self):
        return torch.cuda.Stream(self.device) if self.cuda else None

    @staticmethod
    def on(stream):
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def on_driver(self):
        return self.on(self.driver)

    def wait_for_driver(self) -> None:
        """The calling thread's stream waits for the work queued so far on
        the driver's stream."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.driver)

    def finish(self) -> None:
        """The calling thread waits for its own stream's work."""
        if self.cuda:
            torch.cuda.current_stream(self.device).synchronize()

    def used_here(self, *trees) -> None:
        """The tensors of ``trees`` are read on the calling thread's
        stream: their memory goes back to the allocator only after it."""
        if self.cuda:
            stream = torch.cuda.current_stream(self.device)
            for t in (t for tree in trees for t in _tensors(tree)):
                if t.device.type == "cuda":
                    t.record_stream(stream)

    def build_kernels(self) -> None:
        """Build and load the kernels the async paths launch, before any
        worker thread does."""
        if self.cuda:
            from repro_torch.kernels.build import load

            for name in _SOURCES:
                load(name)


def _raise_failure(res) -> None:
    if isinstance(res, _Failure):
        res.error.add_note(f"raised in async worker {res.worker_id}")
        raise res.error


# ---------------------------------------------------------------------------
# Single-query tier
# ---------------------------------------------------------------------------


def _process_cohort(carry: ExSampleCarry, chunks: ChunkIndex, chunk_ids: torch.Tensor,
                    det_keys: torch.Tensor, *, detector: Callable) -> ExSampleCarry:
    """A whole cohort, frame after frame through ``_process_frame``:
    ``chunk_ids`` i32[B], ``det_keys`` int64[B, 2].  The reference folds
    the same frames under one ``lax.fori_loop``."""
    for i in range(chunk_ids.shape[0]):
        carry = _process_frame(carry, chunks, detector, chunk_ids[i], det_keys[i])
    return carry


@dataclasses.dataclass
class Cohort:
    cohort_id: int
    chunk_ids: np.ndarray      # i32[B]
    issue_count: int = 0       # > 0: re-issued (straggler or death)


@dataclasses.dataclass
class WorkerResult:
    cohort_id: int
    worker_id: int
    delta_n1: torch.Tensor
    delta_n: torch.Tensor
    new_results: int
    frames: int
    matcher: Optional[MatcherState] = None       # the worker's ring after the cohort
    snap_matcher: Optional[MatcherState] = None  # the ring at the snapshot


class AsyncSearchDriver:
    """Cohort scheduler and owner of one query's carry; thread-safe,
    barrier-free."""

    def __init__(self, carry: ExSampleCarry, chunks: ChunkIndex, detector: Callable, *,
                 cohort_size: int = 8, num_workers: int = 4, result_limit: int = 50,
                 max_frames: int = 100_000, straggler_factor: float = 4.0):
        self.carry = carry
        self.chunks = chunks
        self.detector = detector
        self.cohort_size = cohort_size
        self.result_limit = result_limit
        self.max_frames = max_frames
        self.monitor = HeartbeatMonitor(straggler_factor=straggler_factor)
        self._lock = threading.Lock()
        self._work: "queue.Queue[Optional[Cohort]]" = queue.Queue()
        self._results: "queue.Queue" = queue.Queue()
        self._next_cohort = 0
        self._inflight: dict[int, Cohort] = {}
        self.num_workers = num_workers
        self.result_log = ResultLog()
        self._device = carry.step.device
        self._streams = _Streams(self._device)
        # every counter exists from construction, for SearchStats
        self.stats = {"cohorts": 0, "reissues": 0, "merges": 0, "duplicate_drops": 0,
                      "merge_high_water": 0, "spilled": 0}

    # ---- driver side -------------------------------------------------------

    def _issue_cohort(self) -> None:
        """Choose the next cohort from the carry's statistics with the
        exact Gamma sampler (the reference's ``choose_chunks`` default),
        keyed by ``fold_in(carry.key, cohort_id)``."""
        with self._lock, self._streams.on_driver():
            key = prng.fold_in(self.carry.key, self._next_cohort)
            chunk_ids = choose_chunks(key, self.carry.sampler, cohorts=self.cohort_size,
                                      method="exact").cpu().numpy()
            cohort = Cohort(self._next_cohort, chunk_ids)
            self._next_cohort += 1
            self._inflight[cohort.cohort_id] = cohort
            self.stats["cohorts"] += 1
        self._work.put(cohort)

    def _merge(self, res: WorkerResult) -> None:
        """Fold one worker result into the carry, sampler deltas, counters
        and ring under one lock acquisition, at most once a cohort (a
        re-issued cohort's second completion is dropped and counted in
        ``stats["duplicate_drops"]``).  Live destination entries the
        appended window overwrites spill to ``self.result_log`` first; a
        source ring that wrapped (at least ``capacity`` insertions since
        the snapshot) raises ``MatcherRingOverflow`` and commits nothing."""
        with self._lock, self._streams.on_driver():
            if res.cohort_id not in self._inflight:
                self.stats["duplicate_drops"] += 1
                return
            del self._inflight[res.cohort_id]
            self._streams.used_here(res)
            sampler = merge_deltas(self.carry.sampler, res.delta_n1, res.delta_n)
            matcher = self.carry.matcher
            if res.matcher is not None:
                inserted = int(res.matcher.total_inserted - res.snap_matcher.total_inserted)
                self.stats["merge_high_water"] = max(self.stats["merge_high_water"], inserted)
                if inserted >= matcher.capacity:
                    raise MatcherRingOverflow(
                        f"cohort {res.cohort_id}: {inserted} insertions into a capacity-"
                        f"{matcher.capacity} result ring wrapped the source ring (unrecoverable) — "
                        "size max_results above the per-cohort insertion bound")
                if inserted:
                    self.stats["spilled"] += self.result_log.spill(matcher, eviction_mask(matcher, inserted))
                matcher, _ = merge_matcher_checked(matcher, res.matcher, res.snap_matcher)
            self.carry = dataclasses.replace(
                self.carry, sampler=sampler, matcher=matcher,
                step=self.carry.step + res.frames, results=self.carry.results + res.new_results)
            self.stats["merges"] += 1

    def _reissue(self, cohort_id: int) -> None:
        with self._lock:
            cohort = self._inflight.get(cohort_id)
            if cohort is None:
                return
            cohort.issue_count += 1
            self.stats["reissues"] += 1
        self._work.put(cohort)

    # ---- worker side -------------------------------------------------------

    def _process_one(self, wid: int, cohort: Cohort) -> WorkerResult:
        """Process one cohort against a snapshot of the carry; every delta
        is taken against that snapshot.  The snapshot and the cohort's
        work are taken and queued under the lock (see the module's note);
        the result is read after it.  Pure of scheduling, so tests drive
        it synchronously.  The frames' keys are
        ``fold_in(fold_in(PRNGKey(7), cohort_id), i)``."""
        dev = self._device
        b = len(cohort.chunk_ids)
        with self._lock:
            snapshot = self.carry
            self._streams.wait_for_driver()
            base = prng.fold_in(prng.PRNGKey(7, device=dev), cohort.cohort_id)
            # split(base, b)[i] is threefry2x32(base, (0, i)): fold_in(base, i)
            det_keys = prng.split(base, b)
            local = _process_cohort(snapshot, self.chunks,
                                    torch.tensor(cohort.chunk_ids, dtype=torch.int32, device=dev),
                                    det_keys, detector=self.detector)
            new_results = local.results - snapshot.results
        res = WorkerResult(
            cohort_id=cohort.cohort_id, worker_id=wid,
            delta_n1=local.sampler.n1 - snapshot.sampler.n1,
            delta_n=local.sampler.n - snapshot.sampler.n,
            new_results=int(new_results), frames=b,
            matcher=local.matcher, snap_matcher=snapshot.matcher)
        self._streams.finish()
        return res

    def _worker(self, wid: int) -> None:
        self.monitor.register(wid, now=time.monotonic())
        with self._streams.on(self._streams.new()):
            while True:
                cohort = self._work.get()
                if cohort is None:
                    return
                t0 = time.monotonic()
                self.monitor.assign(wid, cohort.cohort_id, now=t0)
                try:
                    res = self._process_one(wid, cohort)
                except BaseException as e:  # noqa: BLE001 — handed to the driver, which raises it
                    self._results.put(_Failure(wid, e))
                    return
                self._results.put(res)
                now = time.monotonic()
                self.monitor.heartbeat(wid, now)
                self.monitor.record_completion(wid, now - t0, now=now)

    # ---- run loop ----------------------------------------------------------

    def run(self) -> ExSampleCarry:
        """Run workers until ``result_limit`` results or ``max_frames``
        frames; returns the carry.  A worker's exception is raised here."""
        self._streams.build_kernels()
        threads = [threading.Thread(target=self._worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        # keep the pipeline full: workers + 1 outstanding cohorts
        for _ in range(self.num_workers + 1):
            self._issue_cohort()
        try:
            while int(self.carry.results) < self.result_limit and int(self.carry.step) < self.max_frames:
                try:
                    res = self._results.get(timeout=60.0)
                except queue.Empty:
                    break
                _raise_failure(res)
                self._merge(res)
                for cid in self.monitor.sweep(time.monotonic())["reissue_cohorts"]:
                    self._reissue(cid)
                self._issue_cohort()
        finally:
            # a raising merge must not leak blocked worker threads
            for _ in threads:
                self._work.put(None)
            for t in threads:
                t.join(timeout=5.0)
        return self.carry


# ---------------------------------------------------------------------------
# Slot-based scheduler over a leading-[Q] carry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SlotBatch:
    """A checked-out set of per-query cohort slots (at most one a query).
    ``carry`` holds the gathered rows at issue time and ``choice`` the
    precomputed choose half, so a re-issued batch reprocesses the same
    work item."""

    batch_id: int
    query_rows: np.ndarray      # i32[B] — driver row of each lane
    carry: ExSampleCarry        # gathered rows, leading [B]
    choice: RoundChoice         # leading [B]
    active: np.ndarray          # bool[B] — False: a padding lane
    select_ids: Optional[np.ndarray] = None   # i32[B] — the id select() sees a lane as
    issue_count: int = 0        # > 0: re-issued (straggler or death)


@dataclasses.dataclass
class SlotResult:
    batch_id: int
    worker_id: int
    carry: ExSampleCarry        # post-round rows, leading [B]
    fresh_calls: int            # unique, uncached frames detected
    cache_hits: int
    aux: RoundAux               # the fresh detections, for the merge's cache insert


@dataclasses.dataclass
class _QueryRow:
    """One query's slot in the pool: its carry and the accounting a
    service reports per tenant (detector calls and cache hits attributed
    by dedup representative, result stamps, admission metadata).
    ``select_id`` is the id ``select`` sees instead of the row index;
    ``vacant`` marks a released slot ``admit()`` may reuse."""

    carry: ExSampleCarry        # single-query carry (0-dim step/results)
    limit: int                  # distinct-result target
    budget: int                 # frame budget of this query
    trace: list
    log: ResultLog
    active: bool = True         # False: retired (finished or vacated)
    inflight: bool = False      # a slot of this query is checked out
    rounds: int = 0             # rounds merged so far
    vacant: bool = False        # released, reusable by admit()
    select_id: Optional[int] = None
    fresh_calls: int = 0        # detector invocations attributed to this row
    cache_hits: int = 0         # cache hits attributed to this row
    index_hits: int = 0         # cache hits served by index-warmed frames
    warm_rounds_saved: int = 0  # warm-up rounds the prior injection stands for
    admitted_s: float = 0.0     # monotonic clock at admission
    first_result_s: float = 0.0  # monotonic clock of the first merge with a result
    finished_s: float = 0.0     # monotonic clock at retirement
    result_stamps: list = dataclasses.field(default_factory=list)  # (clock, results) per growing merge


class AsyncMultiSearchDriver:
    """Slot scheduler: async workers over a leading-[Q] carry.

    The driver owns Q query rows.  ``_issue_ready`` checks out a cohort
    slot for every issuable query (the precomputed ``RoundChoice`` and the
    row's snapshot), ``slots_per_batch`` slots a ``SlotBatch``; workers
    run the shared dedup, cache lookup and detector call
    (``_process_batch``); ``_merge`` inserts the fresh detections into the
    shared cache, spills ring evictions to each row's ``ResultLog`` and
    replaces each lane's row by its post-round state, at most once a
    batch.  Rounds of one query serialize, so with a deterministic
    detector each query's (step, results, trace, sampler, ring, key)
    trajectory equals its solo scan run at any worker count.

    A finished query retires its row; ``admit()`` installs a new one
    mid-flight, its frame budget debited by the pool rounds it missed.
    Batches keep ``slots_per_batch`` lanes, padded with inactive ones.
    The constructor rejects a ring smaller than one round's insertion
    bound (cohorts × detector slots a frame), the only way a source ring
    could wrap between issue and merge, so this path never raises
    ``MatcherRingOverflow``.

    ``method`` is the choose half's Thompson sampler; the plan gives
    ``"exact"``, and ``"wilson_hilferty"`` or ``"pallas"`` make every
    query's trajectory equal the reference's for the same keys."""

    def __init__(self, carries: ExSampleCarry, chunks: ChunkIndex, detector: Callable, *,
                 cohorts: int = 1, num_workers: int = 4,
                 result_limits: Union[int, Sequence[int]] = 50, max_steps: int = 100_000,
                 method: str = "exact", select: Optional[SelectFn] = None, cache_frames: int = 0,
                 trace_every: int = 0, slots_per_batch: Optional[int] = None,
                 straggler_factor: float = 4.0, index=None):
        if carries.step.dim() != 1:
            raise ValueError("AsyncMultiSearchDriver needs a leading-[Q] carry (init_carry_multi / "
                             "stack_carries); got a single-query carry")
        q_n = int(carries.step.shape[0])
        if isinstance(result_limits, (int, np.integer)):
            limits = [int(result_limits)] * q_n
        else:
            limits = [int(v) for v in np.asarray(result_limits).reshape(-1)]
            if len(limits) != q_n:
                raise ValueError(f"result_limits has {len(limits)} entries for a {q_n}-query carry")
        self.chunks = chunks
        self.detector = detector
        self.select = select
        self.cohorts = cohorts
        self.method = method
        self.max_steps = max_steps
        self.trace_every = trace_every
        self.num_workers = num_workers
        self.slots_per_batch = (max(1, math.ceil(q_n / max(num_workers, 1))) if slots_per_batch is None
                                else max(1, slots_per_batch))
        self.monitor = HeartbeatMonitor(straggler_factor=straggler_factor)
        self._lock = threading.Lock()
        self._work: "queue.Queue[Optional[SlotBatch]]" = queue.Queue()
        self._results: "queue.Queue" = queue.Queue()
        self._next_batch = 0
        self._inflight: dict[int, SlotBatch] = {}
        self._device = carries.step.device
        self._streams = _Streams(self._device)
        now0 = time.monotonic()
        self.rows = [_QueryRow(carry=_lane(carries, q), limit=limits[q], budget=max_steps, trace=[],
                               log=ResultLog(), admitted_s=now0) for q in range(q_n)]
        self._threads: list[threading.Thread] = []
        struct = detection_struct(detector, carries.key[0])
        det_slots = int(struct.valid.shape[-1]) if hasattr(struct, "valid") else None
        capacity = int(carries.matcher.times_seen.shape[-1])
        if det_slots is not None and cohorts * det_slots >= capacity:
            raise ValueError(
                f"matcher capacity {capacity} does not cover one round's insertion bound "
                f"(cohorts={cohorts} × {det_slots} detector slots per frame): the ring could wrap "
                "inside a merge window, which no spill can recover — raise max_results or lower cohorts")
        self.index = index
        self._warm_frames: frozenset = frozenset()
        if cache_frames:
            if index is not None:
                # an empty tier warms a cache equal to init_detection_cache
                self.cache, self._warm_frames = index.warm(struct, cache_frames, device=self._device)
            else:
                self.cache = init_detection_cache(struct, cache_frames, device=self._device)
        else:
            self.cache = None
        self._warm_arr = np.asarray(sorted(self._warm_frames), np.int64) if self._warm_frames else None
        # every counter exists from construction, for SearchStats
        self.stats = {
            "slots": 0, "merges": 0, "reissues": 0, "duplicate_drops": 0,
            "merge_high_water": 0, "rounds": 0, "spilled": 0,
            "detector_invocations": 0, "cache_hits": 0, "index_hits": 0,
            # lanes of the emitted batches that carried a live query, and padding
            "lanes_issued": 0, "lanes_padded": 0,
        }

    # ---- row liveness / elasticity ----------------------------------------

    def _row_live(self, row: _QueryRow) -> bool:
        """The solo driver's continue test, per row."""
        return (int(row.carry.results) < row.limit and int(row.carry.step) < row.budget
                and not bool(torch.all(row.carry.sampler.exhausted())))

    def _retire(self, row: _QueryRow) -> None:
        """Mask a finished query out of issue and close its trace with the
        unconditional final checkpoint."""
        row.active = False
        row.finished_s = time.monotonic()
        row.trace.append((int(row.carry.step), int(row.carry.results)))

    def vacate(self, q: int) -> _QueryRow:
        """Release row ``q`` for a later ``admit()``; returns the row (its
        carry, trace and log stay with it).  A row with a slot in flight
        cannot be vacated; an active one is retired without the final
        checkpoint."""
        with self._lock:
            row = self.rows[q]
            if row.inflight:
                raise RuntimeError(f"row {q} has a slot in flight; merge it before vacating")
            row.active = False
            row.vacant = True
            return row

    def pool_rounds(self) -> int:
        """Rounds completed by the furthest-ahead query: ``admit`` debits a
        late query's default budget by ``cohorts × pool_rounds()``."""
        return max((r.rounds for r in self.rows), default=0)

    def admit(self, key: torch.Tensor, *, result_limit: int, max_steps: Optional[int] = None,
              base_max_steps: Optional[int] = None, select_id: Optional[int] = None,
              sampler_init: Optional[SamplerState] = None, warm_rounds_saved: int = 0) -> int:
        """Join a fresh query mid-flight; returns its row index.

        The row starts from zeroed statistics (or ``sampler_init``) and an
        empty ring with the pool's geometry, and issues from the next
        ``_issue_ready``.  Its budget is ``base − cohorts × pool_rounds()``
        with ``base`` = ``base_max_steps`` or the pool's ``max_steps``: a
        query admitted at round r behaves as one present from round 0
        whose budget lost the frames it missed.  ``max_steps`` overrides
        the debit.  ``select_id`` is what ``select`` sees the row as.
        Vacated rows are reused before the pool grows."""
        proto = self.rows[0].carry
        m0, s0 = proto.matcher, proto.sampler
        dev = self._device
        fresh_matcher = dataclasses.replace(
            m0, boxes=torch.zeros_like(m0.boxes), feats=torch.zeros_like(m0.feats),
            video=torch.full_like(m0.video, -1), frame=torch.full_like(m0.frame, -(10**9)),
            chunk=torch.full_like(m0.chunk, -1), times_seen=torch.zeros_like(m0.times_seen),
            cursor=torch.zeros((), dtype=torch.int32, device=dev),
            total_inserted=torch.zeros((), dtype=torch.int32, device=dev))
        fresh_sampler = dataclasses.replace(s0, n1=torch.zeros_like(s0.n1), n=torch.zeros_like(s0.n))
        if sampler_init is not None:
            fresh_sampler = sampler_init
        carry = ExSampleCarry(sampler=fresh_sampler, matcher=fresh_matcher, key=key.to(dev),
                              step=torch.zeros((), dtype=torch.int32, device=dev),
                              results=torch.zeros((), dtype=torch.int32, device=dev))
        with self._lock:
            base = self.max_steps if base_max_steps is None else base_max_steps
            budget = max(0, base - self.cohorts * self.pool_rounds()) if max_steps is None else max_steps
            row = _QueryRow(carry=carry, limit=int(result_limit), budget=budget, trace=[], log=ResultLog(),
                            select_id=select_id, admitted_s=time.monotonic(),
                            warm_rounds_saved=int(warm_rounds_saved))
            slot = next((i for i, r in enumerate(self.rows) if r.vacant), None)
            if slot is None:
                self.rows.append(row)
                return len(self.rows) - 1
            self.rows[slot] = row
            return slot

    # ---- driver side -------------------------------------------------------

    def _issue_ready(self) -> list:
        """Check out a slot for every issuable query (active, live, none in
        flight), packed into fixed-shape batches; a query no longer live
        retires here instead."""
        with self._lock, self._streams.on_driver():
            issuable = []
            for i, row in enumerate(self.rows):
                if not row.active or row.inflight:
                    continue
                if not self._row_live(row):
                    self._retire(row)
                    continue
                issuable.append(i)
            batches = []
            bsz = self.slots_per_batch
            for g in range(0, len(issuable), bsz):
                group = issuable[g:g + bsz]
                pad = bsz - len(group)
                lanes = group + [group[0]] * pad
                active = np.asarray([True] * len(group) + [False] * pad)
                sub = stack_carries([self.rows[i].carry for i in lanes])
                choice = multi_round_choose(sub, self.chunks, torch.as_tensor(active, device=self._device),
                                            cohorts=self.cohorts, method=self.method)
                select_ids = np.asarray([self.rows[i].select_id if self.rows[i].select_id is not None else i
                                         for i in lanes], np.int32)
                batch = SlotBatch(batch_id=self._next_batch, query_rows=np.asarray(lanes, np.int32),
                                  carry=sub, choice=choice, active=active, select_ids=select_ids)
                self._next_batch += 1
                self.stats["lanes_issued"] += len(group)
                self.stats["lanes_padded"] += pad
                for i in group:
                    self.rows[i].inflight = True
                self._inflight[batch.batch_id] = batch
                self.stats["slots"] += 1
                batches.append(batch)
        for batch in batches:
            self._work.put(batch)
        return batches

    def _merge(self, res: SlotResult) -> None:
        """Apply one slot batch to the rows, at most once: a re-issued
        batch's second completion is dropped and counted.  The fresh
        detections go into the shared cache (first write wins), the
        detector economics are attributed to the lanes that represented
        each frame, live ring entries the round evicted spill to the row's
        ``ResultLog``, and each active lane's row is replaced by its
        post-round state, that lane's unique successor."""
        now = time.monotonic()
        with self._lock, self._streams.on_driver():
            batch = self._inflight.pop(res.batch_id, None)
            if batch is None:
                self.stats["duplicate_drops"] += 1
                return
            self._streams.used_here(res)
            if self.cache is not None:
                cache_insert(self.cache, res.aux.flat_frames, res.aux.fresh, res.aux.need)
            self.stats["detector_invocations"] += res.fresh_calls
            self.stats["cache_hits"] += res.cache_hits
            self.stats["merges"] += 1
            self.stats["rounds"] += 1
            lanes_n = len(batch.query_rows)
            need_l = res.aux.need.cpu().numpy().reshape(lanes_n, -1)
            rep_hit_l = res.aux.rep_hit.cpu().numpy().reshape(lanes_n, -1)
            warm_l = None
            if self._warm_arr is not None:
                frames_l = res.aux.flat_frames.cpu().numpy().reshape(lanes_n, -1)
                warm_l = rep_hit_l & np.isin(frames_l, self._warm_arr)
            for lane, qrow in enumerate(batch.query_rows):
                if not batch.active[lane]:
                    continue
                row = self.rows[int(qrow)]
                row.fresh_calls += int(need_l[lane].sum())
                row.cache_hits += int(rep_hit_l[lane].sum())
                if warm_l is not None:
                    lane_ihits = int(warm_l[lane].sum())
                    row.index_hits += lane_ihits
                    self.stats["index_hits"] += lane_ihits
                new_carry = _lane(res.carry, lane)
                inserted = int(new_carry.matcher.total_inserted - row.carry.matcher.total_inserted)
                self.stats["merge_high_water"] = max(self.stats["merge_high_water"], inserted)
                if inserted:
                    self.stats["spilled"] += row.log.spill(row.carry.matcher,
                                                           eviction_mask(row.carry.matcher, inserted))
                if self.trace_every:
                    s0, s1 = int(row.carry.step), int(new_carry.step)
                    if s1 // self.trace_every > s0 // self.trace_every:
                        row.trace.append((s1, int(new_carry.results)))
                if int(new_carry.results) > int(row.carry.results):
                    if not row.first_result_s:
                        row.first_result_s = now
                    row.result_stamps.append((now, int(new_carry.results)))
                row.carry = new_carry
                row.rounds += 1
                row.inflight = False
                if not self._row_live(row):
                    self._retire(row)

    def _reissue(self, batch_id: int) -> None:
        with self._lock:
            batch = self._inflight.get(batch_id)
            if batch is None:
                return
            batch.issue_count += 1
            self.stats["reissues"] += 1
        self._work.put(batch)

    # ---- worker side -------------------------------------------------------

    def _process_batch(self, wid: int, batch: SlotBatch) -> SlotResult:
        """The shared dedup, cache lookup and detector call for the slots
        in flight, then each lane's matcher and sampler fold, queued under
        the lock (see the module's note) and read after it.  Reads only
        the batch's own rows and the cache, which it never writes.  Pure
        of scheduling, so tests drive it synchronously."""
        dev = self._device
        cached = None
        # select() sees a lane as its select_id, else its row: a tenant's
        # predicate binds at admission without changing any shape
        ids = batch.select_ids if batch.select_ids is not None else batch.query_rows
        with self._lock:
            if self.cache is not None:
                with self._streams.on_driver():
                    cached = cache_lookup(self.cache, batch.choice.frame_ids.reshape(-1))
            self._streams.wait_for_driver()
            self._streams.used_here(cached)
            out, _, fresh_calls, cache_hits, aux = multi_round_process(
                batch.carry, None, self.chunks, torch.as_tensor(batch.active, device=dev), batch.choice,
                detector=self.detector, select=self.select,
                query_ids=torch.as_tensor(ids, dtype=torch.int32, device=dev), cached=cached)
            counts = torch.stack([fresh_calls, cache_hits])
        calls, hits = counts.tolist()
        self._streams.finish()
        return SlotResult(batch_id=batch.batch_id, worker_id=wid, carry=out, fresh_calls=calls,
                          cache_hits=hits, aux=aux)

    def _worker(self, wid: int) -> None:
        self.monitor.register(wid, now=time.monotonic())
        with self._streams.on(self._streams.new()):
            while True:
                batch = self._work.get()
                if batch is None:
                    return
                t0 = time.monotonic()
                self.monitor.assign(wid, batch.batch_id, now=t0)
                try:
                    res = self._process_batch(wid, batch)
                except BaseException as e:  # noqa: BLE001 — handed to the driver, which raises it
                    self._results.put(_Failure(wid, e))
                    return
                self._results.put(res)
                now = time.monotonic()
                self.monitor.heartbeat(wid, now)
                self.monitor.record_completion(wid, now - t0, now=now)

    # ---- run loop ----------------------------------------------------------

    def start(self) -> None:
        """Build the kernels, then spawn the worker pool once; idempotent.
        Workers block on the work queue between batches."""
        if self._threads:
            return
        self._streams.build_kernels()
        self._threads = [threading.Thread(target=self._worker, args=(w,), daemon=True)
                         for w in range(self.num_workers)]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        """Drain the worker pool (None sentinels) and join; idempotent."""
        threads, self._threads = self._threads, []
        for _ in threads:
            self._work.put(None)
        for t in threads:
            t.join(timeout=5.0)

    def idle(self) -> bool:
        """True when nothing is in flight and no row wants more rounds."""
        with self._lock:
            return not self._inflight and not any(r.active for r in self.rows)

    def on_driver(self):
        """A context in which the calling thread works on the driver's
        stream: what it reads of the rows and the cache is ordered after
        every merge queued so far, and what it makes is ordered before the
        next issue.  A no-op on the CPU."""
        return self._streams.on_driver()

    def service_tick(self, timeout: float = 0.1) -> bool:
        """One scheduler heartbeat: issue what is issuable, merge at most
        one completed batch, sweep for stragglers.  Returns True if a
        batch was merged, False if the wait timed out.  A worker's
        exception is raised here."""
        self._issue_ready()
        try:
            res = self._results.get(timeout=timeout)
        except queue.Empty:
            return False
        _raise_failure(res)
        self._merge(res)
        for bid in self.monitor.sweep(time.monotonic())["reissue_cohorts"]:
            self._reissue(bid)
        self._issue_ready()
        return True

    def run(self) -> ExSampleCarry:
        """Drive every query to completion; returns the stacked [Q] carry
        (retired rows keep their final state).  Per-query traces are in
        ``self.traces``, spilled results in ``self.logs``."""
        self.start()
        try:
            self._issue_ready()
            while not self.idle():
                if not self.service_tick(timeout=60.0):
                    break
        finally:
            self.stop()
        # rows still active (an abnormal exit) close their trace as the scan driver does
        for row in self.rows:
            if row.active and not row.inflight:
                row.trace.append((int(row.carry.step), int(row.carry.results)))
        return stack_carries([row.carry for row in self.rows])

    @property
    def traces(self) -> list:
        return [row.trace for row in self.rows]

    @property
    def logs(self) -> list:
        return [row.log for row in self.rows]


class ElasticShardedRunner:
    """Elastic mesh-shrink recovery for the composed sharded driver
    (DESIGN.md §14): the reference's runner over the port's
    ``run_search_multi_sharded`` and ``HeartbeatMonitor``.

    Runs the driver in slices of ``sync_windows`` windows; each slice
    returns a resumable carry and the cache in the direct-mapped layout.
    Between slices the live workers heartbeat and the monitor is swept.  A
    dead verdict is acted on at the boundary the runner stands on (the
    window in flight always completes, so no merged result is lost):

      1. the largest shard count k ≤ the survivors with ``cohorts % k ==
         0``, validated by ``plan_resize`` (empty schema);
      2. ``resize_chunk_stats`` strips the old padding and re-pads for k;
      3. ``reshard_cache_host`` re-places the cache only when its padded
         capacity changes (``warm_tag`` keeps its own modulus);
      4. the mesh is rebuilt with k shards on the same device.

    A death in the final window never reshards: the search is already
    complete on merged state.  Replaying a death schedule gives the same
    results.

    One deliberate difference from the reference (ROADMAP C12): a query
    that ran no window in a slice adds no trace entry.  The reference
    extends every query's trace with each slice's, and a slice writes a
    finished query's end state as its one entry, so its windowed traces
    repeat that state once a later slice.  Here, as in one unbounded call,
    each window a query ran is one entry, and a query that ran none ends
    with its end state alone."""

    def __init__(self, carries: ExSampleCarry, chunks, *, detector: Callable, result_limits, max_steps: int,
                 num_shards: int, cohorts: Optional[int] = None, sync_every: int = 1,
                 select: Optional[SelectFn] = None, cache_frames: int = 0, cache=None, warm_tag=None,
                 monitor: Optional[HeartbeatMonitor] = None, clock: Callable[[], float] = time.monotonic,
                 sync_windows: int = 1, device=None):
        from repro_torch.launch.mesh import make_data_mesh
        from repro_torch.serve.batcher import reshard_cache_host

        if sync_windows < 1:
            raise ValueError(f"sync_windows={sync_windows} must be >= 1")
        self.carry = carries
        self.chunks = chunks
        self.detector = detector
        self.max_steps = int(max_steps)
        self.num_shards = int(num_shards)
        self.cohorts = int(cohorts) if cohorts is not None else self.num_shards
        self.sync_every = int(sync_every)
        self.select = select
        self.cache_frames = int(cache_frames)
        self.warm_tag = warm_tag
        self.sync_windows = int(sync_windows)
        self.clock = clock
        self.monitor = monitor if monitor is not None else HeartbeatMonitor()
        self.device = carries.step.device if device is None else device
        self.mesh = make_data_mesh(self.num_shards, device=self.device)
        q_n = carries.step.shape[0]
        self.result_limits = np.broadcast_to(np.asarray(result_limits, np.int32), (q_n,)).copy()
        # workers currently heartbeating; kill_worker() silences one
        self.alive: set[int] = set(range(self.num_shards))
        now = self.clock()
        for w in sorted(self.alive):
            self.monitor.register(w, now)
        self._cache = cache          # direct-mapped between slices
        if cache is not None:
            cap = cache.capacity
            self._cache = reshard_cache_host(cache, cap + (-cap) % self.num_shards)
        self._first_call = True
        self.traces: list[list] = [[] for _ in range(q_n)]
        self.stats = {
            "detector_invocations": 0, "cache_hits": 0, "index_hits": 0,
            "rounds": 0, "merges": 0, "merge_high_water": 0,
            "merge_overflow": False, "frames_sampled": 0,
            "reshard_events": [], "final_cache": None,
        }

    # ---- liveness ----------------------------------------------------------

    def kill_worker(self, worker: int) -> None:
        """Stop heartbeating ``worker``: its silence starts now, the dead
        verdict lands at a later boundary's sweep."""
        self.alive.discard(worker)

    def _live_queries(self) -> np.ndarray:
        """The driver's live mask, on the host."""
        c = self.carry
        res, step = c.results.cpu().numpy(), c.step.cpu().numpy()
        n = c.sampler.n.cpu().numpy()
        exhausted = (n >= c.sampler.frames.cpu().numpy().astype(n.dtype)).all(axis=-1)
        return (res < self.result_limits) & (step < self.max_steps) & ~exhausted

    # ---- mesh shrink -------------------------------------------------------

    def _shrink(self, dead: list) -> None:
        from repro_torch.distributed.elastic import plan_resize, resize_chunk_stats
        from repro_torch.launch.mesh import make_data_mesh
        from repro_torch.serve.batcher import reshard_cache_host

        survivors = sorted(self.alive)
        if not survivors:
            raise RuntimeError("elastic shrink: no surviving workers")
        new_shards = None
        for k in range(min(len(survivors), self.num_shards), 0, -1):
            if self.cohorts % k:
                continue
            if plan_resize({}, make_data_mesh(k, device=self.device), global_batch=self.cohorts).feasible:
                new_shards = k
                break
        if new_shards is None:
            raise RuntimeError(f"elastic shrink: no feasible shard count <= {len(survivors)} survivors for "
                               f"cohorts={self.cohorts}")
        sampler = self.carry.sampler
        n1, n, frames = resize_chunk_stats(sampler.n1, sampler.n, sampler.frames, new_shards)
        self.carry = dataclasses.replace(self.carry, sampler=dataclasses.replace(sampler, n1=n1, n=n, frames=frames))
        if self._cache is not None:
            cap = self._cache.capacity
            self._cache = reshard_cache_host(self._cache, cap + (-cap) % new_shards)
        self.stats["reshard_events"].append({
            "window": self.stats["merges"], "from_shards": self.num_shards,
            "to_shards": new_shards, "dead": sorted(dead),
        })
        self.num_shards = new_shards
        self.mesh = make_data_mesh(new_shards, device=self.device)

    # ---- execution ---------------------------------------------------------

    def step(self) -> bool:
        """One bounded slice and one boundary sweep; True while live
        queries remain."""
        from repro_torch.core.executor import run_search_multi_sharded

        out, traces, stats = run_search_multi_sharded(
            self.carry, self.chunks, mesh=self.mesh, detector=self.detector,
            result_limits=self.result_limits, max_steps=self.max_steps, cohorts=self.cohorts,
            sync_every=self.sync_every, select=self.select,
            cache_frames=self.cache_frames if self._first_call else 0, cache=self._cache,
            warm_tag=self.warm_tag, window_limit=self.sync_windows)
        self._first_call = False
        self.carry = out
        self._cache = stats["final_cache"]
        for q, t in enumerate(traces):
            if stats["query_windows"][q]:          # C12: no window, no entry
                self.traces[q].extend(t)
        for k in ("detector_invocations", "cache_hits", "index_hits", "rounds", "merges"):
            self.stats[k] += stats[k]
        self.stats["merge_high_water"] = max(self.stats["merge_high_water"], stats["merge_high_water"])
        self.stats["merge_overflow"] |= stats["merge_overflow"]
        if not self._live_queries().any():
            return False
        now = self.clock()
        for w in sorted(self.alive):
            self.monitor.heartbeat(w, now)
        verdict = self.monitor.sweep(now)
        dead = [w for w in verdict["dead"] if w < self.num_shards]
        if dead:
            self._shrink(dead)
        return True

    def close_traces(self) -> None:
        """A query that ran no window in any slice ends with its end state
        alone, as one unbounded call writes it."""
        for q, t in enumerate(self.traces):
            if not t:
                t.append((int(self.carry.step[q]), int(self.carry.results[q])))

    def run(self):
        """Drive every query to completion; returns ``(carry, traces,
        stats)`` as ``run_search_multi_sharded`` does, plus
        ``stats["reshard_events"]``."""
        # a live query advances ``cohorts`` steps a window, so this many
        # slices always suffice; more means the driver stalled
        budget = self.max_steps // (self.cohorts * self.sync_windows) + 2
        while self.step():
            budget -= 1
            if budget < 0:
                raise RuntimeError("elastic runner made no progress")
        self.close_traces()
        self.stats["frames_sampled"] = int(self.carry.step.sum())
        self.stats["final_cache"] = self._cache
        return self.carry, self.traces, self.stats
