"""ExSample Algorithm 1 — single-step, batched-cohort and search drivers.

Counterpart of ``repro.core.exsample`` for the single-query drivers:

  * ``_host_search`` — the reference loop; reads the carry back every step.
  * ``_scan_search`` — the resident search.  JAX runs it as one
    ``lax.while_loop`` with a single host sync.  Here each round is masked
    by the loop's exit test (results < limit, step < max_steps, some chunk
    not exhausted), computed on the device: a round past the exit leaves
    the carry as it was.  ``_resident_loop`` runs such rounds
    ``ROUNDS_PER_SYNC`` at a time and reads the exit test back once after
    each batch; on the card it captures one round as a CUDA graph and
    replays it.  Trace checkpoints are written to a device buffer on
    boundary crossings, as the reference writes them, and read once at the
    end.  The (step, results) trajectory, the trace and the final carry
    are the reference's.

Randomness follows the reference's key order exactly: each round splits
``carry.key`` into (key, k_choice, k_det); ``k_choice`` draws the cohort
normals and, for cohorts > 1, ``k_det`` splits into one key per frame.

Detector protocol: ``detector(key, frame_id) -> Detections``.

The multi-query driver (``_multi_search``, DESIGN.md §9) runs Q queries
over one repository as one carry with a leading ``[Q]`` on every tensor
(``init_carry_multi`` / ``stack_carries``).  Each round, every query draws
``cohorts`` chunks from its own statistics (kernel B2, one launch), the
union of the Q·C frames is deduplicated and looked up in the shared
``DetectionCache``, one detector call covers them all, and each query
folds its own C frames into its own ring and statistics, the Q queries
together (one batched B3 launch per cohort slot).  Its detector takes a
batch: ``detector(keys int64[B, 2], frames int64[B]) -> Detections`` with
a leading ``[B]``, where the reference ``jax.vmap``s a per-frame detector.
Per query the trajectory equals the query's own ``_scan_search``.  It
runs through the same ``_resident_loop``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

import torch
from torch.profiler import record_function

from repro_torch.core import prng, thompson
from repro_torch.core.chunks import ChunkIndex, randomplus_frame
from repro_torch.core.matcher import MatcherState, broadcast_leading, match_and_update
from repro_torch.core.state import SamplerState, apply_cross_chunk_decrement, apply_update
from repro_torch.kernels.iou_match.ref import RING_FIELDS
from repro_torch.serve.batcher import (
    DetectionCache,
    cache_insert,
    cache_lookup,
    dedup_first_index,
    init_detection_cache,
    tree_map,
)

DetectorFn = Callable[[torch.Tensor, torch.Tensor], "Detections"]  # noqa: F821
# per-query detection predicate of the multi-query driver: (query indices
# i32[Q], one cohort slot's Detections with a leading [Q]) -> bool[Q, D]
# keep-mask, applied on top of the detector's own validity
SelectFn = Callable[[torch.Tensor, "Detections"], torch.Tensor]  # noqa: F821


@dataclasses.dataclass(frozen=True)
class ExSampleCarry:
    sampler: SamplerState
    matcher: MatcherState
    key: torch.Tensor          # int64[2] — two uint32 words
    step: torch.Tensor         # i32[] — frames processed
    results: torch.Tensor      # i32[] — distinct results found

    def to(self, device) -> "ExSampleCarry":
        return ExSampleCarry(
            sampler=self.sampler.to(device), matcher=self.matcher.to(device),
            key=self.key.to(device), step=self.step.to(device),
            results=self.results.to(device),
        )


def init_carry(sampler: SamplerState, matcher: MatcherState, key: torch.Tensor) -> ExSampleCarry:
    dev = sampler.n.device
    return ExSampleCarry(
        sampler=sampler, matcher=matcher, key=key.to(dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        results=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _process_frame(
    carry: ExSampleCarry,
    chunks: ChunkIndex,
    detector: DetectorFn,
    chunk_id: torch.Tensor,
    det_key: torch.Tensor,
) -> ExSampleCarry:
    """Algorithm 1 lines 9-16 for one frame of ``chunk_id``.  The
    ``exsample.*`` ranges name the layers in a torch.profiler trace."""
    with record_function("exsample.detect"):
        # torch.take keeps the 0-dim chunk id on the device (t[idx] would sync)
        rank = torch.take(carry.sampler.n, chunk_id.long()).long()
        frame_id = randomplus_frame(chunks, chunk_id, rank)
        video_id = torch.take(chunks.video_id, chunk_id.long())
        dets = detector(det_key, frame_id)
    with record_function("exsample.match"):
        m = match_and_update(carry.matcher, dets.boxes, dets.feats, dets.valid,
                             video_id, frame_id, chunk_id)
    with record_function("exsample.update"):
        sampler = apply_update(carry.sampler, chunk_id, m.d0, m.d1 - m.cross_chunk)
        valid_home = m.cross_home >= 0
        sampler = apply_cross_chunk_decrement(
            sampler,
            torch.where(valid_home, m.cross_home, torch.zeros_like(m.cross_home)),
            valid_home.to(sampler.n1.dtype),
        )
    return dataclasses.replace(
        carry, sampler=sampler, matcher=m.new_state,
        step=carry.step + 1, results=carry.results + m.d0,
    )


def _choose_and_process(
    carry: ExSampleCarry,
    chunks: ChunkIndex,
    detector: DetectorFn,
    cohorts: int,
    method: str,
    live: torch.Tensor | None = None,
) -> ExSampleCarry:
    """One round of ``cohorts`` frames.  ``live`` (bool[]) is the resident
    loop's exit test: where it is false the chosen chunk ids become 0
    before any gather, since once every chunk is exhausted the fused
    kernel returns -1 (ROADMAP C2); the caller discards that round."""
    with record_function("exsample.choose"):
        key, k_choice, k_det = prng.split(carry.key, 3)
        carry = dataclasses.replace(carry, key=key)
        chunk_ids = thompson.choose_chunks(k_choice, carry.sampler, cohorts=cohorts, method=method)
        if live is not None:
            chunk_ids = torch.where(live, chunk_ids, torch.zeros_like(chunk_ids))
        # exsample_step uses k_det unsplit
        det_keys = k_det[None] if cohorts == 1 else prng.split(k_det, cohorts)
    for i in range(cohorts):
        carry = _process_frame(carry, chunks, detector, chunk_ids[i], det_keys[i])
    return carry


def exsample_step(
    carry: ExSampleCarry, chunks: ChunkIndex, *, detector: DetectorFn, method: str = "exact"
) -> ExSampleCarry:
    """One iteration of Algorithm 1 (choose → process → update)."""
    return _choose_and_process(carry, chunks, detector, 1, method)


def exsample_batch_step(
    carry: ExSampleCarry,
    chunks: ChunkIndex,
    *,
    detector: DetectorFn,
    cohorts: int,
    method: str = "exact",
) -> ExSampleCarry:
    """§3.7.1 batched execution: ``cohorts`` Thompson draws pick the round's
    frames, which the matcher folds in order."""
    return _choose_and_process(carry, chunks, detector, cohorts, method)


def _host_search(
    carry: ExSampleCarry,
    chunks: ChunkIndex,
    *,
    detector: DetectorFn,
    result_limit: int,
    max_steps: int,
    cohorts: int = 1,
    method: str = "exact",
    trace_every: int = 0,
):
    """Reference driver: iterate until ``result_limit`` results,
    ``max_steps`` frames or exhaustion, reading the carry back every step.
    Returns (final_carry, trace) with trace a list of (frames, results)
    checkpoints on boundary crossings of ``trace_every`` plus a final one."""
    trace = []
    while (
        int(carry.results) < result_limit
        and int(carry.step) < max_steps
        and not bool(torch.all(carry.sampler.exhausted()))
    ):
        prev_step = int(carry.step)
        carry = _choose_and_process(carry, chunks, detector, cohorts, method)
        if trace_every and (int(carry.step) // trace_every) > (prev_step // trace_every):
            trace.append((int(carry.step), int(carry.results)))
    trace.append((int(carry.step), int(carry.results)))
    return carry, trace


# ---------------------------------------------------------------------------
# The resident loop: masked rounds, replayed from a CUDA graph on the card
# ---------------------------------------------------------------------------

# Rounds run between two reads of the exit test.  A round past the exit is
# masked, so it costs only its device time; a read costs a round trip.
ROUNDS_PER_SYNC = 8


@dataclasses.dataclass(frozen=True)
class LoopRecord:
    """How ``_resident_loop`` ran one search."""

    captured: bool          # rounds replayed from a CUDA graph
    rounds_per_sync: int    # rounds between two reads of the exit test
    eager_rounds: int       # rounds run op by op (the first; all of them when not captured)
    replays: int            # graph replays
    syncs: int              # reads of the exit test
    capture_s: float        # host seconds to capture the round
    # kernel launches recorded into the graph, by wrapper: each replay
    # launches them again, though the wrappers counted them once
    captured_launches: dict


def _carry_leaves(c: ExSampleCarry) -> list[torch.Tensor]:
    """The carry's tensors a round may change (the sampler's ``frames``
    never does), in a fixed order."""
    return [c.sampler.n1, c.sampler.n, *(getattr(c.matcher, f) for f in RING_FIELDS), c.key, c.step, c.results]


def _with_leaves(c: ExSampleCarry, leaves) -> ExSampleCarry:
    n1, n, *rest = leaves
    ring, (key, step, results) = rest[:len(RING_FIELDS)], rest[len(RING_FIELDS):]
    return ExSampleCarry(
        sampler=dataclasses.replace(c.sampler, n1=n1, n=n),
        matcher=dataclasses.replace(c.matcher, **dict(zip(RING_FIELDS, ring))),
        key=key, step=step, results=results,
    )


def _select(go: torch.Tensor, new: ExSampleCarry, old: ExSampleCarry) -> ExSampleCarry:
    """``new`` where ``go`` (bool[]) holds, else ``old``, on every leaf."""
    return _with_leaves(old, [torch.where(go, a, b) for a, b in zip(_carry_leaves(new), _carry_leaves(old))])


def _capture(round_fn: Callable, carry: ExSampleCarry):
    """One round captured as a CUDA graph that reads ``carry``'s tensors
    and writes the next carry back into them.  Returns (graph, the kernel
    launches recorded in it).  A host read inside the round fails the
    capture, and the error propagates."""
    from repro_torch.kernels import launch_counts

    static = _carry_leaves(carry)
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        # each leaf of a masked round is a new tensor (``torch.where``, a
        # scatter's copy, a kernel's output), never a view of an input that
        # an earlier copy would overwrite
        for s, o in zip(static, _carry_leaves(round_fn(carry))):
            s.copy_(o)
    after = launch_counts()
    return graph, {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _resident_loop(round_fn: Callable, carry: ExSampleCarry, live: Callable, *, capture: bool,
                   rounds_per_sync: int) -> tuple[ExSampleCarry, LoopRecord]:
    """Run masked rounds until the exit test fails.

    ``round_fn(carry) -> carry`` is one round masked by the exit test
    (past the exit it returns the carry unchanged, bit for bit), reading
    no value back to the host; its trace and counters are updated in
    place.  ``live(carry)`` is the exit test, a bool tensor.

    The first round runs op by op: it builds the kernels and warms the
    allocator.  With ``capture`` (on the card, for the samplers that read
    their key on the device) one round is then captured as a CUDA graph,
    and every later round is a replay of it; a failed capture raises.
    Otherwise every round runs op by op, on any device.  Either way the
    loop runs ``rounds_per_sync`` rounds, reads the exit test once, and
    repeats until it fails."""
    if rounds_per_sync < 1:
        raise ValueError(f"rounds_per_sync must be at least 1, got {rounds_per_sync}")
    with record_function("exsample.eager_round"):
        carry = round_fn(carry)
    eager, replays, syncs, capture_s, graph, recorded = 1, 0, 0, 0.0, None, {}
    if capture:
        t0 = time.perf_counter()
        with record_function("exsample.capture"):
            graph, recorded = _capture(round_fn, carry)
        capture_s = time.perf_counter() - t0
    while True:
        with record_function("exsample.exit_test"):
            syncs += 1
            if not bool(live(carry).any()):   # the one device→host read per batch of rounds
                break
        with record_function("exsample.rounds"):
            for _ in range(rounds_per_sync):
                if graph is not None:
                    graph.replay()
                else:
                    carry = round_fn(carry)
        if graph is not None:
            replays += rounds_per_sync
        else:
            eager += rounds_per_sync
    return carry, LoopRecord(captured=graph is not None, rounds_per_sync=rounds_per_sync,
                             eager_rounds=eager, replays=replays, syncs=syncs, capture_s=capture_s,
                             captured_launches=recorded)


def _captures(method: str, device: torch.device) -> bool:
    """Whether the resident loop replays its rounds from a CUDA graph: on
    the card, except for ``"exact"``, whose sampler seeds a host generator
    from the key every round (``core.thompson.draw_scores``)."""
    return device.type == "cuda" and method != "exact"


def _trace_cap(max_steps: int, cohorts: int, trace_every: int) -> int:
    """Rows of the trace: at most one crossing per ``trace_every`` frames,
    the last round may overshoot ``max_steps`` by ``cohorts - 1``, plus
    the unconditional final entry."""
    return (max_steps + cohorts - 1) // trace_every + 1 if trace_every else 1


def _trace_write(buf: torch.Tensor, n: torch.Tensor, crossed: torch.Tensor, entry: torch.Tensor) -> None:
    """In place: each row's ``entry`` (i32[..., 2]) goes to row ``n`` of
    its buffer (``buf`` i32[..., cap + 1, 2]) where ``crossed``, to the
    spare row ``cap`` elsewhere and once ``n`` reaches ``cap`` (the
    reference's dropped write); ``n += crossed``.  No host read: the
    index is a 1-element tensor, never a 0-dim one."""
    cap = buf.shape[-2] - 1
    rows = buf.reshape(-1, 2)
    base = torch.arange(crossed.numel(), device=buf.device) * (cap + 1)
    at = torch.where(crossed, torch.clamp_max(n, cap), torch.full_like(n, cap)).reshape(-1)
    rows.index_copy_(0, base + at.long(), entry.reshape(-1, 2))
    n.add_(crossed.to(n.dtype))


def _trace_final(buf: torch.Tensor, n: torch.Tensor, entry: torch.Tensor) -> None:
    """The unconditional final checkpoint, at ``min(n, cap - 1)``;
    ``n = min(n + 1, cap)``.  In place."""
    cap = buf.shape[-2] - 1
    _trace_write(buf, torch.clamp_max(n, cap - 1), torch.ones_like(n, dtype=torch.bool), entry)
    n.copy_(torch.clamp_max(n + 1, cap))


def _scan_search(
    carry: ExSampleCarry,
    chunks: ChunkIndex,
    *,
    detector: DetectorFn,
    result_limit: int,
    max_steps: int,
    cohorts: int = 1,
    method: str = "exact",
    trace_every: int = 0,
    rounds_per_sync: int = ROUNDS_PER_SYNC,
):
    """Resident driver: the host driver's (step, results) trajectory and
    trace for the same key.  Each round is masked by the exit test on the
    device; ``_resident_loop`` runs them, replayed from one captured CUDA
    graph on the card (but for ``method="exact"``), and reads the exit
    test once every ``rounds_per_sync`` rounds.  The trace, its count and
    the carry are read once at the end.  Returns (final_carry, trace,
    LoopRecord)."""
    dev = carry.step.device
    cap = _trace_cap(max_steps, cohorts, trace_every)
    buf = torch.zeros((cap + 1, 2), dtype=torch.int32, device=dev)  # row cap: dropped writes
    n = torch.zeros((), dtype=torch.int32, device=dev)
    limit = torch.tensor(result_limit, dtype=torch.int32, device=dev)

    def live(c: ExSampleCarry) -> torch.Tensor:
        return (c.results < limit) & (c.step < max_steps) & ~torch.all(c.sampler.exhausted())

    def round_fn(c: ExSampleCarry) -> ExSampleCarry:
        go = live(c)
        new = _select(go, _choose_and_process(c, chunks, detector, cohorts, method, live=go), c)
        if trace_every:
            crossed = new.step // trace_every > c.step // trace_every
            _trace_write(buf, n, crossed, torch.stack([new.step, new.results]))
        return new

    carry, loop = _resident_loop(round_fn, carry, live, capture=_captures(method, dev),
                                 rounds_per_sync=rounds_per_sync)
    _trace_final(buf, n, torch.stack([carry.step, carry.results]))
    count, *rows = torch.cat([n.reshape(1), buf.reshape(-1)]).tolist()
    trace = [(rows[2 * i], rows[2 * i + 1]) for i in range(count)]
    return carry, trace, loop


# ---------------------------------------------------------------------------
# Multi-query driver (§3.7.1 amortised across queries, DESIGN.md §9)
# ---------------------------------------------------------------------------


def _stack(objs):
    """Stack the tensor fields of equal-typed state dataclasses along a
    new leading axis; their static fields must agree."""
    first = objs[0]
    fields = {}
    for f in dataclasses.fields(first):
        vals = [getattr(o, f.name) for o in objs]
        if isinstance(vals[0], torch.Tensor):
            fields[f.name] = torch.stack(vals)
        elif any(v != vals[0] for v in vals):
            raise ValueError(f"cannot stack carries whose {f.name} differ: {vals}")
    return dataclasses.replace(first, **fields)


def stack_carries(carries) -> ExSampleCarry:
    """Q single-query carries as one multi-query carry (leading [Q])."""
    carries = list(carries)
    return ExSampleCarry(
        sampler=_stack([c.sampler for c in carries]),
        matcher=_stack([c.matcher for c in carries]),
        key=torch.stack([c.key for c in carries]),
        step=torch.stack([c.step for c in carries]),
        results=torch.stack([c.results for c in carries]),
    )


def init_carry_multi(sampler: SamplerState, matcher: MatcherState, keys: torch.Tensor) -> ExSampleCarry:
    """Fresh Q-query carry: ``keys`` int64[Q, 2]; the single-query sampler
    and matcher are repeated for every query."""
    q = keys.shape[0]
    dev = sampler.n.device
    return ExSampleCarry(
        sampler=broadcast_leading(sampler, q),
        matcher=broadcast_leading(matcher, q),
        key=keys.to(dev),
        step=torch.zeros((q,), dtype=torch.int32, device=dev),
        results=torch.zeros((q,), dtype=torch.int32, device=dev),
    )


class RoundChoice(NamedTuple):
    """The choose half of one multi-query round: every per-query decision
    that depends only on round-start state."""

    key_next: torch.Tensor    # int64[Q, 2] — per-query key after this round
    chunk_ids: torch.Tensor   # i32[Q, C] — Thompson winners (0 for finished queries)
    ranks: torch.Tensor       # i32[Q, C] — random+ rank (n0 + within-round occurrence)
    frame_ids: torch.Tensor   # int64[Q, C] — sampled frames
    det_keys: torch.Tensor    # int64[Q, C, 2] — per-slot detector keys


class RoundAux(NamedTuple):
    """Process-half byproducts: the flat frame batch, which slots were
    freshly detected, the raw detector output and the representatives
    the cache served."""

    flat_frames: torch.Tensor   # int64[Q*C]
    need: torch.Tensor          # bool[Q*C]
    fresh: Any                  # detector output, leading [Q*C]
    rep_hit: torch.Tensor       # bool[Q*C]


def multi_round_choose(
    mc: ExSampleCarry,
    chunks: ChunkIndex,
    active: torch.Tensor,     # bool[Q] — round-start liveness per query
    *,
    cohorts: int,
    method: str,
) -> RoundChoice:
    """Choose half of a multi-query round: split every query's key, draw
    ``cohorts`` winners per query from round-start statistics (one
    ``choose_chunks_batched`` call), advance the within-round random+
    ranks and derive the per-slot detector keys."""
    c = cohorts
    keys = prng.split(mc.key, 3)                                     # [Q, 3, 2]
    key_next, k_choice, k_det = keys[:, 0], keys[:, 1], keys[:, 2]
    chunk_ids = thompson.choose_chunks_batched(k_choice, mc.sampler, cohorts=c, method=method)
    # A finished query is still chosen for (the reference does too), and
    # one that has exhausted every chunk gets -1 from the kernel (ROADMAP
    # C2), which no gather below may see.  Its ids become 0.  No output
    # depends on them: its slots are left out of the dedup, its detections
    # are masked invalid, its samples are 0 and its key stays frozen.
    chunk_ids = torch.where(active[:, None], chunk_ids, torch.zeros_like(chunk_ids))
    # cohort j of query q reads n after its own earlier same-chunk picks
    # in this round (exsample_batch_step's sequential order): occ counts
    # them
    eq = (chunk_ids[:, :, None] == chunk_ids[:, None, :]).int()      # [Q, C, C]
    occ = torch.tril(eq, diagonal=-1).sum(-1)                        # [Q, C]
    n0 = mc.sampler.n.gather(-1, chunk_ids.long())
    ranks = (n0 + occ.to(n0.dtype)).int()
    frame_ids = randomplus_frame(chunks, chunk_ids, ranks)
    # exsample_step uses k_det unsplit
    det_keys = k_det[:, None] if c == 1 else prng.split(k_det, c)
    return RoundChoice(key_next=key_next, chunk_ids=chunk_ids, ranks=ranks,
                       frame_ids=frame_ids, det_keys=det_keys)


def multi_round_process(
    mc: ExSampleCarry,
    cache: DetectionCache | None,
    chunks: ChunkIndex,
    active: torch.Tensor,       # bool[Q]
    choice: RoundChoice,
    *,
    detector: DetectorFn,
    select: SelectFn | None,
    query_ids: torch.Tensor | None = None,
    cached: tuple | None = None,
):
    """Process half of a multi-query round: dedup the Q·C frames, resolve
    them through the cache, run one detector call and fold each query's
    slots, in order, into its own ring and statistics.  ``select`` sees
    row q as ``query_ids[q]`` (default q): the async scheduler processes
    gathered rows, whose position is not the query's id.

    ``cached`` is the cache's answer for the round's frames, ``(hit
    bool[Q*C], detections)``, looked up by the caller; the cache is then
    neither read nor written here (``cache`` must be None), and the caller
    inserts ``aux.fresh`` under ``aux.need`` itself.  The async scheduler
    takes this path: its workers read a shared cache that only the
    driver's merge writes.

    Returns ``(mc', cache', fresh_calls i32[], cache_hits i32[], aux)``;
    ``fresh_calls`` counts the unique, uncached frames of live queries,
    what a deployment would send to the detector (the simulated detector
    still evaluates the whole batch, for fixed shapes)."""
    q_n, c = choice.chunk_ids.shape
    b = q_n * c
    dev = active.device
    if cached is not None and cache is not None:
        raise ValueError("pass the cache or the caller's lookup of it, not both")
    if query_ids is None:
        query_ids = torch.arange(q_n, dtype=torch.int32, device=dev)
    flat_frames = choice.frame_ids.reshape(b)
    flat_valid = active[:, None].expand(q_n, c).reshape(b)

    with record_function("exsample.dedup_cache"):
        first_idx = dedup_first_index(flat_frames, flat_valid)
        is_rep = (first_idx == torch.arange(b, dtype=torch.int32, device=dev)) & flat_valid
    with record_function("exsample.detect"):
        fresh = detector(choice.det_keys.reshape(b, -1), flat_frames)
    with record_function("exsample.dedup_cache"):
        if cache is not None or cached is not None:
            hit, stored = cache_lookup(cache, flat_frames) if cached is None else cached
            resolved = tree_map(
                lambda cv, fv: torch.where(hit.reshape((b,) + (1,) * (fv.dim() - 1)), cv, fv),
                stored, fresh)
            need = is_rep & ~hit
            if cache is not None:
                cache = cache_insert(cache, flat_frames, fresh, need)
        else:
            hit = torch.zeros((b,), dtype=torch.bool, device=dev)
            resolved = fresh
            need = is_rep
        # every slot gathers its representative's detections, so each
        # query consumes detections of exactly the frame it sampled
        gather = first_idx.long()
        dets = tree_map(lambda x: x[gather].reshape((q_n, c) + x.shape[1:]), resolved)
        fresh_calls = need.sum().int()
        cache_hits = (is_rep & hit).sum().int()

    sampler, matcher, results = mc.sampler, mc.matcher, mc.results
    samples = active.to(sampler.n.dtype)
    for j in range(c):
        cid, fid = choice.chunk_ids[:, j], choice.frame_ids[:, j]
        with record_function("exsample.match"):
            d = tree_map(lambda x: x[:, j], dets)
            valid = d.valid & active[:, None]
            if select is not None:
                valid = valid & select(query_ids, d)
            m = match_and_update(matcher, d.boxes, d.feats, valid,
                                 torch.take(chunks.video_id, cid.long()), fid, cid)
        with record_function("exsample.update"):
            sampler = apply_update(sampler, cid, m.d0, m.d1 - m.cross_chunk, samples=samples)
            valid_home = m.cross_home >= 0
            sampler = apply_cross_chunk_decrement(
                sampler,
                torch.where(valid_home, m.cross_home, torch.zeros_like(m.cross_home)),
                valid_home.to(sampler.n1.dtype),
            )
            matcher, results = m.new_state, results + m.d0
    mc = ExSampleCarry(
        sampler=sampler, matcher=matcher,
        # finished queries keep their key, so their final carry equals
        # their own solo run's
        key=torch.where(active[:, None], choice.key_next, mc.key),
        step=(mc.step + c * active.int()).int(),
        results=results.int(),
    )
    aux = RoundAux(flat_frames=flat_frames, need=need, fresh=fresh, rep_hit=is_rep & hit)
    return mc, cache, fresh_calls, cache_hits, aux


def _multi_round(
    mc: ExSampleCarry,
    cache: DetectionCache | None,
    chunks: ChunkIndex,
    active: torch.Tensor,
    *,
    detector: DetectorFn,
    select: SelectFn | None,
    cohorts: int,
    method: str,
):
    """One synchronised multi-query round: :func:`multi_round_choose`
    then :func:`multi_round_process`."""
    with record_function("exsample.choose"):
        choice = multi_round_choose(mc, chunks, active, cohorts=cohorts, method=method)
    return multi_round_process(mc, cache, chunks, active, choice, detector=detector, select=select)


def detection_struct(detector: DetectorFn, key: torch.Tensor):
    """One frame's detection tree from a batched ``detector`` (frame 0),
    the shape a ``DetectionCache`` is built for: what the reference reads
    with ``jax.eval_shape``."""
    one = detector(key[None], torch.zeros((1,), dtype=torch.int64, device=key.device))
    return tree_map(lambda x: x[0], one)


def _multi_search(
    carries: ExSampleCarry,
    chunks: ChunkIndex,
    *,
    detector: DetectorFn,
    result_limits,
    max_steps: int,
    cohorts: int = 1,
    method: str = "exact",
    trace_every: int = 0,
    select: SelectFn | None = None,
    cache_frames: int = 0,
    cache: DetectionCache | None = None,
    warm_tag: torch.Tensor | None = None,
    rounds_per_sync: int = ROUNDS_PER_SYNC,
):
    """Q concurrent queries over one repository, one detector call per
    round (DESIGN.md §9); the reference's ``_multi_search``.

    Rounds run until every query is finished.  Each round computes the
    live mask (results < limit, step < max_steps, some chunk not
    exhausted) on the device and masks every query by it; a round with no
    live query leaves the carry, the cache's slots and the counters as
    they were.  ``_resident_loop`` runs the rounds, replayed from one
    captured CUDA graph on the card (but for ``method="exact"``), and
    reads the exit test once every ``rounds_per_sync`` rounds.  Trace
    checkpoints are written on the device on each query's boundary
    crossings (the reference's cap and its unconditional final entry);
    the traces and the counters are read once at the end.
    ``cache_frames`` slots of ``DetectionCache`` (0 = no cache) are
    allocated once, before the first round.

    ``cache`` replaces that fresh cache (a repository index's preload,
    ``RepositoryIndex.warm``), and ``warm_tag`` (i32[S], the preloaded
    cache's tag, copied before the run) splits ``index_hits`` out of
    ``cache_hits``: a hit whose slot still tags the preloaded frame is a
    detector call a past search paid for.  An evicted preload cannot hit,
    and a frame this run inserted into a preloaded slot fails the compare.

    Returns ``(carries', traces, stats)``: per-query traces and the
    accounting ``detector_invocations``, ``cache_hits``, ``index_hits``,
    ``rounds``, ``frames_sampled`` (Σ per-query steps), ``final_cache``
    and ``loop`` (the ``LoopRecord``).
    """
    dev = carries.step.device
    q_n = carries.step.shape[0]
    limits = torch.as_tensor(result_limits, dtype=torch.int32).expand(q_n).to(dev)
    if cache is None and cache_frames:
        cache = init_detection_cache(detection_struct(detector, carries.key[0]), cache_frames, device=dev)
    cap = _trace_cap(max_steps, cohorts, trace_every)
    buf = torch.zeros((q_n, cap + 1, 2), dtype=torch.int32, device=dev)  # row cap: dropped writes
    n = torch.zeros((q_n,), dtype=torch.int32, device=dev)
    # detector calls, cache hits, index hits, rounds with a live query
    counters = torch.zeros((4,), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def live(mc: ExSampleCarry) -> torch.Tensor:
        return ((mc.results < limits) & (mc.step < max_steps)
                & ~torch.all(mc.sampler.exhausted(), dim=-1))

    def round_fn(mc: ExSampleCarry) -> ExSampleCarry:
        active = live(mc)
        new, _, fresh, hit, aux = _multi_round(
            mc, cache, chunks, active, detector=detector, select=select,
            cohorts=cohorts, method=method)
        ihit = zero
        if warm_tag is not None:
            wslot = torch.remainder(aux.flat_frames, warm_tag.shape[0]).long()
            ihit = (aux.rep_hit & (warm_tag[wslot] == aux.flat_frames)).sum().int()
        counters.add_(torch.stack([fresh, hit, ihit, active.any().int()]))
        if trace_every:
            crossed = new.step // trace_every > mc.step // trace_every
            _trace_write(buf, n, crossed, torch.stack([new.step, new.results], dim=-1))
        return new

    mc, loop = _resident_loop(round_fn, carries, live, capture=_captures(method, dev),
                              rounds_per_sync=rounds_per_sync)
    _trace_final(buf, n, torch.stack([mc.step, mc.results], dim=-1))
    flat = torch.cat([counters, n, buf.reshape(-1)]).tolist()
    (calls, hits, ihits, rounds), counts = flat[:4], flat[4:4 + q_n]
    rows = flat[4 + q_n:]
    width = 2 * (cap + 1)
    traces = [[(rows[q * width + 2 * i], rows[q * width + 2 * i + 1]) for i in range(counts[q])]
              for q in range(q_n)]
    stats = {
        "detector_invocations": calls,
        "cache_hits": hits,
        "index_hits": ihits,
        "rounds": rounds,
        "frames_sampled": int(mc.step.sum()),
        "final_cache": cache,
        "loop": loop,
    }
    return mc, traces, stats
