"""ExSample Algorithm 1 — single-step, batched-cohort and search drivers.

Counterpart of ``repro.core.exsample`` for the single-query drivers:

  * ``_host_search`` — the reference loop; reads the carry back every step.
  * ``_scan_search`` — the resident search.  JAX runs it as one
    ``lax.while_loop`` with a single host sync; here it is a Python loop
    over rounds whose exit test (results < limit, step < max_steps, some
    chunk not exhausted) is computed on the device and read back once per
    round.  That is one sync per round where JAX has one in total; the
    (step, results) trajectory, the trace and the final carry are the same.
    The step counter advances by ``cohorts`` every round, so trace
    checkpoints are decided on the host and their (step, results) pairs
    are written to a device buffer that is read once at the end.

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
Per query the trajectory equals the query's own ``_scan_search``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.profiler import record_function

from repro_torch.core import prng, thompson
from repro_torch.core.chunks import ChunkIndex, randomplus_frame
from repro_torch.core.matcher import MatcherState, broadcast_leading, match_and_update
from repro_torch.core.state import SamplerState, apply_cross_chunk_decrement, apply_update
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


def exsample_step(
    carry: ExSampleCarry, chunks: ChunkIndex, *, detector: DetectorFn, method: str = "exact"
) -> ExSampleCarry:
    """One iteration of Algorithm 1 (choose → process → update)."""
    with record_function("exsample.choose"):
        key, k_choice, k_det = prng.split(carry.key, 3)
        carry = dataclasses.replace(carry, key=key)
        chunk_id = thompson.choose_chunks(k_choice, carry.sampler, cohorts=1, method=method)[0]
    return _process_frame(carry, chunks, detector, chunk_id, k_det)


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
    with record_function("exsample.choose"):
        key, k_choice, k_det = prng.split(carry.key, 3)
        carry = dataclasses.replace(carry, key=key)
        chunk_ids = thompson.choose_chunks(k_choice, carry.sampler, cohorts=cohorts, method=method)
        det_keys = prng.split(k_det, cohorts)
    for i in range(cohorts):
        carry = _process_frame(carry, chunks, detector, chunk_ids[i], det_keys[i])
    return carry


def _step_fn(detector, cohorts, method):
    if cohorts == 1:
        return lambda c, chunks: exsample_step(c, chunks, detector=detector, method=method)
    return lambda c, chunks: exsample_batch_step(
        c, chunks, detector=detector, cohorts=cohorts, method=method)


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
    step_fn = _step_fn(detector, cohorts, method)
    while (
        int(carry.results) < result_limit
        and int(carry.step) < max_steps
        and not bool(torch.all(carry.sampler.exhausted()))
    ):
        prev_step = int(carry.step)
        carry = step_fn(carry, chunks)
        if trace_every and (int(carry.step) // trace_every) > (prev_step // trace_every):
            trace.append((int(carry.step), int(carry.results)))
    trace.append((int(carry.step), int(carry.results)))
    return carry, trace


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
):
    """Resident driver: the host driver's (step, results) trajectory and
    trace for the same key, with one exit-test sync per round and the trace
    read once at the end.  Returns (final_carry, trace)."""
    dev = carry.step.device
    # worst case one crossing per trace_every frames, the last round may
    # overshoot max_steps by cohorts-1, plus the unconditional final entry
    cap = (max_steps + cohorts - 1) // trace_every + 1 if trace_every else 1
    buf = torch.zeros((cap + 1, 2), dtype=torch.int32, device=dev)  # row cap: dropped writes
    n = 0
    step = int(carry.step)        # advances by exactly `cohorts` per round
    step_fn = _step_fn(detector, cohorts, method)
    limit = torch.tensor(result_limit, dtype=torch.int32, device=dev)

    def go(c: ExSampleCarry) -> torch.Tensor:
        return (c.results < limit) & (c.step < max_steps) & ~torch.all(c.sampler.exhausted())

    while True:
        with record_function("exsample.exit_test"):
            if not bool(go(carry)):   # the one device→host read per round
                break
        carry = step_fn(carry, chunks)
        prev, step = step, step + cohorts
        if trace_every and step // trace_every > prev // trace_every:
            buf[min(n, cap)] = torch.stack([carry.step, carry.results])
            n += 1
    buf[min(n, cap - 1)] = torch.stack([carry.step, carry.results])
    n = min(n + 1, cap)
    trace = [(int(s), int(r)) for s, r in buf[:n].tolist()]
    return carry, trace


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
):
    """Process half of a multi-query round: dedup the Q·C frames, resolve
    them through the cache, run one detector call and fold each query's
    slots, in order, into its own ring and statistics.  ``select`` sees
    row q as query q.

    Returns ``(mc', cache', fresh_calls i32[], cache_hits i32[], aux)``;
    ``fresh_calls`` counts the unique, uncached frames of live queries,
    what a deployment would send to the detector (the simulated detector
    still evaluates the whole batch, for fixed shapes)."""
    q_n, c = choice.chunk_ids.shape
    b = q_n * c
    dev = active.device
    query_ids = torch.arange(q_n, dtype=torch.int32, device=dev)
    flat_frames = choice.frame_ids.reshape(b)
    flat_valid = active[:, None].expand(q_n, c).reshape(b)

    with record_function("exsample.dedup_cache"):
        first_idx = dedup_first_index(flat_frames, flat_valid)
        is_rep = (first_idx == torch.arange(b, dtype=torch.int32, device=dev)) & flat_valid
    with record_function("exsample.detect"):
        fresh = detector(choice.det_keys.reshape(b, -1), flat_frames)
    with record_function("exsample.dedup_cache"):
        if cache is not None:
            hit, cached = cache_lookup(cache, flat_frames)
            resolved = tree_map(
                lambda cv, fv: torch.where(hit.reshape((b,) + (1,) * (fv.dim() - 1)), cv, fv),
                cached, fresh)
            need = is_rep & ~hit
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
):
    """Q concurrent queries over one repository, one detector call per
    round (DESIGN.md §9); the reference's ``_multi_search``.

    Rounds run until every query is finished.  The live mask
    (results < limit, step < max_steps, some chunk not exhausted) is
    computed on the device and read back once per round: that read is the
    exit test, and the host uses it to advance each query's step count
    (``cohorts`` per live round) and to decide trace checkpoints, which
    are written to a device buffer read once at the end (the reference's
    cap and its unconditional final entry).  ``cache_frames`` slots of
    ``DetectionCache`` (0 = no cache) are allocated once, before the
    first round.

    Returns ``(carries', traces, stats)``: per-query traces and the
    accounting ``detector_invocations``, ``cache_hits``, ``rounds``,
    ``frames_sampled`` (Σ per-query steps) and ``final_cache``.
    """
    dev = carries.step.device
    q_n = carries.step.shape[0]
    limits = torch.as_tensor(result_limits, dtype=torch.int32).expand(q_n).to(dev)
    cache = None
    if cache_frames:
        one = detector(carries.key[:1], torch.zeros((1,), dtype=torch.int64, device=dev))
        cache = init_detection_cache(tree_map(lambda x: x[0], one), cache_frames, device=dev)
    cap = (max_steps + cohorts - 1) // trace_every + 1 if trace_every else 1
    buf = torch.zeros((q_n, cap, 2), dtype=torch.int32, device=dev)
    n = [0] * q_n
    steps = carries.step.tolist()         # host copy, advanced by the live mask
    calls = torch.zeros((), dtype=torch.int32, device=dev)
    hits = torch.zeros((), dtype=torch.int32, device=dev)
    rounds = 0
    mc = carries

    def put(q: int, i: int) -> None:
        buf[q, i] = torch.stack([mc.step[q], mc.results[q]])

    while True:
        with record_function("exsample.exit_test"):
            active = ((mc.results < limits) & (mc.step < max_steps)
                      & ~torch.all(mc.sampler.exhausted(), dim=-1))
            live = active.tolist()        # the one device→host read per round
        if not any(live):
            break
        mc, cache, fresh, hit, _ = _multi_round(
            mc, cache, chunks, active, detector=detector, select=select,
            cohorts=cohorts, method=method)
        calls, hits, rounds = calls + fresh, hits + hit, rounds + 1
        for q in range(q_n):
            if not live[q]:
                continue
            prev, steps[q] = steps[q], steps[q] + cohorts
            if trace_every and steps[q] // trace_every > prev // trace_every:
                if n[q] < cap:
                    put(q, n[q])
                n[q] += 1
    for q in range(q_n):
        put(q, min(n[q], cap - 1))
        n[q] = min(n[q] + 1, cap)
    rows = buf.tolist()
    traces = [[tuple(e) for e in rows[q][: n[q]]] for q in range(q_n)]
    stats = {
        "detector_invocations": int(calls),
        "cache_hits": int(hits),
        "rounds": rounds,
        "frames_sampled": int(mc.step.sum()),
        "final_cache": cache,
    }
    return mc, traces, stats
