"""SearchPlan lowering + execution.

Counterpart of ``repro.core.executor``: ``lower(plan)`` resolves a
:class:`~repro_torch.core.plan.SearchPlan` with the reference's own rules
and ``LoweredPlan.run`` executes the ``host``, ``scan``, ``multi``,
``async``, ``async_multi``, ``sharded`` or ``multi_sharded`` driver,
returning a :class:`SearchResult` with the reference's
:class:`SearchStats`; ``tenant_stats_from_row`` packages one slot of the
async driver the same way for the tenant service.
A plan's ``execution.index`` (or an open index passed to ``run``) binds a
:class:`~repro_torch.index.RepositoryIndex`: the Thompson warm start, the
Q-axis kinds' cache preload and the write-back after the run.

The module also holds the composed lowering, ``run_search_multi_sharded``:
the leading-[Q] multi-query carry over a data mesh (DESIGN.md §10), Q
queries and M-sharded statistics sharing one deduplicated detector pass a
shard a round, with the hash-sharded detection cache (DESIGN.md §14).  A
mesh kind runs on the carry's device unless ``run`` is given a mesh.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch
from torch.profiler import record_function

from repro_torch.core import prng
from repro_torch.core.chunks import ChunkIndex, randomplus_frame
from repro_torch.core.exsample import (
    DetectorFn,
    ExSampleCarry,
    LoopRecord,
    SelectFn,
    _check_mesh_geometry,
    _host_search,
    _matcher_sync,
    _mesh_trace_cap,
    _multi_search,
    _scan_search,
    _sharded_search,
    _trace_close,
    detection_struct,
)
from repro_torch.core.matcher import match_and_update
from repro_torch.core.plan import PlanError, SearchPlan
from repro_torch.core.state import SamplerState
from repro_torch.serve.batcher import tree_map


@dataclasses.dataclass(frozen=True)
class SearchStats:
    """Uniform per-run accounting (the reference's fields; the kinds the
    port runs fill detector invocations, cache hits, rounds, frames
    sampled and the ring totals)."""

    detector_invocations: int = 0
    cache_hits: int = 0
    rounds: int = 0
    frames_sampled: int = 0
    merge_high_water: int = 0
    merge_overflow: bool = False
    merges: int = 0
    reissues: int = 0
    duplicate_drops: int = 0
    results_spilled: int = 0
    matcher_inserted: int = 0
    matcher_capacity: int = 0
    index_hits: int = 0
    persisted_detections: int = 0
    warm_rounds_saved: int = 0

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.detector_invocations
        return self.cache_hits / total if total else 0.0

    @property
    def amortization(self) -> float:
        return self.frames_sampled / max(self.detector_invocations, 1)


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Outcome of ``SearchPlan.run``: final carry, per-query counters and
    traces, and :class:`SearchStats`."""

    carry: ExSampleCarry
    steps: tuple
    results: tuple
    traces: list
    stats: SearchStats
    plan: SearchPlan
    kind: str
    # the final DetectionCache of the multi and async_multi kinds, or None;
    # a bound repository index publishes it
    final_cache: object = None
    # how the resident loop ran (kinds scan and multi), else None
    loop: LoopRecord | None = None

    @property
    def num_queries(self) -> int:
        return len(self.steps)

    @property
    def trace(self):
        return self.traces[0]


def lower(plan: SearchPlan) -> "LoweredPlan":
    """Validate ``plan`` and bind it to one driver."""
    kind, method = plan.resolve()
    return LoweredPlan(plan=plan, kind=kind, method=method)


def tenant_stats_from_row(row) -> SearchStats:
    """One ``AsyncMultiSearchDriver`` row (live or vacated) as the
    :class:`SearchStats` a solo run reports, for the tenant service.
    Detector calls and cache hits are the row's by dedup representative:
    a frame another tenant's lane represented appears in neither.  Reads
    the carry's step and ring totals to host ints."""
    return SearchStats(
        detector_invocations=int(row.fresh_calls),
        cache_hits=int(row.cache_hits),
        rounds=int(row.rounds),
        frames_sampled=int(row.carry.step),
        results_spilled=len(row.log),
        index_hits=int(row.index_hits),
        warm_rounds_saved=int(row.warm_rounds_saved),
        **_matcher_totals(row.carry),
    )


def _matcher_totals(carry: ExSampleCarry) -> dict:
    return dict(
        matcher_inserted=int(carry.matcher.total_inserted.sum()),
        matcher_capacity=int(carry.matcher.times_seen.shape[-1]),
    )


def _host64(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


@dataclasses.dataclass(frozen=True)
class LoweredPlan:
    """A validated plan bound to one driver."""

    plan: SearchPlan
    kind: str
    method: str

    def run(self, carry: ExSampleCarry, chunks: ChunkIndex, *, detector: DetectorFn,
            select: SelectFn | None = None, mesh=None, index=None) -> SearchResult:
        """Run the plan from ``carry``.  ``multi``, ``multi_sharded`` and
        ``async_multi`` take a leading-[Q] carry, a batched detector and an
        optional ``select`` predicate (see ``core.exsample``); the other
        kinds a single-query carry.  The mesh kinds run on ``mesh`` (a
        :class:`~repro_torch.launch.mesh.DataMesh` whose extent must be the
        plan's ``shards``), by default ``execution.shards`` shards on the
        carry's device.  ``index`` passes an open
        :class:`~repro_torch.index.RepositoryIndex` instead of opening one
        from ``execution.index``."""
        p, ex = self.plan, self.plan.execution
        multi = self.kind in ("multi", "multi_sharded", "async_multi")
        ndim = carry.step.dim()
        if multi and ndim != 1:
            raise PlanError(
                f"the {self.kind!r} lowering needs a leading-[Q] carry "
                "(init_carry_multi / stack_carries); got a single-query carry",
                field="queries")
        if multi and carry.step.shape[0] != p.queries:
            raise PlanError(
                f"carry has {carry.step.shape[0]} queries but the plan declares "
                f"queries={p.queries}", field="queries")
        if not multi and ndim != 0:
            raise PlanError(
                f"the {self.kind!r} lowering is single-query but the carry has a "
                "leading axis; set queries/queries_axis on the plan", field="queries")
        if select is not None and not multi:
            raise PlanError(
                "select predicates ride on the shared Q-axis detector pass; this "
                f"plan lowers to the single-query {self.kind!r} driver", field="queries")
        cache = ex.cache
        if cache == -1:
            cache = chunks.total_frames
        if cache and self.kind == "multi_sharded":
            # the hash-sharded placement needs a capacity that divides over
            # the mesh; padded before the index's warm so that the preload
            # and the shards agree on one modulus
            cache += (-cache) % ex.shards
        limits = p.result_limit if isinstance(p.result_limit, tuple) else (p.result_limit,) * p.queries

        # ---- the repository index: open, version check, Thompson warm
        # start, the multi kind's cache preload --------------------------
        spec = ex.index
        if index is None and spec is not None:
            from repro_torch.index import RepositoryIndex

            index = RepositoryIndex.open(spec)
        elif index is not None and spec is not None and spec.detector_version != index.detector_version:
            raise PlanError(
                f"plan declares index.detector_version={spec.detector_version!r} but the live index "
                f"holds {index.detector_version!r} — a version mismatch must be a clean miss, not a "
                "silent replay", field="detector_version")
        prior_weight = spec.prior_weight if spec is not None else (
            index.prior_weight if index is not None else 0.0)
        warm_rounds_saved = 0
        if index is not None and prior_weight > 0:
            warmed, equiv = index.priors.warm_sampler(carry.sampler, None, prior_weight)
            if equiv:
                carry = dataclasses.replace(carry, sampler=warmed)
                warm_rounds_saved = int(equiv) // max(p.cohorts, 1)
        if index is not None:
            # the evidence base after the boost: recorded deltas never count
            # the injected priors as evidence
            n1_base, n_base = _host64(carry.sampler.n1), _host64(carry.sampler.n)
        warm_cache = warm_tag = None
        if index is not None and cache and self.kind in ("multi", "multi_sharded"):
            dev = carry.step.device
            warm_cache, _ = index.warm(detection_struct(detector, carry.key[0]), cache, device=dev)
            # a copy: the run updates the cache's tag in place
            warm_tag = warm_cache.tag[:cache].clone()

        def finish(out, traces, stats, final_cache=None, index_hits=0, loop=None):
            """The index's write-back, shared by every kind."""
            if index is not None:
                persisted = 0
                if not index.read_only:
                    persisted = index.publish_cache(final_cache)
                    index.priors.record(None, _host64(out.sampler.n1) - n1_base,
                                        _host64(out.sampler.n) - n_base)
                    if index.path is not None:
                        index.save()
                stats = dataclasses.replace(stats, index_hits=int(index_hits),
                                            persisted_detections=int(persisted),
                                            warm_rounds_saved=warm_rounds_saved)
            return self._package(out, traces, stats, final_cache=final_cache, loop=loop)

        if self.kind in ("host", "scan"):
            args = dict(detector=detector, result_limit=int(limits[0]), max_steps=p.max_steps,
                        cohorts=p.cohorts, method=self.method, trace_every=p.trace_every)
            if self.kind == "host":
                (out, trace), loop = _host_search(carry, chunks, **args), None
            else:
                out, trace, loop = _scan_search(carry, chunks, **args)
            step = int(out.step)
            stats = SearchStats(detector_invocations=step, frames_sampled=step, **_matcher_totals(out))
            return finish(out, [trace], stats, loop=loop)

        if self.kind == "async":
            from repro_torch.core.runtime import AsyncSearchDriver

            driver = AsyncSearchDriver(carry, chunks, detector, cohort_size=p.cohorts,
                                       num_workers=ex.async_workers, result_limit=int(limits[0]),
                                       max_frames=p.max_steps)
            out = driver.run()
            step = int(out.step)
            stats = SearchStats(
                detector_invocations=step, frames_sampled=step,
                merge_high_water=int(driver.stats["merge_high_water"]), merges=int(driver.stats["merges"]),
                reissues=int(driver.stats["reissues"]),
                duplicate_drops=int(driver.stats["duplicate_drops"]),
                results_spilled=int(driver.stats["spilled"]), **_matcher_totals(out))
            return finish(out, [[(step, int(out.results))]], stats)

        if self.kind == "async_multi":
            from repro_torch.core.runtime import AsyncMultiSearchDriver

            driver = AsyncMultiSearchDriver(
                carry, chunks, detector, cohorts=p.cohorts, num_workers=ex.async_workers,
                result_limits=[int(v) for v in limits], max_steps=p.max_steps, method=self.method,
                select=select, cache_frames=cache or 0, trace_every=p.trace_every, index=index)
            out = driver.run()
            st = driver.stats
            stats = SearchStats(
                detector_invocations=int(st["detector_invocations"]), cache_hits=int(st["cache_hits"]),
                rounds=int(st["rounds"]), frames_sampled=int(out.step.sum()),
                merge_high_water=int(st["merge_high_water"]), merges=int(st["merges"]),
                reissues=int(st["reissues"]), duplicate_drops=int(st["duplicate_drops"]),
                results_spilled=int(st["spilled"]), **_matcher_totals(out))
            return finish(out, driver.traces, stats, final_cache=driver.cache,
                          index_hits=int(st["index_hits"]))

        if self.kind == "multi":
            out, traces, ms = _multi_search(
                carry, chunks, detector=detector, result_limits=[int(v) for v in limits],
                max_steps=p.max_steps, cohorts=p.cohorts, method=self.method,
                trace_every=p.trace_every, select=select, cache_frames=cache or 0,
                cache=warm_cache, warm_tag=warm_tag,
            )
            stats = SearchStats(
                detector_invocations=ms["detector_invocations"], cache_hits=ms["cache_hits"],
                rounds=ms["rounds"], frames_sampled=ms["frames_sampled"], **_matcher_totals(out),
            )
            return finish(out, traces, stats, final_cache=ms["final_cache"], index_hits=ms["index_hits"],
                          loop=ms["loop"])

        # ---- the mesh kinds ---------------------------------------------
        if mesh is None:
            from repro_torch.launch.mesh import make_data_mesh

            if ex.axis != "data":
                raise PlanError(f"axis={ex.axis!r}: only a 'data' mesh can be built automatically — pass "
                                "mesh= with the named axis", field="axis")
            mesh = make_data_mesh(ex.shards, device=carry.step.device)
        elif mesh.shape.get(ex.axis) != ex.shards:
            raise PlanError(
                f"mesh axes {mesh.shape} do not provide the plan's {ex.shards} {ex.axis!r} shards — the "
                "validated cohorts/shards geometry must match what executes", field="shards")
        if self.kind == "sharded":
            out, trace, sh = _sharded_search(
                carry, chunks, mesh=mesh, detector=detector, result_limit=int(limits[0]),
                max_steps=p.max_steps, cohorts=p.cohorts, sync_every=ex.sync_every)
            step = int(out.step)
            stats = SearchStats(
                detector_invocations=step, frames_sampled=step, merge_high_water=sh["merge_high_water"],
                merge_overflow=sh["merge_overflow"], merges=sh["merges"], **_matcher_totals(out))
            return finish(out, [trace], stats)

        out, traces, ms = run_search_multi_sharded(
            carry, chunks, mesh=mesh, detector=detector, select=select,
            result_limits=[int(v) for v in limits], max_steps=p.max_steps, cohorts=p.cohorts,
            sync_every=ex.sync_every, cache_frames=cache or 0, cache=warm_cache, warm_tag=warm_tag)
        stats = SearchStats(
            detector_invocations=ms["detector_invocations"], cache_hits=ms["cache_hits"],
            rounds=ms["rounds"], frames_sampled=ms["frames_sampled"],
            merge_high_water=ms["merge_high_water"], merge_overflow=ms["merge_overflow"],
            merges=ms["merges"], **_matcher_totals(out))
        return finish(out, traces, stats, final_cache=ms["final_cache"], index_hits=ms["index_hits"])

    def _package(self, out, traces, stats, final_cache=None, loop=None) -> SearchResult:
        return SearchResult(
            carry=out, steps=tuple(out.step.reshape(-1).tolist()),
            results=tuple(out.results.reshape(-1).tolist()), traces=traces,
            stats=stats, plan=self.plan, kind=self.kind, final_cache=final_cache, loop=loop,
        )


# ---------------------------------------------------------------------------
# Composed lowering: Q-query carry × M-sharded statistics (DESIGN.md §10)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ShardSlots:
    """One shard's slots of a composed round: its cohorts of every query
    (``[Q, C/S]``), flattened query-major into one detector batch."""

    cids: torch.Tensor
    live: torch.Tensor
    fids: torch.Tensor
    videos: torch.Tensor
    frames: torch.Tensor = None     # int64[b], b = Q·C/S
    first: torch.Tensor = None      # each slot's dedup representative
    is_rep: torch.Tensor = None
    fresh: object = None            # the detector's output, leading [b]
    hit: torch.Tensor = None        # served by the cache
    need: torch.Tensor = None       # representatives the detector pays for
    resolved: object = None         # the cache's detections where it hit, else fresh


def _route_cache(caches: list, batch: list, req: torch.Tensor, mesh) -> None:
    """One round through the hash-sharded cache (frame f homed on shard
    ``f % S``): every home answers every requester's probes from the
    replicated frame matrix ``req`` (i32[Q, C], -1 for a dead slot), the
    answers go back to the requesters and the fresh detections to their
    homes (four ``all_to_all``s), and each home inserts what it received.
    Every lookup precedes every insert.  Sets each shard's ``hit``,
    ``need`` and ``resolved``."""
    from repro_torch.core.distributed import all_to_all
    from repro_torch.serve.batcher import sharded_cache_insert, sharded_cache_lookup

    s_n, devs = mesh.size, mesh.devices
    q_n, b = req.shape[0], batch[0].frames.shape[0]
    req = req.reshape(q_n, s_n, b // q_n).transpose(0, 1).reshape(s_n, b)
    answers = [sharded_cache_lookup(caches[h], req.to(d), h, s_n) for h, d in enumerate(devs)]
    a_hit = all_to_all([a[0] for a in answers], mesh)        # row h: home h's answer for my b slots
    a_vals = tree_map(lambda *xs: all_to_all(list(xs), mesh), *(a[1] for a in answers))
    ins_frames = []
    for s, (d, sb) in enumerate(zip(devs, batch)):
        home = torch.where(sb.frames >= 0, torch.remainder(sb.frames, s_n), torch.zeros_like(sb.frames))
        bi = torch.arange(b, device=d)
        sb.hit = a_hit[s][home, bi]
        sb.resolved = tree_map(lambda cv, fv: torch.where(sb.hit.reshape((b,) + (1,) * (fv.dim() - 1)), cv, fv),
                               tree_map(lambda x: x[s][home, bi], a_vals), sb.fresh)
        sb.need = sb.is_rep & ~sb.hit
        dest = torch.arange(s_n, device=d)[:, None]
        ins_frames.append(torch.where((home[None, :] == dest) & sb.need[None, :], sb.frames[None, :],
                                      torch.full_like(sb.frames[None, :], -1)))
    # received rows flattened requester-major: the batch order of the
    # direct-mapped cache's insert, so a slot collision has its winner
    g_frames = [x.reshape(-1) for x in all_to_all(ins_frames, mesh)]
    g_vals = tree_map(lambda *xs: [x.reshape((-1,) + x.shape[2:]) for x in all_to_all(
        [x.expand((s_n,) + x.shape) for x in xs], mesh)], *(sb.fresh for sb in batch))
    for h in range(s_n):
        sharded_cache_insert(caches[h], g_frames[h], tree_map(lambda v: v[h], g_vals), g_frames[h] >= 0, h, s_n)


def run_search_multi_sharded(
    carries: ExSampleCarry,
    chunks: ChunkIndex,
    *,
    mesh,
    detector: DetectorFn,
    result_limits,
    max_steps: int,
    cohorts: int | None = None,
    sync_every: int = 1,
    select: SelectFn | None = None,
    cache_frames: int = 0,
    cache=None,
    warm_tag: torch.Tensor | None = None,
    window_limit: int | None = None,
):
    """Q concurrent queries × an M-sharded mesh, one deduplicated detector
    pass a shard a round: the reference's ``_search_multi_sharded_device``
    and ``run_search_multi_sharded``.

    ``carries`` has a leading [Q] (``init_carry_multi``); ``detector`` is
    batched, as the multi kind's.  ``cohorts`` is each query's global
    batch a round and must divide over the mesh.  Each round the batched
    choice (one fused launch of B2 a shard) hands shard s cohorts
    ``[s·C/S, (s+1)·C/S)`` of every query; their Q·C/S frames are
    deduplicated into one detector call and resolved through the
    hash-sharded cache (frame f homed on shard ``f % S``): the replicated
    frame matrix lets each home shard answer every requester's probes, so
    a round routes hit flags and values to the requesters and the fresh
    detections to their homes, four ``all_to_all``s in all.  Each query
    then folds its slots in order, the Q queries together (one batched B3
    launch a slot).  Liveness is read at window starts: a finished query
    is frozen (key, statistics, slots out of the dedup).  Every
    ``sync_every`` rounds the per-query deltas are summed, the rings
    folded with the k−1 add-back, and the host reads the live mask.

    With a deterministic detector, query q's trajectory, trace, statistics
    and key equal its own solo ``sharded`` run on the same mesh.

    ``cache`` replaces a fresh cache of ``cache_frames`` slots (padded to a
    multiple of S), ``warm_tag`` (i32, the preload's tag) splits
    ``index_hits`` out of ``cache_hits``, and the final cache comes back
    in ``stats["final_cache"]`` in the direct-mapped layout.
    ``window_limit`` caps the sync windows this call runs: a capped call
    returns at a sync boundary with a resumable carry and cache, the
    elastic runner's drain point.  ``stats["query_windows"]`` counts the
    windows each query ran in this call."""
    from repro_torch.core.distributed import combine_winners, pad_chunks, psum, shard_sampler_state, shard_winners
    from repro_torch.serve.batcher import dedup_first_index, gather_cache, init_detection_cache, scatter_cache

    s_n = mesh.size
    cohorts = _check_mesh_geometry(s_n, cohorts, sync_every)
    dev, devs = mesh.device, mesh.devices
    q_n = carries.step.shape[0]
    m0 = carries.sampler.num_chunks
    shards = shard_sampler_state(pad_chunks(carries.sampler, s_n), mesh)
    lm = shards[0].num_chunks
    m = lm * s_n
    per_shard = cohorts // s_n
    b = q_n * per_shard
    cap = _mesh_trace_cap(max_steps, cohorts, sync_every)
    fdt = shards[0].n.dtype
    a0, b0 = carries.sampler.alpha0, carries.sampler.beta0
    n1_l, n_l, frames_l = [s.n1 for s in shards], [s.n for s in shards], [s.frames for s in shards]
    chunks = chunks.to(dev)
    keys, step, results = carries.key.to(dev), carries.step.to(dev), carries.results.to(dev)
    limits = torch.as_tensor(result_limits, dtype=torch.int32).expand(q_n).to(dev)
    qi = torch.arange(q_n, dtype=torch.int32, device=dev)
    snap = carries.matcher.to(dev)
    matchers = [snap.to(d) for d in devs]
    cap_r = snap.capacity
    pshard = torch.arange(cohorts, dtype=torch.int32, device=dev) // per_shard

    if cache is None and cache_frames:
        cache_frames += (-cache_frames) % s_n
        cache = init_detection_cache(detection_struct(detector, keys[0]), cache_frames, device=dev)
    caches = scatter_cache(cache, mesh) if cache is not None else None
    if warm_tag is not None:
        warm_tag = warm_tag.to(dev)

    def live_mask() -> torch.Tensor:
        exh = [(n >= f.to(fdt)).all(dim=-1).int() for n, f in zip(n_l, frames_l)]
        exhausted = psum(exh, mesh)[0] == s_n
        return (results < limits) & (step < max_steps) & ~exhausted

    def rows(x: torch.Tensor) -> torch.Tensor:
        """Chunk ids ``[Q, ...]`` as positions in a flattened ``[Q, M]``."""
        return (x.long() + (qi.long() * m).reshape((q_n,) + (1,) * (x.dim() - 1))).reshape(-1)

    def one_round(keys, active, dn1, dn, foreign, counters):
        ks = prng.split(keys, 3)
        key_next = ks[:, 0]
        # in one threefry: fold_in(k_choice[q], s) for each shard s and
        # fold_in(k_det[q], g) for each global cohort g (split's counters)
        sub = prng.split(ks[:, 1:], max(s_n, cohorts))

        sl = [slice(s * lm, (s + 1) * lm) for s in range(s_n)]
        views = [SamplerState(n1=n1_l[s] + dn1[s][:, sl[s]], n=n_l[s] + dn[s][:, sl[s]], frames=frames_l[s],
                              alpha0=a0, beta0=b0) for s in range(s_n)]
        with record_function("exsample.choose"):
            c_ids, c_scores, c_n = combine_winners(
                [shard_winners(sub[:, 0, s].to(d), views[s], s, cohorts) for s, d in enumerate(devs)], mesh)
            live_c = torch.isfinite(c_scores) & active[:, None]
            owner = c_ids // lm
            same_before = torch.tril(c_ids[:, :, None] == c_ids[:, None, :], diagonal=-1)
            occ = (same_before & live_c[:, None, :]).sum(-1)
            fgather = torch.gather(foreign, -1, c_ids.long())
            ranks = (c_n + fgather.to(fdt) + occ.to(fdt)).int()
            foreign = foreign.reshape(-1).index_add(
                0, rows(c_ids), ((pshard[None, :] != owner) & live_c).int().reshape(-1)).reshape(q_n, m)
            fids_all = randomplus_frame(chunks, c_ids, ranks)                   # [Q, C]
            videos = torch.take(chunks.video_id, c_ids.long())
            det_keys = sub[:, 1, :cohorts]

        # ---- every shard's batch: its cohorts of every query, deduped ----
        batch = []
        for s, d in enumerate(devs):
            g = slice(s * per_shard, (s + 1) * per_shard)
            sb = _ShardSlots(cids=c_ids[:, g].to(d), live=live_c[:, g].to(d), fids=fids_all[:, g].to(d),
                             videos=videos[:, g].to(d))
            sb.frames = sb.fids.reshape(b)
            flat_live = sb.live.reshape(b)
            with record_function("exsample.dedup_cache"):
                sb.first = dedup_first_index(sb.frames, flat_live)
                sb.is_rep = (sb.first == torch.arange(b, dtype=torch.int32, device=d)) & flat_live
            with record_function("exsample.detect"):
                sb.fresh = detector(det_keys[:, g].reshape(b, -1).to(d), sb.frames)
            sb.hit, sb.need, sb.resolved = torch.zeros_like(sb.is_rep), sb.is_rep, sb.fresh
            batch.append(sb)
        if caches is not None:
            with record_function("exsample.dedup_cache"):
                _route_cache(caches, batch, torch.where(live_c, fids_all, torch.full_like(fids_all, -1)), mesh)

        # ---- counters, then each query's fold over its own slots ---------
        for s, (d, sb) in enumerate(zip(devs, batch)):
            ihit = torch.zeros((), dtype=torch.int32, device=d)
            if warm_tag is not None:
                wt = warm_tag.to(d)
                wslot = torch.remainder(sb.frames, wt.shape[0]).long()
                ihit = (sb.is_rep & sb.hit & (wt[wslot] == sb.frames)).sum().int()
            counters[s] = counters[s] + torch.stack([sb.need.sum().int(), (sb.is_rep & sb.hit).sum().int(), ihit])
            dets = tree_map(lambda x: x[sb.first.long()].reshape((q_n, per_shard) + x.shape[1:]), sb.resolved)
            outs = []
            for j in range(per_shard):
                with record_function("exsample.match"):
                    dj = tree_map(lambda x: x[:, j], dets)
                    valid = dj.valid & sb.live[:, j, None]
                    if select is not None:
                        valid = valid & select(qi.to(d), dj)
                    mres = match_and_update(matchers[s], dj.boxes, dj.feats, valid, sb.videos[:, j], sb.fids[:, j],
                                            sb.cids[:, j])
                matchers[s] = mres.new_state
                outs.append(mres)
            # the shard's updates in one go: every delta is a count, so the
            # sums are exact in any order
            with record_function("exsample.update"):
                upd = sb.live.to(fdt)
                d0 = torch.stack([o.d0 for o in outs], dim=1)                 # [Q, C/S]
                dl = torch.stack([o.d1 - o.cross_chunk for o in outs], dim=1)
                dn1[s].view(-1).index_add_(0, rows(sb.cids), ((d0 - dl).to(fdt) * upd).reshape(-1))
                dn[s].view(-1).index_add_(0, rows(sb.cids), upd.reshape(-1))
                home = torch.stack([o.cross_home for o in outs], dim=1)       # [Q, C/S, R]
                valid_home = home >= 0
                dn1[s].view(-1).index_add_(0, rows(torch.where(valid_home, home, torch.zeros_like(home))),
                                           -valid_home.to(fdt).reshape(-1))
                lstep[s] = lstep[s] + sb.live.int().sum(-1).int()
                lres[s] = lres[s] + d0.sum(-1).int()
        keys = torch.where(active[:, None], key_next, keys)
        return keys, foreign

    counters = [torch.zeros((3,), dtype=torch.int32, device=d) for d in devs]
    hw = torch.zeros((), dtype=torch.int32, device=dev)
    ov = torch.zeros((), dtype=torch.bool, device=dev)
    wlimit = np.iinfo(np.int32).max if window_limit is None else int(window_limit)
    traces = [[] for _ in range(q_n)]
    query_windows = [0] * q_n
    windows = 0
    matcher = snap
    active = live_mask()
    act_h = active.tolist()
    while any(act_h) and windows < wlimit:
        dn1 = [torch.zeros((q_n, m), dtype=fdt, device=d) for d in devs]
        dn = [torch.zeros((q_n, m), dtype=fdt, device=d) for d in devs]
        foreign = torch.zeros((q_n, m), dtype=torch.int32, device=dev)
        lstep = [torch.zeros((q_n,), dtype=torch.int32, device=d) for d in devs]
        lres = [torch.zeros((q_n,), dtype=torch.int32, device=d) for d in devs]
        for _ in range(sync_every):
            keys, foreign = one_round(keys, active, dn1, dn, foreign, counters)
        with record_function("exsample.sync"):
            tot1, tot = psum(dn1, mesh), psum(dn, mesh)
            n1_l = [n1_l[s] + tot1[s][:, s * lm:(s + 1) * lm] for s in range(s_n)]
            n_l = [n_l[s] + tot[s][:, s * lm:(s + 1) * lm] for s in range(s_n)]
            matcher, corr, inserted = _matcher_sync(matchers, snap, mesh, m, fdt)
            n1_l = [n1_l[s] + corr[:, s * lm:(s + 1) * lm].to(d) for s, d in enumerate(devs)]
            hw = torch.maximum(hw, inserted.max())
            ov = ov | (inserted >= cap_r).any()
            step = step + psum(lstep, mesh)[0]
            results = results + psum(lres, mesh)[0]
            snap, matchers = matcher, [matcher.to(d) for d in devs]
            windows += 1
            active = live_mask()
            nxt, s_h, r_h = torch.stack([active.int(), step, results]).tolist()
        for q in range(q_n):
            if act_h[q]:
                query_windows[q] += 1
                if len(traces[q]) < cap:
                    traces[q].append((s_h[q], r_h[q]))
        act_h = nxt
    s_h, r_h = step.tolist(), results.tolist()
    traces = [_trace_close(traces[q], (s_h[q], r_h[q]), cap) for q in range(q_n)]
    calls, hits_n, ihits = psum(counters, mesh)[0].tolist()
    out = ExSampleCarry(
        sampler=dataclasses.replace(carries.sampler, n1=torch.cat([x.to(dev) for x in n1_l], dim=-1)[:, :m0],
                                    n=torch.cat([x.to(dev) for x in n_l], dim=-1)[:, :m0],
                                    frames=carries.sampler.frames),
        matcher=matcher, key=keys, step=step, results=results,
    )
    stats = {
        "detector_invocations": calls,
        "cache_hits": hits_n,
        "index_hits": ihits,
        "rounds": windows * sync_every,
        "frames_sampled": sum(s_h),
        "merge_high_water": int(hw),
        "merge_overflow": bool(ov),
        "merges": windows,
        "final_cache": gather_cache(caches, mesh) if caches is not None else None,
        "query_windows": query_windows,
    }
    return out, traces, stats
