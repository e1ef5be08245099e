"""SearchPlan lowering + execution for the single-device kinds.

Counterpart of ``repro.core.executor``: ``lower(plan)`` resolves a
:class:`~repro_torch.core.plan.SearchPlan` with the reference's own rules
and ``LoweredPlan.run`` executes the ``host``, ``scan``, ``multi``,
``async`` or ``async_multi`` driver, returning a :class:`SearchResult`
with the same :class:`SearchStats` the reference fills for those kinds.
A plan's ``execution.index`` (or an open index passed to ``run``) binds a
:class:`~repro_torch.index.RepositoryIndex`: the Thompson warm start, the
multi kind's cache preload and the write-back after the run.  The mesh
kinds belong to a later slice of the port and raise
:class:`PlanCompatibilityError` when lowered.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.chunks import ChunkIndex
from repro_torch.core.exsample import (
    DetectorFn,
    ExSampleCarry,
    LoopRecord,
    SelectFn,
    _host_search,
    _multi_search,
    _scan_search,
    detection_struct,
)
from repro_torch.core.plan import PlanCompatibilityError, PlanError, SearchPlan

# kinds the reference lowers that this package does not run yet, with the
# slice of the port that brings each
_LATER_SLICES = {
    "sharded": "the mesh slice",
    "multi_sharded": "the mesh slice",
}


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
    if kind in _LATER_SLICES:
        raise PlanCompatibilityError(
            f"plan lowers to kind {kind!r}, which repro_torch does not run yet "
            f"({_LATER_SLICES[kind]} of the port); this package runs the "
            "'host', 'scan', 'multi', 'async' and 'async_multi' kinds", field="execution")
    return LoweredPlan(plan=plan, kind=kind, method=method)


def _matcher_totals(carry: ExSampleCarry) -> dict:
    return dict(
        matcher_inserted=int(carry.matcher.total_inserted.sum()),
        matcher_capacity=int(carry.matcher.times_seen.shape[-1]),
    )


def _host64(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


@dataclasses.dataclass(frozen=True)
class LoweredPlan:
    """A validated plan bound to one single-device driver."""

    plan: SearchPlan
    kind: str
    method: str

    def run(self, carry: ExSampleCarry, chunks: ChunkIndex, *, detector: DetectorFn,
            select: SelectFn | None = None, index=None) -> SearchResult:
        """Run the plan from ``carry``.  ``multi`` and ``async_multi`` take
        a leading-[Q] carry, a batched detector and an optional ``select``
        predicate (see ``core.exsample``); the other kinds a single-query
        carry.  ``index`` passes an open
        :class:`~repro_torch.index.RepositoryIndex` instead of opening one
        from ``execution.index``."""
        p, ex = self.plan, self.plan.execution
        multi = self.kind in ("multi", "async_multi")
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
        if index is not None and cache and self.kind == "multi":
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

    def _package(self, out, traces, stats, final_cache=None, loop=None) -> SearchResult:
        return SearchResult(
            carry=out, steps=tuple(out.step.reshape(-1).tolist()),
            results=tuple(out.results.reshape(-1).tolist()), traces=traces,
            stats=stats, plan=self.plan, kind=self.kind, final_cache=final_cache, loop=loop,
        )
