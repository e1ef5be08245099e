"""SearchPlan lowering + execution for the single-device kinds.

Counterpart of ``repro.core.executor``: ``lower(plan)`` resolves a
:class:`~repro_torch.core.plan.SearchPlan` with the reference's own rules
and ``LoweredPlan.run`` executes the ``host``, ``scan`` or ``multi``
driver, returning a :class:`SearchResult` with the same
:class:`SearchStats` the reference fills for those kinds.  The other
kinds, and the repository index, belong to later slices of the port and
raise :class:`PlanCompatibilityError` when lowered.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.chunks import ChunkIndex
from repro_torch.core.exsample import (
    DetectorFn,
    ExSampleCarry,
    LoopRecord,
    SelectFn,
    _host_search,
    _multi_search,
    _scan_search,
)
from repro_torch.core.plan import PlanCompatibilityError, PlanError, SearchPlan

# kinds the reference lowers that this package does not run yet, with the
# slice of the port that brings each
_LATER_SLICES = {
    "async": "the async runtime slice",
    "async_multi": "the async runtime slice",
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
    # the multi kind's final DetectionCache, or None; the reference hands
    # it to the repository index (a later slice of the port)
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
            "'host', 'scan' and 'multi' kinds", field="execution")
    if plan.execution.index is not None:
        raise PlanCompatibilityError(
            "execution.index needs the repository-index slice of the port",
            field="index")
    return LoweredPlan(plan=plan, kind=kind, method=method)


def _matcher_totals(carry: ExSampleCarry) -> dict:
    return dict(
        matcher_inserted=int(carry.matcher.total_inserted.sum()),
        matcher_capacity=int(carry.matcher.times_seen.shape[-1]),
    )


@dataclasses.dataclass(frozen=True)
class LoweredPlan:
    """A validated plan bound to ``host``, ``scan`` or ``multi``."""

    plan: SearchPlan
    kind: str
    method: str

    def run(self, carry: ExSampleCarry, chunks: ChunkIndex, *, detector: DetectorFn,
            select: SelectFn | None = None) -> SearchResult:
        """Run the plan from ``carry``.  ``multi`` takes a leading-[Q]
        carry, a batched detector and an optional ``select`` predicate
        (see ``core.exsample``); the other kinds a single-query carry."""
        p = self.plan
        multi = self.kind == "multi"
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
        limits = p.result_limit if isinstance(p.result_limit, tuple) else (p.result_limit,) * p.queries
        if not multi:
            args = dict(detector=detector, result_limit=int(limits[0]), max_steps=p.max_steps,
                        cohorts=p.cohorts, method=self.method, trace_every=p.trace_every)
            if self.kind == "host":
                (out, trace), loop = _host_search(carry, chunks, **args), None
            else:
                out, trace, loop = _scan_search(carry, chunks, **args)
            step = int(out.step)
            stats = SearchStats(detector_invocations=step, frames_sampled=step,
                                **_matcher_totals(out))
            return self._package(out, [trace], stats, loop=loop)
        cache = p.execution.cache
        if cache == -1:
            cache = chunks.total_frames
        out, traces, ms = _multi_search(
            carry, chunks, detector=detector, result_limits=[int(v) for v in limits],
            max_steps=p.max_steps, cohorts=p.cohorts, method=self.method,
            trace_every=p.trace_every, select=select, cache_frames=cache or 0,
        )
        stats = SearchStats(
            detector_invocations=ms["detector_invocations"], cache_hits=ms["cache_hits"],
            rounds=ms["rounds"], frames_sampled=ms["frames_sampled"], **_matcher_totals(out),
        )
        return self._package(out, traces, stats, final_cache=ms["final_cache"], loop=ms["loop"])

    def _package(self, out, traces, stats, final_cache=None, loop=None) -> SearchResult:
        return SearchResult(
            carry=out, steps=tuple(out.step.reshape(-1).tolist()),
            results=tuple(out.results.reshape(-1).tolist()), traces=traces,
            stats=stats, plan=self.plan, kind=self.kind, final_cache=final_cache, loop=loop,
        )
