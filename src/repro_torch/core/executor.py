"""SearchPlan lowering + execution for the single-query kinds.

Counterpart of ``repro.core.executor``: ``lower(plan)`` resolves a
:class:`~repro_torch.core.plan.SearchPlan` with the reference's own rules
and ``LoweredPlan.run`` executes the ``host`` or ``scan`` driver,
returning a :class:`SearchResult` with the same :class:`SearchStats` the
reference fills for those kinds.  The other kinds belong to later slices
of the port and raise :class:`PlanCompatibilityError` when lowered.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.chunks import ChunkIndex
from repro_torch.core.exsample import DetectorFn, ExSampleCarry, _host_search, _scan_search
from repro_torch.core.plan import PlanCompatibilityError, PlanError, SearchPlan

# kinds the reference lowers that this package does not run yet, with the
# slice of the port that brings each
_LATER_SLICES = {
    "multi": "the Q-axis multi-query slice",
    "async": "the async runtime slice",
    "async_multi": "the async runtime slice",
    "sharded": "the mesh slice",
    "multi_sharded": "the mesh slice",
}


@dataclasses.dataclass(frozen=True)
class SearchStats:
    """Uniform per-run accounting (the reference's fields; the single-query
    kinds fill detector invocations, frames sampled and the ring totals)."""

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
            "single-query 'host' and 'scan' kinds", field="execution")
    if plan.execution.index is not None:
        raise PlanCompatibilityError(
            "execution.index needs the repository-index slice of the port",
            field="index")
    return LoweredPlan(plan=plan, kind=kind, method=method)


@dataclasses.dataclass(frozen=True)
class LoweredPlan:
    """A validated plan bound to ``host`` or ``scan``."""

    plan: SearchPlan
    kind: str
    method: str

    def run(self, carry: ExSampleCarry, chunks: ChunkIndex, *, detector: DetectorFn) -> SearchResult:
        p = self.plan
        if carry.step.dim() != 0:
            raise PlanError(
                f"the {self.kind!r} lowering is single-query but the carry has a "
                "leading axis", field="queries")
        limit = p.result_limit[0] if isinstance(p.result_limit, tuple) else p.result_limit
        fn = _host_search if self.kind == "host" else _scan_search
        out, trace = fn(
            carry, chunks, detector=detector, result_limit=int(limit),
            max_steps=p.max_steps, cohorts=p.cohorts, method=self.method,
            trace_every=p.trace_every,
        )
        step = int(out.step)
        stats = SearchStats(
            detector_invocations=step, frames_sampled=step,
            matcher_inserted=int(out.matcher.total_inserted),
            matcher_capacity=int(out.matcher.times_seen.shape[-1]),
        )
        return SearchResult(
            carry=out, steps=(step,), results=(int(out.results),), traces=[trace],
            stats=stats, plan=p, kind=self.kind,
        )
