"""Declarative search plans — one entry point for every driver.

Counterpart of ``repro.core.plan``: ``SearchPlan`` (WHAT to search) and
``Execution`` (HOW to run it), their typed ``PlanError`` family, serde and
``resolve()`` are copied whole, so a plan dict validates and resolves to
the same ``(kind, method)`` in both packages.  ``lower()`` binds every
kind: ``host``, ``scan``, ``multi``, ``async``, ``async_multi`` and the
mesh kinds ``sharded`` and ``multi_sharded``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

_STRATEGIES = ("auto", "host", "scan", "sharded", "async")
_METHODS = ("auto", "exact", "wilson_hilferty", "pallas")


class PlanError(ValueError):
    """A :class:`SearchPlan` that cannot be lowered.

    ``field`` names the offending option so tooling can point at it.
    Subclasses: :class:`PlanValueError` (an option invalid on its own),
    :class:`PlanCompatibilityError` (valid options that cannot combine).
    """

    def __init__(self, message: str, *, field: str | None = None):
        super().__init__(message)
        self.field = field


class PlanValueError(PlanError):
    """An option value that is invalid regardless of the rest of the plan."""


class PlanCompatibilityError(PlanError):
    """Individually-valid options that no lowering can combine."""


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Per-tenant service contract riding on an :class:`Execution`
    (DESIGN.md §12) — consumed by the tenant service
    at admission, ignored by every batch lowering.

    * ``slo_latency_s`` — time-to-FIRST-result objective, measured from
      admission onto the driver (0.0 = no SLO; the service reports
      attainment, it never kills a query for missing it).
    * ``priority`` — admission-queue ordering (higher admits first among
      queued plans; FIFO within a priority level).
    * ``queue_on_reject`` — a plan whose projected cost exceeds the
      remaining budget queues for later capacity instead of being
      rejected outright.
    """

    slo_latency_s: float = 0.0
    priority: int = 0
    queue_on_reject: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServiceConfig":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise PlanValueError(
                f"unknown ServiceConfig option(s) {sorted(unknown)}; valid: "
                f"{sorted(f.name for f in dataclasses.fields(cls))}",
                field=sorted(unknown)[0],
            )
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Persistent repository-index binding riding on an :class:`Execution`
    (DESIGN.md §13) — consumed by the executor (and the serving path) to
    open / warm / write back a
    repository index.

    * ``path`` — snapshot directory (auto-loaded when it exists, saved at
      the end of a writable run); ``None`` keeps the index in-memory.
    * ``detector_version`` — the host tier is keyed by
      ``(frame_id, detector_version)``, so a model upgrade is a clean
      miss instead of replaying stale detections.
    * ``read_only`` — consult the index but never publish or save.
    * ``prior_weight`` — how many frames of accumulated past-search
      evidence each chunk's Thompson prior is worth (0.0 = cold start,
      bit-identical to a plan without an index).
    """

    path: Optional[str] = None
    detector_version: str = "v0"
    read_only: bool = False
    prior_weight: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "IndexSpec":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise PlanValueError(
                f"unknown IndexSpec option(s) {sorted(unknown)}; valid: "
                f"{sorted(f.name for f in dataclasses.fields(cls))}",
                field=sorted(unknown)[0],
            )
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Execution:
    """HOW a plan runs — the execution strategy half of the split.

    * ``strategy`` — ``"auto"`` picks the lowering from the other options
      (DESIGN.md §10 rules); ``"host"``/``"scan"``/``"sharded"``/``"async"``
      force a driver family.
    * ``shards`` — data-axis mesh extent; ``> 1`` selects the mesh-resident
      §8 loop (chunk statistics sharded, delta-psum merge schedule).
    * ``queries_axis`` — the carry has a leading ``[Q]`` axis and the §9
      Q-batched machinery (cross-query dedup, one detector pass per round)
      is used even at Q=1.  Implied by ``SearchPlan.queries > 1``.
    * ``sync_every`` — rounds between sampler/matcher merges on the mesh
      paths (eventual-consistency Thompson, §8).
    * ``async_workers`` — ``> 0`` lowers to the threaded async runtime:
      the single-query async search driver, or
      — composed with the Q axis — the slot-based
      async multi-query driver (DESIGN.md
      §11).  Cannot combine with mesh sharding.
    * ``cache`` — detection cache capacity:
      ``None`` disables, ``-1`` sizes it to the repository at run time,
      positive values trade memory for evictions.  Requires the Q-axis
      machinery (the cache lives on the shared detector pass).
    * ``service`` — optional :class:`ServiceConfig` per-tenant contract
      (SLO / priority / queue-on-reject); only the serving path reads it.
    * ``index`` — optional :class:`IndexSpec` persistent repository-index
      binding (DESIGN.md §13): the executor preloads the detection cache
      from the index, writes fresh detections back at the end of the run
      and warm-starts Thompson alphas by ``prior_weight``.
    """

    strategy: str = "auto"
    shards: int = 1
    axis: str = "data"
    queries_axis: bool = False
    sync_every: int = 1
    async_workers: int = 0
    cache: Optional[int] = None
    service: Optional[ServiceConfig] = None
    index: Optional[IndexSpec] = None

    def __post_init__(self):
        if isinstance(self.service, dict):
            object.__setattr__(
                self, "service", ServiceConfig.from_dict(self.service)
            )
        if isinstance(self.index, dict):
            object.__setattr__(
                self, "index", IndexSpec.from_dict(self.index)
            )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Execution":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise PlanValueError(
                f"unknown Execution option(s) {sorted(unknown)}; valid: "
                f"{sorted(f.name for f in dataclasses.fields(cls))}",
                field=sorted(unknown)[0],
            )
        if isinstance(d.get("service"), dict):
            d["service"] = ServiceConfig.from_dict(d["service"])
        if isinstance(d.get("index"), dict):
            d["index"] = IndexSpec.from_dict(d["index"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class SearchPlan:
    """WHAT to search: queries × limits × budget, plus the
    :class:`Execution` strategy.  ``lower()`` validates and resolves the
    plan to one driver; ``run()`` executes it and returns a
    :class:`~repro_torch.core.executor.SearchResult`.

    ``result_limit`` is an int (shared by every query) or a tuple with one
    entry per query.  ``method`` is the Thompson sampler — ``"auto"``
    resolves to exact Gamma on host/scan/multi lowerings and to
    Wilson–Hilferty on the mesh-resident paths (which never run the
    rejection sampler, DESIGN.md §3/§8).
    """

    queries: int = 1
    result_limit: Union[int, tuple] = 50
    max_steps: int = 10_000
    cohorts: int = 1
    method: str = "auto"
    trace_every: int = 0
    execution: Execution = dataclasses.field(default_factory=Execution)

    def __post_init__(self):
        if isinstance(self.result_limit, list):
            object.__setattr__(self, "result_limit", tuple(self.result_limit))
        if isinstance(self.execution, dict):
            object.__setattr__(
                self, "execution", Execution.from_dict(self.execution)
            )

    # ---- validation + lowering resolution (DESIGN.md §10) -----------------

    def resolve(self) -> tuple[str, str]:
        """Validate and return ``(kind, method)``: the lowering target (one
        of ``host | scan | async | sharded | multi | multi_sharded |
        async_multi``) and the resolved Thompson method.  Raises typed
        :class:`PlanError`\\ s with actionable messages on invalid or
        incompatible options."""
        ex = self.execution

        # -- per-option value checks ---------------------------------------
        if self.queries < 1:
            raise PlanValueError(
                f"queries={self.queries} must be >= 1 (a plan searches at "
                "least one query)", field="queries")
        if self.max_steps < 1:
            raise PlanValueError(
                f"max_steps={self.max_steps} must be >= 1", field="max_steps")
        if self.cohorts < 1:
            raise PlanValueError(
                f"cohorts={self.cohorts} must be >= 1 (frames chosen per "
                "Thompson round)", field="cohorts")
        if self.trace_every < 0:
            raise PlanValueError(
                f"trace_every={self.trace_every} must be >= 0 (0 disables "
                "recall-trace checkpoints)", field="trace_every")
        if self.method not in _METHODS:
            raise PlanValueError(
                f"method={self.method!r} not in {_METHODS}", field="method")
        if isinstance(self.result_limit, tuple):
            if len(self.result_limit) != self.queries:
                raise PlanValueError(
                    f"result_limit has {len(self.result_limit)} entries for "
                    f"queries={self.queries}; pass one int per query or a "
                    "single shared int", field="result_limit")
            limits = self.result_limit
        else:
            limits = (self.result_limit,)
        if any(int(v) < 1 for v in limits):
            raise PlanValueError(
                f"result_limit={self.result_limit} must be >= 1 per query",
                field="result_limit")
        if ex.strategy not in _STRATEGIES:
            raise PlanValueError(
                f"strategy={ex.strategy!r} not in {_STRATEGIES}",
                field="strategy")
        if ex.shards < 1:
            raise PlanValueError(
                f"shards={ex.shards} must be >= 1", field="shards")
        if not ex.axis:
            raise PlanValueError("axis must be a non-empty mesh axis name",
                                 field="axis")
        if ex.sync_every < 1:
            raise PlanValueError(
                f"sync_every={ex.sync_every} must be >= 1 (a zero-round "
                "merge window would never advance the resident loop)",
                field="sync_every")
        if ex.async_workers < 0:
            raise PlanValueError(
                f"async_workers={ex.async_workers} must be >= 0",
                field="async_workers")
        if ex.cache == 0:
            raise PlanValueError(
                "cache=0 is ambiguous: use cache=None to disable the "
                "detection cache or a positive capacity (-1 = size to the "
                "repository)", field="cache")
        if ex.cache is not None and ex.cache < -1:
            raise PlanValueError(
                f"cache={ex.cache} must be None, -1 (repository-sized) or a "
                "positive capacity", field="cache")
        if ex.service is not None:
            if ex.service.slo_latency_s < 0:
                raise PlanValueError(
                    f"service.slo_latency_s={ex.service.slo_latency_s} must "
                    "be >= 0 (0 disables the SLO)", field="slo_latency_s")
            if not isinstance(ex.service.priority, int):
                raise PlanValueError(
                    f"service.priority={ex.service.priority!r} must be an "
                    "int (admission-queue ordering)", field="priority")
        if ex.index is not None:
            if not ex.index.detector_version or not isinstance(
                ex.index.detector_version, str
            ):
                raise PlanValueError(
                    f"index.detector_version="
                    f"{ex.index.detector_version!r} must be a non-empty "
                    "string (the host tier is keyed by it)",
                    field="detector_version")
            if ex.index.prior_weight < 0:
                raise PlanValueError(
                    f"index.prior_weight={ex.index.prior_weight} must be "
                    ">= 0 (0 disables Thompson warm-start)",
                    field="prior_weight")
            if ex.index.path is not None and not isinstance(
                ex.index.path, str
            ):
                raise PlanValueError(
                    f"index.path={ex.index.path!r} must be a string "
                    "snapshot directory or None (in-memory index)",
                    field="path")

        # -- cross-option compatibility ------------------------------------
        multi = ex.queries_axis or self.queries > 1
        sharded = ex.shards > 1 or ex.strategy == "sharded"
        if self.queries > 1 and ex.strategy in ("host", "scan"):
            raise PlanCompatibilityError(
                f"queries={self.queries} needs the Q-axis drivers; "
                f"strategy={ex.strategy!r} is single-query — use "
                "strategy='auto' (or 'sharded' to compose with a mesh, "
                "or 'async' for the slot scheduler)",
                field="strategy")
        if ex.cache is not None and not multi:
            raise PlanCompatibilityError(
                "cache requires queries_axis=True: the detection cache "
                "lives on the shared Q-axis detector pass (set "
                "Execution(queries_axis=True), valid at queries=1)",
                field="cache")
        if ex.async_workers > 0:
            if ex.shards > 1:
                raise PlanCompatibilityError(
                    f"async_workers={ex.async_workers} with shards="
                    f"{ex.shards}: the threaded async driver and the "
                    "mesh-resident loop are alternative execution "
                    "strategies — pick one (shards>1 already runs "
                    "barrier-free via the §8 merge schedule)",
                    field="async_workers")
            if self.trace_every > 0 and not multi:
                raise PlanCompatibilityError(
                    "async_workers>0 on a single-query carry records no "
                    "recall trace (merges land out of order); set "
                    "trace_every=0, or compose with queries_axis=True — "
                    "the slot scheduler serializes per-query rounds so "
                    "per-query traces are exact (DESIGN.md §11)",
                    field="trace_every")
            if ex.strategy not in ("auto", "async"):
                raise PlanCompatibilityError(
                    f"async_workers={ex.async_workers} conflicts with "
                    f"strategy={ex.strategy!r}", field="strategy")
        if ex.strategy == "async" and ex.async_workers == 0:
            raise PlanCompatibilityError(
                "strategy='async' needs async_workers >= 1",
                field="async_workers")
        if ex.shards > 1 and ex.strategy in ("host", "scan"):
            raise PlanCompatibilityError(
                f"shards={ex.shards} with strategy={ex.strategy!r}: only "
                "the sharded lowerings place statistics on a mesh — use "
                "strategy='auto' or 'sharded'", field="strategy")
        if ex.strategy == "host" and multi:
            raise PlanCompatibilityError(
                "strategy='host' is the single-query reference loop; it "
                "cannot take queries_axis=True or a cache", field="strategy")
        if ex.strategy == "scan" and multi:
            raise PlanCompatibilityError(
                "strategy='scan' is the single-query resident loop; use "
                "strategy='auto' to get the Q-axis lowering",
                field="strategy")
        if ex.sync_every > 1 and not sharded:
            raise PlanCompatibilityError(
                f"sync_every={ex.sync_every} only applies to the mesh "
                "merge schedule; it needs shards>1 (or strategy='sharded')",
                field="sync_every")
        if sharded and self.cohorts % ex.shards:
            raise PlanCompatibilityError(
                f"cohorts={self.cohorts} must be a positive multiple of "
                f"shards={ex.shards} (each shard processes cohorts/shards "
                f"frames per round; try cohorts={ex.shards * max(1, self.cohorts // ex.shards)})",
                field="cohorts")
        if sharded and self.method in ("exact", "pallas"):
            raise PlanCompatibilityError(
                f"method={self.method!r} on a sharded lowering: the "
                "mesh-resident path is Wilson–Hilferty only (DESIGN.md "
                "§3/§8) — use method='auto' or 'wilson_hilferty'",
                field="method")

        # -- lowering kind (DESIGN.md §10 table) ---------------------------
        if ex.async_workers > 0 or ex.strategy == "async":
            kind = "async_multi" if multi else "async"
        elif ex.strategy == "host":
            kind = "host"
        elif sharded and multi:
            kind = "multi_sharded"
        elif sharded:
            kind = "sharded"
        elif multi:
            kind = "multi"
        else:
            kind = "scan"

        if kind in ("async", "async_multi") and self.method not in (
            "auto", "exact"
        ):
            raise PlanCompatibilityError(
                f"method={self.method!r} on the async lowering: cohort "
                "issue uses the exact Gamma sampler — use method='auto'",
                field="method")

        if self.method != "auto":
            method = self.method
        elif kind in ("sharded", "multi_sharded"):
            method = "wilson_hilferty"
        else:
            method = "exact"
        return kind, method

    def lower(self):
        """Validate and compile: returns a
        :class:`~repro_torch.core.executor.LoweredPlan` bound to one driver."""
        from repro_torch.core.executor import lower

        return lower(self)

    def run(self, carry, chunks, *, detector, select=None, mesh=None, index=None):
        """``lower()`` + execute.  See
        :meth:`repro_torch.core.executor.LoweredPlan.run`; ``mesh`` gives
        the mesh kinds their :class:`~repro_torch.launch.mesh.DataMesh`,
        ``index`` an open :class:`~repro_torch.index.RepositoryIndex`
        instead of opening one from ``execution.index``."""
        return self.lower().run(carry, chunks, detector=detector, select=select, mesh=mesh, index=index)

    # ---- serde ------------------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if isinstance(d["result_limit"], tuple):
            d["result_limit"] = list(d["result_limit"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SearchPlan":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise PlanValueError(
                f"unknown SearchPlan option(s) {sorted(unknown)}; valid: "
                f"{sorted(f.name for f in dataclasses.fields(cls))}",
                field=sorted(unknown)[0],
            )
        if isinstance(d.get("execution"), dict):
            d["execution"] = Execution.from_dict(d["execution"])
        return cls(**d)
