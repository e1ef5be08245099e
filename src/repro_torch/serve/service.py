"""Multi-tenant search service: admission, slot reuse and SLO reports.

Counterpart of ``repro.serve.service``.  Queries arrive from tenants at
any time and the operator grants a priced GPU-time budget.
:class:`SearchService` admits each tenant's single-query
:class:`~repro_torch.core.plan.SearchPlan` onto a free slot of one
long-running :class:`~repro_torch.core.runtime.AsyncMultiSearchDriver`:

* **Admission** prices a plan before it runs
  (:func:`~repro_torch.sim.costmodel.plan_projected_cost` under the
  operator's :class:`~repro_torch.sim.costmodel.CostRates`) and debits a
  :class:`~repro_torch.sim.costmodel.CostBudget`.  A plan that does not
  fit the remaining budget is rejected, or with
  ``ServiceConfig.queue_on_reject`` parked in a priority queue until a
  retirement frees headroom.  Projections are upper bounds; the unspent
  rest is credited back when the tenant retires.
* **Slot reuse**: a finished tenant's row is harvested and its slot
  vacated for the next admission, so the pool's size follows the
  concurrency, not the number of tenants.
* **SLO reports**: each tenant's time to its first result, from
  admission, against its ``ServiceConfig.slo_latency_s``; a query that
  misses is reported, never killed.
* **Shared detector economics**: tenants share the driver's dedup and
  detection cache; lane occupancy follows the ``RequestBatcher``
  convention ``occupancy = 1 − padding``.

Each admitted tenant's trajectory equals its own solo scan at its debited
frame budget (the driver's one-slot-a-query rule): sharing changes which
detector calls happen, never the values a tenant reads.

**On the card.**  Each worker runs on its own CUDA stream and the merges
are queued on the driver's stream.  Every read of a row's tensors here
(``_reap``, ``Tenant.to_dict``, ``Tenant.stats``) and every admission
runs under ``driver.on_driver()``, so it is ordered after the merges that
wrote the row.  ``_reap`` publishes the in-place detection cache to the
index under the driver's lock, taken after the service's own: the lock
order is service → driver, never back.

**A failure stops the service** (ROADMAP C11).  The driver raises a
worker's exception from ``service_tick``.  The pump keeps it and stops;
``tick()``, ``drain()`` and ``submit()`` then raise :class:`ServiceFailure`
from it, and ``busy()`` no longer reports the work that cannot finish.
(The reference's pump thread dies with the exception and ``drain()``
polls to its deadline.)  A run without a failure is the reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.executor import SearchStats, tenant_stats_from_row
from repro_torch.core.plan import PlanError, SearchPlan, ServiceConfig
from repro_torch.core.runtime import AsyncMultiSearchDriver
from repro_torch.sim.costmodel import CostBudget, CostRates, plan_projected_cost, sampling_cost

QUEUED = "queued"
RUNNING = "running"
FINISHED = "finished"
REJECTED = "rejected"


class ServiceFailure(RuntimeError):
    """The service's pump failed: a worker's exception the driver raised,
    or the pump's own.  Raised, from the original, by every later
    ``tick()``, ``drain()`` and ``submit()``."""


def _host64(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


@dataclasses.dataclass
class Tenant:
    """One submitted plan's record: QUEUED → RUNNING → FINISHED, or
    REJECTED at admission."""

    tenant_id: str
    plan: SearchPlan
    key: torch.Tensor
    select_id: Optional[int]
    service: ServiceConfig
    projected_s: float
    seq: int                         # FIFO order within a priority level
    state: str = QUEUED
    reason: str = ""                 # why it was rejected (REJECTED only)
    row: Optional[int] = None        # the driver's slot while RUNNING
    row_obj: object = None           # this tenant's _QueryRow, bound at admission.  By
    #   object, not slot index: admit() installs a fresh row a tenant and vacate()
    #   keeps it, so it stays this tenant's after a later tenant reuses the slot
    actual_s: float = 0.0            # settled cost
    submitted_s: float = 0.0
    n1_init: object = None           # sampler n1 at admission (f64[M]), the prior
    #   included, so _reap records only what the tenant observed
    # the context its reads of the row's tensors run in (the driver's stream)
    reads: Callable = dataclasses.field(default=contextlib.nullcontext, repr=False, compare=False)

    @property
    def stats(self) -> Optional[SearchStats]:
        if self.row_obj is None:
            return None
        with self.reads():
            return tenant_stats_from_row(self.row_obj)

    def slo_report(self) -> dict:
        """Time to first result against this tenant's SLO.  ``ttfr_s`` is
        None until a first result merges; ``slo_met`` is None without an
        SLO (``slo_latency_s`` 0) and while the window is still open.  The
        driver stamps the first result at the merge, so a RUNNING tenant
        reports it too."""
        row = self.row_obj
        ttfr = None
        if row is not None and row.first_result_s:
            ttfr = row.first_result_s - row.admitted_s
        slo = self.service.slo_latency_s
        if slo <= 0:
            met = None
        elif ttfr is not None:
            met = ttfr <= slo
        elif self.state in (QUEUED, RUNNING) and (row is None or time.monotonic() - row.admitted_s <= slo):
            met = None
        else:
            met = False
        return {"slo_latency_s": slo, "ttfr_s": ttfr, "slo_met": met}

    def to_dict(self) -> dict:
        """The tenant as plain Python numbers (``json.dumps`` never meets a
        tensor)."""
        d = {
            "tenant": self.tenant_id,
            "state": self.state,
            "projected_s": self.projected_s,
            "priority": self.service.priority,
        }
        if self.state == REJECTED:
            d["reason"] = self.reason
        if self.row_obj is not None:
            row = self.row_obj
            with self.reads():
                results, steps = int(row.carry.results), int(row.carry.step)
                st = self.stats
            d.update(
                results=results,
                steps=steps,
                spilled=len(row.log),
                detector_invocations=st.detector_invocations,
                cache_hits=st.cache_hits,
                index_hits=st.index_hits,
                warm_rounds_saved=st.warm_rounds_saved,
                actual_s=self.actual_s,
                **self.slo_report(),
            )
        if self.state == FINISHED:
            # what admission reserved against what the tenant cost
            d["projected_vs_settled"] = {
                "projected_s": self.projected_s,
                "settled_s": self.actual_s,
                "credited_s": self.projected_s - self.actual_s,
            }
        return d


class SearchService:
    """A persistent multi-tenant front over one slot driver.

    The service owns the driver (built around a prototype row that is
    vacated at once, so the pool starts empty), the cost ledger and the
    admission queue.  ``submit`` is thread-safe; the pump, the thread
    ``start(pump=True)`` spawns or explicit ``tick()`` calls, merges
    batches, harvests finished tenants and admits queued ones."""

    def __init__(self, carry_proto, chunks, detector, *, select=None, budget_s: float = float("inf"),
                 rates: CostRates = CostRates(), cohorts: int = 4, num_workers: int = 2,
                 max_steps: int = 100_000, cache_frames: int = 0, slots_per_batch: int = 4, index=None):
        """``carry_proto`` is a leading-[1] multi-query carry
        (``init_carry_multi``) that fixes the pool's sampler and ring
        geometry and its device; its row is vacated at once and never runs.
        ``index`` is one shared
        :class:`~repro_torch.index.store.RepositoryIndex` for every tenant:
        the driver's cache warms from it, retiring tenants publish their
        detections and per-chunk evidence to it, and admission injects its
        priors under the tenant's ``select_id``."""
        self.rates = rates
        self.budget = CostBudget(total_s=budget_s)
        self.index = index
        self.total_frames = int(chunks.total_frames)
        self.device = carry_proto.step.device
        self.driver = AsyncMultiSearchDriver(
            carry_proto, chunks, detector, cohorts=cohorts, num_workers=num_workers, result_limits=1,
            max_steps=max_steps, select=select, cache_frames=cache_frames, slots_per_batch=slots_per_batch,
            index=index)
        self.driver.vacate(0)
        self.tenants: dict[str, Tenant] = {}
        self._queue: list[Tenant] = []
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._pump: Optional[threading.Thread] = None
        self._failure: Optional[BaseException] = None

    # ---- lifecycle ---------------------------------------------------------

    def start(self, pump: bool = True) -> None:
        self.driver.start()
        if pump and self._pump is None:
            self._stop_evt.clear()
            self._pump = threading.Thread(target=self._pump_loop, daemon=True)
            self._pump.start()

    def stop(self) -> None:
        if self._pump is not None:
            self._stop_evt.set()
            self._pump.join(timeout=10.0)
            self._pump = None
        self.driver.stop()

    def _pump_loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.tick(timeout=0.05)
            except ServiceFailure:
                return      # kept: tick(), drain() and submit() raise it

    @property
    def failure(self) -> Optional[BaseException]:
        """The exception that stopped the service, or None."""
        return self._failure

    def _raise_failure(self) -> None:
        if self._failure is not None:
            raise ServiceFailure(f"the search service stopped: {self._failure!r}") from self._failure

    # ---- admission ---------------------------------------------------------

    def submit(self, tenant_id: str, plan: SearchPlan, *, key: Optional[torch.Tensor] = None, seed: int = 0,
               select_id: Optional[int] = None) -> Tenant:
        """Price ``plan``, then admit, queue or reject it.  One tenant is
        one row, so a service plan is single-query; ``select_id`` binds the
        tenant's predicate (its query class) through the driver's
        ``select``.  The default key is ``PRNGKey(seed)`` on the pool's
        device, JAX's key for the same seed."""
        self._raise_failure()
        plan.resolve()   # a PlanError before any state changes
        if plan.queries != 1:
            raise PlanError(
                f"service plans are single-query (one tenant = one Q-axis slot); got "
                f"queries={plan.queries} — submit one plan per query", field="queries")
        spec = plan.execution.index
        if spec is not None:
            if self.index is None and spec.prior_weight > 0:
                raise PlanError(
                    "plan requests index warm-start (prior_weight > 0) but the service was "
                    "constructed without a shared RepositoryIndex", field="index")
            if self.index is not None and spec.detector_version != self.index.detector_version:
                raise PlanError(
                    f"plan declares index.detector_version={spec.detector_version!r} but the service "
                    f"index holds {self.index.detector_version!r} — a version mismatch must be a clean "
                    "miss, not a silent replay", field="detector_version")
        svc = plan.execution.service or ServiceConfig()
        projected = plan_projected_cost(plan, self.rates, index=self.index,
                                        total_frames=self.total_frames).total_s
        tenant = Tenant(
            tenant_id=tenant_id, plan=plan,
            key=key if key is not None else prng.PRNGKey(seed, device=self.device),
            select_id=select_id, service=svc, projected_s=projected, seq=next(self._seq),
            submitted_s=time.monotonic(), reads=self.driver.on_driver)
        with self._lock:
            existing = self.tenants.get(tenant_id)
            if existing is not None and existing.state not in (REJECTED, FINISHED):
                raise PlanError(f"tenant {tenant_id!r} already submitted", field="tenant")
            # a terminal record is replaced: a rejected tenant may come back
            # with a smaller plan under the same id
            self.tenants[tenant_id] = tenant
            if projected > self._never_fit_bound():
                tenant.state = REJECTED
                tenant.reason = self._never_fit_reason(projected)
            elif self.budget.debit(projected):
                self._admit(tenant)
            elif svc.queue_on_reject:
                tenant.state = QUEUED
                self._queue.append(tenant)
            else:
                tenant.state = REJECTED
                tenant.reason = (
                    f"projected cost {projected:.1f}s exceeds remaining budget "
                    f"{self.budget.remaining_s:.1f}s (set service.queue_on_reject to wait for capacity)")
        return tenant

    def _never_fit_bound(self) -> float:
        """The most headroom the budget can ever offer again, ``total −
        spent`` (spend is never credited back): a projection above it can
        never be admitted, and queueing it would stall the drain.  The
        caller holds the lock."""
        return self.budget.total_s - self.budget.spent_s

    def _never_fit_reason(self, projected: float) -> str:
        return (f"projected cost {projected:.1f}s can never fit: it exceeds the total budget "
                f"{self.budget.total_s:.1f}s minus settled spend {self.budget.spent_s:.1f}s")

    def _admit(self, tenant: Tenant) -> None:
        """Install a debited tenant on the driver; the caller holds the
        service's lock.  With the shared index's priors and a positive
        ``prior_weight`` (the plan's, else the index's), the fresh row's
        zeroed sampler is warmed under the tenant's ``select_id``; the
        warmed ``n1`` is kept so that ``_reap`` records only the delta."""
        with self.driver.on_driver():
            sampler_init = None
            warm_rounds_saved = 0
            if self.index is not None:
                spec = tenant.plan.execution.index
                w = spec.prior_weight if spec is not None else self.index.prior_weight
                if w > 0:
                    s0 = self.driver.rows[0].carry.sampler
                    fresh = dataclasses.replace(s0, n1=torch.zeros_like(s0.n1), n=torch.zeros_like(s0.n))
                    warmed, equiv = self.index.priors.warm_sampler(fresh, tenant.select_id, w)
                    if equiv:
                        sampler_init = warmed
                        warm_rounds_saved = int(equiv) // max(self.driver.cohorts, 1)
            tenant.row = self.driver.admit(
                tenant.key, result_limit=int(tenant.plan.result_limit), base_max_steps=tenant.plan.max_steps,
                select_id=tenant.select_id, sampler_init=sampler_init, warm_rounds_saved=warm_rounds_saved)
            tenant.row_obj = self.driver.rows[tenant.row]
            if self.index is not None:
                tenant.n1_init = _host64(tenant.row_obj.carry.sampler.n1)
        tenant.state = RUNNING

    def _admit_queued(self) -> None:
        """Admit parked plans in (priority, FIFO) order.  The head blocks
        the tail, so small late arrivals never starve a large
        high-priority plan; a head that no longer fits ``total − spent`` is
        rejected rather than left to block the queue and the drain."""
        with self._lock:
            self._queue.sort(key=lambda t: (-t.service.priority, t.seq))
            while self._queue:
                head = self._queue[0]
                if self.budget.debit(head.projected_s):
                    self._queue.pop(0)
                    self._admit(head)
                    continue
                if head.projected_s > self._never_fit_bound():
                    self._queue.pop(0)
                    head.state = REJECTED
                    head.reason = self._never_fit_reason(head.projected_s)
                    continue
                break

    # ---- pump --------------------------------------------------------------

    def tick(self, timeout: float = 0.05) -> bool:
        """One heartbeat: merge at most one driver batch, harvest retired
        tenants, admit queued plans into the freed headroom.  A failure
        (a worker's exception, raised by the driver) stops the service and
        is raised as :class:`ServiceFailure`."""
        self._raise_failure()
        try:
            merged = self.driver.service_tick(timeout=timeout)
            self._reap()
            self._admit_queued()
        except Exception as e:  # noqa: BLE001 — kept, and raised by every later call
            self._failure = e
            self._raise_failure()
        return merged

    def _reap(self) -> None:
        """Harvest tenants whose row retired: vacate the slot and settle the
        reservation against the realized sampling cost.  Iterates a
        snapshot taken under the lock, since ``submit`` inserts into
        ``self.tenants`` from other threads."""
        with self._lock:
            running = [t for t in self.tenants.values() if t.state == RUNNING]
        learn = self.index is not None and not self.index.read_only
        reaped = 0
        for tenant in running:
            row = tenant.row_obj          # bound at admission, never moves
            if row.active or row.inflight or row.vacant:
                continue
            self.driver.vacate(tenant.row)
            with self.driver.on_driver():
                steps = int(row.carry.step)
                if learn:
                    n1, n = _host64(row.carry.sampler.n1), _host64(row.carry.sampler.n)
            tenant.actual_s = sampling_cost(steps, self.rates).total_s
            with self._lock:
                self.budget.settle(tenant.projected_s, tenant.actual_s)
                tenant.state = FINISHED
                if learn:
                    # the delta against the warmed admission state: the
                    # injected prior is never recorded again as evidence
                    base = tenant.n1_init if tenant.n1_init is not None else np.zeros_like(n1)
                    self.index.priors.record(tenant.select_id, n1 - base, n)
            reaped += 1
        if reaped and learn:
            with self._lock:
                # the cache is updated in place by the merges: read it between two
                with self.driver._lock, self.driver.on_driver():
                    self.index.publish_cache(self.driver.cache)
                if self.index.path is not None:
                    self.index.save()

    def drain(self, deadline_s: float = 120.0) -> None:
        """Block until every queued and running tenant has finished: poll
        the background pump, or tick without one.  Raises
        :class:`ServiceFailure` if the service stopped on a failure, and
        ``TimeoutError`` past the deadline."""
        t0 = time.monotonic()
        while self.busy():
            if time.monotonic() - t0 > deadline_s:
                with self._lock:
                    unfinished = sum(t.state in (QUEUED, RUNNING) for t in self.tenants.values())
                raise TimeoutError(f"drain exceeded {deadline_s}s with {unfinished} tenants unfinished")
            if self._pump is not None:
                time.sleep(0.01)
            else:
                self.tick()
        self._raise_failure()

    def busy(self) -> bool:
        """Queued or running tenants remain, and the service has not
        stopped on a failure."""
        with self._lock:
            if self._failure is not None:
                return False
            return any(t.state in (QUEUED, RUNNING) for t in self.tenants.values())

    def evict_terminal(self) -> int:
        """Drop FINISHED and REJECTED records so a persistent service stays
        bounded; returns how many.  Read ``stats()`` first."""
        with self._lock:
            dead = [tid for tid, t in self.tenants.items() if t.state in (FINISHED, REJECTED)]
            for tid in dead:
                del self.tenants[tid]
            return len(dead)

    # ---- reporting ---------------------------------------------------------

    def padding_fraction(self) -> float:
        """``RequestBatcher``-convention padding over the driver's slot
        lanes (0.0 before any batch)."""
        d = self.driver.stats
        total = d["lanes_issued"] + d["lanes_padded"]
        return d["lanes_padded"] / total if total else 0.0

    @property
    def occupancy(self) -> float:
        """``1 − padding_fraction()``, as ``RequestBatcher.occupancy``."""
        return 1.0 - self.padding_fraction()

    def stats(self) -> dict:
        with self._lock:
            return {
                "tenants": {tid: t.to_dict() for tid, t in self.tenants.items()},
                "budget": {
                    "total_s": self.budget.total_s,
                    "committed_s": self.budget.committed_s,
                    "spent_s": self.budget.spent_s,
                    "remaining_s": self.budget.remaining_s,
                },
                "batch": {
                    "occupancy": self.occupancy,
                    "padding_fraction": self.padding_fraction(),
                    "lanes_issued": self.driver.stats["lanes_issued"],
                    "lanes_padded": self.driver.stats["lanes_padded"],
                },
                "driver": dict(self.driver.stats),
                "index": dict(self.index.stats, entries=len(self.index)) if self.index is not None else None,
            }
