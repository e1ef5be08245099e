"""The tenant service of repro_torch (``serve.service``,
``launch.serve_search``) against the JAX package's ``repro.serve.service``,
on the CPU, on ``tests/test_service.py``'s world.

* **The reference's cases on the port**: the admission matrix, the
  projections, the ledger's settle, slot reuse, the priority queue, the
  never-fit rejection, resubmission, SLO reports, submits racing the
  pump, each tenant equal to its solo run at its debited budget (the
  port's own, under the exact Gamma the service's driver draws), the
  ``select_id`` binding, the per-tenant accounting and the stdin front's
  four-tenant run with zero result loss.
* **Bit for bit against JAX**: both services' drivers set to
  ``"wilson_hilferty"`` (the exact Gamma is held only statistically) and
  driven synchronously, issue, process and merge in one fixed order, then
  ``_reap`` and ``_admit_queued``: the admissions, every tenant's carry,
  row accounting, ``ResultLog`` and ``to_dict()`` less the clock fields,
  and the service's budget and batch stats.
* **Threads**: each tenant equal to its solo scan at W = 1 and 4, with
  and without the background pump; a raising detector stops the service,
  and ``drain()``, ``tick()`` and the front report it within seconds.

Every threaded run goes through ``_bounded``, which fails the test rather
than hang.
"""
import argparse
import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core.plan import Execution as JExecution
from repro.core.plan import ServiceConfig as JServiceConfig
from repro.index.store import RepositoryIndex as JIndex
from repro.serve import service as jsvc
from repro.sim import RepoSpec as JSpec
from repro.sim import generate as j_generate
from repro.sim.oracle import class_select as j_class_select
from repro.sim.oracle import oracle_detect as j_detect
from repro_torch import core as tcore
from repro_torch.core import prng
from repro_torch.core.plan import Execution, IndexSpec, PlanError, SearchPlan, ServiceConfig
from repro_torch.core.runtime import _QueryRow
from repro_torch.index.store import RepositoryIndex
from repro_torch.serve import service as tsvc
from repro_torch.serve.service import FINISHED, QUEUED, REJECTED, RUNNING, SearchService, ServiceFailure
from repro_torch.sim import RepoSpec as TSpec
from repro_torch.sim import class_select, filter_class, generate, oracle_detect
from repro_torch.sim.costmodel import CostRates, plan_projected_cost

CPU = "cpu"
RATES = CostRates()
# default rates: 1/detect_fps + 1/random_read_fps = 0.12 s a sampled frame
FRAME_S = 1.0 / RATES.detect_fps + 1.0 / RATES.random_read_fps
WORLD = dict(video_lengths=[6_000] * 3, num_instances=120, chunk_frames=600, locality=4.0, seed=7)
MATCHER_FIELDS = ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted")
ROW_ACCOUNTING = ("limit", "budget", "trace", "active", "inflight", "rounds", "vacant", "select_id",
                  "fresh_calls", "cache_hits", "index_hits", "warm_rounds_saved")
CLOCK_FIELDS = ("ttfr_s", "slo_met")


def _bounded(fn, seconds=120.0):
    """``fn()`` on a thread joined with a timeout: the test fails rather
    than hangs."""
    out = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"did not finish within {seconds} s")
    if "error" in out:
        raise out["error"]
    return out.get("value")


@pytest.fixture(scope="module")
def world():
    repo, chunks = generate(TSpec(**WORLD), device=CPU)
    return repo, chunks, lambda key, frame: oracle_detect(repo, frame, query_class=0)


@pytest.fixture(scope="module")
def jworld():
    repo, chunks = j_generate(JSpec(**WORLD))
    return repo, chunks


def _qkey(q):
    return prng.fold_in(prng.PRNGKey(0, device=CPU), q)


def _jqkey(q):
    return jax.random.fold_in(jax.random.PRNGKey(0), q)


def _proto(chunks, max_results=64):
    return tcore.init_carry_multi(tcore.init_state(chunks.length, device=CPU),
                                  tcore.init_matcher(max_results=max_results, device=CPU),
                                  torch.stack([prng.PRNGKey(0, device=CPU)]))


def _jproto(chunks, max_results=64):
    return jcore.init_carry_multi(jcore.init_state(chunks.length), jcore.init_matcher(max_results=max_results),
                                  jnp.stack([jax.random.PRNGKey(0)]))


def _service(chunks, det, **kw):
    kw.setdefault("cohorts", 2)
    kw.setdefault("num_workers", 1)
    kw.setdefault("slots_per_batch", 2)
    return SearchService(_proto(chunks), chunks, det, rates=RATES, **kw)


def _plan(max_steps=1500, limit=8, service=None, cohorts=2, execution=Execution):
    return SearchPlan(result_limit=limit, max_steps=max_steps, cohorts=cohorts,
                      execution=execution(queries_axis=True, service=service))


def _jplan(max_steps=1500, limit=8, service=None, cohorts=2):
    return jcore.SearchPlan(result_limit=limit, max_steps=max_steps, cohorts=cohorts,
                            execution=JExecution(queries_axis=True, service=service))


def _drain_sync(svc, deadline_s=120.0):
    def run():
        svc.start(pump=False)
        try:
            svc.drain(deadline_s=deadline_s)
        finally:
            svc.stop()

    _bounded(run, seconds=deadline_s + 30)


def _solo(chunks, det, key, *, result_limit, max_steps, cohorts=2, method="exact"):
    carry = tcore.init_carry(tcore.init_state(chunks.length, device=CPU),
                             tcore.init_matcher(max_results=64, device=CPU), key)
    return SearchPlan(result_limit=result_limit, max_steps=max_steps, cohorts=cohorts,
                      method=method).run(carry, chunks, detector=det).carry


def _assert_same_carry_port(a, b):
    for f in ("n1", "n", "frames"):
        assert torch.equal(getattr(a.sampler, f), getattr(b.sampler, f)), f
    for f in MATCHER_FIELDS:
        assert torch.equal(getattr(a.matcher, f), getattr(b.matcher, f)), f
    for f in ("key", "step", "results"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _assert_same_carry(tc_, jc_):
    for f in ("n1", "n", "frames"):
        np.testing.assert_array_equal(getattr(tc_.sampler, f).numpy(), np.asarray(getattr(jc_.sampler, f)),
                                      err_msg=f)
    for f in MATCHER_FIELDS:
        np.testing.assert_array_equal(getattr(tc_.matcher, f).numpy(), np.asarray(getattr(jc_.matcher, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tc_.key.numpy().astype(np.uint32), np.asarray(jc_.key))
    assert int(tc_.step) == int(jc_.step) and int(tc_.results) == int(jc_.results)


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------


def test_admission_accept_reject_matrix(world):
    """Projected cost against the remaining budget decides accept, queue or
    reject, before anything runs."""
    _, chunks, det = world
    svc = _service(chunks, det, budget_s=1000 * FRAME_S)

    a = svc.submit("a", _plan(max_steps=600), key=_qkey(0))
    assert a.state == RUNNING
    assert a.projected_s == pytest.approx(600 * FRAME_S)
    assert svc.budget.committed_s == pytest.approx(600 * FRAME_S)

    b = svc.submit("b", _plan(max_steps=600), key=_qkey(1))
    assert b.state == REJECTED and "remaining" in b.reason

    c = svc.submit("c", _plan(max_steps=600, service=ServiceConfig(queue_on_reject=True)), key=_qkey(2))
    assert c.state == QUEUED
    assert svc.budget.committed_s == pytest.approx(600 * FRAME_S)

    d = svc.submit("d", _plan(max_steps=100_000, service=ServiceConfig(queue_on_reject=True)), key=_qkey(3))
    assert d.state == REJECTED and "total" in d.reason

    with pytest.raises(PlanError, match="single-query"):
        svc.submit("e", SearchPlan(queries=2, execution=Execution(queries_axis=True)), key=_qkey(4))
    with pytest.raises(PlanError, match="already submitted"):
        svc.submit("a", _plan(), key=_qkey(0))


def test_projection_matches_costmodel(world):
    assert plan_projected_cost(_plan(max_steps=777), RATES).total_s == pytest.approx(777 * FRAME_S)


def test_warm_plan_admitted_where_cold_projection_rejects(world):
    """A plan whose detections are ~90% in the shared index is priced with
    the coverage discount, admitted under a budget the cold price fails,
    and settles with its credit in the tenant's economics."""
    _, chunks, det = world
    index = RepositoryIndex(detector_version="v1")
    covered = int(0.9 * chunks.total_frames)
    f = torch.arange(covered, dtype=torch.int32)
    index.publish(f, f.float())
    coverage = covered / chunks.total_frames

    ms = 1500
    cold = plan_projected_cost(_plan(max_steps=ms), RATES).total_s
    assert cold == pytest.approx(ms * FRAME_S)
    warm_plan = SearchPlan(result_limit=8, max_steps=ms, cohorts=2,
                           execution=Execution(queries_axis=True, index=IndexSpec(detector_version="v1")))
    warm = plan_projected_cost(warm_plan, RATES, index=index, total_frames=chunks.total_frames).total_s
    assert warm == pytest.approx(ms * ((1 - coverage) / RATES.detect_fps + 1 / RATES.random_read_fps))
    assert ms / RATES.random_read_fps <= warm < cold

    svc = _service(chunks, det, budget_s=0.5 * (warm + cold), index=index)
    t = svc.submit("warm", warm_plan, key=_qkey(0))
    assert t.state == RUNNING
    assert t.projected_s == pytest.approx(warm)
    assert svc.budget.committed_s == pytest.approx(warm)
    _drain_sync(svc)
    assert t.state == FINISHED
    assert svc.budget.committed_s == pytest.approx(0.0)
    assert t.actual_s == pytest.approx(int(t.row_obj.carry.step) * FRAME_S)
    econ = t.to_dict()["projected_vs_settled"]
    assert econ["projected_s"] == pytest.approx(warm)
    assert econ["settled_s"] == pytest.approx(t.actual_s)
    assert econ["credited_s"] == pytest.approx(warm - t.actual_s)


def test_warm_projection_requires_index_binding(world):
    """No IndexSpec on the plan, or no live index or frame count at the
    call, or another detector version: the cold price."""
    _, chunks, _ = world
    index = RepositoryIndex(detector_version="v1")
    f = torch.arange(100, dtype=torch.int32)
    index.publish(f, f.float())
    cold = 500 * FRAME_S
    assert plan_projected_cost(_plan(max_steps=500), RATES, index=index,
                               total_frames=chunks.total_frames).total_s == pytest.approx(cold)
    bound = SearchPlan(result_limit=8, max_steps=500,
                       execution=Execution(queries_axis=True, index=IndexSpec(detector_version="v1")))
    assert plan_projected_cost(bound, RATES).total_s == pytest.approx(cold)
    assert plan_projected_cost(bound, RATES, index=index, total_frames=0).total_s == pytest.approx(cold)
    other = dataclasses.replace(bound, execution=Execution(queries_axis=True,
                                                           index=IndexSpec(detector_version="v9")))
    assert plan_projected_cost(other, RATES, index=index,
                               total_frames=chunks.total_frames).total_s == pytest.approx(cold)


def test_budget_settles_actual_and_credits_unspent(world):
    _, chunks, det = world
    svc = _service(chunks, det, budget_s=10_000 * FRAME_S)
    t = svc.submit("a", _plan(max_steps=5_000, limit=4), key=_qkey(0))
    _drain_sync(svc)
    assert t.state == FINISHED
    assert svc.budget.committed_s == pytest.approx(0.0)
    assert t.actual_s == pytest.approx(int(t.row_obj.carry.step) * FRAME_S)
    assert svc.budget.spent_s == pytest.approx(t.actual_s)
    assert t.actual_s < t.projected_s          # the limit came early: a credit
    assert svc.budget.remaining_s == pytest.approx(10_000 * FRAME_S - t.actual_s)


# ---------------------------------------------------------------------------
# Slot reuse and queued admission
# ---------------------------------------------------------------------------


def test_slot_reuse_after_retire(world):
    _, chunks, det = world
    svc = _service(chunks, det)
    a = svc.submit("a", _plan(limit=3), key=_qkey(0))
    _drain_sync(svc)
    b = svc.submit("b", _plan(limit=3), key=_qkey(1))
    _drain_sync(svc)
    assert a.state == b.state == FINISHED
    assert a.row == b.row                     # one slot, two generations
    assert len(svc.driver.rows) == 1
    assert a.row_obj is not b.row_obj
    assert int(a.row_obj.carry.results) >= 3 and int(b.row_obj.carry.results) >= 3


def test_queued_tenants_admit_by_priority_when_capacity_frees(world):
    _, chunks, det = world
    svc = _service(chunks, det, budget_s=1000 * FRAME_S)
    t1 = svc.submit("t1", _plan(max_steps=900, limit=3), key=_qkey(0))
    lo = svc.submit("lo", _plan(max_steps=900, limit=3, service=ServiceConfig(queue_on_reject=True, priority=0)),
                    key=_qkey(1))
    hi = svc.submit("hi", _plan(max_steps=900, limit=3, service=ServiceConfig(queue_on_reject=True, priority=5)),
                    key=_qkey(2))
    assert t1.state == RUNNING and lo.state == QUEUED and hi.state == QUEUED
    _drain_sync(svc)
    assert {t.state for t in (t1, lo, hi)} == {FINISHED}
    assert hi.row_obj.admitted_s < lo.row_obj.admitted_s


def test_queued_plan_that_can_never_fit_is_rejected_not_stuck(world):
    """Spend is never credited back: a parked plan above ``total − spent``
    is rejected by the pump, not left to stall the drain."""
    _, chunks, det = world
    svc = _service(chunks, det, budget_s=1000 * FRAME_S)
    a = svc.submit("a", _plan(max_steps=600, limit=64), key=_qkey(0))
    b = svc.submit("b", _plan(max_steps=600, limit=3, service=ServiceConfig(queue_on_reject=True)), key=_qkey(1))
    assert a.state == RUNNING and b.state == QUEUED
    _drain_sync(svc, deadline_s=60.0)
    assert a.state == FINISHED
    assert int(a.row_obj.carry.step) == 600
    assert b.state == REJECTED and "never fit" in b.reason
    assert svc.budget.committed_s == pytest.approx(0.0)


def test_rejected_tenant_can_resubmit_under_same_id(world):
    _, chunks, det = world
    svc = _service(chunks, det, budget_s=1000 * FRAME_S)
    r = svc.submit("a", _plan(max_steps=100_000), key=_qkey(0))
    assert r.state == REJECTED
    t = svc.submit("a", _plan(max_steps=500, limit=3), key=_qkey(0))
    assert t.state == RUNNING
    with pytest.raises(PlanError, match="already submitted"):
        svc.submit("a", _plan(max_steps=500, limit=3), key=_qkey(0))
    _drain_sync(svc)
    assert t.state == FINISHED
    again = svc.submit("a", _plan(max_steps=500, limit=3), key=_qkey(1))
    assert again.state == RUNNING
    _drain_sync(svc)
    assert again.state == FINISHED
    assert svc.tenants["a"] is again
    assert svc.evict_terminal() == 1
    assert not svc.tenants and not svc.busy()


def test_running_tenant_slo_visible_before_retire(world):
    _, chunks, det = world
    svc = _service(chunks, det)
    t = svc.submit("a", _plan(max_steps=1500, limit=64, service=ServiceConfig(slo_latency_s=300.0)), key=_qkey(0))

    def run():
        svc.start(pump=False)
        try:
            for _ in range(200):
                svc.tick(timeout=5.0)
                if t.state != RUNNING or t.row_obj.first_result_s:
                    break
            assert t.state == RUNNING
            rep = t.slo_report()
            assert rep["ttfr_s"] is not None and rep["ttfr_s"] > 0
            assert rep["slo_met"] is True
            assert t.to_dict()["results"] >= 1
            svc.drain()
        finally:
            svc.stop()

    _bounded(run)
    assert t.state == FINISHED


@pytest.mark.parametrize("submitters", [1, 8])
def test_concurrent_submits_race_the_background_pump(world, submitters):
    """Submits from ``submitters`` threads against the hot pump, the
    interpreter switching threads every 10 µs: every tenant finishes and
    the ledger loses no update (nothing committed, the spend the sum of
    the settled costs)."""
    import sys

    _, chunks, det = world
    svc = _service(chunks, det, num_workers=2)
    per = 16 // submitters
    interval = sys.getswitchinterval()

    def submit_some(k):
        for i in range(k * per, (k + 1) * per):
            svc.submit(f"t{i}", _plan(max_steps=60, limit=2), key=_qkey(i))

    def run():
        svc.start(pump=True)
        try:
            threads = [threading.Thread(target=submit_some, args=(k,)) for k in range(submitters)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30.0)
            assert not any(t.is_alive() for t in threads)
            svc.drain(deadline_s=60.0)
        finally:
            svc.stop()

    sys.setswitchinterval(1e-5)
    try:
        _bounded(run)
    finally:
        sys.setswitchinterval(interval)
    tenants = list(svc.tenants.values())
    assert len(tenants) == 16 and all(t.state == FINISHED for t in tenants)
    assert svc.budget.committed_s == pytest.approx(0.0)
    assert svc.budget.spent_s == pytest.approx(sum(t.actual_s for t in tenants))


# ---------------------------------------------------------------------------
# Each tenant equals its solo run
# ---------------------------------------------------------------------------


def test_two_tenant_solo_parity_at_debited_budget(world):
    """Each tenant, one of them admitted mid-flight, equals its solo scan at
    the frame budget the service debited it."""
    _, chunks, det = world
    svc = _service(chunks, det)
    a = svc.submit("a", _plan(max_steps=1500, limit=8), key=_qkey(0))

    def run():
        svc.start(pump=False)
        try:
            for _ in range(3):
                svc.tick(timeout=5.0)
            b = svc.submit("b", _plan(max_steps=1500, limit=8), key=_qkey(1))
            svc.drain()
        finally:
            svc.stop()
        return b

    b = _bounded(run)
    assert a.state == b.state == FINISHED
    assert a.row_obj.budget == 1500
    assert b.row_obj.budget < 1500
    assert (1500 - b.row_obj.budget) % svc.driver.cohorts == 0
    for tenant, key in ((a, _qkey(0)), (b, _qkey(1))):
        row = tenant.row_obj
        solo = _solo(chunks, det, key, result_limit=8, max_steps=row.budget)
        _assert_same_carry_port(row.carry, solo)


def test_select_id_binds_tenant_predicate(world):
    """``select_id`` routes a tenant's lane to its class through the one
    universe ``class_select``: equal to a solo Q = 1 multi run with the
    class bound directly."""
    repo, chunks, _ = world
    num_classes = int(repo.inst_class.max()) + 1

    def det_all(key, frame):
        return oracle_detect(repo, frame, query_class=None)

    svc = _service(chunks, det_all, select=class_select(repo, list(range(num_classes))))
    tenants = {cls: svc.submit(f"cls{cls}", _plan(max_steps=1200, limit=5), key=_qkey(cls), select_id=cls)
               for cls in (0, 1)}
    _drain_sync(svc)
    for cls, tenant in tenants.items():
        assert tenant.state == FINISHED
        row = tenant.row_obj
        carry = tcore.init_carry_multi(tcore.init_state(chunks.length, device=CPU),
                                       tcore.init_matcher(max_results=64, device=CPU), torch.stack([_qkey(cls)]))
        ref = SearchPlan(queries=1, result_limit=5, max_steps=row.budget, cohorts=2,
                         execution=Execution(queries_axis=True)).run(
            carry, chunks, detector=det_all, select=class_select(repo, [cls]))
        assert int(row.carry.step) == ref.steps[0]
        assert int(row.carry.results) == ref.results[0]
        assert torch.equal(row.carry.sampler.n, ref.carry.sampler.n[0])
        assert torch.equal(row.carry.matcher.times_seen, ref.carry.matcher.times_seen[0])


# ---------------------------------------------------------------------------
# SLO and per-tenant accounting
# ---------------------------------------------------------------------------


def test_slo_accounting(world):
    _, chunks, det = world
    svc = _service(chunks, det)
    met = svc.submit("met", _plan(limit=3, service=ServiceConfig(slo_latency_s=300.0)), key=_qkey(0))
    missed = svc.submit("missed", _plan(limit=3, service=ServiceConfig(slo_latency_s=1e-9)), key=_qkey(1))
    none = svc.submit("none", _plan(limit=3), key=_qkey(2))
    _drain_sync(svc)
    for t in (met, missed, none):
        assert t.state == FINISHED
        rep = t.slo_report()
        assert rep["ttfr_s"] is not None and rep["ttfr_s"] > 0
        row = t.row_obj
        assert row.admitted_s < row.first_result_s <= row.finished_s
    assert met.slo_report()["slo_met"] is True
    assert missed.slo_report()["slo_met"] is False
    assert none.slo_report()["slo_met"] is None


def test_per_tenant_stats_and_occupancy(world):
    _, chunks, det = world
    svc = _service(chunks, det)
    a = svc.submit("a", _plan(limit=4), key=_qkey(0))
    b = svc.submit("b", _plan(limit=4), key=_qkey(1))
    _drain_sync(svc)
    st = svc.stats()
    d = svc.driver.stats
    assert abs(svc.occupancy + svc.padding_fraction() - 1.0) < 1e-12
    assert st["batch"]["lanes_issued"] == d["lanes_issued"] > 0
    assert sum(t.stats.detector_invocations for t in (a, b)) == d["detector_invocations"]
    assert sum(t.stats.cache_hits for t in (a, b)) == d["cache_hits"]
    for t in (a, b):
        s = t.stats
        assert s.frames_sampled == int(t.row_obj.carry.step)
        assert s.rounds == t.row_obj.rounds > 0
        assert s.results_spilled == len(t.row_obj.log)
        assert s.matcher_capacity == 64 and s.matcher_inserted == int(t.row_obj.carry.matcher.total_inserted)


def test_default_key_is_jax_prngkey_and_reports_are_plain_numbers(world):
    """``submit``'s default key is ``jax.random.PRNGKey(seed)`` bit for bit,
    on the pool's device; ``to_dict`` and ``stats`` hold no tensor."""
    _, chunks, det = world
    svc = _service(chunks, det)
    t = svc.submit("a", _plan(limit=3, service=ServiceConfig(slo_latency_s=60.0)), seed=123456789)
    np.testing.assert_array_equal(t.key.numpy().astype(np.uint32), np.asarray(jax.random.PRNGKey(123456789)))
    assert t.key.device == torch.device(CPU)
    _drain_sync(svc)

    def leaves(obj):
        if isinstance(obj, dict):
            for v in obj.values():
                yield from leaves(v)
        else:
            yield obj

    st = svc.stats()
    assert all(v is None or type(v) in (int, float, bool, str) for v in leaves(st))
    assert json.loads(json.dumps(st))["tenants"]["a"]["results"] == int(t.row_obj.carry.results) >= 3


# ---------------------------------------------------------------------------
# Bit for bit against JAX's SearchService
# ---------------------------------------------------------------------------


def _drain_work(driver):
    items = []
    while True:
        try:
            item = driver._work.get_nowait()
        except Exception:
            break
        if item is not None:
            items.append(item)
    return items


def _sync_tick(svc):
    """One synchronous heartbeat: issue, process and merge every batch in
    issue order, then harvest and admit."""
    driver = svc.driver
    driver._issue_ready()
    for batch in _drain_work(driver):
        driver._merge(driver._process_batch(0, batch))
    svc._reap()
    svc._admit_queued()


def _dict_less_clock(t):
    return {k: v for k, v in t.to_dict().items() if k not in CLOCK_FIELDS}


@pytest.mark.parametrize("with_index", [False, True])
def test_synchronous_service_drive_equals_jax(world, jworld, with_index):
    """Tenants admitted at round 0, one admitted after 3 rounds with a
    debited budget, two queued and admitted by priority, one rejected,
    over a class-agnostic detector with ``class_select``, a shared cache
    and (``with_index``) an index whose priors warm the admissions and
    which the retirements publish to: every admission, carry, row
    accounting, log, ``to_dict()`` less the clock fields and the budget,
    batch and driver stats equal JAX's."""
    trepo, tc, _ = world
    jrepo, jc = jworld
    num_classes = int(trepo.inst_class.max()) + 1
    indexes = (None, None)
    if with_index:
        rng = np.random.default_rng(3)
        indexes = (RepositoryIndex(detector_version="v0", prior_weight=20.0),
                   JIndex(detector_version="v0", prior_weight=20.0))
        for cls in (0, 1):
            n = rng.integers(0, 40, tc.length.shape[0]).astype(np.float64)
            n1 = np.floor(n * rng.uniform(0, 0.5, n.shape))
            for index in indexes:
                index.priors.record(cls, n1, n)
    kw = dict(cohorts=2, num_workers=1, slots_per_batch=2, cache_frames=tc.total_frames, rates=RATES,
              budget_s=780 * FRAME_S)
    tsv = SearchService(_proto(tc), tc, lambda k, f: oracle_detect(trepo, f, query_class=None),
                        select=class_select(trepo, list(range(num_classes))), index=indexes[0], **kw)
    jsv = jsvc.SearchService(_jproto(jc), jc, lambda k, f: j_detect(jrepo, f, query_class=None),
                             select=j_class_select(jrepo, list(range(num_classes))), index=indexes[1], **kw)
    tsv.driver.method = jsv.driver.method = "wilson_hilferty"

    def submit(tid, q, cls, *, max_steps=200, limit=64, service=None):
        t = tsv.submit(tid, _plan(max_steps=max_steps, limit=limit,
                                  service=None if service is None else ServiceConfig(**service)),
                       key=_qkey(q), select_id=cls)
        j = jsv.submit(tid, _jplan(max_steps=max_steps, limit=limit,
                                   service=None if service is None else JServiceConfig(**service)),
                       key=_jqkey(q), select_id=cls)
        assert (t.state, t.projected_s, t.reason) == (j.state, j.projected_s, j.reason)
        return t

    def same_service():
        tst, jst = tsv.stats(), jsv.stats()
        assert tst["budget"] == jst["budget"] and tst["batch"] == jst["batch"] and tst["driver"] == jst["driver"]
        for tid, tt in tsv.tenants.items():
            jt = jsv.tenants[tid]
            assert (tt.state, tt.row, tt.reason) == (jt.state, jt.row, jt.reason), tid
            assert _dict_less_clock(tt) == _dict_less_clock(jt), tid

    submit("a", 0, 0)
    submit("b", 1, 0, limit=3)
    for _ in range(3):
        _sync_tick(tsv)
        _sync_tick(jsv)
        same_service()
    late = submit("late", 2, 1)
    assert late.state == RUNNING and late.row_obj.budget == 200 - 2 * 3
    assert submit("lo", 3, 1, limit=3, service=dict(queue_on_reject=True, priority=0)).state == QUEUED
    assert submit("hi", 4, 0, limit=3, service=dict(queue_on_reject=True, priority=5)).state == QUEUED
    assert submit("rej", 5, 0, max_steps=10**6, service=dict(queue_on_reject=True)).state == REJECTED
    admitted_at = {}
    for tick in range(1_000):
        if not (tsv.busy() or jsv.busy()):
            break
        _sync_tick(tsv)
        _sync_tick(jsv)
        same_service()
        for tid in ("lo", "hi"):
            if tsv.tenants[tid].state != QUEUED:
                admitted_at.setdefault(tid, tick)
    else:
        pytest.fail("the services did not drain")
    assert {tid: t.state for tid, t in tsv.tenants.items()} == dict(
        a=FINISHED, b=FINISHED, late=FINISHED, lo=FINISHED, hi=FINISHED, rej=REJECTED)
    assert admitted_at["hi"] < admitted_at["lo"]
    assert len(tsv.driver.rows) == len(jsv.driver.rows) <= 3
    for tid, tt in tsv.tenants.items():
        if tt.row_obj is None:
            continue
        jt = jsv.tenants[tid]
        _assert_same_carry(tt.row_obj.carry, jt.row_obj.carry)
        assert {f: getattr(tt.row_obj, f) for f in ROW_ACCOUNTING} == \
            {f: getattr(jt.row_obj, f) for f in ROW_ACCOUNTING}, tid
        assert len(tt.row_obj.log) == len(jt.row_obj.log)
        if len(jt.row_obj.log):
            ta, ja = tt.row_obj.log.as_arrays(), jt.row_obj.log.as_arrays()
            for f in ja:
                np.testing.assert_array_equal(ta[f], np.asarray(ja[f]), err_msg=f)
        if with_index:
            np.testing.assert_array_equal(tt.n1_init, np.asarray(jt.n1_init))
    np.testing.assert_array_equal(tsv.driver.cache.tag[:-1].numpy(), np.asarray(jsv.driver.cache.tag))
    assert tsv.driver.stats["cache_hits"] > 0
    if with_index:
        assert any(t.row_obj.warm_rounds_saved for t in tsv.tenants.values() if t.row_obj is not None)
        assert len(indexes[0]) == len(indexes[1]) > 0
        assert indexes[0].stats == indexes[1].stats
        ta, ja = indexes[0].priors.to_arrays(), indexes[1].priors.to_arrays()
        assert sorted(ta) == sorted(ja)
        for f in ja:
            np.testing.assert_array_equal(ta[f], ja[f], err_msg=f)


# ---------------------------------------------------------------------------
# Threads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pump", [False, True])
@pytest.mark.parametrize("workers", [1, 4])
def test_threaded_tenants_equal_their_solo_scans(world, workers, pump):
    """With W worker threads, driven by ``tick()`` or the background pump,
    each tenant (one admitted late, one queued behind the budget) equals
    its solo scan at its debited budget under the exact Gamma."""
    repo, chunks, _ = world

    def det_all(key, frame):
        return oracle_detect(repo, frame, query_class=None)

    svc = _service(chunks, det_all, num_workers=workers, select=class_select(repo, [0, 1, 2, 3]),
                   cache_frames=chunks.total_frames, budget_s=2400 * FRAME_S)
    classes = {"a": 0, "b": 1, "late": 0, "queued": 1}

    def run():
        svc.start(pump=pump)
        try:
            svc.submit("a", _plan(max_steps=600, limit=6), key=_qkey(0), select_id=0)
            svc.submit("b", _plan(max_steps=600, limit=6), key=_qkey(1), select_id=1)
            while svc.driver.pool_rounds() < 2:
                if pump:
                    time.sleep(0.005)
                else:
                    svc.tick(timeout=5.0)
            svc.submit("late", _plan(max_steps=600, limit=6), key=_qkey(2), select_id=0)
            q = svc.submit("queued", _plan(max_steps=700, limit=6, service=ServiceConfig(queue_on_reject=True)),
                           key=_qkey(3), select_id=1)
            assert q.state == QUEUED
            svc.drain(deadline_s=90.0)
        finally:
            svc.stop()

    _bounded(run)
    assert len(svc.driver.rows) <= 3
    for q, (tid, cls) in enumerate(classes.items()):
        t = svc.tenants[tid]
        assert t.state == FINISHED
        row = t.row_obj
        solo = _solo(chunks, lambda k, f, c=cls: filter_class(repo, det_all(k, f), c), _qkey(q),
                     result_limit=6, max_steps=row.budget)
        _assert_same_carry_port(row.carry, solo)
        assert int(row.carry.results) == int((row.carry.matcher.times_seen > 0).sum()) + len(row.log)
    assert svc.tenants["late"].row_obj.budget < 600
    assert svc.budget.committed_s == pytest.approx(0.0)


def _raising_off_main(detector):
    def det(key, frame):
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("detector failed on a worker")
        return detector(key, frame)

    return det


@pytest.mark.parametrize("pump", [False, True])
def test_a_raising_detector_stops_the_service(world, pump):
    """A worker's exception stops the service: ``drain()`` and ``tick()``
    raise it within seconds, ``busy()`` reports no work that cannot
    finish, and the front answers ``ok: false``."""
    from repro_torch.launch.serve_search import handle_request

    _, chunks, det = world
    # the constructor probes the detector on this (the main) thread
    svc = _service(chunks, _raising_off_main(det), num_workers=2)

    def run():
        svc.start(pump=pump)
        try:
            svc.submit("a", _plan(max_steps=600, limit=6), key=_qkey(0))
            t0 = time.monotonic()
            with pytest.raises(ServiceFailure, match="detector failed on a worker") as e:
                svc.drain(deadline_s=60.0)
            assert time.monotonic() - t0 < 20
            assert isinstance(e.value.__cause__, RuntimeError)
            with pytest.raises(ServiceFailure, match="detector failed on a worker"):
                svc.tick(timeout=0.01)
            assert not svc.busy() and svc.failure is e.value.__cause__
            for req in ({"op": "drain"}, {"op": "submit", "tenant": "b", "plan": {
                    "result_limit": 3, "max_steps": 100, "cohorts": 2, "execution": {"queries_axis": True}}}):
                resp = handle_request(svc, req)
                assert resp["ok"] is False and "detector failed on a worker" in resp["error"]
            assert handle_request(svc, {"op": "stats"})["ok"] is True
        finally:
            svc.stop()

    _bounded(run, seconds=60)


# ---------------------------------------------------------------------------
# The stdin front: four tenants on one live driver
# ---------------------------------------------------------------------------


def test_front_e2e_four_tenants_one_live_driver():
    """Four tenants share one live driver through ``handle_request``,
    admission queues one plan and rejects another, the drain is clean and
    no result is lost: ``results == ring live entries + len(ResultLog)``."""
    from repro_torch.launch.serve_search import build_service, handle_request

    args = argparse.Namespace(dataset="dashcam", scale=0.02, seed=0, budget_s=4 * 1200 * FRAME_S + 1.0,
                              cohorts=4, workers=2, max_steps=100_000, max_results=256, slots_per_batch=4,
                              cache=True, device="cpu")
    service = build_service(args)
    assert isinstance(service.driver.rows[0], _QueryRow) and service.device == torch.device(CPU)

    def run():
        service.start()
        try:
            def submit(tid, cls, seed, *, max_steps=1200, limit=4, service_cfg=None):
                plan = {"result_limit": limit, "max_steps": max_steps, "cohorts": 4,
                        "execution": {"queries_axis": True}}
                if service_cfg:
                    plan["execution"]["service"] = service_cfg
                return handle_request(service, {"op": "submit", "tenant": tid, "class": cls, "seed": seed,
                                                "plan": plan})

            live = [submit(f"t{i}", cls=i % service.num_classes, seed=i) for i in range(4)]
            assert all(r["ok"] and r["state"] == RUNNING for r in live)
            queued = submit("t4", cls=0, seed=4, service_cfg={"queue_on_reject": True})
            assert queued["ok"] and queued["state"] == QUEUED
            rejected = submit("t5", cls=1, seed=5, max_steps=500_000)
            assert rejected["ok"] and rejected["state"] == REJECTED and "budget" in rejected["reason"]
            bad = handle_request(service, {"op": "submit", "tenant": "bad", "class": 0, "plan": {"max_step": 5}})
            assert not bad["ok"] and bad["field"] == "max_step"
            resp = handle_request(service, {"op": "drain", "deadline_s": 100})
            assert resp["ok"]
            return json.loads(json.dumps(resp))
        finally:
            service.stop()

    resp = _bounded(run)
    tenants = resp["tenants"]
    assert len([t for t in tenants.values() if t["state"] == FINISHED]) == 5
    assert tenants["t5"]["state"] == REJECTED and "bad" not in tenants
    for tid in ("t0", "t1", "t2", "t3", "t4"):
        row = service.tenants[tid].row_obj
        ring_live = int((row.carry.matcher.times_seen > 0).sum())
        assert int(row.carry.results) == ring_live + len(row.log) == tenants[tid]["results"]
        assert int(row.carry.results) >= 1
        assert int(row.carry.results) >= 4 or int(row.carry.step) >= row.budget
    assert resp["budget"]["committed_s"] == pytest.approx(0.0)
    assert resp["budget"]["spent_s"] > 0
    assert len(service.driver.rows) <= 4
    assert all(r.vacant for r in service.driver.rows)
    assert not handle_request(service, {"op": "nope"})["ok"]
    assert tsvc.RUNNING == jsvc.RUNNING and tsvc.QUEUED == jsvc.QUEUED
