"""The async runtime of repro_torch (``core.runtime``) against the JAX
package's ``repro.core.runtime``, on the CPU, mirroring
``tests/test_async_runtime.py`` and ``tests/test_async_compose.py`` on
their ``world`` repositories.

* **Single-query tier.**  Its cohorts race the merges at any worker count,
  and its issue step draws the exact Gamma, which the port holds only
  statistically; so ``_process_cohort``, ``_process_one`` and ``_merge``
  are held bit for bit against JAX's on the same chunk ids in a
  synchronous drive in a fixed order (overlapping snapshots, out-of-order
  merges, ring spills), and threaded runs to the reference's invariants.
* **Slot tier.**  Each query equals its solo scan run at any worker count:
  driven with ``method="wilson_hilferty"`` (which the constructor takes
  and the plan does not), at W = 1 and W = 4 every query equals JAX's
  driver and the port's scan and multi kinds; in a synchronous drive the
  counters equal JAX's too.  Through the plan (exact Gamma) ``async_multi``
  equals the port's own ``multi`` run.  Also: admit and retire, a forced
  reissue merged at most once, a tiny ring spilling without loss, the
  overflow guard, a warm index, and a raising detector raising from
  ``run()`` within seconds.

Every threaded run goes through ``_bounded``, which fails the test rather
than hang.
"""
import dataclasses
import functools
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import core as jcore
from repro.core import distributed as jdist
from repro.core import exsample as jex
from repro.core import runtime as jrt
from repro.distributed import fault_tolerance as jft
from repro.sim import RepoSpec as JSpec
from repro.sim import generate as j_generate
from repro.sim.oracle import class_select as j_class_select
from repro.sim.oracle import oracle_detect as j_detect
from repro_torch import core as tcore
from repro_torch.core import distributed as tdist
from repro_torch.core import exsample as tex
from repro_torch.core import prng
from repro_torch.core import runtime as trt
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.kernels import build
from repro_torch.sim import RepoSpec as TSpec
from repro_torch.sim import class_select as t_class_select
from repro_torch.sim import generate as t_generate
from repro_torch.sim import oracle_detect as t_detect

CPU = "cpu"
MATCHER_FIELDS = ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted")
# tests/test_async_runtime.py's world and tests/test_async_compose.py's
SINGLE = dict(video_lengths=[10_000] * 4, num_instances=150, chunk_frames=1_000, locality=4.0, seed=5)
COMPOSE = dict(video_lengths=[6_000] * 3, num_instances=120, chunk_frames=600, locality=4.0, seed=7)

warnings.filterwarnings("ignore", message="run_search_scan")


def _bounded(fn, seconds=180.0):
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
    return out["value"]


@pytest.fixture(scope="module")
def single():
    jr, jc = j_generate(JSpec(**SINGLE))
    tr, tc = t_generate(TSpec(**SINGLE), device=CPU)
    return (jr, jc, lambda k, f: j_detect(jr, f, query_class=0)), (tr, tc, lambda k, f: t_detect(tr, f, query_class=0))


@pytest.fixture(scope="module")
def compose():
    jr, jc = j_generate(JSpec(**COMPOSE))
    tr, tc = t_generate(TSpec(**COMPOSE), device=CPU)
    return (jr, jc, lambda k, f: j_detect(jr, f, query_class=0)), (tr, tc, lambda k, f: t_detect(tr, f, query_class=0))


def _assert_same_carry(tc_, jc_, q=None):
    """Every leaf of a port carry against a JAX carry (row ``q`` of a
    leading-[Q] JAX carry when given)."""
    pick = (lambda x: np.asarray(x)) if q is None else (lambda x: np.asarray(x)[q])
    for f in ("n1", "n", "frames"):
        np.testing.assert_array_equal(getattr(tc_.sampler, f).numpy(), pick(getattr(jc_.sampler, f)), err_msg=f)
    for f in MATCHER_FIELDS:
        np.testing.assert_array_equal(getattr(tc_.matcher, f).numpy(), pick(getattr(jc_.matcher, f)), err_msg=f)
    np.testing.assert_array_equal(tc_.key.numpy().astype(np.uint32), pick(jc_.key))
    np.testing.assert_array_equal(tc_.step.numpy(), pick(jc_.step))
    np.testing.assert_array_equal(tc_.results.numpy(), pick(jc_.results))


def _assert_same_log(tlog, jlog):
    assert len(tlog) == len(jlog)
    ta, ja = tlog.as_arrays(), jlog.as_arrays()
    if len(jlog):
        for f in ja:
            np.testing.assert_array_equal(ta[f], np.asarray(ja[f]), err_msg=f)


def _jcarry(jc, seed=0, ring=1024):
    return jcore.init_carry(jcore.init_state(jc.length), jcore.init_matcher(max_results=ring),
                            jax.random.PRNGKey(seed))


def _tcarry(tc, seed=0, ring=1024):
    return tcore.init_carry(tcore.init_state(tc.length, device=CPU), tcore.init_matcher(max_results=ring, device=CPU),
                            prng.PRNGKey(seed, device=CPU))


# ---------------------------------------------------------------------------
# Single-query tier: exact in a synchronous drive
# ---------------------------------------------------------------------------


def test_process_cohort_equals_jax(single):
    (_, jc, jdet), (_, tc, tdet) = single
    ids = np.asarray([3, 3, 7, 0, 39, 12, 7, 7], np.int32)
    base_j = jax.random.fold_in(jax.random.PRNGKey(7), 5)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(base_j, i))(jnp.arange(len(ids), dtype=jnp.int32))
    tkeys = prng.split(prng.fold_in(prng.PRNGKey(7, device=CPU), 5), len(ids))
    np.testing.assert_array_equal(tkeys.numpy().astype(np.uint32), np.asarray(jkeys))
    jout, tout = _jcarry(jc), _tcarry(tc)
    for _ in range(3):   # from a fresh carry, then from the carries the cohort left
        jout = jrt._process_cohort(jout, jc, jnp.asarray(ids), jkeys, detector=jdet)
        tout = trt._process_cohort(tout, tc, torch.as_tensor(ids), tkeys, detector=tdet)
        _assert_same_carry(tout, jout)
    assert int(tout.results) > 0


def _paired_drivers(single, ring, cohort_size=4):
    (_, jc, jdet), (_, tc, tdet) = single
    kw = dict(cohort_size=cohort_size, num_workers=1, result_limit=10**9, max_frames=10**9)
    return jrt.AsyncSearchDriver(_jcarry(jc, ring=ring), jc, jdet, **kw), \
        trt.AsyncSearchDriver(_tcarry(tc, ring=ring), tc, tdet, **kw)


def _issue_both(jd, td):
    """Issue one cohort in each driver; the port's takes JAX's chunk ids
    (its exact-Gamma choice is held only statistically)."""
    jd._issue_cohort()
    td._issue_cohort()
    jco, tco = jd._work.get_nowait(), td._work.get_nowait()
    assert jco.cohort_id == tco.cohort_id
    tco.chunk_ids = np.asarray(jco.chunk_ids, np.int32)
    return jco, tco


def _check_drivers(jd, td):
    _assert_same_carry(td.carry, jd.carry)
    assert td.stats == jd.stats
    _assert_same_log(td.result_log, jd.result_log)


@pytest.mark.parametrize("ring", [1024, 48])
def test_synchronous_drive_equals_jax(single, ring):
    """A fixed order of issues, snapshots and merges: two cohorts against
    one snapshot merged out of order, a re-issued duplicate, then
    snapshots taken between merges.  A ring of 48 makes merges evict live
    entries, which spill to the ResultLog."""
    jd, td = _paired_drivers(single, ring)
    (j0, t0), (j1, t1) = _issue_both(jd, td), _issue_both(jd, td)
    jr0, tr0 = jd._process_one(0, j0), td._process_one(0, t0)
    jr1, tr1 = jd._process_one(1, j1), td._process_one(1, t1)
    assert (tr0.new_results, tr1.new_results) == (jr0.new_results, jr1.new_results)
    np.testing.assert_array_equal(tr1.delta_n1.numpy(), np.asarray(jr1.delta_n1))
    jd._merge(jr1)
    td._merge(tr1)
    _check_drivers(jd, td)
    jd._merge(jr0)
    td._merge(tr0)
    jd._merge(jr0)   # a second completion: dropped
    td._merge(tr0)
    _check_drivers(jd, td)
    for _ in range(12):
        (ja, ta), (jb, tb) = _issue_both(jd, td), _issue_both(jd, td)
        jra, tra = jd._process_one(0, ja), td._process_one(0, ta)
        jd._merge(jra)
        td._merge(tra)
        jrb, trb = jd._process_one(0, jb), td._process_one(0, tb)
        jd._merge(jrb)
        td._merge(trb)
        _check_drivers(jd, td)
    assert td.stats["duplicate_drops"] == 1 and td.stats["merges"] == 26
    if ring == 48:
        assert td.stats["spilled"] > 0
    assert int(td.carry.results) == int(td.carry.matcher.total_inserted)


def test_merge_deltas_equals_jax():
    rng = np.random.default_rng(0)
    n1, n = rng.normal(size=7).astype(np.float32), rng.integers(0, 9, 7).astype(np.float32)
    d1, dn = rng.normal(size=(3, 7)).astype(np.float32), rng.integers(0, 4, (3, 7)).astype(np.float32)
    js = jdist.merge_deltas(dataclasses.replace(jcore.init_state(np.full(7, 50)), n1=jnp.asarray(n1),
                                                n=jnp.asarray(n)), jnp.asarray(d1), jnp.asarray(dn))
    ts = tdist.merge_deltas(dataclasses.replace(tcore.init_state(np.full(7, 50), device=CPU),
                                                n1=torch.as_tensor(n1), n=torch.as_tensor(n)),
                            torch.as_tensor(d1), torch.as_tensor(dn))
    np.testing.assert_array_equal(ts.n1.numpy(), np.asarray(js.n1))
    np.testing.assert_array_equal(ts.n.numpy(), np.asarray(js.n))
    one = tdist.merge_deltas(ts, torch.as_tensor(d1[0]), torch.as_tensor(dn[0]))
    np.testing.assert_array_equal(one.n1.numpy(), (ts.n1 + torch.as_tensor(d1[0])).numpy())


def test_heartbeat_monitor_equals_jax():
    """The same script of registrations, heartbeats, assignments and
    completions on a synthetic clock gives the same decisions."""
    mons = [jft.HeartbeatMonitor(suspect_after_s=5.0, dead_after_s=20.0, straggler_factor=3.0),
            tft.HeartbeatMonitor(suspect_after_s=5.0, dead_after_s=20.0, straggler_factor=3.0)]
    out = [[], []]
    for i, m in enumerate(mons):
        m.register(0, now=0.0)
        m.register(1, now=0.0)
        m.register(2, now=None)
        for w in range(3):
            m.assign(w, 10 + w, now=1.0)
        m.record_completion(0, 1.0, now=2.0)
        m.record_completion(1, 1.5, now=2.5)
        m.heartbeat(0, 2.0)
        m.assign(0, 20, now=2.0)
        m.record_completion(7, 2.0)          # an unknown worker, no timestamp
        for now in (3.0, 6.5, 8.0, 25.0, 40.0):
            out[i].append(m.sweep(now))
        out[i].append(sorted(m.healthy_workers))
        out[i].append({w: (info.state.value, info.completed, info.inflight_cohort)
                       for w, info in m.workers.items()})
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# Single-query tier: threaded, the reference's invariants
# ---------------------------------------------------------------------------


def _occupied(carry):
    return int((carry.matcher.times_seen > 0).sum())


def test_async_driver_finds_results(single):
    _, (_, tc, tdet) = single
    driver = trt.AsyncSearchDriver(_tcarry(tc), tc, tdet, cohort_size=4, num_workers=3, result_limit=15,
                                   max_frames=3_000)
    out = _bounded(driver.run)
    assert int(out.results) >= 15
    assert driver.stats["cohorts"] >= 4 and driver.stats["merges"] >= 4
    assert int(out.step) == int(out.sampler.n.sum())


def test_async_driver_merge_is_atomic_under_contention(single):
    _, (_, tc, tdet) = single
    driver = trt.AsyncSearchDriver(_tcarry(tc, seed=3, ring=2048), tc, tdet, cohort_size=8, num_workers=8,
                                   result_limit=40, max_frames=4_000)
    seen, frames, orig = [], [], driver._merge

    def spy(res):
        seen.append(res.new_results)
        if res.cohort_id in driver._inflight:
            frames.append(res.frames)
        orig(res)

    driver._merge = spy
    out = _bounded(driver.run)
    assert int(out.results) >= 40 or int(out.step) >= 4_000
    assert int(out.step) == int(out.sampler.n.sum()) == sum(frames)   # Σ merged frames = step
    assert all(d >= 0 for d in seen)
    assert _occupied(out) == int(out.results)
    assert driver.stats["merges"] == len(frames)


def test_async_driver_drops_duplicate_completions(single):
    _, (_, tc, tdet) = single
    driver = trt.AsyncSearchDriver(_tcarry(tc, seed=7), tc, tdet, cohort_size=4, num_workers=1,
                                   result_limit=10**9, max_frames=10**9)
    driver._issue_cohort()
    cohort = driver._work.get_nowait()
    first = driver._process_one(0, cohort)
    driver._reissue(cohort.cohort_id)
    second = driver._process_one(1, driver._work.get_nowait())
    driver._merge(first)
    driver._merge(second)
    assert driver.stats["reissues"] == 1 and driver.stats["duplicate_drops"] == 1
    assert int(driver.carry.step) == len(cohort.chunk_ids) == int(driver.carry.sampler.n.sum())
    assert _occupied(driver.carry) == int(driver.carry.results)


def test_async_driver_merge_high_water_and_overflow_guard(single):
    _, (_, tc, tdet) = single
    driver = trt.AsyncSearchDriver(_tcarry(tc, seed=1, ring=8), tc, tdet, cohort_size=2, num_workers=1,
                                   result_limit=10**9, max_frames=10**9)
    driver._issue_cohort()
    res = driver._process_one(0, driver._work.get_nowait())
    driver._merge(res)
    assert driver.stats["merge_high_water"] == int(res.matcher.total_inserted - res.snap_matcher.total_inserted)
    driver._issue_cohort()
    res2 = driver._process_one(0, driver._work.get_nowait())
    bad = dataclasses.replace(res2, matcher=dataclasses.replace(
        res2.matcher, total_inserted=res2.snap_matcher.total_inserted + 9))
    step_before = int(driver.carry.step)
    with pytest.raises(trt.MatcherRingOverflow):
        driver._merge(bad)
    assert int(driver.carry.step) == step_before


def test_async_driver_single_worker(single):
    _, (_, tc, tdet) = single
    driver = trt.AsyncSearchDriver(_tcarry(tc), tc, tdet, cohort_size=2, num_workers=1, result_limit=10,
                                   max_frames=2_000)
    out = _bounded(driver.run)
    assert int(out.results) >= 10 and driver.stats["reissues"] == 0
    assert int(out.step) == 2 * driver.stats["merges"]


# ---------------------------------------------------------------------------
# Slot tier
# ---------------------------------------------------------------------------


def _jqkey(q):
    return jax.random.fold_in(jax.random.PRNGKey(0), q)


def _tqkey(q):
    return prng.fold_in(prng.PRNGKey(0, device=CPU), q)


def _jmulti(jc, q_n, ring=64):
    return jcore.init_carry_multi(jcore.init_state(jc.length), jcore.init_matcher(max_results=ring),
                                  jax.vmap(_jqkey)(jnp.arange(q_n)))


def _tmulti(tc, q_n, ring=64):
    return tcore.init_carry_multi(tcore.init_state(tc.length, device=CPU),
                                  tcore.init_matcher(max_results=ring, device=CPU),
                                  torch.stack([_tqkey(q) for q in range(q_n)]))


def _tsolo(tc, tdet, q, *, result_limit, max_steps, cohorts, trace_every=0, ring=64):
    carry = tcore.init_carry(tcore.init_state(tc.length, device=CPU),
                             tcore.init_matcher(max_results=ring, device=CPU), _tqkey(q))
    res = tcore.SearchPlan(result_limit=result_limit, max_steps=max_steps, cohorts=cohorts,
                           method="wilson_hilferty", trace_every=trace_every).run(carry, tc, detector=tdet)
    return res.carry, res.trace


@pytest.mark.parametrize("workers", [1, 4])
def test_composed_equals_jax_and_the_solo_scans(compose, workers):
    """Every query through the slot scheduler (``"wilson_hilferty"``)
    equals JAX's driver's and the port's solo scan, at W = 1 and W = 4."""
    (_, jc, jdet), (_, tc, tdet) = compose
    q_n = 3
    kw = dict(cohorts=2, num_workers=workers, result_limits=8, max_steps=1500, trace_every=25,
              method="wilson_hilferty")
    jd = jrt.AsyncMultiSearchDriver(_jmulti(jc, q_n), jc, jdet, **kw)
    td = trt.AsyncMultiSearchDriver(_tmulti(tc, q_n), tc, tdet, **kw)
    jout, tout = jd.run(), _bounded(td.run)
    multi = tcore.SearchPlan(queries=q_n, cohorts=2, result_limit=8, max_steps=1500, trace_every=25,
                             method="wilson_hilferty",
                             execution=tcore.Execution(queries_axis=True)).run(_tmulti(tc, q_n), tc, detector=tdet)
    for q in range(q_n):
        _assert_same_carry(trt._lane(tout, q), jout, q)
        assert td.traces[q] == jd.traces[q]
        solo, solo_trace = _tsolo(tc, tdet, q, result_limit=8, max_steps=1500, cohorts=2, trace_every=25)
        _assert_same_carry_port(trt._lane(tout, q), solo)
        assert td.traces[q] == solo_trace == multi.traces[q]
        _assert_same_carry_port(trt._lane(tout, q), trt._lane(multi.carry, q))
    assert td.stats["merges"] == td.stats["rounds"] > 0
    assert td.stats["detector_invocations"] <= int(tout.step.sum())


def _assert_same_carry_port(a, b):
    for f in ("n1", "n", "frames"):
        assert torch.equal(getattr(a.sampler, f), getattr(b.sampler, f)), f
    for f in MATCHER_FIELDS:
        assert torch.equal(getattr(a.matcher, f), getattr(b.matcher, f)), f
    for f in ("key", "step", "results"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _drain(driver):
    items = []
    while True:
        try:
            item = driver._work.get_nowait()
        except Exception:
            break
        if item is not None:
            items.append(item)
    return items


def _pump_round(driver):
    driver._issue_ready()
    batches = _drain(driver)
    for batch in batches:
        driver._merge(driver._process_batch(0, batch))
    return len(batches)


def _pump_to_completion(driver, max_pumps=10_000):
    for _ in range(max_pumps):
        if not _pump_round(driver) and not driver._inflight:
            if not any(r.active for r in driver.rows):
                return
    raise AssertionError("driver did not converge")


ROW_ACCOUNTING = ("limit", "budget", "trace", "active", "inflight", "rounds", "vacant", "select_id",
                  "fresh_calls", "cache_hits", "index_hits", "warm_rounds_saved")


def test_synchronous_composed_drive_equals_jax(compose):
    """A synchronous drive (issue, process, merge in a fixed order) over a
    class-agnostic detector with ``class_select``, a shared cache and two
    slots a batch: rows, row accounting, logs and every counter equal
    JAX's."""
    (jr, jc, _), (tr, tc, _) = compose
    classes = (0, 1, 0, 1)
    kw = dict(cohorts=3, num_workers=2, result_limits=[6, 9, 12, 5], max_steps=600, trace_every=30,
              method="wilson_hilferty", cache_frames=tc.total_frames, slots_per_batch=2)
    jd = jrt.AsyncMultiSearchDriver(_jmulti(jc, 4, ring=128), jc, lambda k, f: j_detect(jr, f, query_class=None),
                                    select=j_class_select(jr, classes), **kw)
    td = trt.AsyncMultiSearchDriver(_tmulti(tc, 4, ring=128), tc, lambda k, f: t_detect(tr, f, query_class=None),
                                    select=t_class_select(tr, classes), **kw)
    for _ in range(4):
        _pump_round(jd)
        _pump_round(td)
        assert td.stats == jd.stats
    _pump_to_completion(jd)
    _pump_to_completion(td)
    assert td.stats == jd.stats
    assert td.stats["cache_hits"] > 0 and td.stats["lanes_padded"] >= 0
    for trow, jrow in zip(td.rows, jd.rows):
        _assert_same_carry(trow.carry, jrow.carry)
        assert {f: getattr(trow, f) for f in ROW_ACCOUNTING} == {f: getattr(jrow, f) for f in ROW_ACCOUNTING}
        _assert_same_log(trow.log, jrow.log)
    np.testing.assert_array_equal(td.cache.tag[:-1].numpy(), np.asarray(jd.cache.tag))


def test_multi_round_process_query_ids_reach_select(compose):
    """``select`` sees a row as ``query_ids[row]``, as the reference's."""
    (jr, jc, _), (tr, tc, _) = compose
    classes = (0, 1, 1, 0)
    q_ids = [3, 0, 2]
    jmc, tmc = _jmulti(jc, 3, ring=128), _tmulti(tc, 3, ring=128)
    active_t = torch.ones((3,), dtype=torch.bool)
    jchoice = jex.multi_round_choose(jmc, jc, cohorts=4, method="wilson_hilferty")
    tchoice = tex.multi_round_choose(tmc, tc, active_t, cohorts=4, method="wilson_hilferty")
    # jitted, as the reference's drivers run it (XLA contracts the oracle's FMA)
    jout = jax.jit(functools.partial(jex.multi_round_process, detector=lambda k, f: j_detect(jr, f, query_class=None),
                                     select=j_class_select(jr, classes)))(
        jmc, None, jc, jnp.ones((3,), bool), jchoice, query_ids=jnp.asarray(q_ids, jnp.int32))
    tout = tex.multi_round_process(tmc, None, tc, active_t, tchoice,
                                   detector=lambda k, f: t_detect(tr, f, query_class=None),
                                   select=t_class_select(tr, classes),
                                   query_ids=torch.tensor(q_ids, dtype=torch.int32))
    _assert_same_carry(tout[0], jout[0])
    assert int(tout[2]) == int(jout[2])


@settings(max_examples=5, deadline=None)
@given(r=st.integers(1, 4))
def test_admitted_query_equals_reduced_budget_solo(compose, r):
    _, (_, tc, tdet) = compose
    cohorts = 2
    driver = trt.AsyncMultiSearchDriver(_tmulti(tc, 2), tc, tdet, cohorts=cohorts, num_workers=1,
                                        result_limits=50, max_steps=200, slots_per_batch=2,
                                        method="wilson_hilferty")
    for _ in range(r):
        assert _pump_round(driver) == 1
    assert driver.pool_rounds() == r
    row_idx = driver.admit(_tqkey(9), result_limit=8)
    budget = driver.rows[row_idx].budget
    assert budget == 200 - cohorts * r
    _pump_to_completion(driver)
    solo, _ = _tsolo(tc, tdet, 9, result_limit=8, max_steps=budget, cohorts=cohorts)
    _assert_same_carry_port(driver.rows[row_idx].carry, solo)


def test_retired_rows_frozen_and_masked(compose):
    _, (_, tc, tdet) = compose
    driver = trt.AsyncMultiSearchDriver(_tmulti(tc, 2), tc, tdet, cohorts=1, num_workers=1, result_limits=[1, 30],
                                        max_steps=400, slots_per_batch=1)
    while driver.rows[0].active:
        assert _pump_round(driver)
    frozen = driver.rows[0].carry
    for _ in range(5):
        _pump_round(driver)
    assert driver.rows[0].carry is frozen
    assert driver.rows[0].trace[-1] == (int(frozen.step), int(frozen.results))
    _pump_to_completion(driver)
    assert not any(row.active for row in driver.rows)
    row = driver.vacate(0)
    assert row.vacant and driver.admit(_tqkey(5), result_limit=3) == 0


def test_forced_reissue_merges_at_most_once(compose):
    _, (_, tc, tdet) = compose
    driver = trt.AsyncMultiSearchDriver(_tmulti(tc, 2), tc, tdet, cohorts=1, num_workers=1, result_limits=20,
                                        max_steps=300, slots_per_batch=2)
    driver._issue_ready()
    (batch,) = _drain(driver)
    res_first = driver._process_batch(0, batch)
    driver._reissue(batch.batch_id)
    (dup,) = _drain(driver)
    assert dup.batch_id == batch.batch_id and dup.issue_count == 1
    res_dup = driver._process_batch(1, dup)
    driver._merge(res_first)
    snapshot = [(row.carry.step.clone(), row.carry.sampler.n.clone()) for row in driver.rows]
    merges = driver.stats["merges"]
    driver._merge(res_dup)
    assert driver.stats["duplicate_drops"] == 1 and driver.stats["reissues"] == 1
    assert driver.stats["merges"] == merges
    for row, (step, n) in zip(driver.rows, snapshot):
        assert torch.equal(row.carry.step, step) and torch.equal(row.carry.sampler.n, n)
    _pump_to_completion(driver)


def test_tiny_ring_spills_without_loss(compose):
    _, (tr, tc, _) = compose
    q_n = 2
    driver = trt.AsyncMultiSearchDriver(_tmulti(tc, q_n, ring=8), tc,
                                        lambda k, f: t_detect(tr, f, query_class=0, max_dets=4),
                                        cohorts=1, num_workers=2, result_limits=40, max_steps=3000)
    out = _bounded(driver.run)
    assert driver.stats["spilled"] > 0
    total = 0
    for q in range(q_n):
        live = int((out.matcher.times_seen[q] > 0).sum())
        logged = len(driver.logs[q])
        assert int(out.results[q]) == live + logged == int(out.matcher.total_inserted[q])
        total += logged
    assert driver.stats["spilled"] == total
    arrs = driver.logs[0].as_arrays()
    assert arrs["frame"].shape[0] == len(driver.logs[0]) and np.all(arrs["times_seen"] >= 1)


def test_overflow_impossible_by_construction(compose):
    _, (tr, tc, _) = compose
    with pytest.raises(ValueError, match="capacity"):
        trt.AsyncMultiSearchDriver(_tmulti(tc, 2, ring=8), tc, lambda k, f: t_detect(tr, f, query_class=0, max_dets=8),
                                   cohorts=1, num_workers=1, result_limits=4, max_steps=100)
    with pytest.raises(ValueError, match="leading"):
        trt.AsyncMultiSearchDriver(_tcarry(tc), tc, lambda k, f: t_detect(tr, f, query_class=0))


def test_stats_keys_exist_at_construction(compose):
    _, (_, tc, tdet) = compose
    driver = trt.AsyncMultiSearchDriver(_tmulti(tc, 2), tc, tdet, num_workers=1)
    jdriver = jrt.AsyncMultiSearchDriver(_jmulti(compose[0][1], 2), compose[0][1], compose[0][2], num_workers=1)
    assert driver.stats == jdriver.stats == {
        "slots": 0, "merges": 0, "reissues": 0, "duplicate_drops": 0, "merge_high_water": 0, "rounds": 0,
        "spilled": 0, "detector_invocations": 0, "cache_hits": 0, "index_hits": 0,
        "lanes_issued": 0, "lanes_padded": 0}
    single = trt.AsyncSearchDriver(_tcarry(tc), tc, tdet)
    assert single.stats == {"cohorts": 0, "reissues": 0, "merges": 0, "duplicate_drops": 0,
                            "merge_high_water": 0, "spilled": 0}


# ---------------------------------------------------------------------------
# Through the plan
# ---------------------------------------------------------------------------


def test_lowering_runs_every_single_device_kind():
    from repro_torch.core.executor import _LATER_SLICES

    assert sorted(_LATER_SLICES) == ["multi_sharded", "sharded"]
    assert tcore.SearchPlan(execution=tcore.Execution(async_workers=2)).lower().kind == "async"
    assert tcore.SearchPlan(queries=2, execution=tcore.Execution(queries_axis=True, async_workers=2)) \
        .lower().kind == "async_multi"
    with pytest.raises(tcore.PlanCompatibilityError):
        tcore.SearchPlan(execution=tcore.Execution(shards=2)).lower()


def test_async_multi_plan_equals_the_ports_multi(compose):
    """Through the plan (the exact Gamma, seeded per query from its key),
    async_multi equals the port's own multi kind per query."""
    _, (_, tc, tdet) = compose
    q_n = 4
    common = dict(queries=q_n, cohorts=2, result_limit=8, max_steps=1500, trace_every=25)
    res = _bounded(lambda: tcore.SearchPlan(**common, execution=tcore.Execution(
        queries_axis=True, async_workers=2, cache=-1)).run(_tmulti(tc, q_n), tc, detector=tdet))
    ref = tcore.SearchPlan(**common, method="exact", execution=tcore.Execution(queries_axis=True, cache=-1)).run(
        _tmulti(tc, q_n), tc, detector=tdet)
    assert res.kind == "async_multi" and res.plan.lower().method == "exact"
    assert res.steps == ref.steps and res.results == ref.results and res.traces == ref.traces
    for q in range(q_n):
        _assert_same_carry_port(trt._lane(res.carry, q), trt._lane(ref.carry, q))
    st_ = res.stats
    assert st_.merges == st_.rounds > 0 and st_.frames_sampled == int(res.carry.step.sum())
    assert st_.results_spilled == 0 and st_.detector_invocations <= st_.frames_sampled
    assert res.final_cache is not None


def test_async_plan_invariants(single):
    _, (_, tc, tdet) = single
    res = _bounded(lambda: tcore.SearchPlan(result_limit=12, max_steps=2000, cohorts=4, execution=tcore.Execution(
        async_workers=3)).run(_tcarry(tc), tc, detector=tdet))
    st_ = res.stats
    assert res.kind == "async" and res.results[0] >= 12
    assert st_.frames_sampled == st_.detector_invocations == res.steps[0] == int(res.carry.sampler.n.sum())
    assert st_.frames_sampled == 4 * st_.merges
    assert res.traces == [[(res.steps[0], res.results[0])]]


def test_async_multi_with_a_warm_index(compose, tmp_path):
    """The second run over the first's snapshot calls the detector on no
    frame, every cache hit an index hit, with the same trajectories."""
    _, (_, tc, tdet) = compose
    q_n = 3
    plan = tcore.SearchPlan(queries=q_n, cohorts=2, result_limit=8, max_steps=800, trace_every=25,
                            execution=tcore.Execution(queries_axis=True, async_workers=2, cache=-1,
                                                      index=tcore.IndexSpec(path=str(tmp_path))))
    cold = _bounded(lambda: plan.run(_tmulti(tc, q_n), tc, detector=tdet))
    warm = _bounded(lambda: plan.run(_tmulti(tc, q_n), tc, detector=tdet))
    # two batches in flight can both detect a frame: each counts, one persists
    assert 0 < cold.stats.persisted_detections <= cold.stats.detector_invocations
    assert warm.stats.detector_invocations == 0
    assert warm.stats.index_hits == warm.stats.cache_hits > 0
    assert warm.stats.persisted_detections == 0
    assert warm.steps == cold.steps and warm.results == cold.results and warm.traces == cold.traces


# ---------------------------------------------------------------------------
# A worker's exception reaches the driver
# ---------------------------------------------------------------------------


def _raising_off_main(detector):
    def det(key, frame):
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("detector failed on a worker")
        return detector(key, frame)

    return det


def test_a_raising_detector_raises_from_run(single, compose):
    _, (_, tc, tdet) = single
    driver = trt.AsyncSearchDriver(_tcarry(tc), tc, _raising_off_main(tdet), cohort_size=4, num_workers=2,
                                   result_limit=15, max_frames=3_000)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="detector failed on a worker"):
        _bounded(driver.run, seconds=30)
    assert time.monotonic() - t0 < 20
    _, (_, tcm, tdetm) = compose
    mdriver = trt.AsyncMultiSearchDriver(_tmulti(tcm, 2), tcm, _raising_off_main(tdetm), cohorts=2, num_workers=2,
                                         result_limits=8, max_steps=400)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="detector failed on a worker"):
        _bounded(mdriver.run, seconds=30)
    assert time.monotonic() - t0 < 20
    mdriver2 = trt.AsyncMultiSearchDriver(_tmulti(tcm, 2), tcm, _raising_off_main(tdetm), cohorts=2,
                                          num_workers=1, result_limits=8, max_steps=400)
    mdriver2.start()
    try:
        with pytest.raises(RuntimeError, match="detector failed on a worker"):
            for _ in range(100):
                mdriver2.service_tick(timeout=5.0)
    finally:
        mdriver2.stop()


# ---------------------------------------------------------------------------
# Kernel loading from several threads
# ---------------------------------------------------------------------------


def test_load_builds_once_from_eight_threads(monkeypatch, tmp_path):
    calls = []
    lib = tmp_path / "libfake.so"

    def fake_build(names):
        calls.append(tuple(names))
        time.sleep(0.2)          # long enough for every thread to miss the cache
        lib.write_bytes(b"")
        return {}

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build, "library_path", lambda name: lib)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("loaded", path))
    monkeypatch.setattr(build, "_loaded", {})
    barrier = threading.Barrier(8)
    got = []

    def worker():
        barrier.wait()
        got.append(build.load("fake"))

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert calls == [("fake",)]
    assert len(got) == 8 and all(g is got[0] for g in got)


def test_launch_counts_are_exact_from_several_threads():
    from repro_torch.kernels._launch import count_launch

    def wrapper():
        pass

    wrapper.launches = 0
    threads = [threading.Thread(target=lambda: [count_launch(wrapper) for _ in range(20_000)]) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert wrapper.launches == 8 * 20_000
