"""The resident search loop of repro_torch (``core.exsample._resident_loop``)
against the JAX package's ``lax.while_loop`` drivers, on the CPU.

The port runs each round masked by the loop's exit test, computed on the
device, and reads that test back once every ``rounds_per_sync`` rounds
(on the card it replays one captured round from a CUDA graph; on the CPU
the same masked round runs op by op).  So after the exit up to
``rounds_per_sync - 1`` masked rounds run, and each must leave everything
as it was.  Held here:

  * a masked round past the exit is a bit-exact no-op, for the scan kind
    (the results limit, the step budget, and a carry whose every chunk is
    exhausted, where the fused Thompson round returns -1) and for the
    multi kind (no query live; the detection cache's slots, detector
    calls and cache hits unchanged);
  * ``_scan_search`` and ``_multi_search`` equal the reference's drivers
    for rounds_per_sync 1, 3 and 8: steps, results, traces, stats and
    final carries;
  * the trace's edge cases: a buffer exactly full, the last round
    overshooting ``max_steps`` by up to ``cohorts - 1``, ``trace_every``
    0, and writes past the cap into the spare row (the reference's
    dropped writes).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs.exsample_paper import dashcam as j_dashcam
from repro.core import exsample as jex
from repro.sim import RepoSpec as JSpec
from repro.sim import generate as j_generate
from repro.sim.oracle import class_select as j_class_select
from repro.sim.oracle import oracle_detect as j_detect
from repro_torch import core as tcore
from repro_torch.configs.exsample_paper import dashcam as t_dashcam
from repro_torch.core import exsample as tex
from repro_torch.core import prng
from repro_torch.serve.batcher import tree_map
from repro_torch.sim import RepoSpec as TSpec
from repro_torch.sim import class_select as t_class_select
from repro_torch.sim import generate as t_generate
from repro_torch.sim import oracle_detect as t_detect

CPU = "cpu"
QUERY_CLASS = 7          # dashcam(0.02)'s densest class
RING = 256
MATCHER_FIELDS = ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted")
WORLD = dict(video_lengths=[6_000] * 3, num_instances=120, chunk_frames=600, locality=4.0, seed=7)


@functools.lru_cache(maxsize=None)
def _dashcam():
    return j_generate(j_dashcam(scale=0.02).repo), t_generate(t_dashcam(scale=0.02).repo, device=CPU)


@functools.lru_cache(maxsize=None)
def _world():
    return j_generate(JSpec(**WORLD)), t_generate(TSpec(**WORLD), device=CPU)


def _leaves(c):
    return tex._carry_leaves(c) + [c.sampler.frames]


def _assert_bits_equal(got, want):
    for i, (a, b) in enumerate(zip(_leaves(got), _leaves(want))):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b), i


def _assert_same_carry(tc, jc):
    for f in ("n1", "n", "frames"):
        np.testing.assert_array_equal(getattr(tc.sampler, f).numpy(), np.asarray(getattr(jc.sampler, f)),
                                      err_msg=f)
    for f in MATCHER_FIELDS:
        np.testing.assert_array_equal(getattr(tc.matcher, f).numpy(), np.asarray(getattr(jc.matcher, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tc.key.numpy().astype(np.uint32), np.asarray(jc.key))
    np.testing.assert_array_equal(tc.step.numpy(), np.asarray(jc.step))
    np.testing.assert_array_equal(tc.results.numpy(), np.asarray(jc.results))


def _scan_carries(seed=3):
    (_, jc), (_, tc) = _dashcam()
    j = jcore.init_carry(jcore.init_state(jc.length), jcore.init_matcher(max_results=RING),
                         jax.random.PRNGKey(seed))
    t = tcore.init_carry(tcore.init_state(tc.length, device=CPU), tcore.init_matcher(max_results=RING, device=CPU),
                         prng.PRNGKey(seed, device=CPU))
    return j, t


def _scan_detectors():
    (jr, _), (tr, _) = _dashcam()
    return (lambda k, f: j_detect(jr, f, query_class=QUERY_CLASS),
            lambda k, f: t_detect(tr, f, query_class=QUERY_CLASS))


def _masked_scan_round(carry, go, cohorts, method):
    """The scan kind's round as ``_scan_search`` builds it, for a given
    exit test ``go``."""
    _, (_, tc) = _dashcam()
    det = _scan_detectors()[1]
    go = torch.tensor(go)
    return tex._select(go, tex._choose_and_process(carry, tc, det, cohorts, method, live=go), carry)


# ---- a masked round past the exit is a bit-exact no-op --------------------------

def _mid_search_carry(cohorts, method):
    """A scan carry some rounds into a search: ring, statistics and key all
    off their initial values."""
    _, carry = _scan_carries()
    _, (_, tc) = _dashcam()
    out, _, _ = tex._scan_search(carry, tc, detector=_scan_detectors()[1], result_limit=10_000,
                                 max_steps=32, cohorts=cohorts, method=method, rounds_per_sync=1)
    assert int(out.results) > 0 and int(out.step) == 32
    return out


@pytest.mark.parametrize("method", ["pallas", "wilson_hilferty"])
@pytest.mark.parametrize("cohorts", [1, 8])
def test_masked_scan_round_is_a_no_op(cohorts, method):
    carry = _mid_search_carry(cohorts, method)
    _assert_bits_equal(_masked_scan_round(carry, False, cohorts, method), carry)
    # the same round with the test true moves every leaf a round changes
    moved = _masked_scan_round(carry, True, cohorts, method)
    assert int(moved.step) == int(carry.step) + cohorts and not torch.equal(moved.key, carry.key)


@pytest.mark.parametrize("cohorts", [1, 8])
def test_masked_scan_round_with_every_chunk_exhausted(cohorts):
    """Every chunk exhausted: the fused round returns -1 for each cohort,
    which the masked round must turn to 0 before any gather."""
    carry = _mid_search_carry(cohorts, "pallas")
    full = carry.sampler.frames.float()
    carry = dataclasses.replace(carry, sampler=dataclasses.replace(carry.sampler, n=full))
    k_choice = prng.split(carry.key, 3)[1]
    assert tcore.choose_chunks(k_choice, carry.sampler, cohorts=cohorts, method="pallas").tolist() == [-1] * cohorts
    _assert_bits_equal(_masked_scan_round(carry, False, cohorts, "pallas"), carry)
    # through the driver: the exit test fails before the first round, the
    # eager round is masked, and the trace holds the final entry alone
    _, (_, tc) = _dashcam()
    out, trace, loop = tex._scan_search(carry, tc, detector=_scan_detectors()[1], result_limit=10_000,
                                        max_steps=10_000, cohorts=cohorts, method="pallas", trace_every=4)
    _assert_bits_equal(out, carry)
    assert trace == [(int(carry.step), int(carry.results))]
    assert (loop.captured, loop.eager_rounds, loop.syncs, loop.replays) == (False, 1, 1, 0)


def _multi_state(cache_frames):
    """A multi carry of 3 queries some rounds into a search over WORLD,
    two classes through ``class_select``, and its cache."""
    _, (tr, tc) = _world()
    det = lambda k, f: t_detect(tr, f, query_class=None)
    select = t_class_select(tr, [0, 1, 0])
    keys = torch.stack([prng.fold_in(prng.PRNGKey(1, device=CPU), q) for q in range(3)])
    carry = tcore.init_carry_multi(tcore.init_state(tc.length, device=CPU),
                                   tcore.init_matcher(max_results=RING, device=CPU), keys)
    mc, _, stats = tex._multi_search(carry, tc, detector=det, select=select, result_limits=10_000, max_steps=24,
                                     cohorts=4, method="pallas", cache_frames=cache_frames, rounds_per_sync=1)
    assert min(mc.results.tolist()) > 0 and mc.step.tolist() == [24] * 3
    return mc, stats["final_cache"], det, select


def _cache_copy(cache):
    return None if cache is None else (cache.tag.clone(), tree_map(lambda x: x.clone(), cache.store))


def _assert_cache_slots_equal(cache, copy):
    """The cache's S slots, bit for bit; the spare row S past them takes
    the writes ``cache_insert`` drops and is never looked up."""
    if cache is None:
        return
    s = cache.capacity
    tag, store = copy
    assert torch.equal(cache.tag[:s], tag[:s])
    for got, want in zip(cache.store, store):
        assert torch.equal(got[:s], want[:s])


@pytest.mark.parametrize("exhausted", [False, True])
@pytest.mark.parametrize("cache_frames", [0, 18_000])
def test_multi_round_with_no_live_query_is_a_no_op(cache_frames, exhausted):
    mc, cache, det, select = _multi_state(cache_frames)
    _, (_, tc) = _world()
    if exhausted:
        # every chunk of every query exhausted: the fused round returns -1
        mc = dataclasses.replace(mc, sampler=dataclasses.replace(mc.sampler, n=mc.sampler.frames.float()))
    before = _cache_copy(cache)
    active = torch.zeros(3, dtype=torch.bool)
    new, cache2, fresh, hit, _ = tex._multi_round(mc, cache, tc, active, detector=det, select=select,
                                                  cohorts=4, method="pallas")
    assert cache2 is cache and (int(fresh), int(hit)) == (0, 0)
    _assert_bits_equal(new, mc)
    _assert_cache_slots_equal(cache, before)


def test_multi_driver_past_the_exit_changes_nothing():
    """Through ``_multi_search``: a carry whose every query is finished
    runs one masked round and stops, with zero rounds, detector calls and
    hits, and the trace's final entry alone."""
    mc, _, det, select = _multi_state(0)
    _, (_, tc) = _world()
    out, traces, stats = tex._multi_search(mc, tc, detector=det, select=select, result_limits=[1, 1, 1],
                                           max_steps=10_000, cohorts=4, method="pallas", trace_every=8,
                                           cache_frames=18_000, rounds_per_sync=3)
    _assert_bits_equal(out, mc)
    assert (stats["rounds"], stats["detector_invocations"], stats["cache_hits"]) == (0, 0, 0)
    assert traces == [[(24, r)] for r in mc.results.tolist()]
    loop = stats["loop"]
    assert (loop.eager_rounds, loop.syncs, loop.replays, loop.rounds_per_sync) == (1, 1, 0, 3)


# ---- the drivers against the reference, for several rounds a sync ------------------

@functools.lru_cache(maxsize=None)
def _j_scan(cohorts, method, result_limit, max_steps, trace_every):
    j, _ = _scan_carries()
    (_, jc), _ = _dashcam()
    return jex._scan_search(j, jc, detector=_scan_detectors()[0], result_limit=result_limit, max_steps=max_steps,
                            cohorts=cohorts, method=method, trace_every=trace_every)


def _check_scan(k, cohorts, method, result_limit, max_steps, trace_every):
    jcarry, jtrace = _j_scan(cohorts, method, result_limit, max_steps, trace_every)
    _, t = _scan_carries()
    _, (_, tc) = _dashcam()
    tcarry, ttrace, loop = tex._scan_search(t, tc, detector=_scan_detectors()[1], result_limit=result_limit,
                                            max_steps=max_steps, cohorts=cohorts, method=method,
                                            trace_every=trace_every, rounds_per_sync=k)
    assert ttrace == jtrace
    _assert_same_carry(tcarry, jcarry)
    rounds = int(tcarry.step) // cohorts
    # the eager round, then k rounds a read of the exit test, the last
    # batch running up to k - 1 rounds past the exit
    assert not loop.captured and loop.rounds_per_sync == k and loop.replays == 0
    assert loop.eager_rounds == 1 + k * (loop.syncs - 1)
    assert rounds <= loop.eager_rounds < rounds + k + 1
    return jtrace


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("cohorts,method", [(8, "pallas"), (1, "wilson_hilferty")])
def test_scan_search_matches_reference_for_rounds_a_sync(k, cohorts, method):
    trace = _check_scan(k, cohorts, method, 12, 240 if cohorts == 1 else 480, 24)
    assert len(trace) >= 2


@pytest.mark.parametrize("k", [1, 3, 8])
def test_multi_search_matches_reference_for_rounds_a_sync(k):
    _, (tr, tc) = _world()
    classes, limits = [0, 0, 1, 1], [12, 12, 6, 12]
    common = dict(result_limits=limits, max_steps=900, cohorts=4, method="pallas", trace_every=25,
                  cache_frames=tc.total_frames)
    tkeys = torch.stack([prng.fold_in(prng.PRNGKey(0, device=CPU), q) for q in range(4)])
    jout, jtraces, jstats = _j_multi(tuple(limits), tuple(classes))
    tout, ttraces, tstats = tex._multi_search(
        tcore.init_carry_multi(tcore.init_state(tc.length, device=CPU),
                               tcore.init_matcher(max_results=RING, device=CPU), tkeys),
        tc, detector=lambda k_, f: t_detect(tr, f, query_class=None), select=t_class_select(tr, classes),
        rounds_per_sync=k, **common)
    assert ttraces == jtraces
    for name in ("detector_invocations", "cache_hits", "rounds", "frames_sampled"):
        assert tstats[name] == int(jstats[name]), name
    _assert_same_carry(tout, jout)
    cap = tstats["final_cache"].capacity
    np.testing.assert_array_equal(tstats["final_cache"].tag[:cap].numpy(), np.asarray(jstats["final_cache"].tag))
    loop = tstats["loop"]
    assert loop.eager_rounds == 1 + k * (loop.syncs - 1)
    assert tstats["rounds"] <= loop.eager_rounds < tstats["rounds"] + k + 1
    assert len(set(tout.step.tolist())) > 1            # queries finished at different rounds


@functools.lru_cache(maxsize=None)
def _j_multi(limits, classes):
    (jr, jc), _ = _world()
    jkeys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), q) for q in range(len(limits))])
    return jex._multi_search(
        jcore.init_carry_multi(jcore.init_state(jc.length), jcore.init_matcher(max_results=RING), jkeys),
        jc, detector=lambda k, f: j_detect(jr, f, query_class=None), select=j_class_select(jr, list(classes)),
        result_limits=list(limits), max_steps=900, cohorts=4, method="pallas", trace_every=25,
        cache_frames=jc.total_frames)


# ---- the trace's edge cases ----------------------------------------------------

@pytest.mark.parametrize("cohorts,max_steps,trace_every", [
    (1, 40, 1),       # a crossing every frame: the buffer ends exactly full
    (8, 101, 1),      # the last round overshoots max_steps by 3 (up to cohorts - 1)
    (8, 103, 5),      # ... by 1, each round crossing one or two boundaries
    (8, 120, 0),      # no trace: the final entry alone
])
def test_scan_trace_edges_match_reference(cohorts, max_steps, trace_every):
    trace = _check_scan(3, cohorts, "pallas", 10_000, max_steps, trace_every)
    steps = -(-max_steps // cohorts) * cohorts
    assert trace[-1][0] == steps
    if trace_every == 0:
        assert len(trace) == 1
    else:
        assert len(trace) == min(steps // trace_every, -(-max_steps // cohorts)) + 1
    if (cohorts, trace_every) == (1, 1):
        assert len(trace) == tex._trace_cap(max_steps, cohorts, trace_every)


def test_multi_trace_overshoot_and_no_trace_match_reference():
    (jr, jc), (tr, tc) = _world()
    for max_steps, trace_every in ((37, 1), (37, 0)):
        common = dict(result_limits=[10_000, 3, 10_000], max_steps=max_steps, cohorts=4, method="pallas",
                      trace_every=trace_every)
        jout, jtraces, jstats = jex._multi_search(
            jcore.init_carry_multi(jcore.init_state(jc.length), jcore.init_matcher(max_results=RING),
                                   jnp.stack([jax.random.fold_in(jax.random.PRNGKey(2), q) for q in range(3)])),
            jc, detector=lambda k, f: j_detect(jr, f, query_class=0), **common)
        tout, ttraces, tstats = tex._multi_search(
            tcore.init_carry_multi(tcore.init_state(tc.length, device=CPU),
                                   tcore.init_matcher(max_results=RING, device=CPU),
                                   torch.stack([prng.fold_in(prng.PRNGKey(2, device=CPU), q) for q in range(3)])),
            tc, detector=lambda k, f: t_detect(tr, f, query_class=0), rounds_per_sync=3, **common)
        assert ttraces == jtraces and tstats["rounds"] == int(jstats["rounds"])
        _assert_same_carry(tout, jout)
        assert tout.step.tolist()[0] == 40 and tout.step.tolist()[1] < 40


@pytest.mark.parametrize("n0", [0, 2, 3, 4, 6])
def test_trace_writes_past_the_cap_go_to_the_spare_row(n0):
    """The reference writes a crossing at ``where(crossed, n, cap)`` and
    drops it there or past the cap, then puts the final entry at
    ``min(n, cap - 1)``; the port writes those to its spare row.  Rows 0
    to cap - 1 and the count agree with the reference's for counts at,
    below and above the cap."""
    cap, q = 4, 3
    crossed = np.array([True, False, True])
    entry, final = np.arange(6, dtype=np.int32).reshape(q, 2) + 10, np.arange(6, dtype=np.int32).reshape(q, 2) + 50
    start = np.arange(q * cap * 2, dtype=np.int32).reshape(q, cap, 2)
    n = np.array([n0, n0, max(n0 - 1, 0)], np.int32)

    jbuf, jn = jnp.asarray(start), jnp.asarray(n)
    idx = jnp.where(jnp.asarray(crossed), jn, cap)
    jbuf = jax.vmap(lambda b, i, e: b.at[i].set(e, mode="drop"))(jbuf, idx, jnp.asarray(entry))
    jn = jn + jnp.asarray(crossed).astype(jnp.int32)
    jbuf = jax.vmap(lambda b, i, e: b.at[i].set(e, mode="drop"))(jbuf, jnp.minimum(jn, cap - 1), jnp.asarray(final))
    jn = jnp.minimum(jn + 1, cap)

    tbuf = torch.zeros((q, cap + 1, 2), dtype=torch.int32)
    tbuf[:, :cap] = torch.from_numpy(start)
    tn = torch.from_numpy(n.copy())
    tex._trace_write(tbuf, tn, torch.from_numpy(crossed), torch.from_numpy(entry))
    tex._trace_final(tbuf, tn, torch.from_numpy(final))
    np.testing.assert_array_equal(tbuf[:, :cap].numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    # the single-query form: 0-dim count and test
    one, c1 = torch.zeros((cap + 1, 2), dtype=torch.int32), torch.tensor(n0, dtype=torch.int32)
    one[:cap] = torch.from_numpy(start[0])
    tex._trace_write(one, c1, torch.tensor(True), torch.from_numpy(entry[0]))
    tex._trace_final(one, c1, torch.from_numpy(final[0]))
    np.testing.assert_array_equal(one[:cap].numpy(), np.asarray(jbuf[0]))
    assert int(c1) == int(jn[0])


def test_exact_runs_its_rounds_eagerly():
    """``method="exact"`` seeds a host generator every round, so its
    rounds never go into a graph; on the CPU no method does."""
    _, t = _scan_carries()
    _, (_, tc) = _dashcam()
    out, trace, loop = tex._scan_search(t, tc, detector=_scan_detectors()[1], result_limit=8, max_steps=400,
                                        cohorts=8, method="exact", trace_every=50, rounds_per_sync=3)
    assert not loop.captured and loop.capture_s == 0.0 and loop.captured_launches == {}
    assert trace[-1] == (int(out.step), int(out.results)) and 0 < int(out.results)
    assert not tex._captures("exact", torch.device("cuda")) and tex._captures("pallas", torch.device("cuda"))
    assert not tex._captures("pallas", torch.device("cpu"))


def test_the_plan_records_how_the_loop_ran():
    """``SearchResult.loop``: the scan and multi kinds run the resident
    loop at the module's rounds a sync; the host kind does not."""
    (_, _), (tr, tc) = _dashcam()
    _, t = _scan_carries()
    det = _scan_detectors()[1]
    scan = tcore.SearchPlan(result_limit=6, max_steps=200, cohorts=8, method="pallas").run(t, tc, detector=det)
    host = tcore.SearchPlan(result_limit=6, max_steps=200, cohorts=8, method="pallas",
                            execution=tcore.Execution(strategy="host")).run(t, tc, detector=det)
    assert scan.loop.rounds_per_sync == tex.ROUNDS_PER_SYNC and host.loop is None
    assert (scan.steps, scan.results, scan.traces) == (host.steps, host.results, host.traces)
