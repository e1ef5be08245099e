"""The multi-query kind (``multi``, DESIGN.md §9) of repro_torch against the
JAX package, on the CPU, mirroring ``tests/test_multiquery_driver.py`` on
its ``world`` repository and at its sizes.

Per query and in the pooled accounting the port must equal the reference
exactly: steps, results, traces, every ``SearchStats`` field, the final
sampler, the matcher rings and the keys.  At Q=1 the multi kind equals the
port's own scan kind, and every query of a Q>1 run equals its solo run.
The dedup and the detection cache are held to the reference's unit
semantics (first write wins, a -1 sentinel never hits or inserts).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import core as jcore
from repro.core.thompson import choose_chunks_batched as j_choose_batched
from repro.serve import batcher as jbatcher
from repro.sim import RepoSpec as JSpec
from repro.sim import generate as j_generate
from repro.sim.oracle import class_select as j_class_select
from repro.sim.oracle import oracle_detect as j_detect
from repro_torch import core as tcore
from repro_torch.core import prng
from repro_torch.core import thompson as tthompson
from repro_torch.serve import batcher as tbatcher
from repro_torch.sim import RepoSpec as TSpec
from repro_torch.sim import class_select as t_class_select
from repro_torch.sim import filter_class as t_filter_class
from repro_torch.sim import generate as t_generate
from repro_torch.sim import oracle_detect as t_detect

CPU = "cpu"
RING = 512
MATCHER_FIELDS = ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted")
WORLD = dict(video_lengths=[6_000] * 3, num_instances=120, chunk_frames=600, locality=4.0, seed=7)


@pytest.fixture(scope="module")
def world():
    jr, jc = j_generate(JSpec(**WORLD))
    tr, tc = t_generate(TSpec(**WORLD), device=CPU)
    return (jr, jc), (tr, tc)


def _jkeys(seeds):
    return jnp.stack([jax.random.fold_in(jax.random.PRNGKey(s), q) for q, s in enumerate(seeds)])


def _tkeys(seeds):
    return torch.stack([prng.fold_in(prng.PRNGKey(s, device=CPU), q) for q, s in enumerate(seeds)])


def _run_both(world, plan, seeds, *, classes=None, det_class=0):
    """One plan dict through both packages' multi kind, the keys
    ``fold_in(PRNGKey(seeds[q]), q)``; a class-agnostic oracle with
    ``class_select(classes)`` when ``classes`` is given."""
    (jr, jc), (tr, tc) = world
    qc = None if classes is not None else det_class
    jres = jcore.SearchPlan.from_dict(plan).run(
        jcore.init_carry_multi(jcore.init_state(jc.length), jcore.init_matcher(max_results=RING),
                               _jkeys(seeds)),
        jc, detector=lambda k, f: j_detect(jr, f, query_class=qc),
        select=None if classes is None else j_class_select(jr, classes))
    tres = tcore.SearchPlan.from_dict(plan).run(
        tcore.init_carry_multi(tcore.init_state(tc.length, device=CPU),
                               tcore.init_matcher(max_results=RING, device=CPU), _tkeys(seeds)),
        tc, detector=lambda k, f: t_detect(tr, f, query_class=qc),
        select=None if classes is None else t_class_select(tr, classes))
    return jres, tres


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


def _assert_same_result(tres, jres):
    assert tres.kind == jres.kind == "multi"
    assert tres.steps == jres.steps and tres.results == jres.results
    assert tres.traces == jres.traces
    assert dataclasses.asdict(tres.stats) == dataclasses.asdict(jres.stats)
    _assert_same_carry(tres.carry, jres.carry)


def _multi_plan(q_n, **kw):
    cache = kw.pop("cache", None)
    return dict(queries=q_n, execution=dict(queries_axis=True, cache=cache), **kw)


# ---- Q=1: the multi kind is the scan kind ---------------------------------

@pytest.mark.parametrize("cohorts", [1, 8])
def test_multi_q1_equals_the_ports_scan(world, cohorts):
    _, (tr, tc) = world
    det = lambda k, f: t_detect(tr, f, query_class=0)
    common = dict(result_limit=15, max_steps=1200, cohorts=cohorts, method="pallas", trace_every=25)
    key = prng.PRNGKey(0, device=CPU)
    scan = tcore.SearchPlan.from_dict(common).run(
        tcore.init_carry(tcore.init_state(tc.length, device=CPU),
                         tcore.init_matcher(max_results=RING, device=CPU), key), tc, detector=det)
    multi = tcore.SearchPlan.from_dict(_multi_plan(1, **common)).run(
        tcore.init_carry_multi(tcore.init_state(tc.length, device=CPU),
                               tcore.init_matcher(max_results=RING, device=CPU), key[None]),
        tc, detector=det)
    assert multi.kind == "multi" and scan.kind == "scan"
    assert (scan.steps, scan.results, scan.traces) == (multi.steps, multi.results, multi.traces)
    for part, fields in (("sampler", ("n1", "n")), ("matcher", MATCHER_FIELDS)):
        for f in fields:
            a, b = getattr(getattr(scan.carry, part), f), getattr(getattr(multi.carry, part), f)[0]
            assert torch.equal(a, b), (part, f)
    assert torch.equal(scan.carry.key, multi.carry.key[0])
    # one query, no duplicates: every sampled frame is one detector call
    assert multi.stats.detector_invocations == multi.steps[0] == scan.stats.detector_invocations
    assert multi.stats.rounds == -(-multi.steps[0] // cohorts)


# ---- Q=4 against the reference ---------------------------------------------

@pytest.mark.parametrize("method", ["pallas", "wilson_hilferty"])
@pytest.mark.parametrize("cache", [None, -1])
def test_multi_q4_matches_reference_exactly(world, cache, method):
    plan = _multi_plan(4, result_limit=[12, 12, 6, 12], max_steps=900, cohorts=4, method=method,
                       trace_every=25, cache=cache)
    jres, tres = _run_both(world, plan, [0] * 4)
    _assert_same_result(tres, jres)
    # query 2 finished early and masked out while the others went on
    assert tres.steps[2] < max(tres.steps)
    assert tres.stats.detector_invocations <= tres.stats.frames_sampled
    if cache == -1:
        assert tres.stats.cache_hits > 0
        cap = tres.final_cache.capacity
        assert cap == world[1][1].total_frames
        tag = tres.final_cache.tag[:cap]
        assert int((tag >= 0).sum()) == tres.stats.detector_invocations


def test_multi_queries_equal_their_solo_scans(world):
    _, (tr, tc) = world
    det = lambda k, f: t_detect(tr, f, query_class=0)
    limits = [12, 12, 6, 12]
    seeds = [0, 0, 0, 0]
    multi = tcore.SearchPlan.from_dict(_multi_plan(
        4, result_limit=limits, max_steps=900, cohorts=4, method="pallas", trace_every=25,
        cache=-1)).run(
        tcore.init_carry_multi(tcore.init_state(tc.length, device=CPU),
                               tcore.init_matcher(max_results=RING, device=CPU), _tkeys(seeds)),
        tc, detector=det)
    for q in range(4):
        solo = tcore.SearchPlan(result_limit=limits[q], max_steps=900, cohorts=4, method="pallas",
                                trace_every=25).run(
            tcore.init_carry(tcore.init_state(tc.length, device=CPU),
                             tcore.init_matcher(max_results=RING, device=CPU), _tkeys(seeds)[q]),
            tc, detector=det)
        assert (solo.steps[0], solo.results[0], solo.trace) == (multi.steps[q], multi.results[q],
                                                                 multi.traces[q]), q
        assert torch.equal(solo.carry.sampler.n, multi.carry.sampler.n[q])
        assert torch.equal(solo.carry.matcher.boxes, multi.carry.matcher.boxes[q])
        assert torch.equal(solo.carry.key, multi.carry.key[q])


def test_identical_queries_dedup_exactly(world):
    """Q identical queries sample identical frames every round, so the
    batched pass detects each frame once: invocations = frames / Q."""
    _, (tr, tc) = world
    q_n = 4
    keys = torch.stack([prng.PRNGKey(3, device=CPU)] * q_n)
    res = tcore.SearchPlan.from_dict(_multi_plan(q_n, result_limit=12, max_steps=600, cohorts=4,
                                                 method="wilson_hilferty")).run(
        tcore.init_carry_multi(tcore.init_state(tc.length, device=CPU),
                               tcore.init_matcher(max_results=RING, device=CPU), keys),
        tc, detector=lambda k, f: t_detect(tr, f, query_class=0))
    assert len(set(res.steps)) == 1
    assert res.stats.frames_sampled == sum(res.steps)
    assert res.stats.detector_invocations * q_n == res.stats.frames_sampled


def test_class_select_matches_reference_accounting(world):
    """A class-agnostic detector shared by four queries of two classes:
    the per-query results and the pooled detector invocations and cache
    hits equal the reference's."""
    plan = _multi_plan(4, result_limit=10, max_steps=800, cohorts=4, method="pallas",
                       trace_every=40, cache=-1)
    jres, tres = _run_both(world, plan, [1, 2, 1, 2], classes=[0, 0, 1, 1])
    _assert_same_result(tres, jres)
    assert tres.stats.cache_hits > 0 and min(tres.results) > 0


def test_filter_class_solo_run_equals_its_class_select_query(world):
    (_, _), (tr, tc) = world
    plan = _multi_plan(2, result_limit=10, max_steps=400, cohorts=4, method="pallas", cache=-1)
    classes = [1, 0]
    multi = tcore.SearchPlan.from_dict(plan).run(
        tcore.init_carry_multi(tcore.init_state(tc.length, device=CPU),
                               tcore.init_matcher(max_results=RING, device=CPU), _tkeys([5, 5])),
        tc, detector=lambda k, f: t_detect(tr, f, query_class=None), select=t_class_select(tr, classes))
    for q, cls in enumerate(classes):
        solo = tcore.SearchPlan(result_limit=10, max_steps=400, cohorts=4, method="pallas").run(
            tcore.init_carry(tcore.init_state(tc.length, device=CPU),
                             tcore.init_matcher(max_results=RING, device=CPU), _tkeys([5, 5])[q]),
            tc, detector=lambda k, f, c=cls: t_filter_class(tr, t_detect(tr, f, query_class=None), c))
        assert (solo.steps[0], solo.results[0]) == (multi.steps[q], multi.results[q])
        assert torch.equal(solo.carry.sampler.n1, multi.carry.sampler.n1[q])


# ---- a query that exhausts the repository while others go on ---------------

TINY = dict(video_lengths=[40, 40], num_instances=40, chunk_frames=20, locality=1.0, seed=3)


@pytest.mark.parametrize("cache", [None, -1])
def test_exhausted_query_while_others_continue(cache):
    """Query 0 starts from statistics that have sampled all but one frame
    of the tiny repository, so it exhausts every chunk in its first round
    while queries 1 and 2 keep sampling.  Its Thompson row is then all
    exhausted: the kernel rule gives -1 there (the reference's CPU path 0),
    and the port must mask it before any gather and still equal the
    reference exactly."""
    jr, jc = j_generate(JSpec(**TINY))
    tr, tc = t_generate(TSpec(**TINY), device=CPU)
    m = int(jc.num_chunks)
    n0 = np.asarray(jc.length, np.float32).copy()
    n0[0] -= 1.0                                           # one frame left, in chunk 0
    plan = _multi_plan(3, result_limit=1000, max_steps=200, cohorts=3, method="pallas",
                       trace_every=10, cache=cache)

    jcar = jcore.init_carry_multi(jcore.init_state(jc.length), jcore.init_matcher(max_results=64),
                                  _jkeys([4, 4, 4]))
    jcar = dataclasses.replace(jcar, sampler=dataclasses.replace(
        jcar.sampler, n=jcar.sampler.n.at[0].set(jnp.asarray(n0))))
    jres = jcore.SearchPlan.from_dict(plan).run(jcar, jc, detector=lambda k, f: j_detect(jr, f, query_class=None))

    tcar = tcore.init_carry_multi(tcore.init_state(tc.length, device=CPU),
                                  tcore.init_matcher(max_results=64, device=CPU), _tkeys([4, 4, 4]))
    n = tcar.sampler.n.clone()
    n[0] = torch.from_numpy(n0)
    tcar = dataclasses.replace(tcar, sampler=dataclasses.replace(tcar.sampler, n=n))
    # the first round's choice: query 0's row is live (one frame left) ...
    live = torch.tensor([True, True, True])
    first = tcore.multi_round_choose(tcar, tc, live, cohorts=3, method="pallas")
    assert bool((first.chunk_ids[0] == 0).all())
    tres = tcore.SearchPlan.from_dict(plan).run(tcar, tc, detector=lambda k, f: t_detect(tr, f, query_class=None))
    _assert_same_result(tres, jres)
    # ... and afterwards it is all exhausted while the others go on
    assert bool(tres.carry.sampler.exhausted()[0].all())
    assert tres.steps[0] == 3 and min(tres.steps[1:]) > 3 and m == 4
    alpha, beta, z = tthompson._kernel_inputs(prng.split(tres.carry.key, 3)[:, 1], tres.carry.sampler, 3)
    from repro_torch.kernels.thompson.ops import choose_batched

    idx, _ = choose_batched(alpha, beta, z)
    assert idx[0].tolist() == [-1, -1, -1]


# ---- the batched Thompson choice --------------------------------------------

def _batched_state(q_n=5, m=37, seed=11):
    rng = np.random.default_rng(seed)
    n1 = (np.abs(rng.standard_normal((q_n, m))) * 3).astype(np.float32)
    n = (np.abs(rng.standard_normal((q_n, m))) * 9).astype(np.float32)
    n[:, 0] = 100.0                                # an exhausted chunk per query
    n[q_n - 1, :] = 100.0                          # and one query with all of them
    frames = np.full((q_n, m), 100, np.int32)
    js = dataclasses.replace(jcore.init_state(frames[0]), n1=jnp.asarray(n1), n=jnp.asarray(n),
                             frames=jnp.asarray(frames))
    ts = dataclasses.replace(tcore.init_state(frames[0], device=CPU), n1=torch.from_numpy(n1),
                             n=torch.from_numpy(n), frames=torch.from_numpy(frames))
    return js, ts


@pytest.mark.parametrize("method", ["wilson_hilferty", "pallas"])
@pytest.mark.parametrize("cohorts", [1, 6])
def test_choose_chunks_batched_matches_reference(method, cohorts):
    js, ts = _batched_state()
    q_n = js.n.shape[0]
    want = np.asarray(j_choose_batched(_jkeys([0] * q_n), js, cohorts=cohorts, method=method))
    got = tthompson.choose_chunks_batched(_tkeys([0] * q_n), ts, cohorts=cohorts, method=method).numpy()
    assert got.shape == (q_n, cohorts)
    # the all-exhausted query: the kernel's -1 under "pallas", where the
    # reference's CPU path (vmap of thompson_ref) gives 0 (ROADMAP C2)
    np.testing.assert_array_equal(got[:-1], want[:-1])
    assert got[-1].tolist() == ([-1] * cohorts if method == "pallas" else [0] * cohorts)
    assert want[-1].tolist() == [0] * cohorts
    for q in range(q_n - 1):
        row = dataclasses.replace(ts, n1=ts.n1[q], n=ts.n[q], frames=ts.frames[q])
        single = tthompson.choose_chunks(_tkeys([0] * q_n)[q], row, cohorts=cohorts, method=method)
        np.testing.assert_array_equal(got[q], single.numpy())


def test_choose_chunks_batched_exact_is_per_query():
    _, ts = _batched_state()
    keys = _tkeys([2] * 5)
    got = tthompson.choose_chunks_batched(keys, ts, cohorts=50, method="exact")
    for q in range(4):
        row = dataclasses.replace(ts, n1=ts.n1[q], n=ts.n[q], frames=ts.frames[q])
        assert torch.equal(got[q], tthompson.choose_chunks(keys[q], row, cohorts=50, method="exact"))
        assert not bool((got[q] == 0).any())           # chunk 0 is exhausted


# ---- carries -----------------------------------------------------------------

def test_stack_carries_matches_init_multi(world):
    _, (_, tc) = world
    keys = _tkeys([0, 0, 0])
    singles = [tcore.init_carry(tcore.init_state(tc.length, device=CPU),
                                tcore.init_matcher(max_results=RING, device=CPU), k) for k in keys]
    stacked = tcore.stack_carries(singles)
    built = tcore.init_carry_multi(tcore.init_state(tc.length, device=CPU),
                                   tcore.init_matcher(max_results=RING, device=CPU), keys)
    for part in ("sampler", "matcher"):
        a, b = getattr(stacked, part), getattr(built, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, f.name
    for f in ("key", "step", "results"):
        assert torch.equal(getattr(stacked, f), getattr(built, f))


def test_init_matcher_multi_layout():
    single = tcore.init_matcher(max_results=8, feat_dim=4, iou_thresh=0.3, device=CPU)
    multi = tcore.init_matcher_multi(3, max_results=8, feat_dim=4, iou_thresh=0.3, device=CPU)
    jm = jcore.init_matcher_multi(3, max_results=8, feat_dim=4, iou_thresh=0.3)
    assert multi.iou_thresh == single.iou_thresh == jm.iou_thresh
    for f in MATCHER_FIELDS:
        a, b = getattr(multi, f), getattr(single, f)
        assert a.shape == (3,) + b.shape and torch.equal(a[1], b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jm, f)))
    assert multi.capacity == 8


def test_multi_plan_checks_the_carry(world):
    _, (tr, tc) = world
    det = lambda k, f: t_detect(tr, f, query_class=0)
    single = tcore.init_carry(tcore.init_state(tc.length, device=CPU),
                              tcore.init_matcher(max_results=8, device=CPU), prng.PRNGKey(0, device=CPU))
    with pytest.raises(tcore.PlanError, match="leading-\\[Q\\]"):
        tcore.SearchPlan(queries=2).run(single, tc, detector=det)
    with pytest.raises(tcore.PlanError, match="select"):
        tcore.SearchPlan().run(single, tc, detector=det, select=t_class_select(tr, [0]))
    three = tcore.stack_carries([single] * 3)
    with pytest.raises(tcore.PlanError, match="queries=2"):
        tcore.SearchPlan(queries=2).run(three, tc, detector=det)


# ---- dedup and the detection cache -------------------------------------------

@settings(max_examples=60, deadline=None)
@given(frames=st.lists(st.integers(0, 9), min_size=1, max_size=32),
       valid_bits=st.integers(0, 2**32 - 1))
def test_dedup_never_drops_never_duplicates(frames, valid_bits):
    valid = np.asarray([(valid_bits >> i) & 1 for i in range(len(frames))], bool)
    first = tbatcher.dedup_first_index(torch.tensor(frames), torch.from_numpy(valid)).numpy()
    ref = np.asarray(jbatcher.dedup_first_index(jnp.asarray(frames, jnp.int32), jnp.asarray(valid)))
    np.testing.assert_array_equal(first, ref)
    is_rep = (first == np.arange(len(frames))) & valid
    for i in np.nonzero(valid)[0]:
        r = first[i]
        # never drops: every valid slot gathers a valid representative of
        # exactly its own frame
        assert valid[r] and frames[r] == frames[i] and is_rep[r] and r <= i
    # never double-counts: one representative per distinct valid frame
    assert is_rep.sum() == len({frames[i] for i in np.nonzero(valid)[0]})


def _det_struct():
    return {"boxes": torch.zeros((2, 4)), "valid": torch.zeros((2,), dtype=torch.bool)}


def _dets(k):
    return {"boxes": torch.arange(k * 2 * 4, dtype=torch.float32).reshape(k, 2, 4),
            "valid": torch.ones((k, 2), dtype=torch.bool)}


def test_cache_roundtrip_and_eviction():
    cache = tbatcher.init_detection_cache(_det_struct(), capacity=4)
    assert cache.capacity == 4
    frames = torch.tensor([0, 1, 5, 2])
    dets = _dets(4)
    cache = tbatcher.cache_insert(cache, frames, dets, torch.ones(4, dtype=torch.bool))
    hit, vals = tbatcher.cache_lookup(cache, frames)
    # frame 5 collides with frame 1 (slot 1); the first masked write wins
    assert hit.tolist() == [True, True, False, True]
    assert torch.equal(vals["boxes"][0], dets["boxes"][0]) and torch.equal(vals["boxes"][1], dets["boxes"][1])
    assert cache.tag[:4].tolist() == [0, 1, 2, -1]
    # eviction: inserting frame 5 now overwrites slot 1
    cache = tbatcher.cache_insert(cache, torch.tensor([5]), {k: v[2:3] for k, v in dets.items()},
                                  torch.ones(1, dtype=torch.bool))
    hit2, _ = tbatcher.cache_lookup(cache, frames)
    assert hit2.tolist() == [True, False, True, True]
    # the reference does the same
    jc = jbatcher.init_detection_cache(
        {"boxes": jax.ShapeDtypeStruct((2, 4), jnp.float32), "valid": jax.ShapeDtypeStruct((2,), jnp.bool_)}, 4)
    jd = {k: jnp.asarray(v.numpy()) for k, v in dets.items()}
    jc = jbatcher.cache_insert(jc, jnp.asarray([0, 1, 5, 2], jnp.int32), jd, jnp.ones((4,), bool))
    jc = jbatcher.cache_insert(jc, jnp.asarray([5], jnp.int32), {k: v[2:3] for k, v in jd.items()},
                               jnp.ones((1,), bool))
    np.testing.assert_array_equal(cache.tag[:4].numpy(), np.asarray(jc.tag))
    np.testing.assert_array_equal(cache.store["boxes"][:4].numpy(), np.asarray(jc.store["boxes"]))


def test_cache_sentinel_frames_never_hit_or_insert():
    cache = tbatcher.init_detection_cache(_det_struct(), capacity=4)
    padded = torch.tensor([0, -1, -1, 2])
    hit, _ = tbatcher.cache_lookup(cache, padded)
    assert hit.tolist() == [False] * 4
    dets = {"boxes": torch.ones((4, 2, 4)), "valid": torch.ones((4, 2), dtype=torch.bool)}
    cache = tbatcher.cache_insert(cache, torch.tensor([7]), {k: v[:1] for k, v in dets.items()},
                                  torch.ones(1, dtype=torch.bool))
    # a mask that wrongly covers the sentinels: the real entry survives
    cache = tbatcher.cache_insert(cache, padded, dets, torch.ones(4, dtype=torch.bool))
    assert int(cache.tag[3]) == 7
    hit2, _ = tbatcher.cache_lookup(cache, torch.tensor([7, -1]))
    assert hit2.tolist() == [True, False]


def test_cache_masked_insert_is_a_noop():
    cache = tbatcher.init_detection_cache(_det_struct(), capacity=4)
    before = cache.store["boxes"].clone()
    cache = tbatcher.cache_insert(cache, torch.tensor([3]), {k: v[:1] for k, v in _dets(1).items()},
                                  torch.zeros(1, dtype=torch.bool))
    hit, _ = tbatcher.cache_lookup(cache, torch.tensor([3]))
    assert not bool(hit[0])
    assert cache.tag[:4].tolist() == [-1] * 4 and torch.equal(cache.store["boxes"][:4], before[:4])


def test_cache_holds_detections_trees():
    """The multi driver caches ``Detections`` NamedTuples as they come
    from the oracle, one scratch row past the capacity."""
    tr, _ = t_generate(TSpec(**TINY), device=CPU)
    frames = torch.tensor([3, 17, 3, 60])
    dets = t_detect(tr, frames, query_class=None)
    cache = tbatcher.init_detection_cache(tbatcher.tree_map(lambda x: x[0], dets), capacity=80)
    assert cache.store.boxes.shape == (81, 16, 4) and cache.store.inst_id.dtype == torch.int32
    cache = tbatcher.cache_insert(cache, frames, dets, torch.tensor([True, True, False, True]))
    hit, got = tbatcher.cache_lookup(cache, frames)
    assert hit.tolist() == [True] * 4
    for name in dets._fields:
        assert torch.equal(getattr(got, name), getattr(dets, name)), name


def test_bench_multiquery_quick_workload_matches_reference():
    """The multi arm of ``benchmarks/bench_multiquery.py --quick``: 8
    queries of 2 classes on dashcam(0.02), one class-agnostic detector,
    a repository-sized cache, a 4096-entry ring; its frame budget cut
    from 2,048 to 512 per query to keep the test short.  Detector
    invocations, cache hits, rounds and every query's results equal the
    reference's."""
    from repro.configs.exsample_paper import dashcam as j_dashcam
    from repro_torch.configs.exsample_paper import dashcam as t_dashcam

    classes = (0, 0, 0, 0, 1, 1, 1, 1)
    jr, jc = j_generate(j_dashcam(seed=0, scale=0.02).repo)
    tr, tc = t_generate(t_dashcam(seed=0, scale=0.02).repo, device=CPU)
    plan = _multi_plan(8, result_limit=15, max_steps=512, cohorts=8, method="wilson_hilferty", cache=-1)
    jres = jcore.SearchPlan.from_dict(plan).run(
        jcore.init_carry_multi(jcore.init_state(jc.length), jcore.init_matcher(max_results=4096),
                               _jkeys([0] * 8)),
        jc, detector=lambda k, f: j_detect(jr, f, query_class=None), select=j_class_select(jr, classes))
    tres = tcore.SearchPlan.from_dict(plan).run(
        tcore.init_carry_multi(tcore.init_state(tc.length, device=CPU),
                               tcore.init_matcher(max_results=4096, device=CPU), _tkeys([0] * 8)),
        tc, detector=lambda k, f: t_detect(tr, f, query_class=None), select=t_class_select(tr, classes))
    _assert_same_result(tres, jres)
    assert tres.stats.detector_invocations * 2 <= tres.stats.frames_sampled
