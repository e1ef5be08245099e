"""The slice as a whole: one SearchPlan dict through the JAX package and
through repro_torch (on the CPU), with the oracle detector on
dashcam(scale=0.02).

For the ``host`` and ``scan`` kinds, cohorts 1 and 8, and the
``"pallas"`` and ``"wilson_hilferty"`` samplers, the port must reproduce
the reference exactly: steps, results, trace, SearchStats, the final
sampler, the matcher ring and the carry key.  ``method="exact"`` draws
its Gamma variates from torch's generator, so it is held statistically,
as ``tests/test_state_thompson.py`` holds the reference.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs.exsample_paper import dashcam as j_dashcam
from repro.core import thompson as jthompson
from repro.sim import generate as j_generate
from repro.sim.oracle import oracle_detect as j_detect
from repro_torch import core as tcore
from repro_torch.configs.exsample_paper import dashcam as t_dashcam
from repro_torch.core import prng
from repro_torch.core import state as tstate
from repro_torch.core import thompson as tthompson
from repro_torch.sim import generate as t_generate
from repro_torch.sim import oracle_detect as t_detect

QUERY_CLASS = 7          # the densest class at this scale
CAPACITY = 256


@pytest.fixture(scope="module")
def repos():
    jr, jc = j_generate(j_dashcam(scale=0.02).repo)
    tr, tc = t_generate(t_dashcam(scale=0.02).repo, device="cpu")
    return (jr, jc), (tr, tc)


def _plan(kind, cohorts, method):
    return dict(result_limit=12, max_steps=240 if cohorts == 1 else 480, cohorts=cohorts,
                method=method, trace_every=24, execution=dict(strategy=kind))


def _run_both(repos, plan, seed=3):
    (jr, jc), (tr, tc) = repos
    jres = jcore.SearchPlan.from_dict(plan).run(
        jcore.init_carry(jcore.init_state(jc.length), jcore.init_matcher(max_results=CAPACITY),
                         jax.random.PRNGKey(seed)),
        jc, detector=lambda k, f: j_detect(jr, f, query_class=QUERY_CLASS))
    tres = tcore.SearchPlan.from_dict(plan).run(
        tcore.init_carry(tcore.init_state(tc.length, device="cpu"),
                         tcore.init_matcher(max_results=CAPACITY, device="cpu"),
                         prng.PRNGKey(seed, device="cpu")),
        tc, detector=lambda k, f: t_detect(tr, f, query_class=QUERY_CLASS))
    return jres, tres


@pytest.mark.parametrize("method", ["pallas", "wilson_hilferty"])
@pytest.mark.parametrize("cohorts", [1, 8])
@pytest.mark.parametrize("kind", ["scan", "host"])
def test_search_matches_reference_exactly(repos, kind, cohorts, method):
    plan = _plan(kind, cohorts, method)
    jres, tres = _run_both(repos, plan)
    assert tres.kind == jres.kind == kind
    assert tres.steps == jres.steps and tres.results == jres.results
    assert tres.traces == jres.traces
    assert dataclasses.asdict(tres.stats) == dataclasses.asdict(jres.stats)
    jc, tc = jres.carry, tres.carry
    np.testing.assert_array_equal(tc.sampler.n1.numpy(), np.asarray(jc.sampler.n1))
    np.testing.assert_array_equal(tc.sampler.n.numpy(), np.asarray(jc.sampler.n))
    for f in ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted"):
        np.testing.assert_array_equal(getattr(tc.matcher, f).numpy(), np.asarray(getattr(jc.matcher, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tc.key.numpy().astype(np.uint32), np.asarray(jc.key))
    assert jres.results[0] > 0 and len(jres.trace) >= 2


def test_plan_resolution_and_unported_kinds_raise():
    for d in (dict(), dict(method="pallas"), dict(execution=dict(strategy="host")),
              dict(queries=2), dict(cohorts=2, execution=dict(shards=2)),
              dict(queries=2, cohorts=2, execution=dict(shards=2)),
              dict(queries=2, execution=dict(async_workers=2)),
              dict(execution=dict(async_workers=2))):
        jp, tp = jcore.SearchPlan.from_dict(d), tcore.SearchPlan.from_dict(d)
        assert jp.resolve() == tp.resolve()
        assert jp.to_dict() == tp.to_dict()
        # every kind lowers, the mesh kinds too since the mesh slice
        assert (tp.lower().kind, tp.lower().method) == (jp.lower().kind, jp.lower().method)
    with pytest.raises(tcore.PlanValueError):
        tcore.SearchPlan(cohorts=0).resolve()


# ---- method="exact": statistical, mirroring tests/test_state_thompson.py

def _state(m=4, frames=1000):
    return tstate.init_state(np.full(m, frames, np.int32), device="cpu")


def test_exact_exhausted_chunks_never_chosen():
    s = dataclasses.replace(_state(m=4, frames=2), n=torch.tensor([2.0, 2.0, 2.0, 0.0]))
    for i in range(20):
        c = tthompson.choose_chunks(prng.PRNGKey(i, device="cpu"), s, cohorts=4, method="exact")
        assert bool((c == 3).all())


def test_exact_concentrates_but_explores():
    s = _state(m=4)
    for _ in range(20):
        s = tstate.apply_update(s, 0, 1, 0)
    for c in (1, 2):
        for _ in range(20):
            s = tstate.apply_update(s, c, 0, 0)
    picks = tthompson.choose_chunks(prng.PRNGKey(0, device="cpu"), s, cohorts=2000, method="exact").numpy()
    counts = np.bincount(picks, minlength=4)
    assert counts[0] / 2000 > 0.6
    assert counts[3] > 0
    assert counts[3] > counts[1] + counts[2]


def test_exact_argmax_distribution_matches_reference():
    """The port's exact sampler and the reference's agree on the argmax
    distribution (and both agree with Wilson–Hilferty), within the
    reference test's 0.08 tolerance."""
    js = jcore.init_state(np.full(6, 1000, np.int32))
    js = jcore.apply_update(js, 2, 4, 0)
    js = jcore.apply_update(js, 5, 1, 0)
    ts = tstate.apply_update(tstate.apply_update(_state(m=6), 2, 4, 0), 5, 1, 0)
    ref = np.asarray(jthompson.choose_chunks(jax.random.PRNGKey(1), js, cohorts=2000, method="exact"))
    got = tthompson.choose_chunks(prng.PRNGKey(1, device="cpu"), ts, cohorts=2000, method="exact").numpy()
    wh = tthompson.choose_chunks(prng.PRNGKey(2, device="cpu"), ts, cohorts=2000, method="wilson_hilferty").numpy()
    p_ref, p_got, p_wh = (np.bincount(x, minlength=6) / 2000 for x in (ref, got, wh))
    assert np.abs(p_ref - p_got).max() < 0.08
    assert np.abs(p_got - p_wh).max() < 0.08


def test_exact_search_runs_through_the_plan(repos):
    (_, _), (tr, tc) = repos
    res = tcore.SearchPlan(result_limit=8, max_steps=400, cohorts=8, trace_every=50).run(
        tcore.init_carry(tcore.init_state(tc.length, device="cpu"),
                         tcore.init_matcher(max_results=CAPACITY, device="cpu"),
                         prng.PRNGKey(0, device="cpu")),
        tc, detector=lambda k, f: t_detect(tr, f, query_class=QUERY_CLASS))
    assert res.kind == "scan" and res.plan.resolve()[1] == "exact"
    assert 0 < res.results[0] and res.steps[0] <= 400 + 7
    assert res.trace[-1] == (res.steps[0], res.results[0])


def test_greedy_chunks_matches_reference():
    js = jcore.init_state(np.array([10, 10, 10, 2], np.int32))
    ts = tstate.init_state(np.array([10, 10, 10, 2], np.int32), device="cpu")
    for c, d0 in ((1, 3), (2, 1), (3, 0)):
        js, ts = jcore.apply_update(js, c, d0, 0), tstate.apply_update(ts, c, d0, 0)
    ts = dataclasses.replace(ts, n=torch.tensor([10.0, 1.0, 1.0, 1.0]))
    js = dataclasses.replace(js, n=jax.numpy.asarray([10.0, 1.0, 1.0, 1.0]))
    np.testing.assert_array_equal(tthompson.greedy_chunks(ts, cohorts=3).numpy(),
                                  np.asarray(jthompson.greedy_chunks(js, cohorts=3)))


def test_state_moves_between_devices_as_a_whole(repos):
    (_, _), (tr, tc) = repos
    carry = tcore.init_carry(tcore.init_state(tc.length, device="cpu"),
                             tcore.init_matcher(max_results=16, device="cpu"),
                             prng.PRNGKey(5, device="cpu"))
    moved = carry.to("cpu")
    assert moved.key.device.type == "cpu" and torch.equal(moved.matcher.frame, carry.matcher.frame)
    assert tr.to("cpu").total_frames == tr.total_frames and tc.to("cpu").num_chunks == tc.num_chunks
