"""repro_torch's baseline policies (``core.baselines``) and savings bench
(``bench.savings``) against the JAX package, on the CPU.

Every policy drives the same frame processing as ExSample (the port's
``_process_frame``, B3's ``match_update`` on the card), so its
``(step, results)`` trajectory, trace and final carry must equal the
reference's exactly for the same key: random+, random, sequential, skip
and surrogate through ``run_schedule``, greedy through ``run_greedy``, on
dashcam(0.02) with the oracle and with the noisy detector.  The frame
schedules are the reference's numpy generators, compared element for
element, and ``_chunk_of_frame`` at every chunk edge.  The savings bench's
random+, random, greedy and surrogate columns equal the reference
bench's; its ExSample column runs ``method="auto"`` (the exact Gamma,
held statistically), so it is not compared.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs.exsample_paper import dashcam as j_dashcam
from repro.core import baselines as jb
from repro.sim import generate as j_generate
from repro.sim import oracle as joracle
from repro_torch import core as tcore
from repro_torch.configs.exsample_paper import dashcam as t_dashcam
from repro_torch.core import baselines as tb
from repro_torch.core import prng
from repro_torch.sim import generate as t_generate
from repro_torch.sim import oracle as toracle

CPU = "cpu"
QUERY_CLASS = 7          # dashcam(0.02)'s densest class
RING = 512
STEPS = 240
MATCHER_FIELDS = ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's plain paths are many small elementwise passes (the key
    stream op by op): one intra-op thread runs them faster than eight, and
    the suite's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _repos():
    return j_generate(j_dashcam(scale=0.02).repo), t_generate(t_dashcam(scale=0.02).repo, device=CPU)


def _fresh(seed=0):
    (_, jc), (_, tc) = _repos()
    return (jcore.init_carry(jcore.init_state(jc.length), jcore.init_matcher(max_results=RING),
                             jax.random.PRNGKey(seed)),
            tcore.init_carry(tcore.init_state(tc.length, device=CPU), tcore.init_matcher(max_results=RING, device=CPU),
                             prng.PRNGKey(seed, device=CPU)))


def _detectors(noisy: bool):
    (jr, _), (tr, _) = _repos()
    if noisy:
        return (lambda k, f: joracle.noisy_detect(k, jr, f, query_class=QUERY_CLASS),
                lambda k, f: toracle.noisy_detect(k, tr, f, query_class=QUERY_CLASS))
    return (lambda k, f: joracle.oracle_detect(jr, f, query_class=QUERY_CLASS),
            lambda k, f: toracle.oracle_detect(tr, f, query_class=QUERY_CLASS))


def _assert_same_carry(tc, jc):
    for f in ("n1", "n", "frames"):
        np.testing.assert_array_equal(getattr(tc.sampler, f).numpy(), np.asarray(getattr(jc.sampler, f)), err_msg=f)
    for f in MATCHER_FIELDS:
        np.testing.assert_array_equal(getattr(tc.matcher, f).numpy(), np.asarray(getattr(jc.matcher, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tc.key.numpy().astype(np.uint32), np.asarray(jc.key))
    assert (int(tc.step), int(tc.results)) == (int(jc.step), int(jc.results))


def _schedule(policy: str, total: int):
    if policy == "surrogate":
        scores = np.random.default_rng(2).random(total)
        return jb.surrogate_schedule(scores, dedup_window=90)[:STEPS]
    return getattr(jb.FrameSchedule, policy)(total, STEPS)


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("policy", ["randomplus", "random", "sequential", "skip", "surrogate"])
def test_run_schedule_matches_reference(policy, noisy):
    (_, jc), _ = _repos()
    sched = _schedule(policy, jc.total_frames)
    limit = 25 if noisy else 12
    jcar, ttcar = _fresh()
    jdet, tdet = _detectors(noisy)
    jout, jtrace = jb.run_schedule(jcar, jc, sched, detector=jdet, result_limit=limit, trace_every=16)
    tout, ttrace = tb.run_schedule(ttcar, _repos()[1][1], sched, detector=tdet, result_limit=limit,
                                   trace_every=16)
    assert ttrace == jtrace and len(jtrace) >= 2
    _assert_same_carry(tout, jout)


@pytest.mark.parametrize("noisy", [False, True])
def test_run_greedy_matches_reference(noisy):
    (_, jc), (_, tc) = _repos()
    jcar, tcar = _fresh(seed=5)
    jdet, tdet = _detectors(noisy)
    jout, jtrace = jb.run_greedy(jcar, jc, detector=jdet, result_limit=30, max_steps=STEPS, trace_every=16)
    tout, ttrace = tb.run_greedy(tcar, tc, detector=tdet, result_limit=30, max_steps=STEPS, trace_every=16)
    assert ttrace == jtrace and len(jtrace) >= 2
    _assert_same_carry(tout, jout)


@pytest.mark.parametrize("total,steps,seed", [(54_000, 5000, 0), (1_200_000, 7, 3), (1000, 2500, 1), (1, 3, 0)])
def test_frame_schedules_identical(total, steps, seed):
    for name in ("random", "randomplus", "sequential", "skip"):
        got = getattr(tb.FrameSchedule, name)(total, steps, seed=seed)
        want = getattr(jb.FrameSchedule, name)(total, steps, seed=seed)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(tb.FrameSchedule.skip(total, steps, stride=7),
                                  jb.FrameSchedule.skip(total, steps, stride=7))


@pytest.mark.parametrize("window", [0, 1, 2, 90])
def test_surrogate_schedule_identical(window):
    scores = np.random.default_rng(window).normal(size=3000)
    scores[::7] = 1.0                          # ties: the stable order decides
    got, want = tb.surrogate_schedule(scores, dedup_window=window), jb.surrogate_schedule(scores, dedup_window=window)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_chunk_of_frame_at_every_edge():
    (_, jc), (_, tc) = _repos()
    starts = np.asarray(jc.start).astype(np.int64)
    frames = np.unique(np.concatenate([starts, starts - 1, starts + 1, [0, jc.total_frames - 1]]))
    frames = frames[(frames >= 0) & (frames < jc.total_frames)].astype(np.int32)
    want = np.asarray(jax.vmap(lambda f: jb._chunk_of_frame(jc, f))(jnp.asarray(frames)))
    got = [int(tb._chunk_of_frame(tc, torch.tensor(int(f), dtype=torch.int32))) for f in frames]
    np.testing.assert_array_equal(np.asarray(got, np.int32), want)


def test_savings_bench_baseline_columns_match_reference():
    import importlib
    import sys
    from pathlib import Path

    from repro_torch.bench import savings as tsavings

    bench = Path(__file__).resolve().parents[1] / "benchmarks"
    sys.path.insert(0, str(bench))
    try:
        jsavings = importlib.import_module("bench_savings")
    finally:
        sys.path.remove(str(bench))
    kw = dict(scale=0.02, classes=(QUERY_CLASS,), recalls=(0.5,), max_steps=150, quick=True)
    want = jsavings.run(**kw)
    got = tsavings.run(device=CPU, **kw)
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "exsample"} == {k: v for k, v in w.items() if k != "exsample"}
        assert 0 < g["exsample"] <= 150
    (jr, _), (tr, _) = _repos()
    np.testing.assert_array_equal(tsavings._surrogate_scores(tr, tr.total_frames, QUERY_CLASS),
                                  jsavings._surrogate_scores(jr, jr.total_frames, QUERY_CLASS))
