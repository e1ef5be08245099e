"""Elastic mesh-shrink recovery of repro_torch (``ElasticShardedRunner``,
``distributed/elastic.py``, DESIGN.md §14) against the JAX package, on
the CPU.

``resize_chunk_stats`` and ``plan_resize`` equal the reference's.  The
runner in bounded slices equals one unbounded ``run_search_multi_sharded``
call, and both equal JAX's single call.  The kill schedule of
``tests/_mesh_cases.py::ELASTIC`` (8 shards, worker 7 silenced after the
second slice, reshard 8 → 6 at window 4) equals JAX's runner run in the
file's child: final carry, results after every slice, counters, reshard
event and final cache; its traces are compared under ROADMAP C12's rule.
The replay of the schedule is identical, and the CLI prints the
reference's reshard and finish lines.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import _mesh_cases as mc
from _mesh_cases import one_intra_op_thread  # noqa: F401
from repro.core import init_carry_multi as j_init_multi
from repro.core import init_matcher as j_init_matcher
from repro.core import init_state as j_init_state
from repro.core.executor import run_search_multi_sharded as j_run
from repro.distributed import elastic as jel
from repro.launch.mesh import make_data_mesh as j_mesh
from repro.sim import RepoSpec as JSpec
from repro.sim import generate as j_generate
from repro.sim.oracle import oracle_detect as j_detect
from repro_torch.core import init_carry_multi, init_matcher, init_state, prng
from repro_torch.core.executor import run_search_multi_sharded
from repro_torch.core.runtime import ElasticShardedRunner
from repro_torch.distributed import HeartbeatMonitor, WorkerState
from repro_torch.distributed import elastic as tel
from repro_torch.launch import search
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.sim import RepoSpec, generate, oracle_detect


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return mc.reference(["elastic"], tmp_path_factory.mktemp("elastic"))


# ---- resize_chunk_stats and plan_resize --------------------------------------------


@settings(max_examples=30, deadline=None)
@given(m=st.integers(1, 12), pad=st.integers(0, 7), q=st.sampled_from([0, 2]), new=st.integers(1, 9),
       seed=st.integers(0, 2**16))
def test_resize_chunk_stats_equals_jax(m, pad, q, new, seed):
    rng = np.random.default_rng(seed)
    lead = (q,) if q else ()
    n1 = rng.integers(0, 3, lead + (m,)).astype(np.float32)
    n = rng.integers(0, 3, lead + (m,)).astype(np.float32)
    frames = rng.integers(0, 2, lead + (m,)).astype(np.int32)     # fill look-alikes inside
    fill = lambda a, v: np.concatenate([a, np.full(lead + (pad,), v, a.dtype)], -1)  # noqa: E731
    n1, n, frames = fill(n1, 0), fill(n, 1), fill(frames, 0)
    want = jel.resize_chunk_stats(jnp.asarray(n1), jnp.asarray(n), jnp.asarray(frames), new)
    got = tel.resize_chunk_stats(torch.as_tensor(n1), torch.as_tensor(n), torch.as_tensor(frames), new)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)) and g.numpy().dtype == np.asarray(w).dtype
    assert got[0].shape[-1] % new == 0


def test_plan_resize_checks_the_data_parallel_batch():
    assert tel.plan_resize({}, make_data_mesh(6, device="cpu"), global_batch=24).feasible
    bad = tel.plan_resize({}, make_data_mesh(7, device="cpu"), global_batch=24)
    assert not bad.feasible and bad.issues == jel.plan_resize({}, j_mesh(1), global_batch=24).issues + (
        "global_batch 24 not divisible by dp=7",)
    with pytest.raises(NotImplementedError):
        tel.plan_resize({"w": object()}, make_data_mesh(2, device="cpu"))
    with pytest.raises(ValueError):
        tel.resize_chunk_stats(torch.zeros(3), torch.zeros(3), torch.zeros(3, dtype=torch.int32), 0)


# ---- the runner in slices -------------------------------------------------------


def _world():
    repo, chunks = generate(RepoSpec(**mc.WORLDS["a"]), device="cpu")
    return chunks, (lambda k, f: oracle_detect(repo, f, query_class=0))


def _carries(chunks, q_n=2, ring=mc.RING):
    keys = torch.stack([prng.fold_in(prng.PRNGKey(0, device="cpu"), q) for q in range(q_n)])
    return init_carry_multi(init_state(chunks.length, device="cpu"), init_matcher(max_results=ring, device="cpu"), keys)


def _clock(step):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]

    return clock


def _c12(trace):
    """ROADMAP C12: the reference's windowed runner repeats a finished
    query's end state once a later slice; an active window always advances
    the step, so those repeats are the consecutive duplicates."""
    return [e for i, e in enumerate(trace) if i == 0 or e != trace[i - 1]]


def test_windowed_runner_equals_one_call_and_jax():
    """Slices of 2 windows (carry and cache fed back) equal one unbounded
    call, and JAX's unbounded call; query 0 finishes while query 1 goes
    on, where the reference's runner would repeat query 0's end state."""
    chunks, det = _world()
    kw = dict(result_limits=8, max_steps=120, cohorts=2, cache_frames=64)
    one, one_traces, one_stats = run_search_multi_sharded(_carries(chunks), chunks, mesh=make_data_mesh(1, device="cpu"),
                                                          detector=det, **kw)
    runner = ElasticShardedRunner(_carries(chunks), chunks, detector=det, result_limits=8, max_steps=120,
                                  num_shards=1, cohorts=2, cache_frames=64, clock=_clock(1.0), sync_windows=2)
    out, traces, stats = runner.run()
    assert not stats["reshard_events"]
    for f in ("step", "results", "key"):
        assert torch.equal(getattr(out, f), getattr(one, f)), f
    for f in ("n", "n1"):
        assert torch.equal(getattr(out.sampler, f), getattr(one.sampler, f)), f
    assert traces == one_traces
    for k in ("detector_invocations", "cache_hits", "index_hits", "rounds"):
        assert stats[k] == one_stats[k], k
    assert torch.equal(stats["final_cache"].tag, one_stats["final_cache"].tag)

    jr, jc = j_generate(JSpec(**mc.WORLDS["a"]))
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), q) for q in range(2)])
    j_out, j_traces, j_stats = j_run(j_init_multi(j_init_state(jc.length), j_init_matcher(max_results=mc.RING), keys),
                                     jc, mesh=j_mesh(1), detector=lambda k, f: j_detect(jr, f, query_class=0), **kw)
    assert traces == j_traces == [_c12(t) for t in j_traces]
    assert np.array_equal(out.sampler.n1.numpy(), np.asarray(j_out.sampler.n1))
    assert np.array_equal(out.key.numpy(), np.asarray(j_out.key))
    for k in ("detector_invocations", "cache_hits", "rounds"):
        assert stats[k] == j_stats[k], k
    assert np.array_equal(stats["final_cache"].tag[:-1].numpy(), np.asarray(j_stats["final_cache"].tag))
    assert len(traces[0]) < len(traces[1])      # query 0 finished first: the C12 case


def test_handshake_register_silence_verdict():
    chunks, det = _world()
    mon = HeartbeatMonitor(suspect_after_s=50.0, dead_after_s=150.0)
    runner = ElasticShardedRunner(_carries(chunks), chunks, detector=det, result_limits=10**9, max_steps=500,
                                  num_shards=1, cohorts=2, monitor=mon, clock=_clock(100.0), sync_windows=1,
                                  device="cpu")
    assert set(mon.workers) == {0}
    assert runner.step()
    assert mon.workers[0].state is WorkerState.HEALTHY
    runner.kill_worker(0)
    assert runner.step()                      # silence 100 < 150: deferred
    assert mon.workers[0].state is not WorkerState.DEAD
    with pytest.raises(RuntimeError, match="no surviving workers"):
        runner.step()
    assert mon.workers[0].state is WorkerState.DEAD


def test_death_during_the_final_window_completes():
    chunks, det = _world()
    runner = ElasticShardedRunner(_carries(chunks), chunks, detector=det, result_limits=10**9, max_steps=40,
                                  num_shards=1, cohorts=2, clock=_clock(1000.0), sync_windows=100)
    runner.kill_worker(0)
    out, _, stats = runner.run()
    assert not stats["reshard_events"]
    assert (out.step == 40).all()
    assert torch.equal((out.matcher.times_seen > 0).sum(-1).int(), out.results)


# ---- kill 7 of 8: reshard to 6 ------------------------------------------------------


def test_kill_7_of_8_reshards_to_6_as_jax_does(ref):
    got = mc.run("torch", "elastic", "kill7of8-a")
    want = ref[("elastic", "kill7of8-a")]
    traces = [k for k in want if k.startswith("trace")]
    mc.assert_same(got, want, [k for k in want if k not in traces])
    for k in traces:
        assert [tuple(e) for e in got[k]] == _c12([tuple(e) for e in want[k]]), k
    assert got["events"].tolist() == [[4, 8, 6, 7]] and int(got["num_shards"]) == 6
    assert (got["step"] == 480).all() and int(got["stats.rounds"]) == 20
    assert (np.diff(got["per_slice"], axis=0) >= 0).all()
    assert np.array_equal((got["ring.times_seen"] > 0).sum(-1), got["results"])
    # the same death schedule replays to the same search
    mc.assert_same(mc.run("torch", "elastic", "kill7of8-a"), got)


def test_cli_kill_worker_reshards_and_finishes(capsys):
    search.main(["--device", "cpu", "--scale", "0.02", "--kill-worker", "7", "--plan",
                 '{"queries": 2, "result_limit": 1000000000, "max_steps": 240, "cohorts": 24, '
                 '"execution": {"queries_axis": true, "shards": 8, "cache": -1}}'])
    out = capsys.readouterr().out
    assert "elastic: worker 7 silenced after window 2" in out
    assert re.search(r"reshard @window 4: 8 -> 6 shards \(dead=\[7\]\)", out), out
    assert re.search(r"finished on 6 shards: \d+ results / 480 frames sampled", out), out
    with pytest.raises(SystemExit, match="multi_sharded"):
        search.main(["--device", "cpu", "--scale", "0.02", "--kill-worker", "1", "--plan",
                     '{"result_limit": 5, "max_steps": 40, "cohorts": 4, "execution": {"shards": 2}}'])
