"""The repository index of repro_torch (``repro_torch.index``) against the
JAX package's ``repro.index``, on the CPU, mirroring the non-service tests
of ``tests/test_index.py`` on its ``world`` repository.

Held here: the host tier (publish, lookup, duplicates, detector-version
isolation), the snapshot (round trip, read-only, orphan cleanup, an
incompatible format), ``warm()`` (an empty tier equals
``init_detection_cache``, scratch row included; the collision fill), the
priors' rules, ``IndexSpec``; a snapshot written by either package loads
in the other with every leaf bit-equal in dtype, shape and order;
``publish_cache`` never persists the cache's scratch row; and, through
the plan against JAX: a cold index equals no index, the warm replay makes
0 detector calls with JAX's ``index_hits`` and ``persisted_detections``,
and a warm-started scan equals JAX's.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import index as jindex
from repro.core.plan import Execution as JExecution
from repro.core.plan import IndexSpec as JIndexSpec
from repro.core.plan import SearchPlan as JPlan
from repro.sim import RepoSpec as JSpec
from repro.sim import generate as j_generate
from repro.sim.oracle import oracle_detect as j_detect
from repro_torch import core as tcore
from repro_torch import index as tindex
from repro_torch.core import prng
from repro_torch.core.plan import Execution, IndexSpec, PlanError, SearchPlan
from repro_torch.serve.batcher import cache_insert, cache_lookup, init_detection_cache
from repro_torch.sim import RepoSpec as TSpec
from repro_torch.sim import generate as t_generate
from repro_torch.sim import oracle_detect as t_detect

CPU = "cpu"
RING = 512
WORLD = dict(video_lengths=[5_000] * 3, num_instances=100, chunk_frames=500, locality=4.0, seed=7)
MATCHER_FIELDS = ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted")


@pytest.fixture(scope="module")
def world():
    jr, jc = j_generate(JSpec(**WORLD))
    tr, tc = t_generate(TSpec(**WORLD), device=CPU)
    return (jr, jc), (tr, tc)


def _jfresh_multi(jc, q_n=1):
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), q) for q in range(q_n)])
    return jcore.init_carry_multi(jcore.init_state(jc.length), jcore.init_matcher(max_results=RING), keys)


def _tfresh_multi(tc, q_n=1):
    keys = torch.stack([prng.fold_in(prng.PRNGKey(0, device=CPU), q) for q in range(q_n)])
    return tcore.init_carry_multi(tcore.init_state(tc.length, device=CPU),
                                  tcore.init_matcher(max_results=RING, device=CPU), keys)


def _plan(cls, exec_cls, index=None, limit=10, max_steps=600, cohorts=4, method="wilson_hilferty"):
    return cls(result_limit=limit, max_steps=max_steps, cohorts=cohorts, method=method,
               execution=exec_cls(queries_axis=True, cache=-1, index=index))


def _assert_same_carry(tc_, jc_):
    for f in ("n1", "n", "frames"):
        np.testing.assert_array_equal(getattr(tc_.sampler, f).numpy(), np.asarray(getattr(jc_.sampler, f)),
                                      err_msg=f)
    for f in MATCHER_FIELDS:
        np.testing.assert_array_equal(getattr(tc_.matcher, f).numpy(), np.asarray(getattr(jc_.matcher, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tc_.key.numpy().astype(np.uint32), np.asarray(jc_.key))
    np.testing.assert_array_equal(tc_.step.numpy(), np.asarray(jc_.step))
    np.testing.assert_array_equal(tc_.results.numpy(), np.asarray(jc_.results))


def _assert_same_result(tres, jres):
    assert tres.kind == jres.kind
    assert tres.steps == jres.steps and tres.results == jres.results
    assert tres.traces == jres.traces
    assert dataclasses.asdict(tres.stats) == dataclasses.asdict(jres.stats)
    _assert_same_carry(tres.carry, jres.carry)


# ---------------------------------------------------------------------------
# Host tier, versions, snapshot
# ---------------------------------------------------------------------------


def _toy_struct():
    return torch.zeros((), dtype=torch.float32)


def _publish_frames(index, frames):
    f = torch.as_tensor(frames, dtype=torch.int32)
    return index.publish(f, f.float())


def test_index_publish_lookup_and_duplicates():
    idx = tindex.RepositoryIndex(detector_version="v1")
    assert _publish_frames(idx, [4, 9, -1, 4]) == 2   # sentinel and duplicate skipped
    assert idx.stats["duplicates"] == 1
    assert len(idx) == 2
    assert float(idx.lookup(4)[0]) == 4.0
    assert idx.lookup(5) is None
    assert idx.lookup(4, version="v2") is None


def test_index_publish_mask_and_read_only_publish_nothing():
    idx = tindex.RepositoryIndex(detector_version="v1")
    f = torch.tensor([1, 2, 3], dtype=torch.int32)
    assert idx.publish(f, f.float(), torch.tensor([True, False, True])) == 2
    assert idx.lookup(2) is None and idx.lookup(3) is not None


def test_index_detector_version_isolation():
    idx = tindex.RepositoryIndex(detector_version="v1")
    _publish_frames(idx, [1, 2, 3])
    idx.detector_version = "v2"
    assert len(idx) == 0
    _publish_frames(idx, [1])
    assert idx.entries("v1") == 3 and idx.entries("v2") == 1
    _, warm = idx.warm(_toy_struct(), 16)
    assert warm == {1}


def test_index_snapshot_roundtrip(tmp_path):
    path = str(tmp_path / "idx")
    idx = tindex.RepositoryIndex(path, detector_version="v1")
    _publish_frames(idx, [2, 11, 7])
    idx.priors.record(0, np.asarray([1.0, 0.0]), np.asarray([4.0, 2.0]))
    idx.save()
    idx2 = tindex.RepositoryIndex(path, detector_version="v1")
    assert idx2.stats["loaded"] == 3
    assert sorted(f for f in (2, 7, 11) if idx2.lookup(f) is not None) == [2, 7, 11]
    assert float(idx2.lookup(11)[0]) == 11.0
    np.testing.assert_array_equal(idx2.priors.warm_alphas(0, 2, 4.0), idx.priors.warm_alphas(0, 2, 4.0))
    idx3 = tindex.RepositoryIndex(path, detector_version="v2")
    assert len(idx3) == 0 and idx3.entries("v1") == 3


def test_index_read_only_discipline(tmp_path):
    idx = tindex.RepositoryIndex(str(tmp_path / "ro"), detector_version="v1", read_only=True)
    assert _publish_frames(idx, [1, 2]) == 0
    assert len(idx) == 0
    with pytest.raises(ValueError, match="read_only"):
        idx.save()


def test_index_snapshot_orphan_cleanup(tmp_path):
    path = str(tmp_path / "idx")
    idx = tindex.RepositoryIndex(path, detector_version="v1")
    _publish_frames(idx, [1, 2])
    idx.detector_version = "v2"
    _publish_frames(idx, [3])
    idx.save()
    assert sorted(os.listdir(path)) == ["detections_0.npz", "detections_1.npz", "manifest.json", "priors.npz"]
    with open(os.path.join(path, "detections_7.npz"), "wb") as fh:
        fh.write(b"torn")
    assert tindex.RepositoryIndex(path).stats["loaded"] == 3
    idx2 = tindex.RepositoryIndex(path, detector_version="v2")
    idx2._tiers.pop("v1")
    idx2.save()
    assert sorted(os.listdir(path)) == ["detections_0.npz", "manifest.json", "priors.npz"]
    idx3 = tindex.RepositoryIndex(path, detector_version="v2")
    assert idx3.stats["loaded"] == 1 and idx3.lookup(3) is not None


def test_index_rejects_incompatible_snapshot(tmp_path):
    path = tmp_path / "bad"
    path.mkdir()
    (path / "manifest.json").write_text('{"format": 99, "versions": {}}')
    with pytest.raises(ValueError, match="format"):
        tindex.RepositoryIndex(str(path))


def test_index_rejects_an_empty_detector_version():
    with pytest.raises(ValueError, match="detector_version"):
        tindex.RepositoryIndex(detector_version="")


# ---------------------------------------------------------------------------
# warm(): the port's cache layout, the collision fill
# ---------------------------------------------------------------------------


def _det_struct(tr):
    dets = t_detect(tr, torch.zeros((1,), dtype=torch.int64), query_class=None)
    return type(dets)(*(x[0] for x in dets))


def _assert_same_cache(a, b):
    assert a.capacity == b.capacity
    assert a.tag.dtype == b.tag.dtype and torch.equal(a.tag, b.tag)
    for x, y in zip(a.store, b.store):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize("capacity", [1, 8, 64])
def test_index_warm_empty_equals_init_detection_cache(world, capacity):
    """Tensor for tensor, the scratch row (tag -1, zero store) included."""
    _, (tr, _) = world
    struct = _det_struct(tr)
    warm_cache, warm = tindex.RepositoryIndex().warm(struct, capacity)
    assert warm == frozenset()
    _assert_same_cache(warm_cache, init_detection_cache(struct, capacity, device=CPU))
    toy, _ = tindex.RepositoryIndex().warm(_toy_struct(), capacity)
    cold = init_detection_cache(_toy_struct(), capacity, device=CPU)
    assert torch.equal(toy.tag, cold.tag) and torch.equal(toy.store, cold.store)
    assert toy.store.dtype == cold.store.dtype and toy.tag.shape == (capacity + 1,)


def test_index_warm_collision_deterministic():
    idx = tindex.RepositoryIndex()
    _publish_frames(idx, [7, 3, 11])     # 3, 7, 11 all map to slot 3 of 4
    cache, warm = idx.warm(_toy_struct(), 4)
    assert warm == {3}
    hit, vals = cache_lookup(cache, torch.tensor([3, 7, 11], dtype=torch.int32))
    assert hit.tolist() == [True, False, False]
    assert float(vals[0]) == 3.0
    assert int(cache.tag[4]) == -1


def test_index_warm_equals_the_references_warm(world):
    """The same host tier warms the same cache in both packages (the
    port's extra scratch row aside), at a capacity with collisions."""
    (jr, _), (tr, _) = world
    frames = [3, 100, 2500, 7000, 7003, 14_999, 1]
    jidx, tidx = jindex.RepositoryIndex(), tindex.RepositoryIndex()
    jf = jnp.asarray(frames, jnp.int32)
    jidx.publish(jf, jax.vmap(lambda f: j_detect(jr, f, query_class=None))(jf))
    tf = torch.tensor(frames, dtype=torch.int64)
    tidx.publish(tf, t_detect(tr, tf, query_class=None))
    struct = jax.eval_shape(lambda k, f: j_detect(jr, f, query_class=None), jax.random.PRNGKey(0),
                            jnp.zeros((), jnp.int32))
    for capacity in (5, 97):
        jcache, jwarm = jidx.warm(struct, capacity)
        tcache, twarm = tidx.warm(_det_struct(tr), capacity)
        assert jwarm == twarm
        np.testing.assert_array_equal(tcache.tag[:capacity].numpy(), np.asarray(jcache.tag))
        for x, y in zip(tcache.store, jcache.store):
            np.testing.assert_array_equal(x[:capacity].numpy(), np.asarray(y))


# ---------------------------------------------------------------------------
# publish_cache never persists the scratch row
# ---------------------------------------------------------------------------


def test_publish_cache_skips_the_scratch_row():
    """Two frames of one batch collide on a slot: the first wins, the
    loser's write goes to the scratch row, whose tag then holds the
    loser's id; the loser must not be persisted."""
    cache = init_detection_cache(_toy_struct(), 4, device=CPU)
    frames = torch.tensor([3, 7, 2], dtype=torch.int64)     # 3 and 7 share slot 3
    cache_insert(cache, frames, frames.float(), torch.tensor([True, True, True]))
    assert int(cache.tag[4]) == 7, "the loser's write lands on the scratch row"
    idx = tindex.RepositoryIndex()
    assert idx.publish_cache(cache) == 2
    assert idx.lookup(3) is not None and idx.lookup(2) is not None
    assert idx.lookup(7) is None
    assert idx.publish_cache(None) == 0


# ---------------------------------------------------------------------------
# A snapshot written by either package loads in the other
# ---------------------------------------------------------------------------


FRAMES = (3, 100, 2500, 7000, 14_999, 1)


def _jax_snapshot(jr, path):
    idx = jindex.RepositoryIndex(path, detector_version="v1")
    f = jnp.asarray(FRAMES, jnp.int32)
    idx.publish(f, jax.vmap(lambda fr: j_detect(jr, fr, query_class=None))(f))
    idx.priors.record(None, np.arange(30, dtype=np.float64), np.full(30, 3.0))
    idx.priors.record(2, np.ones(30), np.full(30, 5.0))
    idx.save()
    return idx


def _port_snapshot(tr, path):
    idx = tindex.RepositoryIndex(path, detector_version="v1")
    f = torch.tensor(FRAMES, dtype=torch.int64)
    idx.publish(f, t_detect(tr, f, query_class=None))
    idx.priors.record(None, np.arange(30, dtype=np.float64), np.full(30, 3.0))
    idx.priors.record(2, np.ones(30), np.full(30, 5.0))
    idx.save()
    return idx


def _assert_same_tiers(a, b):
    assert sorted(a._tiers) == sorted(b._tiers)
    for version in a._tiers:
        ta, tb = a._tiers[version], b._tiers[version]
        assert sorted(ta) == sorted(tb)
        for f in ta:
            assert len(ta[f]) == len(tb[f]) == 4           # boxes, feats, valid, inst_id
            for x, y in zip(ta[f], tb[f]):
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
    assert a.priors.classes() == b.priors.classes()
    for k, v in a.priors.to_arrays().items():
        np.testing.assert_array_equal(v, b.priors.to_arrays()[k])


def test_snapshot_written_by_jax_loads_in_the_port(world, tmp_path):
    (jr, _), _ = world
    j = _jax_snapshot(jr, str(tmp_path / "jax"))
    t = tindex.RepositoryIndex(str(tmp_path / "jax"), detector_version="v1")
    assert t.stats["loaded"] == len(FRAMES)
    _assert_same_tiers(t, j)
    dtypes = [np.asarray(x).dtype for x in t.lookup(FRAMES[0])]
    assert dtypes == [np.float32, np.float32, np.bool_, np.int32]


def test_snapshot_written_by_the_port_loads_in_jax(world, tmp_path):
    (jr, _), (tr, _) = world
    t = _port_snapshot(tr, str(tmp_path / "port"))
    j = jindex.RepositoryIndex(str(tmp_path / "port"), detector_version="v1")
    assert j.stats["loaded"] == len(FRAMES)
    _assert_same_tiers(j, t)
    # the leaves are the reference detector's own
    jdets = j_detect(jr, jnp.int32(FRAMES[2]), query_class=None)
    for x, y in zip(j.lookup(FRAMES[2]), jdets):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_both_packages_write_the_same_snapshot(world, tmp_path):
    """File for file: the same manifest and the same npz arrays, names,
    dtypes and values."""
    (jr, _), (tr, _) = world
    _jax_snapshot(jr, str(tmp_path / "jax"))
    _port_snapshot(tr, str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))
    for name in os.listdir(tmp_path / "jax"):
        if name.endswith(".json"):
            assert json.loads((tmp_path / "jax" / name).read_text()) == \
                json.loads((tmp_path / "port" / name).read_text())
            continue
        with np.load(tmp_path / "jax" / name) as zj, np.load(tmp_path / "port" / name) as zt:
            assert zj.files == zt.files
            for k in zj.files:
                assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape
                np.testing.assert_array_equal(zj[k], zt[k])


# ---------------------------------------------------------------------------
# ChunkPriors
# ---------------------------------------------------------------------------


def test_priors_zero_weight_returns_input_object():
    p = tindex.ChunkPriors()
    p.record(None, np.ones(4), np.full(4, 2.0))
    state = tcore.init_state(np.full(4, 100), device=CPU)
    out, equiv = p.warm_sampler(state, None, 0.0)
    assert out is state and equiv == 0.0
    out, equiv = p.warm_sampler(state, 5, 1.0)
    assert out is state and equiv == 0.0
    out, equiv = tindex.ChunkPriors().warm_sampler(state, None, 1.0)
    assert out is state and equiv == 0.0


def test_priors_inject_n1_only_as_the_reference_rounds():
    p, jp = tindex.ChunkPriors(), jindex.ChunkPriors()
    for q in (p, jp):
        q.record(0, np.asarray([3.0, 0.0, 1.0]), np.asarray([6.0, 0.0, 4.0]))
    state = tcore.init_state(np.full(3, 100), device=CPU)
    out, equiv = p.warm_sampler(state, 0, 8.0)
    assert out is not state and equiv > 0
    assert torch.equal(out.n, state.n)
    np.testing.assert_allclose((out.n1 - state.n1).numpy(), [4.0, 0.0, 2.0])
    # a boost that float32 cannot hold exactly rounds as jnp.asarray does
    p2, jp2 = tindex.ChunkPriors(), jindex.ChunkPriors()
    for q in (p2, jp2):
        q.record(None, np.asarray([1.0, 2.0, 1.0]), np.asarray([3.0, 7.0, 9.0]))
    tout, tequiv = p2.warm_sampler(state, None, 1.7)
    jout, jequiv = jp2.warm_sampler(jcore.init_state(np.full(3, 100)), None, 1.7)
    assert tequiv == jequiv
    np.testing.assert_array_equal(tout.n1.numpy(), np.asarray(jout.n1))
    assert tout.n1.dtype == torch.float32


def test_priors_warm_a_multi_query_state():
    """A [Q, M] state takes the same boost on every query's row."""
    p = tindex.ChunkPriors()
    p.record(None, np.asarray([[1.0, 0.0], [1.0, 2.0]]), np.asarray([[2.0, 2.0], [2.0, 2.0]]))
    carry = tcore.init_carry_multi(tcore.init_state(np.full(2, 50), device=CPU),
                                   tcore.init_matcher(max_results=8, device=CPU),
                                   torch.stack([prng.PRNGKey(q, device=CPU) for q in range(3)]))
    out, equiv = p.warm_sampler(carry.sampler, None, 4.0)
    np.testing.assert_allclose(out.n1.numpy(), [[2.0, 2.0]] * 3)
    assert equiv == 4.0


def test_priors_geometry_mismatch_refuses():
    p = tindex.ChunkPriors()
    p.record(0, np.ones(4), np.ones(4))
    assert p.warm_alphas(0, 5, 1.0) is None
    state = tcore.init_state(np.full(5, 100), device=CPU)
    out, _ = p.warm_sampler(state, 0, 1.0)
    assert out is state
    with pytest.raises(ValueError, match="chunk-count"):
        p.record(0, np.ones(3), np.ones(3))


def test_priors_record_batched_and_ingest_and_serde():
    p = tindex.ChunkPriors()
    p.record(None, torch.ones((2, 3)), torch.full((2, 3), 2.0))
    np.testing.assert_array_equal(p._n1[-1], [2.0, 2.0, 2.0])
    p.ingest(1, np.asarray([0.5, 2.0, -1.0]), weight=4.0)
    np.testing.assert_array_equal(p._n1[1], [2.0, 4.0, 0.0])
    np.testing.assert_array_equal(p._n[1], [4.0, 4.0, 4.0])
    assert p.classes() == [None, 1]
    q = tindex.ChunkPriors.from_arrays(p.to_arrays())
    assert q.classes() == p.classes()
    np.testing.assert_array_equal(q._n1[1], p._n1[1])
    np.testing.assert_array_equal(q._n[-1], p._n[-1])


# ---------------------------------------------------------------------------
# IndexSpec
# ---------------------------------------------------------------------------


def test_index_spec_serde_roundtrip():
    plan = _plan(SearchPlan, Execution, index=IndexSpec(path="/tmp/x", detector_version="v3", read_only=True,
                                                         prior_weight=2.5))
    back = SearchPlan.from_dict(plan.to_dict())
    assert back == plan
    assert back.execution.index.detector_version == "v3" and back.execution.index.read_only is True
    assert plan.lower().kind == "multi"


def test_index_spec_validation():
    with pytest.raises(PlanError, match="unknown") as e:
        IndexSpec.from_dict({"path": None, "sharding": 4})
    assert e.value.field == "sharding"
    for spec, field in ((IndexSpec(detector_version=""), "detector_version"),
                        (IndexSpec(prior_weight=-1.0), "prior_weight"), (IndexSpec(path=7), "path")):
        with pytest.raises(PlanError) as e:
            _plan(SearchPlan, Execution, index=spec).resolve()
        assert e.value.field == field


def test_executor_version_mismatch_raises(world):
    _, (tr, tc) = world
    live = tindex.RepositoryIndex(detector_version="v1")
    with pytest.raises(PlanError) as e:
        _plan(SearchPlan, Execution, index=IndexSpec(detector_version="v2")).run(
            _tfresh_multi(tc), tc, detector=lambda k, f: t_detect(tr, f, query_class=0), index=live)
    assert e.value.field == "detector_version"


# ---------------------------------------------------------------------------
# Through the plan, against JAX
# ---------------------------------------------------------------------------


def _run_both(world, jspec, tspec, **kw):
    (jr, jc), (tr, tc) = world
    jres = _plan(JPlan, JExecution, index=jspec, **kw).run(
        _jfresh_multi(jc), jc, detector=lambda k, f: j_detect(jr, f, query_class=0))
    tres = _plan(SearchPlan, Execution, index=tspec, **kw).run(
        _tfresh_multi(tc), tc, detector=lambda k, f: t_detect(tr, f, query_class=0))
    return jres, tres


def test_cold_index_equals_no_index_and_jax(world, tmp_path):
    """A cold index with prior_weight 0 changes nothing, and the port's
    run, write-back included, equals JAX's."""
    base_j, base_t = _run_both(world, None, None)
    _assert_same_result(base_t, base_j)
    jres, tres = _run_both(world, JIndexSpec(path=str(tmp_path / "j")), IndexSpec(path=str(tmp_path / "t")))
    _assert_same_result(tres, jres)
    assert tres.steps == base_t.steps and tres.traces == base_t.traces
    assert tres.stats.detector_invocations == base_t.stats.detector_invocations
    assert tres.stats.index_hits == 0 and tres.stats.persisted_detections > 0


def test_warm_index_replays_exactly_as_jax(world, tmp_path):
    spec_j, spec_t = JIndexSpec(path=str(tmp_path / "j")), IndexSpec(path=str(tmp_path / "t"))
    j1, t1 = _run_both(world, spec_j, spec_t)
    j2, t2 = _run_both(world, spec_j, spec_t)
    _assert_same_result(t2, j2)
    assert t2.steps == t1.steps and t2.traces == t1.traces
    assert t2.stats.detector_invocations == 0
    assert t2.stats.index_hits == t2.stats.cache_hits == j2.stats.index_hits > 0
    assert t2.stats.persisted_detections == 0
    assert t1.stats.persisted_detections == j1.stats.persisted_detections == t1.stats.detector_invocations
    # the port's warm run over the reference's snapshot replays the same way
    tx = _plan(SearchPlan, Execution, index=IndexSpec(path=str(tmp_path / "j"), read_only=True)).run(
        _tfresh_multi(world[1][1]), world[1][1], detector=lambda k, f: t_detect(world[1][0], f, query_class=0))
    assert tx.stats.detector_invocations == 0 and tx.steps == t1.steps


def test_warm_started_scan_equals_jax(world, tmp_path):
    """Evidence recorded by a cold multi run warms a scan's Thompson
    prior (prior_weight > 0): the port's scan equals JAX's, trajectory,
    trace, carry and warm_rounds_saved."""
    (jr, jc), (tr, tc) = world
    spec_j, spec_t = JIndexSpec(path=str(tmp_path / "j")), IndexSpec(path=str(tmp_path / "t"))
    _run_both(world, spec_j, spec_t)
    common = dict(result_limit=10, max_steps=600, cohorts=4, method="wilson_hilferty", trace_every=16)
    jres = JPlan(**common, execution=JExecution(index=dataclasses.replace(spec_j, prior_weight=50.0))).run(
        jcore.init_carry(jcore.init_state(jc.length), jcore.init_matcher(max_results=RING),
                         jax.random.PRNGKey(3)), jc, detector=lambda k, f: j_detect(jr, f, query_class=0))
    tres = SearchPlan(**common, execution=Execution(index=dataclasses.replace(spec_t, prior_weight=50.0))).run(
        tcore.init_carry(tcore.init_state(tc.length, device=CPU), tcore.init_matcher(max_results=RING, device=CPU),
                         prng.PRNGKey(3, device=CPU)), tc, detector=lambda k, f: t_detect(tr, f, query_class=0))
    assert tres.kind == jres.kind == "scan"
    assert tres.stats.warm_rounds_saved == jres.stats.warm_rounds_saved > 0
    _assert_same_result(tres, jres)
    assert tres.results[0] == 10
    # the recorded evidence excludes the boost, as the reference's does
    tidx = tindex.RepositoryIndex(spec_t.path)
    jidx = jindex.RepositoryIndex(spec_j.path)
    for k, v in jidx.priors.to_arrays().items():
        np.testing.assert_array_equal(tidx.priors.to_arrays()[k], v)
