"""The composed kind (``multi_sharded``, DESIGN.md §10) and the
hash-sharded detection cache (DESIGN.md §14) of repro_torch against the
JAX package, on the CPU.

Each case of ``tests/_mesh_cases.py::MULTI`` runs Q queries through
``SearchPlan.run`` in both packages (S = 1 here, S = 2 and 8 in the file's
JAX child): sync_every 1 and 4, cohorts S and 2S, M = 16 and 15, a cache
of 0, of 64 slots (evictions, collisions routed across shards) and of
every frame (-1), per-query limits, the exhausting world; ``WARM`` runs a
second search over the first's cache with its tag as the warm tag.  The
port must equal JAX bit for bit: per query the steps, results, traces,
statistics, ring and key, and the pooled detector invocations, cache
hits, index hits, rounds, merges and ring pressure, and the final cache's
tags.  Each composed query must equal its own solo ``sharded`` run, and
the cache's layout functions, routed lookup and insert and host reshard
equal the reference's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import _mesh_cases as mc
from _mesh_cases import one_intra_op_thread  # noqa: F401
from repro.serve import batcher as jb
from repro_torch import core as tcore
from repro_torch.core import IndexSpec, SearchPlan, init_carry, init_carry_multi, init_matcher, init_state, prng
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.serve import batcher as tb
from repro_torch.sim import RepoSpec, class_select, filter_class, generate, oracle_detect


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return mc.reference(["multi", "warm"], tmp_path_factory.mktemp("multi_sharded"))


@pytest.mark.parametrize("group,case", [("multi", c) for c in mc.MULTI] + [("warm", c) for c in mc.WARM])
def test_multi_sharded_equals_jax(request, group, case):
    got = mc.run("torch", group, case)
    if mc.mesh_size(group, case) > 1:
        want = request.getfixturevalue("ref")[(group, case)]
    else:
        want = mc.run("jax", group, case)
    mc.assert_same(got, want)
    occupied = (got["ring.times_seen"] > 0).sum(-1)
    assert np.array_equal(occupied, got["results"])
    if group == "warm":
        assert 0 < int(got["stats.index_hits"]) <= int(got["stats.cache_hits"])


@pytest.mark.parametrize("s,cohorts,sync", [(2, 4, 1), (8, 8, 4)])
def test_each_composed_query_equals_its_solo_sharded_run(s, cohorts, sync):
    """Cross-query dedup and the cache change which detector calls happen,
    never what a query consumes: query q equals a solo ``sharded`` run on
    the same mesh with its key and its class's detector."""
    repo, chunks = generate(RepoSpec(**mc.WORLDS["b"]), device="cpu")
    classes, limit, steps = (0, 1, 0), 15, 160
    mesh = make_data_mesh(s, device="cpu")
    keys = torch.stack([prng.fold_in(prng.PRNGKey(0, device="cpu"), q) for q in range(len(classes))])
    det_all = lambda k, f: oracle_detect(repo, f, query_class=None)  # noqa: E731
    comp = SearchPlan.from_dict(dict(queries=len(classes), result_limit=limit, max_steps=steps, cohorts=cohorts,
                                     execution=dict(queries_axis=True, shards=s, sync_every=sync, cache=-1))).run(
        init_carry_multi(init_state(chunks.length, device="cpu"), init_matcher(max_results=mc.RING, device="cpu"),
                         keys), chunks, detector=det_all, select=class_select(repo, list(classes)), mesh=mesh)
    assert comp.stats.cache_hits > 0 and comp.stats.detector_invocations < comp.stats.frames_sampled
    for q, c in enumerate(classes):
        solo = SearchPlan.from_dict(dict(result_limit=limit, max_steps=steps, cohorts=cohorts,
                                         execution=dict(shards=s, sync_every=sync))).run(
            init_carry(init_state(chunks.length, device="cpu"), init_matcher(max_results=mc.RING, device="cpu"),
                       keys[q]), chunks, detector=lambda k, f, c=c: filter_class(repo, det_all(k, f), c), mesh=mesh)
        assert (comp.steps[q], comp.results[q], comp.traces[q]) == (solo.steps[0], solo.results[0], solo.traces[0])
        for f in ("n1", "n"):
            assert torch.equal(getattr(comp.carry.sampler, f)[q], getattr(solo.carry.sampler, f)), f
        assert torch.equal(comp.carry.key[q], solo.carry.key)


# ---- the hash-sharded cache ------------------------------------------------------


def _caches(cap: int, seed: int, fill: float = 0.6):
    """The same direct-mapped cache in both packages: a random tag (frames
    ``≡ slot`` mod cap, or -1) and a two-leaf store."""
    rng = np.random.default_rng(seed)
    tag = np.where(rng.random(cap) < fill, np.arange(cap) + cap * rng.integers(0, 5, cap), -1).astype(np.int32)
    store = {"boxes": rng.random((cap, 3, 4)).astype(np.float32), "valid": rng.random((cap, 3)) < 0.5}
    j = jb.DetectionCache(tag=jnp.asarray(tag), store={k: jnp.asarray(v) for k, v in store.items()})
    t = tb._cache_from_rows(torch.as_tensor(tag), {k: torch.as_tensor(v) for k, v in store.items()})
    return j, t


def _same_cache(t, j):
    assert t.capacity == j.capacity and t.tag.shape[0] == j.capacity + 1
    assert np.array_equal(t.tag[:-1].numpy(), np.asarray(j.tag))
    for k in j.store:
        assert np.array_equal(t.store[k][:-1].numpy(), np.asarray(j.store[k])), k


@pytest.mark.parametrize("cap,s", [(24, 8), (30, 6), (16, 1), (12, 4)])
def test_cache_layouts_equal_jax(cap, s):
    j, t = _caches(cap, cap * 10 + s)
    lay_j, lay_t = jb.shard_cache_layout(j, s), tb.shard_cache_layout(t, s)
    _same_cache(lay_t, lay_j)
    _same_cache(tb.unshard_cache_layout(lay_t, s), jb.unshard_cache_layout(lay_j, s))
    _same_cache(tb.unshard_cache_layout(lay_t, s), j)
    mesh = make_data_mesh(s, device="cpu")
    parts = tb.scatter_cache(t, mesh)
    local = cap // s
    for h, p in enumerate(parts):
        assert p.capacity == local
        assert torch.equal(p.tag[:-1], lay_t.tag[h * local:(h + 1) * local])
    _same_cache(tb.gather_cache(parts, mesh), j)
    with pytest.raises(ValueError, match="multiple"):
        tb.shard_cache_layout(t, 7)


@pytest.mark.parametrize("cap,s", [(24, 8), (30, 3)])
def test_sharded_lookup_and_insert_equal_jax(cap, s):
    """Each home shard's half of the routed lookup and insert, on a batch
    with sentinels, frames homed elsewhere, within-batch slot collisions
    and a masked-out slot."""
    j, t = _caches(cap, cap + s)
    lay_j = jb.shard_cache_layout(j, s)
    parts = tb.scatter_cache(t, make_data_mesh(s, device="cpu"))
    local = cap // s
    rng = np.random.default_rng(s)
    frames = np.concatenate([np.asarray(j.tag)[rng.integers(0, cap, 10)], rng.integers(0, 6 * cap, 14), [-1, -1]])
    frames = np.concatenate([frames, frames[:4] + cap]).astype(np.int64)   # collisions, same slot
    mask = rng.random(frames.shape[0]) < 0.8
    vals = {"boxes": rng.random((frames.shape[0], 3, 4)).astype(np.float32),
            "valid": rng.random((frames.shape[0], 3)) < 0.5}
    for h in range(s):
        loc_j = jb.DetectionCache(tag=lay_j.tag[h * local:(h + 1) * local],
                                  store={k: v[h * local:(h + 1) * local] for k, v in lay_j.store.items()})
        hj, vj = jb.sharded_cache_lookup(loc_j, jnp.asarray(frames.astype(np.int32)), h, s)
        ht, vt = tb.sharded_cache_lookup(parts[h], torch.as_tensor(frames), h, s)
        assert np.array_equal(ht.numpy(), np.asarray(hj))
        for k in vj:
            assert np.array_equal(vt[k].numpy(), np.asarray(vj[k])), k
        ins_j = jb.sharded_cache_insert(loc_j, jnp.asarray(frames.astype(np.int32)),
                                        {k: jnp.asarray(v) for k, v in vals.items()}, jnp.asarray(mask), h, s)
        tb.sharded_cache_insert(parts[h], torch.as_tensor(frames), {k: torch.as_tensor(v) for k, v in vals.items()},
                                torch.as_tensor(mask), h, s)
        _same_cache(parts[h], ins_j)


@settings(max_examples=20, deadline=None)
@given(cap=st.integers(4, 40), new_cap=st.integers(1, 48), seed=st.integers(0, 2**16))
def test_reshard_cache_host_equals_jax(cap, new_cap, seed):
    j, t = _caches(cap, seed, fill=0.8)
    _same_cache(tb.reshard_cache_host(t, new_cap), jb.reshard_cache_host(j, new_cap))
    assert tb.reshard_cache_host(t, cap) is t


def test_the_composed_kind_with_a_repository_index_equals_jax(tmp_path):
    """A bound index on the composed kind (S = 1 here, as JAX's in
    process): the cold run persists its detections, the warm run over the
    snapshot preloads the hash-sharded cache (capacity padded to the
    shards first) and calls the detector on no frame; both runs equal
    JAX's.  At 2 shards the port's warm run replays its cold run."""
    from repro import core as jcore
    from repro.core.plan import IndexSpec as JIndexSpec

    jr, jc = mc.world("jax", "a")
    tr, tc = mc.world("torch", "a")
    plan = dict(queries=2, result_limit=10, max_steps=160, cohorts=2)

    def run(core, spec, s, chunks, repo, m):
        ex = dict(queries_axis=True, shards=s, cache=-1, index=spec)
        if s == 1:
            ex["strategy"] = "sharded"
        carry = core.init_carry_multi(core.init_state(chunks.length, **m["dev"]),
                                      core.init_matcher(max_results=mc.RING, **m["dev"]), m["keys"](2))
        return core.SearchPlan(**plan, execution=core.Execution(**ex)).run(
            carry, chunks, detector=lambda k, f: m["detect"](repo, f, query_class=0), mesh=m["mesh"](s))

    jm, tm = mc._mods("jax"), mc._mods("torch")
    for name in ("cold", "warm"):
        j = run(jcore, JIndexSpec(path=str(tmp_path / "j")), 1, jc, jr, jm)
        t = run(tcore, IndexSpec(path=str(tmp_path / "t")), 1, tc, tr, tm)
        assert (t.steps, t.results, t.traces) == (j.steps, j.results, j.traces), name
        assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats), name
        assert np.array_equal(t.carry.sampler.n1.numpy(), np.asarray(j.carry.sampler.n1))
    assert t.stats.detector_invocations == 0 and t.stats.index_hits == t.stats.cache_hits > 0
    cold2 = run(tcore, IndexSpec(path=str(tmp_path / "t2")), 2, tc, tr, tm)
    warm2 = run(tcore, IndexSpec(path=str(tmp_path / "t2")), 2, tc, tr, tm)
    assert cold2.stats.persisted_detections == cold2.stats.detector_invocations > 0
    assert warm2.stats.detector_invocations == 0 and (warm2.steps, warm2.traces) == (cold2.steps, cold2.traces)
