"""The mesh slice's parity cases, run by both packages.

The reference runs its mesh kinds under ``shard_map``, so S shards need S
JAX devices, and the device count is fixed when JAX starts.  A test file
therefore runs its S = 1 cases against JAX in its own process and its
S > 1 cases in ONE JAX child per file, started with 8 forced host devices
(``CHILD_XLA_FLAGS``, ``JAX_PLATFORMS=cpu``) under its own timeout:

    python tests/_mesh_cases.py GROUP OUT.npz

The child runs every case of GROUP with S > 1 through the JAX package and
writes the outputs to an npz; the parent runs the same cases through the
port on the CPU and compares.  ``run(pkg, group, case)`` is the one
function both sides call, ``pkg`` "jax" or "torch"; it returns a flat dict
of numpy arrays (traces as ``[n, 2]`` arrays, one a query).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 300
# a child that outlives its timeout is run once more: under a loaded test run
# the JAX elastic runner's 6-shard all-gather has hung in XLA's CPU rendezvous
# (a child alone takes under a minute); the second run's outputs are compared
# as the first's would have been
CHILD_ATTEMPTS = 2
# 8 host devices; XLA's CPU collectives abort a rendezvous that waits 40 s by
# default, which a loaded machine (the test run's other workers) can exceed
CHILD_XLA_FLAGS = ("--xla_force_host_platform_device_count=8 --xla_cpu_collective_timeout_seconds=600 "
                   "--xla_cpu_collective_call_terminate_timeout_seconds=600")

# M = 16 (the reference's ``_elastic_world``), M = 15 (divides by no S > 1),
# and a 70-frame world every search exhausts (dead cohorts and shards)
WORLDS = {
    "a": dict(video_lengths=[4_000] * 2, num_instances=60, chunk_frames=500, locality=4.0, seed=11),
    "b": dict(video_lengths=[4_000, 3_500], num_instances=60, chunk_frames=500, locality=4.0, seed=3),
    "tiny": dict(video_lengths=[40, 30], num_instances=6, chunk_frames=10, locality=4.0, seed=5),
}
RING = 512
NEVER = 10**9

# the sharded kind: (world, S, cohorts, sync_every, result_limit, max_steps)
SHARDED = {
    "s1-c1-sync1-a": ("a", 1, 1, 1, 12, 200),
    "s1-c2-sync4-b": ("b", 1, 2, 4, 30, 300),
    "s2-c2-sync1-b": ("b", 2, 2, 1, 25, 300),
    "s2-c4-sync4-a": ("a", 2, 4, 4, 40, 400),
    "s8-c8-sync1-b": ("b", 8, 8, 1, 30, 300),
    "s8-c16-sync4-a": ("a", 8, 16, 4, NEVER, 320),
    "s2-c4-sync1-tiny": ("tiny", 2, 4, 1, NEVER, 200),
    "s8-c8-sync4-tiny": ("tiny", 8, 8, 4, NEVER, 200),
}

# the composed kind: (world, S, cohorts, sync_every, result_limit(s), max_steps,
# cache, classes: one per query for a class-agnostic detector + select, or
# an int Q for Q queries over the class-0 detector)
MULTI = {
    "s1-q2-c2-cache64-a": ("a", 1, 2, 1, 8, 120, 64, 2),
    "s1-q3-c1-sync4-cacheall-b": ("b", 1, 1, 4, 10, 150, -1, (0, 1, 0)),
    "s2-q2-c2-sync4-cacheall-b": ("b", 2, 2, 4, 12, 200, -1, (0, 1)),
    "s2-q3-c4-nocache-a": ("a", 2, 4, 1, (10, 20, 5), 240, None, (0, 1, 1)),
    "s8-q2-c8-cacheall-a": ("a", 8, 8, 1, 25, 160, -1, (0, 1)),
    "s8-q2-c16-sync4-cache64-b": ("b", 8, 16, 4, NEVER, 192, 64, (1, 0)),
    "s8-q2-c8-cacheall-tiny": ("tiny", 8, 8, 1, NEVER, 200, -1, 2),
}
# a preloaded cache and its tag: the second of two runs over one cache
WARM = {"s2-q2-warm-a": ("a", 2, 4, 1, 15, 120, 64, (0, 1))}

# the elastic runner's kill schedule: (world, S, cohorts, Q, max_steps, kill worker, after slice)
ELASTIC = {"kill7of8-a": ("a", 8, 24, 2, 480, 7, 2)}

# the sharded choice on random statistics: (M, S, C, Q or None, seed); the
# statistics give shard 0 nothing live, and the "dead" cases nothing at all
WINNERS = {
    "m16-s1-c4": (16, 1, 4, None, 0),
    "m16-s2-c4": (16, 2, 4, None, 1),
    "m24-s8-c8": (24, 8, 8, None, 2),
    "m24-s8-c8-dead": (24, 8, 8, None, 3),
    "m16-s2-c4-q3": (16, 2, 4, 3, 4),
    "m24-s8-c8-q2": (24, 8, 8, 2, 5),
    "m24-s8-c8-q2-dead": (24, 8, 8, 2, 6),
}
COLLECTIVE_SHAPE = (3, 8)   # each shard's operand of all_to_all: [S, 3, 8] at S = 8

GROUPS = {"sharded": SHARDED, "multi": MULTI, "warm": WARM, "elastic": ELASTIC, "winners": WINNERS}


def mesh_size(group: str, case: str) -> int:
    if group == "collectives":
        return 8
    return GROUPS[group][case][1]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The port's CPU cases run as fast on one intra-op thread as on eight,
    and the test run shares the machine with its other workers and this
    file's JAX child."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the two packages behind one interface
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def world(pkg: str, name: str):
    if pkg == "jax":
        from repro.sim import RepoSpec, generate

        return generate(RepoSpec(**WORLDS[name]))
    from repro_torch.sim import RepoSpec, generate

    return generate(RepoSpec(**WORLDS[name]), device="cpu")


def _mods(pkg: str):
    if pkg == "jax":
        import jax
        import jax.numpy as jnp

        from repro import core
        from repro.core import executor, runtime
        from repro.distributed.fault_tolerance import HeartbeatMonitor
        from repro.launch.mesh import make_data_mesh
        from repro.sim.oracle import class_select, oracle_detect

        def keys(q_n):
            return jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), q) for q in range(q_n)])

        return dict(core=core, executor=executor, runtime=runtime, monitor=HeartbeatMonitor, select=class_select,
                    detect=oracle_detect, key=lambda: jax.random.PRNGKey(0), keys=keys, dev={},
                    mesh=make_data_mesh)
    import torch

    from repro_torch import core
    from repro_torch.core import executor, prng, runtime
    from repro_torch.distributed import HeartbeatMonitor
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.sim import class_select, oracle_detect

    def keys(q_n):
        return torch.stack([prng.fold_in(prng.PRNGKey(0, device="cpu"), q) for q in range(q_n)])

    return dict(core=core, executor=executor, runtime=runtime, monitor=HeartbeatMonitor, select=class_select,
                detect=oracle_detect, key=lambda: prng.PRNGKey(0, device="cpu"), keys=keys, dev=dict(device="cpu"),
                mesh=lambda s: make_data_mesh(s, device="cpu"))


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _carry_out(carry, prefix="") -> dict:
    out = {prefix + "n1": _np(carry.sampler.n1), prefix + "n": _np(carry.sampler.n),
           prefix + "key": _np(carry.key).astype(np.int64), prefix + "step": _np(carry.step),
           prefix + "results": _np(carry.results)}
    for f in ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted"):
        out[prefix + "ring." + f] = _np(getattr(carry.matcher, f))
    return out


def _traces_out(traces) -> dict:
    return {f"trace{q}": np.asarray(t, dtype=np.int64).reshape(-1, 2) for q, t in enumerate(traces)}


def _stats_out(stats) -> dict:
    return {"stats." + f.name: np.asarray(getattr(stats, f.name)) for f in dataclasses.fields(stats)}


def _cache_tag(cache) -> np.ndarray:
    """The direct-mapped tag without the port's scratch row."""
    cap = cache.capacity
    return _np(cache.tag)[:cap]


def _detector(m, pkg, world_name, classes):
    repo, _ = world(pkg, world_name)
    if isinstance(classes, int):
        return (lambda k, f: m["detect"](repo, f, query_class=0)), None, classes
    return (lambda k, f: m["detect"](repo, f, query_class=None)), m["select"](repo, list(classes)), len(classes)


def _run_sharded(pkg, case):
    wname, s, c, sync, limit, steps = SHARDED[case]
    m = _mods(pkg)
    repo, chunks = world(pkg, wname)
    core = m["core"]
    plan = dict(result_limit=limit, max_steps=steps, cohorts=c,
                execution=dict(shards=s, sync_every=sync) if s > 1 else dict(strategy="sharded", sync_every=sync))
    carry = core.init_carry(core.init_state(chunks.length, **m["dev"]), core.init_matcher(max_results=RING, **m["dev"]),
                            m["key"]())
    res = core.SearchPlan.from_dict(plan).run(carry, chunks, detector=lambda k, f: m["detect"](repo, f, query_class=0),
                                              mesh=m["mesh"](s))
    assert res.kind == "sharded", res.kind
    return dict(_carry_out(res.carry), **_traces_out(res.traces), **_stats_out(res.stats))


def _run_multi(pkg, case):
    wname, s, c, sync, limit, steps, cache, classes = MULTI[case]
    m = _mods(pkg)
    _, chunks = world(pkg, wname)
    core = m["core"]
    det, select, q_n = _detector(m, pkg, wname, classes)
    ex = dict(queries_axis=True, shards=s, sync_every=sync, cache=cache)
    if s == 1:
        ex["strategy"] = "sharded"
    plan = dict(queries=q_n, result_limit=limit, max_steps=steps, cohorts=c, execution=ex)
    carry = core.init_carry_multi(core.init_state(chunks.length, **m["dev"]),
                                  core.init_matcher(max_results=RING, **m["dev"]), m["keys"](q_n))
    res = core.SearchPlan.from_dict(plan).run(carry, chunks, detector=det, select=select, mesh=m["mesh"](s))
    assert res.kind == "multi_sharded", res.kind
    return dict(_carry_out(res.carry), **_traces_out(res.traces), **_stats_out(res.stats))


def _run_warm(pkg, case):
    """Two runs over one cache: the second preloaded with the first's final
    cache, its tag the warm tag (``index_hits``)."""
    wname, s, c, sync, limit, steps, cache, classes = WARM[case]
    m = _mods(pkg)
    _, chunks = world(pkg, wname)
    core = m["core"]
    det, select, q_n = _detector(m, pkg, wname, classes)
    mesh = m["mesh"](s)

    def once(keys, **kw):
        carry = core.init_carry_multi(core.init_state(chunks.length, **m["dev"]),
                                      core.init_matcher(max_results=RING, **m["dev"]), keys)
        return m["executor"].run_search_multi_sharded(carry, chunks, mesh=mesh, detector=det, select=select,
                                                      result_limits=limit, max_steps=steps, cohorts=c,
                                                      sync_every=sync, **kw)

    _, _, first = once(m["keys"](q_n), cache_frames=cache)
    warm = first["final_cache"]
    tag = warm.tag[:warm.capacity].clone() if pkg == "torch" else warm.tag
    out, traces, st = once(m["keys"](q_n + 1)[1:], cache=warm, warm_tag=tag)
    res = dict(_carry_out(out), **_traces_out(traces), cache_tag=_cache_tag(st["final_cache"]),
               first_tag=_cache_tag(first["final_cache"]))
    for k in ("detector_invocations", "cache_hits", "index_hits", "rounds", "merges", "merge_high_water"):
        res["stats." + k] = np.asarray(st[k])
    return res


def _run_elastic(pkg, case, replay=False):
    wname, s, c, q_n, steps, kill, after = ELASTIC[case]
    m = _mods(pkg)
    repo, chunks = world(pkg, wname)
    core = m["core"]
    t = [0.0]

    def clock():
        t[0] += 100.0
        return t[0]

    carry = core.init_carry_multi(core.init_state(chunks.length, **m["dev"]),
                                  core.init_matcher(max_results=2048, **m["dev"]), m["keys"](q_n))
    runner = m["runtime"].ElasticShardedRunner(
        carry, chunks, detector=lambda k, f: m["detect"](repo, f, query_class=0), result_limits=NEVER,
        max_steps=steps, num_shards=s, cohorts=c, cache_frames=chunks.total_frames + 8,
        monitor=m["monitor"](suspect_after_s=50.0, dead_after_s=150.0), clock=clock, sync_windows=1, **m["dev"])
    per_slice, slices = [], 0
    while True:
        alive = runner.step()
        slices += 1
        per_slice.append(_np(runner.carry.results).copy())
        if slices == after:
            runner.kill_worker(kill)
        if not alive:
            break
    out = dict(_carry_out(runner.carry), **_traces_out(runner.traces), per_slice=np.stack(per_slice),
               cache_tag=_cache_tag(runner._cache), num_shards=np.asarray(runner.num_shards),
               events=np.asarray([[e["window"], e["from_shards"], e["to_shards"]] + e["dead"]
                                  for e in runner.stats["reshard_events"]]))
    for k in ("detector_invocations", "cache_hits", "index_hits", "rounds", "merges", "merge_high_water"):
        out["stats." + k] = np.asarray(runner.stats[k])
    return out


def winners_state(case):
    """numpy (n1, n, frames) f32/f32/i32 of ``[M]`` or ``[Q, M]``: random
    counts, about a quarter of the chunks exhausted and the first
    ``M / max(S, 2)`` all exhausted (at S > 1, shard 0's slice); every
    chunk exhausted in the "dead" cases."""
    m_n, s, c, q_n, seed = WINNERS[case]
    rng = np.random.default_rng(seed)
    lead = () if q_n is None else (q_n,)
    frames = rng.integers(5, 40, size=lead + (m_n,)).astype(np.int32)
    n = np.floor(rng.random(lead + (m_n,)) * frames).astype(np.float32)
    n1 = np.floor(rng.random(lead + (m_n,)) * np.minimum(n, 6)).astype(np.float32) - (rng.random(lead + (m_n,)) < 0.1)
    exhausted = rng.random(lead + (m_n,)) < 0.25
    exhausted[..., : m_n // max(s, 2)] = True
    if case.endswith("dead"):
        exhausted[...] = True
    n = np.where(exhausted, frames, n).astype(np.float32)
    return n1.astype(np.float32), n, frames


def _run_winners(pkg, case):
    m_n, s, c, q_n, seed = WINNERS[case]
    n1, n, frames = winners_state(case)
    m = _mods(pkg)
    if pkg == "jax":
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from repro.core.distributed import (distributed_choose, get_shard_map, local_cohort_winners,
                                            local_cohort_winners_batched)
        from repro.core.state import SamplerState
        from repro.core.thompson import gamma_params

        state = SamplerState(n1=jnp.asarray(n1), n=jnp.asarray(n), frames=jnp.asarray(frames))
        mesh = m["mesh"](s)
        a, b = gamma_params(state)
        body = local_cohort_winners if q_n is None else local_cohort_winners_batched
        key = m["key"]() if q_n is None else m["keys"](q_n)
        sp = P("data") if q_n is None else P(None, "data")
        fn = get_shard_map()(lambda k, a_, b_, e_, n_: body(k, a_, b_, e_, n_, axis="data", cohorts=c),
                             mesh=mesh, in_specs=(P(), sp, sp, sp, sp), out_specs=(P(), P(), P()), check_rep=False)
        ids, scores, ns = jax.jit(fn)(key, a, b, state.exhausted(), state.n)
        out = dict(ids=np.asarray(ids), scores=np.asarray(scores), ns=np.asarray(ns))
        if q_n is None:
            out["choose"] = np.asarray(distributed_choose(key, state, mesh=mesh, cohorts=c))
        return out
    import torch

    from repro_torch.core.distributed import (distributed_choose, local_cohort_winners,
                                              local_cohort_winners_batched, shard_sampler_state)
    from repro_torch.core.state import SamplerState

    state = SamplerState(n1=torch.as_tensor(n1), n=torch.as_tensor(n), frames=torch.as_tensor(frames))
    mesh = m["mesh"](s)
    key = m["key"]() if q_n is None else m["keys"](q_n)
    body = local_cohort_winners if q_n is None else local_cohort_winners_batched
    views = shard_sampler_state(state, mesh)
    out = {}
    for tag, plain in (("", False), ("plain.", True)):
        ids, scores, ns = body(key, views, mesh, cohorts=c, plain=plain)
        out.update({tag + "ids": _np(ids), tag + "scores": _np(scores), tag + "ns": _np(ns)})
    if q_n is None:
        out["choose"] = _np(distributed_choose(key, state, mesh=mesh, cohorts=c))
    return out


def collective_inputs() -> list:
    """Shard s's int32 operand ``[8, 3, 8]``, distinct everywhere."""
    base = np.arange(8 * 8 * int(np.prod(COLLECTIVE_SHAPE)), dtype=np.int32)
    return list(base.reshape((8, 8) + COLLECTIVE_SHAPE) * 7 % 1009)


def _run_collectives(pkg):
    xs = collective_inputs()
    if pkg == "jax":
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from repro.core.distributed import get_shard_map
        from repro.launch.mesh import make_data_mesh

        def body(x):
            x = x[0]
            return (jax.lax.all_gather(x, "data")[None], jax.lax.psum(x, "data")[None],
                    jax.lax.all_to_all(x, "data", 0, 0)[None])

        fn = get_shard_map()(body, mesh=make_data_mesh(8), in_specs=(P("data"),),
                             out_specs=(P("data"), P("data"), P("data")), check_rep=False)
        g, p, a = jax.jit(fn)(jnp.asarray(np.stack(xs)))
        return dict(all_gather=np.asarray(g), psum=np.asarray(p), all_to_all=np.asarray(a))
    import torch

    from repro_torch.core.distributed import all_gather, all_to_all, psum
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(8, device="cpu")
    ts = [torch.as_tensor(x) for x in xs]
    return {name: np.stack([_np(y) for y in fn(ts, mesh)])
            for name, fn in (("all_gather", all_gather), ("psum", psum), ("all_to_all", all_to_all))}


def run(pkg: str, group: str, case: str = "") -> dict:
    fn = {"sharded": _run_sharded, "multi": _run_multi, "warm": _run_warm, "elastic": _run_elastic,
          "winners": _run_winners}.get(group)
    if group == "collectives":
        return _run_collectives(pkg)
    return fn(pkg, case)


# ---------------------------------------------------------------------------
# the JAX child
# ---------------------------------------------------------------------------


def child_cases(groups) -> list:
    """Every (group, case) of ``groups`` that needs more than one device."""
    out = []
    for g in groups:
        if g == "collectives":
            out.append((g, ""))
            continue
        out += [(g, c) for c in GROUPS[g] if mesh_size(g, c) > 1]
    return out


def reference(groups, tmp_dir) -> dict:
    """Run the JAX child over ``groups`` and load its npz: ``{(group,
    case): {field: array}}``."""
    out = Path(tmp_dir) / "reference.npz"
    env = dict(os.environ, XLA_FLAGS=CHILD_XLA_FLAGS, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, str(Path(__file__)), ",".join(groups), str(out)]
    for attempt in range(CHILD_ATTEMPTS):
        try:
            r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
                               cwd=str(ROOT))
            break
        except subprocess.TimeoutExpired:
            if attempt == CHILD_ATTEMPTS - 1:
                raise
    assert r.returncode == 0, r.stdout[-3000:] + "\n" + r.stderr[-3000:]
    flat = np.load(out)
    res: dict = {}
    for k in flat.files:
        g, c, f = k.split("|", 2)
        res.setdefault((g, c), {})[f] = flat[k]
    return res


def _child(groups: str, out: str) -> None:
    import jax

    jax.config.update("jax_default_matmul_precision", "highest")
    flat = {}
    for g, c in child_cases(groups.split(",")):
        for f, v in run("jax", g, c).items():
            flat[f"{g}|{c}|{f}"] = v
    np.savez(out, **flat)


def assert_same(got: dict, want: dict, fields=None) -> None:
    """Every field of ``want`` (or ``fields``) equal, bit for bit."""
    for f in fields if fields is not None else sorted(want):
        a, b = np.asarray(got[f]), np.asarray(want[f])
        assert a.shape == b.shape, (f, a.shape, b.shape)
        if a.dtype.kind == "f":
            assert np.array_equal(a.view(np.int32 if a.itemsize == 4 else np.int64),
                                  b.astype(a.dtype).view(np.int32 if a.itemsize == 4 else np.int64)), (f, a, b)
        else:
            assert np.array_equal(a, b), (f, a, b)


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2])
