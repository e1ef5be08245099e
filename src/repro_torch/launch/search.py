"""Search CLI: ExSample distinct-object queries, end to end, on the card.

Counterpart of ``repro.launch.search``, every kind (``host``, ``scan``,
``multi``, ``async``, ``async_multi``, ``sharded``, ``multi_sharded``):

  python -m repro_torch.launch.search --limit 50 --cohorts 16
  python -m repro_torch.launch.search --dataset bdd --scale 1.0 \\
      --plan '{"result_limit": 200, "max_steps": 5000, "cohorts": 50, "method": "pallas"}'
  python -m repro_torch.launch.search --dataset bdd --scale 1.0 --queries 0 0 0 0 1 1 1 1 \\
      --plan '{"queries": 8, "result_limit": 200, "max_steps": 2000, "cohorts": 50,
               "method": "pallas", "execution": {"queries_axis": true, "cache": -1}}'

``--plan`` takes a ``SearchPlan.to_dict()`` JSON document (or ``@file``);
the Thompson method, the detection cache, the async workers
(``"execution": {"async_workers": 4}``) and the repository index
(``"execution": {"index": {"path": ...}}``) go inside it, as in the
reference CLI.  Without it the plan is a single query built from
``--limit``/``--max-steps``/``--cohorts``.  A plan that lowers to ``multi``
or ``async_multi`` runs one query per class in ``--queries`` (default
``0..Q-1``) over one class-agnostic detector, each query keeping its own
class's detections, with the keys ``fold_in(PRNGKey(seed), q)``.  ``--detector noisy`` adds
misses, box jitter and false positives (``sim.noisy_detect``).
``--baseline`` then runs random+ over the same repository, up to the
plan's frame budget, and prints the savings (random+ frames / ExSample
frames); not for ``multi``.  ``--device`` defaults to ``cuda`` and fails
without a card; ``--device cpu`` runs the plain PyTorch versions of the
kernels.

A plan with ``"shards": S`` runs on a mesh of S shards on that device
(``launch.mesh.make_data_mesh``); with ``queries_axis`` it lowers to the
composed ``multi_sharded`` kind.  ``--kill-worker W`` (repeatable) drives
such a plan through ``ElasticShardedRunner`` on a synthetic clock and
silences worker W after ``--kill-after-windows`` windows; the dead verdict
lands two boundaries later, the mesh shrinks, and the search finishes on
the survivors:

  python -m repro_torch.launch.search --dataset bdd --scale 1.0 --kill-worker 7 \\
      --plan '{"queries": 8, "result_limit": 200, "max_steps": 2000, "cohorts": 48,
               "execution": {"queries_axis": true, "shards": 8, "cache": -1}}'
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.exsample_paper import bdd, dashcam
from repro_torch.core import (
    SearchPlan,
    init_carry,
    init_carry_multi,
    init_matcher,
    init_state,
    prng,
)
from repro_torch.core.baselines import FrameSchedule, run_schedule
from repro_torch.device import resolve
from repro_torch.sim import class_select, generate, noisy_detect, oracle_detect
from repro_torch.sim.costmodel import CostRates, sampling_cost

MATCHER_CAPACITY = 8192


def build_plan(args) -> SearchPlan:
    if args.plan:
        text = args.plan
        if text.startswith("@"):
            with open(text[1:]) as f:
                text = f.read()
        return SearchPlan.from_dict(json.loads(text))
    return SearchPlan(result_limit=args.limit, max_steps=args.max_steps,
                      cohorts=args.cohorts, trace_every=256)


def _run_elastic_smoke(plan, carry, chunks, det, select, args):
    """The ``--kill-worker`` path: the plan through ``ElasticShardedRunner``
    on a synthetic clock (100 s a boundary, dead after 150 s of silence),
    the listed workers silenced after ``--kill-after-windows`` windows.
    Returns the runner."""
    from repro_torch.core.runtime import ElasticShardedRunner
    from repro_torch.distributed.fault_tolerance import HeartbeatMonitor

    ex = plan.execution
    cache = ex.cache if ex.cache is not None else 0
    if cache == -1:
        cache = chunks.total_frames
    t = [0.0]

    def clock():
        t[0] += 100.0
        return t[0]

    runner = ElasticShardedRunner(
        carry, chunks, detector=det, result_limits=plan.result_limit, max_steps=plan.max_steps,
        num_shards=ex.shards, cohorts=plan.cohorts, sync_every=ex.sync_every, select=select,
        cache_frames=cache, monitor=HeartbeatMonitor(suspect_after_s=50.0, dead_after_s=150.0),
        clock=clock, sync_windows=1)
    t0 = time.perf_counter()
    windows = 0
    while True:
        alive = runner.step()
        windows += 1
        if windows == args.kill_after_windows:
            for w in args.kill_worker:
                print(f"elastic: worker {w} silenced after window {windows}")
                runner.kill_worker(w)
        if not alive:
            break
    wall = time.perf_counter() - t0
    out, stats = runner.carry, runner.stats
    for ev in stats["reshard_events"]:
        print(f"elastic: reshard @window {ev['window']}: {ev['from_shards']} -> {ev['to_shards']} shards "
              f"(dead={ev['dead']})")
    results = out.results.tolist()
    print(f"elastic: finished on {runner.num_shards} shards: {sum(results)} results / "
          f"{int(out.step.sum()):,} frames sampled / {stats['detector_invocations']:,} detector invocations "
          f"({stats['cache_hits']:,} cache hits) (driver wall {wall:.1f}s)")
    return runner


def main(argv=None):
    """Run the CLI; returns the ``SearchResult``, or with ``--kill-worker``
    the ``ElasticShardedRunner``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--plan", default="", help="SearchPlan JSON (or @file)")
    ap.add_argument("--dataset", default="dashcam", choices=["dashcam", "bdd"])
    ap.add_argument("--scale", type=float, default=0.2)
    ap.add_argument("--query-class", type=int, default=0)
    ap.add_argument("--queries", type=int, nargs="+", default=None, metavar="CLASS",
                    help="the class of each query of a --plan that lowers to multi "
                         "(default 0..Q-1)")
    ap.add_argument("--limit", type=int, default=50)
    ap.add_argument("--cohorts", type=int, default=16)
    ap.add_argument("--max-steps", type=int, default=50_000)
    ap.add_argument("--detector", default="oracle", choices=["oracle", "noisy"])
    ap.add_argument("--baseline", action="store_true", help="also run random+ for comparison")
    ap.add_argument("--kill-worker", type=int, action="append", default=[], metavar="W",
                    help="elastic-shrink smoke (multi_sharded plans only): silence worker W mid-run and "
                         "recover on the survivors via ElasticShardedRunner (repeatable)")
    ap.add_argument("--kill-after-windows", type=int, default=2,
                    help="sync windows to run before the --kill-worker workers go silent")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    plan = build_plan(args)
    lowered = plan.lower()
    multi = lowered.kind in ("multi", "multi_sharded", "async_multi")
    if args.queries and not multi:
        raise SystemExit("--queries needs a --plan that lowers to multi (queries_axis)")
    device = resolve(args.device)
    setup = (dashcam if args.dataset == "dashcam" else bdd)(seed=args.seed, scale=args.scale)
    repo, chunks = generate(setup.repo, device=device)
    print(f"{args.dataset}: {chunks.total_frames:,} frames / {chunks.num_chunks} chunks / "
          f"{repo.num_instances} instances on {device}")
    print(f"plan: lowering={lowered.kind} method={lowered.method} {json.dumps(plan.to_dict())}")

    sampler = init_state(chunks.length, device=device)
    matcher = init_matcher(max_results=MATCHER_CAPACITY, device=device)
    select = None
    query_class = None if multi else args.query_class
    if args.detector == "oracle":
        def det(key, frame):
            return oracle_detect(repo, frame, query_class=query_class)
    else:
        def det(key, frame):
            return noisy_detect(key, repo, frame, query_class=query_class)

    if multi:
        classes = args.queries if args.queries else list(range(plan.queries))
        if len(classes) != plan.queries:
            raise SystemExit(f"--queries lists {len(classes)} classes for a {plan.queries}-query plan")
        select = class_select(repo, classes)
        key = prng.PRNGKey(args.seed, device=device)
        carry = init_carry_multi(sampler, matcher,
                                 torch.stack([prng.fold_in(key, q) for q in range(plan.queries)]))
    else:
        carry = init_carry(sampler, matcher, prng.PRNGKey(args.seed, device=device))
    if plan.execution.shards > 1:
        from repro_torch.launch.mesh import describe, make_data_mesh

        print(describe(make_data_mesh(plan.execution.shards, device=device)))
    if args.kill_worker:
        if lowered.kind != "multi_sharded":
            raise SystemExit("--kill-worker needs a queries_axis + shards>1 plan "
                             f"(multi_sharded lowering, got {lowered.kind})")
        return _run_elastic_smoke(plan, carry, chunks, det, select, args)
    t0 = time.perf_counter()
    res = lowered.run(carry, chunks, detector=det, select=select)
    wall = time.perf_counter() - t0
    st = res.stats
    if res.num_queries > 1:
        for q in range(res.num_queries):
            print(f"  query {q}: {res.results[q]} results / {res.steps[q]:,} frames")
    cost = sampling_cost(st.detector_invocations, CostRates())
    line = (f"ExSample[{res.kind}]: {sum(res.results)} results / {st.frames_sampled:,} frames "
            f"sampled / {st.detector_invocations:,} detector invocations")
    if st.cache_hits or res.num_queries > 1:
        line += (f" ({st.cache_hits:,} cache hits, hit rate {st.cache_hit_rate:.2f}, "
                 f"{st.amortization:.2f}x amortization, {st.rounds} rounds)")
    print(line + f" / est. {cost.total_s:.0f} gpu·s (driver wall {wall:.1f}s, "
          f"{st.frames_sampled / max(wall, 1e-9):.0f} frames/s)")
    if st.merges:
        print(f"  merges: {st.merges} windows, ring high-water {st.merge_high_water}/{st.matcher_capacity}"
              + (f", {st.results_spilled} results spilled to host log" if st.results_spilled else "")
              + (" OVERFLOW" if st.merge_overflow else ""))
    if plan.execution.index is not None:
        print(f"  index: {st.index_hits:,} index hits, {st.persisted_detections:,} detections persisted, "
              f"{st.warm_rounds_saved} warm rounds saved")
    if args.baseline and not multi:
        base = init_carry(init_state(chunks.length, device=device),
                          init_matcher(max_results=MATCHER_CAPACITY, device=device),
                          prng.PRNGKey(args.seed, device=device))
        rp, _ = run_schedule(base, chunks, FrameSchedule.randomplus(chunks.total_frames, plan.max_steps),
                             detector=det, result_limit=plan.result_limit
                             if isinstance(plan.result_limit, int) else args.limit)
        rp_results, rp_steps = int(rp.results), int(rp.step)
        print(f"random+: {rp_results} results / {rp_steps:,} frames "
              f"→ savings {rp_steps / max(st.frames_sampled, 1):.2f}x")
    return res


if __name__ == "__main__":
    main()
