"""The composed Q × shards lowering: detector invocations per result.

Counterpart of ``benchmarks/bench_plan_compose.py``.  Q = 8 overlapping
dashcam queries (two predicates, four users each) on an 8-shard data mesh,
three arms at the same per-query keys and budgets:

  * sequential-sharded: one 8-shard ``sharded`` plan a query, one after
    another; every sampled frame pays a detector call;
  * composed: one ``queries_axis`` × ``shards`` plan, the eight queries
    sharing each shard's deduplicated, cached detector pass a round; with
    the oracle each query's trajectory equals its sequential-sharded run;
  * single-device multi, a cross-check of the result counts (another key
    path, so it agrees only statistically).

Gates: composed per-query results and steps equal the sequential arm's;
at least 2× fewer detector invocations a result; per-query results within
15% (or one sync window) of the multi arm.  The mesh is one process's
(``launch.mesh.make_data_mesh``): 8 shards on the card, or on the CPU
with ``--device cpu``.

    python -m repro_torch.bench.plan_compose                 # full, on the card
    python -m repro_torch.bench.plan_compose --device cpu --quick
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.exsample_paper import dashcam
from repro_torch.core import Execution, SearchPlan, init_carry, init_carry_multi, init_matcher, init_state, prng
from repro_torch.device import resolve
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.sim import class_select, filter_class, generate, oracle_detect

Q_CLASSES = (0, 0, 0, 0, 1, 1, 1, 1)   # two predicates × four users
SHARDS = 8


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(quick: bool = False, device=None) -> dict:
    """The three arms; returns their per-query results and steps, the
    composed arm's accounting and the walls."""
    device = resolve(device)
    scale = 0.02 if quick else 0.05
    limit = 12 if quick else 25
    budget = 1_024 if quick else 2_048
    cohorts, sync_every = SHARDS, 1
    repo, chunks = generate(dashcam(seed=0, scale=scale).repo, device=device)
    q_n = len(Q_CLASSES)
    mesh = make_data_mesh(SHARDS, device=device)

    def det_all(key, frame):
        return oracle_detect(repo, frame, query_class=None)

    keys = [prng.fold_in(prng.PRNGKey(0, device=device), q) for q in range(q_n)]

    def fresh_multi():
        return init_carry_multi(init_state(chunks.length, device=device),
                                init_matcher(max_results=4096, device=device), torch.stack(keys))

    seq_plan = SearchPlan(result_limit=limit, max_steps=budget, cohorts=cohorts,
                          execution=Execution(shards=SHARDS, sync_every=sync_every))
    seq_steps, seq_results, seq_wall = [], [], 0.0
    for q in range(q_n):
        carry = init_carry(init_state(chunks.length, device=device), init_matcher(max_results=4096, device=device),
                           keys[q])
        _sync(device)
        t0 = time.perf_counter()
        res = seq_plan.run(carry, chunks, mesh=mesh, detector=lambda key, frame, c=Q_CLASSES[q]: filter_class(
            repo, det_all(key, frame), c))
        _sync(device)
        seq_wall += time.perf_counter() - t0
        seq_steps.append(res.steps[0])
        seq_results.append(res.results[0])

    carries = fresh_multi()
    _sync(device)
    t0 = time.perf_counter()
    comp = SearchPlan(queries=q_n, result_limit=limit, max_steps=budget, cohorts=cohorts,
                      execution=Execution(queries_axis=True, shards=SHARDS, sync_every=sync_every, cache=-1)).run(
        carries, chunks, mesh=mesh, detector=det_all, select=class_select(repo, Q_CLASSES))
    _sync(device)
    comp_wall = time.perf_counter() - t0
    if comp.kind != "multi_sharded":
        raise AssertionError(f"the composed plan lowered to {comp.kind}")

    multi = SearchPlan(queries=q_n, result_limit=limit, max_steps=budget, cohorts=cohorts,
                       method="wilson_hilferty", execution=Execution(queries_axis=True, cache=-1)).run(
        fresh_multi(), chunks, detector=det_all, select=class_select(repo, Q_CLASSES))
    st = comp.stats
    return dict(seq_steps=seq_steps, seq_results=seq_results, seq_wall=seq_wall,
                comp_steps=list(comp.steps), comp_results=list(comp.results), comp_wall=comp_wall,
                comp_traces=comp.traces, detector_invocations=st.detector_invocations, cache_hits=st.cache_hits,
                rounds=st.rounds, frames_sampled=st.frames_sampled, merges=st.merges,
                merge_high_water=st.merge_high_water, multi_results=list(multi.results),
                multi_invocations=multi.stats.detector_invocations, multi_frames=multi.stats.frames_sampled,
                window=cohorts * sync_every)


def gates(r: dict) -> float:
    """The benchmark's three gates; returns the invocation ratio, raising
    SystemExit on a failed gate."""
    seq_inv = sum(r["seq_steps"])          # one detector call a sampled frame
    seq_per_result = seq_inv / max(sum(r["seq_results"]), 1)
    comp_per_result = r["detector_invocations"] / max(sum(r["comp_results"]), 1)
    ratio = seq_per_result / max(comp_per_result, 1e-9)
    if r["comp_results"] != r["seq_results"] or r["comp_steps"] != r["seq_steps"]:
        raise SystemExit(f"composed != sequential-sharded per query: {r['comp_results']} / {r['comp_steps']} "
                         f"against {r['seq_results']} / {r['seq_steps']}")
    if ratio < 2.0:
        raise SystemExit(f"amortization {ratio:.2f}x below the 2x gate")
    for q, (c, m) in enumerate(zip(r["comp_results"], r["multi_results"])):
        if abs(c - m) > max(r["window"], 0.15 * max(c, m)):
            raise SystemExit(f"query {q}: composed {c} results against the multi arm's {m}")
    return ratio


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true", help="dashcam(0.02), limit 12, budget 1,024")
    args = ap.parse_args(argv)
    r = run(quick=args.quick, device=args.device)
    q_n = len(Q_CLASSES)
    seq_inv = sum(r["seq_steps"])
    print("arm,queries,results,frames_sampled,detector_invocations,det_per_result,wall_s")
    print(f"sequential_sharded,{q_n},{sum(r['seq_results'])},{seq_inv},{seq_inv},"
          f"{seq_inv / max(sum(r['seq_results']), 1):.2f},{r['seq_wall']:.1f}")
    print(f"composed,{q_n},{sum(r['comp_results'])},{r['frames_sampled']},{r['detector_invocations']},"
          f"{r['detector_invocations'] / max(sum(r['comp_results']), 1):.2f},{r['comp_wall']:.1f}")
    print(f"multi_1dev,{q_n},{sum(r['multi_results'])},{r['multi_frames']},{r['multi_invocations']},"
          f"{r['multi_invocations'] / max(sum(r['multi_results']), 1):.2f},-")
    ratio = gates(r)
    print(f"amortization,{q_n},cache_hits={r['cache_hits']},merge_high_water={r['merge_high_water']},"
          f"ratio={ratio:.2f}x,OK")
    print("plan_compose_parity,OK")
    return ratio


if __name__ == "__main__":
    main()
