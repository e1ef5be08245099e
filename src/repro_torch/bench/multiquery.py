"""Multi-query amortisation: detector invocations per result.

Counterpart of ``benchmarks/bench_multiquery.py``.  Q = 8 overlapping
dashcam queries (two predicates, four users each: shared ingest) run two
ways over one repository with the same per-query keys, result limits and
frame budget: the sequential arm runs each query alone through the scan
kind, over a class-agnostic oracle filtered to its class; the multi arm
runs all eight through the multi kind, one detector call a round with
cross-query dedup and a repository-sized detection cache.  With the
oracle the per-query trajectories are the same in both arms, so the ratio
of detector invocations per result is the amortisation.  Gate: ≥ 2×.

    python -m repro_torch.bench.multiquery                 # on the card
    python -m repro_torch.bench.multiquery --device cpu --quick

Without ``--device cpu`` a missing card is an error.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.exsample_paper import dashcam
from repro_torch.core import Execution, SearchPlan, init_carry, init_carry_multi, init_matcher, init_state, prng
from repro_torch.device import resolve
from repro_torch.sim import class_select, filter_class, generate, oracle_detect

Q_CLASSES = (0, 0, 0, 0, 1, 1, 1, 1)   # two predicates × four users


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(quick: bool = False, device=None) -> dict:
    """Both arms; returns their per-query results and steps and the
    multi arm's accounting."""
    device = resolve(device)
    scale = 0.02 if quick else 0.05
    limit = 15 if quick else 40
    budget = 2_048 if quick else 8_192
    cohorts = 8
    repo, chunks = generate(dashcam(seed=0, scale=scale).repo, device=device)
    q_n = len(Q_CLASSES)

    def det_all(key, frame):
        return oracle_detect(repo, frame, query_class=None)

    keys = [prng.fold_in(prng.PRNGKey(0, device=device), q) for q in range(q_n)]

    # sequential arm: Q single-query scan plans, each over the shared
    # detector's output filtered to its class (``select``'s predicate)
    seq_plan = SearchPlan(result_limit=limit, max_steps=budget, cohorts=cohorts, method="wilson_hilferty")
    seq_steps, seq_results, seq_wall = [], [], 0.0
    for q in range(q_n):
        carry = init_carry(init_state(chunks.length, device=device),
                           init_matcher(max_results=4096, device=device), keys[q])
        _sync(device)
        t0 = time.perf_counter()
        res = seq_plan.run(carry, chunks, detector=lambda key, frame, c=Q_CLASSES[q]: filter_class(
            repo, det_all(key, frame), c))
        _sync(device)
        seq_wall += time.perf_counter() - t0
        seq_steps.append(res.steps[0])
        seq_results.append(res.results[0])

    # multi arm: one driver, one shared detector pass a round
    carries = init_carry_multi(init_state(chunks.length, device=device),
                               init_matcher(max_results=4096, device=device), torch.stack(keys))
    _sync(device)
    t0 = time.perf_counter()
    mres = SearchPlan(queries=q_n, result_limit=limit, max_steps=budget, cohorts=cohorts,
                      method="wilson_hilferty", execution=Execution(queries_axis=True, cache=-1)).run(
        carries, chunks, detector=det_all, select=class_select(repo, Q_CLASSES))
    _sync(device)
    multi_wall = time.perf_counter() - t0
    return dict(seq_steps=seq_steps, seq_results=seq_results, seq_wall=seq_wall,
                multi_steps=list(mres.steps), multi_results=list(mres.results), multi_wall=multi_wall,
                detector_invocations=mres.stats.detector_invocations, cache_hits=mres.stats.cache_hits,
                rounds=mres.stats.rounds, frames_sampled=mres.stats.frames_sampled)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true", help="dashcam(0.02), limit 15, budget 2,048")
    args = ap.parse_args(argv)
    r = run(quick=args.quick, device=args.device)
    q_n = len(Q_CLASSES)
    seq_inv = sum(r["seq_steps"])          # one detector call a sampled frame
    multi_inv = r["detector_invocations"]
    seq_per_result = seq_inv / max(sum(r["seq_results"]), 1)
    multi_per_result = multi_inv / max(sum(r["multi_results"]), 1)
    ratio = seq_per_result / max(multi_per_result, 1e-9)
    print("arm,queries,results,frames_sampled,detector_invocations,det_per_result,steps_per_sec")
    print(f"sequential,{q_n},{sum(r['seq_results'])},{seq_inv},{seq_inv},"
          f"{seq_per_result:.2f},{seq_inv / max(r['seq_wall'], 1e-9):.0f}")
    print(f"multi,{q_n},{sum(r['multi_results'])},{r['frames_sampled']},{multi_inv},{multi_per_result:.2f},"
          f"{r['frames_sampled'] / max(r['multi_wall'], 1e-9):.0f}")
    print(f"amortization,{q_n},cache_hits={r['cache_hits']},rounds={r['rounds']},ratio={ratio:.2f}x,"
          f"{'OK' if ratio >= 2.0 else 'FAIL'}")
    # the oracle's per-query trajectories are the same in both arms
    if r["multi_results"] != r["seq_results"]:
        raise SystemExit(f"per-query results differ: multi {r['multi_results']}, sequential {r['seq_results']}")
    if ratio < 2.0:
        raise SystemExit(f"amortization {ratio:.2f}x below the 2x gate")
    return ratio


if __name__ == "__main__":
    main()
