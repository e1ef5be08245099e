"""Async × Q-axis composition: detector invocations per result.

Counterpart of ``benchmarks/bench_async_compose.py``.  Q = 8 overlapping
dashcam queries (two predicates, four users each: the workload of
``bench.multiquery``) run two ways with the same per-query keys, result
limits and frame budget: one after another through the single-query
async kind (``Execution(async_workers=4)``), each over the class-agnostic
oracle filtered to its class, and all eight through the composed
``async_multi`` kind with 4 workers, one shared dedup and detection-cache
pass a slot batch.  The sequential arm pays one detector call a sampled
frame; the composed arm shares the dedup and the repository-sized cache.
The single-query async trajectories depend on the merge order, so the
arms are compared on aggregate cost, not per query.  Gate: at least 2×
fewer detector invocations a result.

    python -m repro_torch.bench.async_compose                 # on the card
    python -m repro_torch.bench.async_compose --device cpu --quick

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
WORKERS = 4


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(quick: bool = False, device=None) -> dict:
    """Both arms; returns their results, invocations and wall seconds and
    the composed arm's ``SearchStats``."""
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

    # sequential arm: Q single-query async runs, each over the shared
    # detector's output filtered to its class (``select``'s predicate)
    seq_plan = SearchPlan(result_limit=limit, max_steps=budget, cohorts=cohorts,
                          execution=Execution(async_workers=WORKERS))
    seq_inv, seq_results, seq_wall = 0, [], 0.0
    for q in range(q_n):
        carry = init_carry(init_state(chunks.length, device=device),
                           init_matcher(max_results=4096, device=device), keys[q])
        _sync(device)
        t0 = time.perf_counter()
        res = seq_plan.run(carry, chunks, detector=lambda key, frame, c=Q_CLASSES[q]: filter_class(
            repo, det_all(key, frame), c))
        _sync(device)
        seq_wall += time.perf_counter() - t0
        seq_inv += res.stats.detector_invocations
        seq_results.append(res.results[0])

    # composed arm: one slot pool, shared dedup and cache
    carries = init_carry_multi(init_state(chunks.length, device=device),
                               init_matcher(max_results=4096, device=device), torch.stack(keys))
    _sync(device)
    t0 = time.perf_counter()
    mres = SearchPlan(queries=q_n, result_limit=limit, max_steps=budget, cohorts=cohorts,
                      execution=Execution(queries_axis=True, async_workers=WORKERS, cache=-1)).run(
        carries, chunks, detector=det_all, select=class_select(repo, Q_CLASSES))
    _sync(device)
    multi_wall = time.perf_counter() - t0
    return dict(seq_inv=seq_inv, seq_results=seq_results, seq_wall=seq_wall, multi_results=list(mres.results),
                multi_wall=multi_wall, stats=mres.stats)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true", help="dashcam(0.02), limit 15, budget 2,048")
    args = ap.parse_args(argv)
    r = run(quick=args.quick, device=args.device)
    q_n, st = len(Q_CLASSES), r["stats"]
    seq_inv, multi_inv = r["seq_inv"], st.detector_invocations
    seq_per_result = seq_inv / max(sum(r["seq_results"]), 1)
    multi_per_result = multi_inv / max(sum(r["multi_results"]), 1)
    ratio = seq_per_result / max(multi_per_result, 1e-9)
    print("arm,queries,workers,results,frames_sampled,detector_invocations,det_per_result,wall_s")
    print(f"sequential_async,{q_n},{WORKERS},{sum(r['seq_results'])},{seq_inv},{seq_inv},"
          f"{seq_per_result:.2f},{r['seq_wall']:.2f}")
    print(f"async_multi,{q_n},{WORKERS},{sum(r['multi_results'])},{st.frames_sampled},{multi_inv},"
          f"{multi_per_result:.2f},{r['multi_wall']:.2f}")
    print(f"amortization,{q_n},cache_hits={st.cache_hits},rounds={st.rounds},spilled={st.results_spilled},"
          f"ratio={ratio:.2f}x,{'OK' if ratio >= 2.0 else 'FAIL'}")
    # the constructor's no-overflow guarantee held: nothing was lost
    if st.merge_overflow:
        raise SystemExit("a merge window overflowed the result ring")
    if ratio < 2.0:
        raise SystemExit(f"amortization {ratio:.2f}x below the 2x gate")
    return ratio


if __name__ == "__main__":
    main()
