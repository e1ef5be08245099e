"""Paper Figs. 3–4: frames processed to a fixed recall, against random+.

Counterpart of ``benchmarks/bench_savings.py``: ExSample, random+, random,
greedy and surrogate over the dashcam- and BDD-style simulated
repositories, for several query classes and recall targets, printing the
frames each policy processed and the savings against random+ (the paper's
normalisation), one CSV line a (dataset, class, recall), then the geomean
savings.  The paper reports ~2× on average, up to ~4× on localised
classes (§4.5).

    python -m repro_torch.bench.savings                  # on the card
    python -m repro_torch.bench.savings --device cpu --quick --scale 0.05

``--quick`` runs dashcam alone; without ``--device cpu`` a missing card
is an error.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from repro_torch.configs.exsample_paper import bdd, dashcam
from repro_torch.core import Execution, SearchPlan, init_carry, init_matcher, init_state, prng
from repro_torch.core.baselines import FrameSchedule, run_greedy, run_schedule, surrogate_schedule
from repro_torch.device import resolve
from repro_torch.sim import generate, instances_visible, oracle_detect

# frames scored a call of the surrogate's visibility count
_SCORE_BATCH = 4096


def _fresh(chunks, seed, device):
    return init_carry(init_state(chunks.length, device=device), init_matcher(max_results=4096, device=device),
                      prng.PRNGKey(seed, device=device))


def _surrogate_scores(repo, total_frames: int, query_class: int, stride: int = 37) -> np.ndarray:
    """Stand-in for a trained surrogate: the class's visible-instance count
    every ``stride`` frames plus noise (the BlazeIt best case)."""
    dev = repo.inst_class.device
    frames = torch.arange(0, total_frames, stride, device=dev)
    of_class = repo.inst_class == query_class
    vis = torch.cat([(instances_visible(repo, f) & of_class).sum(-1)
                     for f in frames.split(_SCORE_BATCH)]).float()
    rng = np.random.default_rng(0)
    dense = np.repeat(vis.cpu().numpy(), stride)[:total_frames]
    return dense + rng.normal(0, 0.3, total_frames)


def run(scale: float = 0.15, classes=(0, 1, 2), recalls=(0.1, 0.5), max_steps: int = 5000, seed: int = 0,
        quick: bool = False, device=None) -> list[dict]:
    """One row a (dataset, class, recall) with the frames of each policy."""
    device = resolve(device)
    rows = []
    setups = [("dashcam", dashcam(seed=seed, scale=scale))]
    if not quick:
        setups.append(("bdd", bdd(seed=seed, scale=scale)))
    for ds_name, setup in setups:
        repo, chunks = generate(setup.repo, device=device)
        for qc in classes:
            n_total = int((repo.inst_class == qc).sum())
            if n_total < 10:
                continue

            def det(key, frame, qc=qc):
                return oracle_detect(repo, frame, query_class=qc)

            for recall in recalls:
                limit = max(int(n_total * recall), 1)
                cohorts = 8 if limit >= 24 else 1   # §3.7.1: no cohort overshoot on tiny limits
                ex = SearchPlan(result_limit=limit, max_steps=max_steps, cohorts=cohorts,
                                execution=Execution(strategy="scan")).run(
                    _fresh(chunks, seed, device), chunks, detector=det).carry
                rp, _ = run_schedule(_fresh(chunks, seed, device), chunks,
                                     FrameSchedule.randomplus(chunks.total_frames, max_steps),
                                     detector=det, result_limit=limit)
                rnd, _ = run_schedule(_fresh(chunks, seed, device), chunks,
                                      FrameSchedule.random(chunks.total_frames, max_steps),
                                      detector=det, result_limit=limit)
                gr, _ = run_greedy(_fresh(chunks, seed, device), chunks, detector=det,
                                   result_limit=limit, max_steps=max_steps)
                scores = _surrogate_scores(repo, chunks.total_frames, qc)
                sur, _ = run_schedule(_fresh(chunks, seed, device), chunks,
                                      surrogate_schedule(scores, dedup_window=90)[:max_steps],
                                      detector=det, result_limit=limit)
                rows.append(dict(dataset=ds_name, query=qc, recall=recall, limit=limit,
                                 exsample=int(ex.step), randomplus=int(rp.step), random=int(rnd.step),
                                 greedy=int(gr.step), surrogate=int(sur.step)))
    return rows


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scale", type=float, default=0.15)
    ap.add_argument("--quick", action="store_true", help="dashcam only")
    args = ap.parse_args(argv)
    rows = run(scale=args.scale, quick=args.quick, device=args.device)
    savings = []
    print("dataset,query,recall,frames_exsample,frames_random+,frames_random,"
          "frames_greedy,frames_surrogate,savings_vs_random+")
    for r in rows:
        s = r["randomplus"] / max(r["exsample"], 1)
        savings.append(s)
        print(f"{r['dataset']},{r['query']},{r['recall']},{r['exsample']},"
              f"{r['randomplus']},{r['random']},{r['greedy']},{r['surrogate']},{s:.2f}")
    geo = math.exp(sum(math.log(max(s, 1e-9)) for s in savings) / len(savings))
    print(f"geomean_savings,{geo:.3f},paper_reports~2x_(1.1-4x)")
    return geo


if __name__ == "__main__":
    main()
