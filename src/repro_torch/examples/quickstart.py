"""Quickstart: a distinct-object query over a simulated video repository.

Counterpart of ``examples/quickstart.py``.  Generates a 10-video dashcam
repository with localized instances, answers "find 40 distinct class-0
objects" with ExSample (one declarative ``SearchPlan``, lowered to the
resident scan driver) and with random+, compares the frames each
processed (the paper's cost metric) and prints the recall trace.  Then
the warm restart: a plan bound to a repository index (``IndexSpec``) runs
twice over one snapshot directory, and the second run answers from the
detections the first one persisted instead of calling the detector.

    python -m repro_torch.examples.quickstart                # on the card
    python -m repro_torch.examples.quickstart --device cpu

Without ``--device cpu`` a missing card is an error.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs.exsample_paper import dashcam
from repro_torch.core import (Execution, IndexSpec, SearchPlan, init_carry, init_carry_multi, init_matcher,
                              init_state, prng)
from repro_torch.core.baselines import FrameSchedule, run_schedule
from repro_torch.device import resolve
from repro_torch.sim import generate, oracle_detect
from repro_torch.sim.costmodel import CostRates, sampling_cost


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scale", type=float, default=0.15, help="dashcam scale (the reference's 0.15)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    setup = dashcam(scale=args.scale)
    repo, chunks = generate(setup.repo, device=device)
    print(f"repository: {chunks.total_frames:,} frames, {chunks.num_chunks} chunks, "
          f"{repo.num_instances} instances")

    def detector(key, frame):
        return oracle_detect(repo, frame, query_class=0)

    def fresh():
        return init_carry(init_state(chunks.length, device=device),
                          init_matcher(max_results=1024, device=device), prng.PRNGKey(0, device=device))

    # one declarative plan; it lowers to the resident scan driver, whose
    # recall trace comes back in one read at the end
    plan = SearchPlan(result_limit=40, max_steps=20_000, cohorts=8, trace_every=200)
    res = plan.run(fresh(), chunks, detector=detector)

    rp, _ = run_schedule(fresh(), chunks, FrameSchedule.randomplus(chunks.total_frames, 20_000),
                         detector=detector, result_limit=40)
    rates = CostRates()
    ex_steps = res.stats.frames_sampled
    rp_results, rp_steps = int(rp.results), int(rp.step)
    print(f"\nExSample : {res.results[0]} results in {ex_steps:,} frames "
          f"(~{sampling_cost(ex_steps, rates).total_s:.0f} gpu·s, lowering={res.kind})")
    print(f"random+  : {rp_results} results in {rp_steps:,} frames "
          f"(~{sampling_cost(rp_steps, rates).total_s:.0f} gpu·s)")
    print(f"savings  : {rp_steps / max(ex_steps, 1):.2f}x fewer frames")
    print("\nrecall trace (frames, results):", res.trace[:8], "...")

    # warm restart: the plan bound to a persistent index; the second,
    # identical search preloads its detection cache from the snapshot
    def fresh_multi():
        return init_carry_multi(init_state(chunks.length, device=device),
                                init_matcher(max_results=1024, device=device),
                                torch.stack([prng.PRNGKey(0, device=device)]))

    with tempfile.TemporaryDirectory() as tmp:
        warm_plan = SearchPlan(result_limit=40, max_steps=20_000, cohorts=8,
                               execution=Execution(queries_axis=True, cache=-1, index=IndexSpec(path=tmp)))
        cold = warm_plan.run(fresh_multi(), chunks, detector=detector)
        warm = warm_plan.run(fresh_multi(), chunks, detector=detector)
    print(f"\nwarm restart: {cold.stats.detector_invocations:,} detector invocations cold -> "
          f"{warm.stats.detector_invocations:,} warm ({warm.stats.index_hits:,} index hits, "
          f"{cold.stats.persisted_detections:,} persisted)")
    return dict(exsample=res, randomplus=(rp_results, rp_steps), cold=cold, warm=warm)


if __name__ == "__main__":
    main()
