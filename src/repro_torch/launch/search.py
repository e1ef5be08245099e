"""Search CLI: one ExSample distinct-object query, end to end, on the card.

Counterpart of ``repro.launch.search`` for the single-query kinds:

  python -m repro_torch.launch.search --limit 50 --cohorts 16
  python -m repro_torch.launch.search --dataset bdd --scale 1.0 \\
      --plan '{"result_limit": 200, "max_steps": 5000, "cohorts": 50, "method": "pallas"}'

``--plan`` takes a ``SearchPlan.to_dict()`` JSON document (or ``@file``);
the Thompson method goes inside it, as in the reference CLI.  Without it
the plan is built from ``--limit``/``--max-steps``/``--cohorts``.
``--device`` defaults to ``cuda`` and fails without a card; ``--device
cpu`` runs the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs.exsample_paper import bdd, dashcam
from repro_torch.core import SearchPlan, init_carry, init_matcher, init_state, prng
from repro_torch.device import resolve
from repro_torch.sim import generate, oracle_detect
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plan", default="", help="SearchPlan JSON (or @file)")
    ap.add_argument("--dataset", default="dashcam", choices=["dashcam", "bdd"])
    ap.add_argument("--scale", type=float, default=0.2)
    ap.add_argument("--query-class", type=int, default=0)
    ap.add_argument("--limit", type=int, default=50)
    ap.add_argument("--cohorts", type=int, default=16)
    ap.add_argument("--max-steps", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    plan = build_plan(args)
    lowered = plan.lower()
    setup = (dashcam if args.dataset == "dashcam" else bdd)(seed=args.seed, scale=args.scale)
    repo, chunks = generate(setup.repo, device=device)
    print(f"{args.dataset}: {chunks.total_frames:,} frames / {chunks.num_chunks} chunks / "
          f"{repo.num_instances} instances on {device}")
    print(f"plan: lowering={lowered.kind} method={lowered.method} {json.dumps(plan.to_dict())}")

    def det(key, frame):
        return oracle_detect(repo, frame, query_class=args.query_class)

    carry = init_carry(init_state(chunks.length, device=device),
                       init_matcher(max_results=MATCHER_CAPACITY, device=device),
                       prng.PRNGKey(args.seed, device=device))
    t0 = time.perf_counter()
    res = lowered.run(carry, chunks, detector=det)
    wall = time.perf_counter() - t0
    st = res.stats
    cost = sampling_cost(st.detector_invocations, CostRates())
    print(f"ExSample[{res.kind}]: {sum(res.results)} results / {st.frames_sampled:,} frames "
          f"sampled / {st.detector_invocations:,} detector invocations / est. "
          f"{cost.total_s:.0f} gpu·s (driver wall {wall:.1f}s, "
          f"{st.frames_sampled / max(wall, 1e-9):.0f} frames/s)")


if __name__ == "__main__":
    main()
