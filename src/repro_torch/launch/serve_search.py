"""Search service front: JSON requests over stdin to one live driver.

Counterpart of ``repro.launch.serve_search``.  Boots a
:class:`~repro_torch.serve.service.SearchService` around a simulated
repository and answers line-delimited JSON requests on stdin, one JSON
response a line on stdout:

  {"op": "submit", "tenant": "a", "class": 0, "seed": 1,
   "plan": {"result_limit": 10, "max_steps": 4000, "cohorts": 4,
            "execution": {"queries_axis": true,
                          "service": {"slo_latency_s": 30.0}}}}
  {"op": "stats"}
  {"op": "drain"}

EOF drains: the front never exits with admitted work unfinished.

  printf '%s\\n' '{"op": "submit", ...}' '{"op": "drain"}' | \\
      PYTHONPATH=src python -m repro_torch.launch.serve_search --device cpu --scale 0.02

Tenants bind their predicate by query class: the service holds one
class-agnostic detector and one ``class_select`` over the repository's
classes, and a tenant's ``class`` is its row's ``select_id``.
``--device`` defaults to ``cuda`` and fails without a card; ``--device
cpu`` runs the plain PyTorch versions of the kernels.  A failure that
stops the service (a worker's exception) is answered ``{"ok": false}``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

from repro_torch.configs.exsample_paper import bdd, dashcam
from repro_torch.core import init_carry_multi, init_matcher, init_state, prng
from repro_torch.core.plan import PlanError, SearchPlan
from repro_torch.device import resolve
from repro_torch.serve.service import SearchService, ServiceFailure
from repro_torch.sim import class_select, generate, oracle_detect
from repro_torch.sim.costmodel import CostRates


def build_service(args) -> SearchService:
    """The world on ``args.device``, a class-agnostic detector, a
    ``class_select`` over every class and an empty pool under the CLI's
    cost budget."""
    device = resolve(getattr(args, "device", None))
    setup = (dashcam if args.dataset == "dashcam" else bdd)(seed=args.seed, scale=args.scale)
    repo, chunks = generate(setup.repo, device=device)
    num_classes = int(repo.inst_class.max()) + 1

    def detector(key, frame):
        return oracle_detect(repo, frame, query_class=None)

    select = class_select(repo, list(range(num_classes)))
    proto = init_carry_multi(init_state(chunks.length, device=device),
                             init_matcher(max_results=args.max_results, device=device),
                             torch.stack([prng.PRNGKey(0, device=device)]))
    index = None
    index_path = getattr(args, "index", None)
    if index_path:
        from repro_torch.index.store import RepositoryIndex

        index = RepositoryIndex(index_path, detector_version=getattr(args, "detector_version", "v0"),
                                prior_weight=getattr(args, "prior_weight", 0.0))
    service = SearchService(
        proto, chunks, detector, select=select, budget_s=args.budget_s, rates=CostRates(),
        cohorts=args.cohorts, num_workers=args.workers, max_steps=args.max_steps,
        cache_frames=chunks.total_frames if args.cache else 0, slots_per_batch=args.slots_per_batch,
        index=index)
    service.num_classes = num_classes
    print(f"service: {args.dataset} {chunks.total_frames:,} frames / {num_classes} classes / budget "
          f"{args.budget_s:.0f}s / cohorts {args.cohorts} x {args.workers} workers on {device}", file=sys.stderr)
    return service


def handle_request(service: SearchService, obj: dict) -> dict:
    """One request dict to one response dict; the stdin loop, the HTTP
    front and the tests call it."""
    op = obj.get("op")
    try:
        if op == "submit":
            plan = SearchPlan.from_dict(obj["plan"])
            tenant = service.submit(
                str(obj["tenant"]), plan, seed=int(obj.get("seed", 0)),
                select_id=int(obj["class"]) if obj.get("class") is not None else None)
            return {"ok": True, **tenant.to_dict()}
        if op == "stats":
            return {"ok": True, **service.stats()}
        if op == "drain":
            service.drain(deadline_s=float(obj.get("deadline_s", 120.0)))
            return {"ok": True, **service.stats()}
        return {"ok": False, "error": f"unknown op {op!r} (submit | stats | drain)"}
    except PlanError as e:
        return {"ok": False, "error": str(e), "field": e.field}
    except (KeyError, ValueError, TimeoutError, ServiceFailure) as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def _print_tenant_summary(service: SearchService) -> None:
    for tid, t in service.stats()["tenants"].items():
        line = f"  tenant {tid}: {t['state']}"
        if "results" in t:
            line += (f" — {t['results']} results / {t['steps']:,} frames / {t['detector_invocations']:,} "
                     f"fresh detections ({t['cache_hits']:,} cache hits)")
            if t.get("ttfr_s") is not None:
                met = t.get("slo_met")
                line += f", first result {t['ttfr_s']:.2f}s" + (
                    "" if met is None else f" (SLO {'met' if met else 'MISSED'})")
        elif t["state"] == "rejected":
            line += f" — {t['reason']}"
        print(line, file=sys.stderr)


def build_parser(ap: Optional[argparse.ArgumentParser] = None) -> argparse.ArgumentParser:
    """The service's flags, shared with the HTTP front (which adds its
    bind address)."""
    if ap is None:
        ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="dashcam", choices=["dashcam", "bdd"])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget-s", type=float, default=float("inf"),
                    help="total priced GPU-time budget the admission controller enforces (CostRates pricing)")
    ap.add_argument("--cohorts", type=int, default=4)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--max-steps", type=int, default=100_000, help="pool-level frame-budget ceiling")
    ap.add_argument("--max-results", type=int, default=512)
    ap.add_argument("--slots-per-batch", type=int, default=4)
    ap.add_argument("--cache", action="store_true", default=True)
    ap.add_argument("--no-cache", dest="cache", action="store_false")
    ap.add_argument("--index", default=None,
                    help="directory of the persistent RepositoryIndex; loaded if a snapshot exists, saved at "
                         "every tenant retirement")
    ap.add_argument("--detector-version", default="v0",
                    help="detector version key; a mismatch against a snapshot is a clean miss")
    ap.add_argument("--prior-weight", dest="prior_weight", type=float, default=0.0,
                    help="default Thompson warm-start weight for tenants whose plans do not set execution.index")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    service = build_service(args)
    service.start()
    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            print(json.dumps(handle_request(service, json.loads(line))), flush=True)
        if service.busy() or service.failure is not None:
            service.drain()   # EOF drains: no admitted work is lost, no failure is hidden
    finally:
        service.stop()
    _print_tenant_summary(service)
    print("service: clean drain", file=sys.stderr)


if __name__ == "__main__":
    main()
