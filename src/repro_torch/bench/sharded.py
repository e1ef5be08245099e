"""Sharded-kind throughput and parity (paper §3.7.1 distributed, DESIGN.md §8).

Counterpart of ``benchmarks/bench_sharded.py``.  Frames a second of the
``sharded`` kind at 1, 2, 4 and 8 shards against the single-device scan
kind (Wilson–Hilferty) on a 1,000-chunk repository, each arm timed on its
second run; in full mode, the acceptance parity: at 8 shards the sharded
kind finds the scan kind's result count within ±5% for the same query and
frame budget on dashcam(0.05).  The shards are one process's mesh
(``launch.mesh.make_data_mesh``) on one device, run one after another, so
the rate measures the mesh's overhead, not a speed-up.

    python -m repro_torch.bench.sharded                  # full, on the card
    python -m repro_torch.bench.sharded --device cpu --quick
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.exsample_paper import dashcam
from repro_torch.core import Execution, SearchPlan, init_carry, init_matcher, init_state, prng
from repro_torch.device import resolve
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.sim import RepoSpec, generate, oracle_detect

DEVICE_COUNTS = (1, 2, 4, 8)
NEVER = 10**9   # an unreachable result limit: the steady rate


def _timed(run, device) -> float:
    run()                              # builds the kernels, warms the allocator
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return res.steps[0] / (time.perf_counter() - t0)


def run(quick: bool = False, device=None) -> dict:
    """Frames a second by arm and, in full mode, the dashcam parity."""
    device = resolve(device)
    steps = 256 if quick else 1_024
    cohorts, sync_every = 8, 1
    videos, chunk_frames, m_chunks = 10, 64, 1_000
    repo, chunks = generate(RepoSpec(video_lengths=[m_chunks * chunk_frames // videos] * videos, num_instances=64,
                                     chunk_frames=chunk_frames, seed=0), device=device)

    def det(key, frame):
        return oracle_detect(repo, frame, query_class=0)

    def fresh(ring=512):
        return init_carry(init_state(chunks.length, device=device), init_matcher(max_results=ring, device=device),
                          prng.PRNGKey(0, device=device))

    rows = [("scanned", 1, cohorts, "-", _timed(lambda: SearchPlan(
        result_limit=NEVER, max_steps=steps, cohorts=cohorts, method="wilson_hilferty").run(
        fresh(), chunks, detector=det), device))]
    for s in DEVICE_COUNTS:
        ex = Execution(shards=s, sync_every=sync_every) if s > 1 else Execution(strategy="sharded",
                                                                                  sync_every=sync_every)
        plan = SearchPlan(result_limit=NEVER, max_steps=steps, cohorts=cohorts, execution=ex)
        mesh = make_data_mesh(s, device=device)
        rows.append(("sharded", s, cohorts, sync_every,
                     _timed(lambda: plan.run(fresh(), chunks, detector=det, mesh=mesh), device)))
    out = dict(rows=rows)
    if not quick:
        repo, chunks = generate(dashcam(seed=0, scale=0.05).repo, device=device)
        budget, s = 2_048, max(DEVICE_COUNTS)
        scan = SearchPlan(result_limit=NEVER, max_steps=budget, cohorts=cohorts, method="wilson_hilferty").run(
            fresh(8192), chunks, detector=det)
        sh = SearchPlan(result_limit=NEVER, max_steps=budget, cohorts=cohorts,
                        execution=Execution(shards=s, sync_every=sync_every)).run(
            fresh(8192), chunks, detector=det, mesh=make_data_mesh(s, device=device))
        out["parity"] = dict(shards=s, scan=scan.results[0], sharded=sh.results[0],
                             ratio=sh.results[0] / max(scan.results[0], 1))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true", help="256 frames an arm, no parity row")
    args = ap.parse_args(argv)
    r = run(quick=args.quick, device=args.device)
    print("driver,shards,global_cohorts,sync_every,steps_per_sec")
    for name, s, c, sync, rate in r["rows"]:
        print(f"{name},{s},{c},{sync},{rate:.0f}")
    if "parity" in r:
        p = r["parity"]
        ok = abs(p["ratio"] - 1.0) <= 0.05
        print(f"parity_dashcam,{p['shards']},scan={p['scan']},sharded={p['sharded']},ratio={p['ratio']:.3f},"
              f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"8-way parity off by {p['ratio']:.3f}x")
    return r


if __name__ == "__main__":
    main()
