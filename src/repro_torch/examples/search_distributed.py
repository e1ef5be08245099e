"""Distributed ExSample: the mesh-sharded and the composed Q × shards plans.

Counterpart of ``examples/search_distributed.py``.  One ``SearchPlan``
with ``Execution(shards=8)`` splits the chunk statistics over an 8-shard
data mesh: each round every shard processes its slice of the globally
consistent Thompson cohort, and the shards' rings merge every
``sync_every`` rounds.  A single-device plan of the same query shows the
sharded statistics land on the same answer, and a composed
``queries_axis`` × ``shards`` plan runs four queries through the same
mesh, sharing one deduplicated, cached detector pass a round a shard.
The mesh is one process's: 8 shards on the card, or on the CPU with
``--device cpu``.

    python -m repro_torch.examples.search_distributed               # on the card
    python -m repro_torch.examples.search_distributed --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import Execution, SearchPlan, init_carry, init_carry_multi, init_matcher, init_state, prng
from repro_torch.device import resolve
from repro_torch.launch.mesh import describe, make_data_mesh
from repro_torch.sim import RepoSpec, generate, oracle_detect


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    repo, chunks = generate(RepoSpec(video_lengths=[20_000] * 4, num_instances=200, chunk_frames=2_000,
                                     locality=4.0, seed=1), device=device)

    def det(key, frame):
        return oracle_detect(repo, frame, query_class=0)

    def fresh(key):
        return init_carry(init_state(chunks.length, device=device), init_matcher(max_results=1024, device=device),
                          key)

    shards, sync_every, limit, budget = 8, 4, 120, 4_000
    mesh = make_data_mesh(shards, device=device)
    print(describe(mesh))
    key = prng.PRNGKey(0, device=device)
    t0 = time.perf_counter()
    sharded = SearchPlan(result_limit=limit, max_steps=budget, cohorts=shards,
                         execution=Execution(shards=shards, sync_every=sync_every)).run(
        fresh(key), chunks, detector=det, mesh=mesh)
    wall = time.perf_counter() - t0
    st = sharded.stats
    print(f"sharded({shards}x, sync_every={sync_every}): {sharded.results[0]} distinct results in "
          f"{sharded.steps[0]} frames / {st.merges} merges (ring high-water {st.merge_high_water}) ({wall:.1f}s)")
    n = sharded.carry.sampler.n
    top = torch.argsort(-n, stable=True)[:5]
    print("most-sampled chunks:", top.tolist(), "samples:", n[top].int().tolist())

    scan = SearchPlan(result_limit=limit, max_steps=budget, cohorts=shards, method="wilson_hilferty").run(
        fresh(key), chunks, detector=det)
    print(f"single-device scan: {scan.results[0]} results in {scan.steps[0]} frames")
    overlap = len(set(top.tolist()) & set(torch.argsort(-scan.carry.sampler.n, stable=True)[:5].tolist()))
    print(f"top-5 hot-chunk overlap with scan: {overlap}/5")

    q_n = 4
    carries = init_carry_multi(init_state(chunks.length, device=device), init_matcher(max_results=1024, device=device),
                               torch.stack([prng.fold_in(key, q) for q in range(q_n)]))
    t0 = time.perf_counter()
    comp = SearchPlan(queries=q_n, result_limit=limit // q_n, max_steps=budget, cohorts=shards,
                      execution=Execution(queries_axis=True, shards=shards, sync_every=sync_every, cache=-1)).run(
        carries, chunks, detector=det, mesh=mesh)
    wall = time.perf_counter() - t0
    st = comp.stats
    print(f"composed({q_n} queries x {shards} shards): {sum(comp.results)} results / {st.frames_sampled} frames "
          f"sampled / {st.detector_invocations} detector invocations ({st.amortization:.2f}x amortization, cache "
          f"hit rate {st.cache_hit_rate:.2f}) ({wall:.1f}s)")
    return dict(sharded=sharded.results[0], scan=scan.results[0], overlap=overlap, composed=list(comp.results),
                amortization=st.amortization)


if __name__ == "__main__":
    main()
