"""Chip smoke for repro_torch: build the CUDA kernels, check each against its
plain PyTorch version on the card, drive the full-size scan search and the
full-width multi-query search on the card and hold each against the same
search on the CPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout's ``src/``.  Exits non-zero on
any failure (no card, build error, kernel mismatch, search mismatch).  The
last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the per-kernel JSON summary and, before that, the
card's name and power limit as nvidia-smi reports them.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# (non-tensor-core) rate, used for each kernel's lower-bound time.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

MAIN_PLAN = dict(result_limit=200, max_steps=5000, cohorts=50, method="pallas", trace_every=256)
HOST_CHECK_PLAN = dict(result_limit=40, max_steps=400, cohorts=8, method="pallas", trace_every=64)
MATCHER_CAPACITY = 8192
# the multi-query path: 2 predicates x 4 users, the mix of
# benchmarks/bench_multiquery.py, sharing one repository-sized cache
MULTI_CLASSES = (0, 0, 0, 0, 1, 1, 1, 1)
MULTI_PLAN = dict(queries=len(MULTI_CLASSES), result_limit=200, max_steps=2000, cohorts=50,
                  method="pallas", trace_every=256,
                  execution=dict(queries_axis=True, cache=-1))
SOLO_CHECK_STEPS = 400


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def median_ms(fn, *, inner: int = 20, reps: int = 7) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def device_events(prof):
    """The device-side activities (kernels, copies, fills) of a profile,
    without the device-timeline copies of ``record_function`` ranges."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.name.startswith("exsample.")]


def device_ms(fn, *, n: int = 50) -> float | None:
    """Device time per call of ``fn``: the summed durations of the device
    activities it launches, from torch.profiler (CUPTI).  None when the
    profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.time_range.elapsed_us() for e in device_events(prof))
    return total_us / n / 1e3 if total_us > 0 else None


def bits_equal(x, y) -> bool:
    """Same shape, dtype and bit pattern (so -0.0 != 0.0 and NaN == NaN)."""
    import torch

    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dtype == torch.float32:
        return torch.equal(x.view(torch.int32), y.view(torch.int32))
    return torch.equal(x, y)


# ----------------------------------------------------------------- kernels

def thompson_inputs(c: int, m: int, seed: int, *, all_exhausted: bool = False):
    import torch

    g = torch.Generator().manual_seed(seed)
    n1 = torch.randint(0, 30, (m,), generator=g).float()
    n = torch.randint(0, 400, (m,), generator=g).float()
    alpha = torch.clamp_min(n1 + 0.1, 0.05)
    beta = n + 1.0
    z = torch.randn((c, m), generator=g)
    alpha[torch.rand((m,), generator=g) < 0.2] = -1.0        # exhausted sentinels
    if all_exhausted:
        alpha[:] = -1.0
    if m >= 4 and not all_exhausted:
        # forced exact ties at the row maximum: chunks 1 and m-1 share a
        # dominant (alpha, beta) and the same normals in every row, so the
        # argmax is a tie across thread strides that the lower index wins
        j, k = 1, m - 1
        alpha[j] = alpha[k] = 1000.0
        beta[j] = beta[k] = 1.0
        z[:, k] = z[:, j]
    return alpha.cuda(), beta.cuda(), z.cuda()


def iou_inputs(d: int, r: int, seed: int):
    import torch

    g = torch.Generator().manual_seed(seed)

    def boxes(k):
        xy = torch.rand((k, 2), generator=g) * 0.7 + 0.05
        wh = torch.rand((k, 2), generator=g) * 0.15 + 0.05
        b = torch.cat([xy, xy + wh], dim=1)
        flat = torch.rand((k,), generator=g) < 0.1
        b[flat, 2] = b[flat, 0]                                   # zero-area boxes
        return b

    a, b = boxes(d), boxes(r)
    if r > d:
        b[:d] = a + 0.002 * torch.randn((d, 4), generator=g)   # real overlaps
    b[-1] = 0.0                                                 # empty ring slot
    return a.contiguous().cuda(), b.contiguous().cuda()


def thompson_batched_inputs(q: int, c: int, m: int, seed: int):
    """Q queries of ``thompson_inputs`` (each with its forced ties across
    thread strides); the last query has every chunk exhausted."""
    import torch

    rows = [thompson_inputs(c, m, seed + i, all_exhausted=(i == q - 1)) for i in range(q)]
    return tuple(torch.stack([r[k] for r in rows]).contiguous() for k in range(3))


def timed_row(kernel, plain, **row) -> dict:
    """Device time per call (profiler) of the kernel and of its plain
    version, and their host-inclusive time per call (CUDA events around a
    loop of calls, which the host's launch rate bounds for small kernels)."""
    row.update(ms=device_ms(kernel), plain_ms=device_ms(plain),
               call_ms=median_ms(kernel), plain_call_ms=median_ms(plain))
    if row["ms"] is None or row["plain_ms"] is None:
        print("    (profiler recorded no device time: ms falls back to CUDA events)")
        row["ms"] = row["ms"] or row["call_ms"]
        row["plain_ms"] = row["plain_ms"] or row["plain_call_ms"]
    t_bytes = row["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = row["ops"] / F32_OPS_PER_S * 1e3
    row.update(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    return row


def describe(row) -> str:
    return (f"device {row['ms'] * 1e3:.2f} us (plain {row['plain_ms'] * 1e3:.2f} us), "
            f"per call with launch {row['call_ms'] * 1e3:.1f} us (plain {row['plain_call_ms'] * 1e3:.1f} us), "
            f"bound {row['bound_ms'] * 1e3:.3f} us by {row['bound_by']}, {row['bytes']} B")


def check_kernels(torch) -> dict:
    from repro_torch.kernels.iou_match.kernel import iou_matrix
    from repro_torch.kernels.iou_match.ref import iou_ref
    from repro_torch.kernels.thompson.kernel import thompson_choose
    from repro_torch.kernels.thompson.ref import thompson_ref

    rows = {}
    for c, m, all_ex in ((50, 22, False), (50, 1000, False), (50, 10000, False),
                         (7, 1025, False), (3, 64, True)):
        alpha, beta, z = thompson_inputs(c, m, seed=c * 7919 + m, all_exhausted=all_ex)
        ki, kv = thompson_choose(alpha, beta, z)
        ri, rv = thompson_ref(alpha, beta, z)
        torch.cuda.synchronize()
        if not torch.equal(ki, ri) or not bits_equal(kv, rv):
            fail(f"thompson_choose != plain at (C={c}, M={m}): idx {ki.tolist()} vs {ri.tolist()}")
        if all_ex and not (bool((ki == -1).all()) and bool((kv == -1e30).all())):
            fail("thompson_choose on an all-exhausted row must give (-1, -1e30)")
        live = int((alpha > 0).sum())
        nbytes = 8 * m + 4 * c * m + 8 * c
        ops = 14 * c * live
        row = timed_row(lambda: thompson_choose(alpha, beta, z), lambda: thompson_ref(alpha, beta, z),
                        shape=[c, m], bytes=nbytes, ops=ops,
                        max_abs_err=float((kv - rv).abs().max()) if live else 0.0)
        rows[("thompson_choose", c, m)] = row
        print(f"  thompson_choose C={c:>3} M={m:>5}{' all-exhausted' if all_ex else ''}: equal; "
              + describe(row))
    for d, r in ((16, 8192), (13, 1000), (1, 1)):
        a, b = iou_inputs(d, r, seed=d * 131 + r)
        k = iou_matrix(a, b)
        p = iou_ref(a, b)
        torch.cuda.synchronize()
        if not bits_equal(k, p):
            bad = int((k.view(torch.int32) != p.view(torch.int32)).sum())
            fail(f"iou_matrix != plain at (D={d}, R={r}): {bad} entries differ")
        nbytes = 16 * d + 16 * r + 4 * d * r
        row = timed_row(lambda: iou_matrix(a, b), lambda: iou_ref(a, b), shape=[d, r],
                        bytes=nbytes, ops=20 * d * r, max_abs_err=float((k - p).abs().max()))
        rows[("iou_matrix", d, r)] = row
        print(f"  iou_matrix D={d:>3} R={r:>5}: bit-equal; " + describe(row))
    check_batched_kernels(torch, rows)
    return rows


def check_batched_kernels(torch, rows) -> None:
    """B2 against its plain version (index exact, value bitwise) and the
    batched B3 against its plain version and the 2-D kernel per slice."""
    from repro_torch.kernels.iou_match.kernel import iou_matrix, iou_matrix_batched
    from repro_torch.kernels.iou_match.ref import iou_ref
    from repro_torch.kernels.thompson.kernel import thompson_choose, thompson_choose_batched
    from repro_torch.kernels.thompson.ref import thompson_ref

    for q, c, m in ((8, 50, 22), (8, 50, 1000), (8, 50, 10000), (3, 7, 1025)):
        alpha, beta, z = thompson_batched_inputs(q, c, m, seed=q * 131 + c * 7919 + m)
        ki, kv = thompson_choose_batched(alpha, beta, z)
        ri, rv = thompson_ref(alpha, beta, z)
        torch.cuda.synchronize()
        if not torch.equal(ki, ri) or not bits_equal(kv, rv):
            bad = int((ki != ri).sum())
            fail(f"thompson_choose_batched != plain at (Q={q}, C={c}, M={m}): {bad} indices differ")
        if not (bool((ki[-1] == -1).all()) and bool((kv[-1] == -1e30).all())):
            fail("thompson_choose_batched on an all-exhausted query must give (-1, -1e30)")
        for i in range(q):
            bi, bv = thompson_choose(alpha[i].contiguous(), beta[i].contiguous(), z[i].contiguous())
            if not torch.equal(ki[i], bi) or not bits_equal(kv[i], bv):
                fail(f"thompson_choose_batched query {i} != thompson_choose at (C={c}, M={m})")
        live = int((alpha > 0).sum())
        nbytes = 8 * q * m + 4 * q * c * m + 8 * q * c
        row = timed_row(lambda: thompson_choose_batched(alpha, beta, z),
                        lambda: thompson_ref(alpha, beta, z),
                        shape=[q, c, m], bytes=nbytes, ops=14 * c * live,
                        max_abs_err=float((kv - rv).abs().max()))
        rows[("thompson_choose_batched", q, c, m)] = row
        print(f"  thompson_choose_batched Q={q} C={c:>3} M={m:>5} (last query all exhausted): equal, "
              f"and equal to B1 per query; " + describe(row))
    for q, d, r in ((8, 16, 8192), (3, 13, 1000)):
        pairs = [iou_inputs(d, r, seed=q * 977 + i * 131 + d + r) for i in range(q)]
        a = torch.stack([p[0] for p in pairs]).contiguous()
        b = torch.stack([p[1] for p in pairs]).contiguous()
        k = iou_matrix_batched(a, b)
        p = iou_ref(a, b)
        torch.cuda.synchronize()
        if not bits_equal(k, p):
            bad = int((k.view(torch.int32) != p.view(torch.int32)).sum())
            fail(f"iou_matrix_batched != plain at (Q={q}, D={d}, R={r}): {bad} entries differ")
        for i in range(q):
            if not bits_equal(k[i], iou_matrix(a[i].contiguous(), b[i].contiguous())):
                fail(f"iou_matrix_batched slice {i} != iou_matrix at (D={d}, R={r})")
        nbytes = q * (16 * d + 16 * r + 4 * d * r)
        row = timed_row(lambda: iou_matrix_batched(a, b), lambda: iou_ref(a, b),
                        shape=[q, d, r], bytes=nbytes, ops=20 * q * d * r,
                        max_abs_err=float((k - p).abs().max()))
        rows[("iou_matrix_batched", q, d, r)] = row
        print(f"  iou_matrix_batched Q={q} D={d:>3} R={r:>5}: bit-equal, and equal to the 2-D kernel "
              f"per slice; " + describe(row))


# ------------------------------------------------------------- main path

def kernel_fns() -> dict:
    """Every kernel wrapper of the port, by name; each counts its launches."""
    from repro_torch.kernels.iou_match.kernel import iou_matrix, iou_matrix_batched
    from repro_torch.kernels.thompson.kernel import thompson_choose, thompson_choose_batched

    return {"thompson_choose": thompson_choose, "thompson_choose_batched": thompson_choose_batched,
            "iou_matrix": iou_matrix, "iou_matrix_batched": iou_matrix_batched}


def reset_launches() -> None:
    for fn in kernel_fns().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_fns().items()}


def run_search(torch, setup, plan_dict, device, kind="scan", around=contextlib.nullcontext):
    """One search; ``around()`` is entered around ``plan.run`` alone (set-up
    excluded).  Returns (SearchResult, wall seconds of plan.run, M)."""
    from repro_torch.core import SearchPlan, init_carry, init_matcher, init_state, prng
    from repro_torch.sim import generate, oracle_detect

    repo, chunks = generate(setup.repo, device=device)
    plan = SearchPlan.from_dict(dict(plan_dict, execution=dict(strategy=kind)))

    def det(key, frame):
        return oracle_detect(repo, frame, query_class=0)

    carry = init_carry(init_state(chunks.length, device=device),
                       init_matcher(max_results=MATCHER_CAPACITY, device=device),
                       prng.PRNGKey(0, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize()
    with around():
        t0 = time.perf_counter()
        res = plan.run(carry, chunks, detector=det)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return res, wall, chunks.num_chunks


def same_search(a, b) -> list[str]:
    """Field names on which two SearchResults differ."""
    import dataclasses

    import torch

    diffs = [f for f in ("steps", "results", "traces") if getattr(a, f) != getattr(b, f)]
    if dataclasses.asdict(a.stats) != dataclasses.asdict(b.stats):
        diffs.append("stats")
    pairs = [("sampler." + f, getattr(a.carry.sampler, f), getattr(b.carry.sampler, f))
             for f in ("n1", "n", "frames")]
    pairs += [("matcher." + f, getattr(a.carry.matcher, f), getattr(b.carry.matcher, f))
              for f in ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor",
                        "total_inserted")]
    pairs += [("key", a.carry.key, b.carry.key), ("step", a.carry.step, b.carry.step),
              ("results", a.carry.results, b.carry.results)]
    if a.final_cache is not None or b.final_cache is not None:
        if a.final_cache is None or b.final_cache is None:
            return diffs + ["final_cache"]
        cap = a.final_cache.capacity
        pairs.append(("cache.tag", a.final_cache.tag[:cap], b.final_cache.tag[:cap]))
    for name, x, y in pairs:
        if not bits_equal(x.cpu(), y.cpu()):
            diffs.append(name)
    return diffs


def main_path(torch, name, setup) -> dict:
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    reset_launches()
    gpu, gpu_s, m = run_search(torch, setup, MAIN_PLAN, cuda)
    launches = read_launches()
    ref, cpu_s, _ = run_search(torch, setup, MAIN_PLAN, cpu)
    frames = gpu.steps[0]
    rounds = frames // MAIN_PLAN["cohorts"]
    for (s, r) in gpu.trace:
        if s < 0 or r < 0:
            fail(f"{name}: malformed trace entry {(s, r)}")
    if not all(math.isfinite(v) for v in gpu.carry.sampler.n1.tolist()):
        fail(f"{name}: non-finite sampler state")
    if gpu.results[0] <= 0 or frames <= 0:
        fail(f"{name}: the search found nothing ({gpu.results}, {gpu.steps})")
    diffs = same_search(gpu, ref)
    if diffs:
        fail(f"{name}: card run != CPU run on {diffs}")
    if (launches["thompson_choose"] != rounds or launches["iou_matrix"] != frames
            or launches["thompson_choose_batched"] or launches["iou_matrix_batched"]):
        fail(f"{name}: launches {launches} != rounds {rounds} / frames {frames}")
    print(f"  {name}: M={m} chunks, {gpu.results[0]} results in {frames} frames / {rounds} rounds; "
          f"card == CPU exactly; card {frames / gpu_s:.1f} frames/s {rounds / gpu_s:.2f} rounds/s "
          f"({gpu_s:.2f} s), CPU {frames / cpu_s:.1f} frames/s {rounds / cpu_s:.2f} rounds/s "
          f"({cpu_s:.2f} s); launches {launches}")
    return launches


def profile_path(torch, label: str, run, cohorts: int) -> None:
    """Where the time goes: torch.profiler over one search on the card
    (``run(around) -> (SearchResult, wall seconds)``, profiling only
    ``plan.run``, not the repository's generation), by driver layer (the
    ``exsample.*`` ranges), with the device's busy time, the launches and
    the host syncs per round.  Shares are of the rounds' own span, from
    the first ``exsample.*`` range's start to the last one's end, so the
    driver's set-up (the detection cache's allocation) is outside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(contextlib.nullcontext)                              # warm
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    res, wall = run(lambda: prof)
    frames = res.stats.frames_sampled
    rounds = res.stats.rounds or frames // cohorts
    spans = [e for e in prof.events() if e.name.startswith("exsample.") and e.device_type == DeviceType.CPU]
    lo = min(e.time_range.start for e in spans)
    hi = max(e.time_range.end for e in spans)
    span_us = hi - lo
    busy_us = sum(e.time_range.elapsed_us() for e in device_events(prof))
    busy_span_us = sum(max(0, min(e.time_range.end, hi) - max(e.time_range.start, lo))
                       for e in device_events(prof))
    print(f"profile: {label}, {frames} frames / {rounds} rounds; plan.run {wall:.3f} s "
          f"({frames / wall:.1f} frames/s, {rounds / wall:.2f} rounds/s under the profiler), "
          f"device busy {busy_us / 1e3:.1f} ms of it; the rounds' span {span_us / 1e3:.1f} ms "
          f"({100 * span_us / 1e6 / wall:.1f}% of plan.run): device busy {busy_span_us / 1e3:.1f} ms "
          f"= {100 * busy_span_us / span_us:.1f}%, idle {100 - 100 * busy_span_us / span_us:.1f}%")
    ranges = {}
    for e in spans:
        r = ranges.setdefault(e.name, [0, 0.0, 0.0])
        r[0] += 1
        r[1] += e.cpu_time_total
        r[2] += e.device_time_total
    for name, (count, cpu_us, dev_us) in sorted(ranges.items(), key=lambda kv: -kv[1][1]):
        print(f"  {name:<20} {count:>6} calls  host {cpu_us / 1e3:9.1f} ms "
              f"({100 * cpu_us / span_us:5.1f}% of the rounds)  device {dev_us / 1e3:8.2f} ms")
    outside = span_us - sum(r[1] for r in ranges.values())
    print(f"  {'(between ranges)':<20} {'':>6}        host {outside / 1e3:9.1f} ms "
          f"({100 * outside / span_us:5.1f}% of the rounds)")
    calls, callers, loop_syncs = {}, {}, 0
    for e in prof.events():
        if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync",
                      "cudaLaunchKernel", "cudaLaunchKernelExC"):
            calls[e.name] = calls.get(e.name, 0) + 1
            if e.name != "cudaLaunchKernel":
                chain, p = [], e.cpu_parent
                while p is not None:
                    chain.append(p.name)
                    p = p.cpu_parent
                key = f"{e.name} <- {' <- '.join(chain[:3])}"
                callers[key] = callers.get(key, 0) + 1
                # a sync inside the rounds (under an exsample.* range), not set-up
                if e.name == "cudaStreamSynchronize" and any(n.startswith("exsample.") for n in chain):
                    loop_syncs += 1
    launches = calls.get("cudaLaunchKernel", 0) + calls.get("cudaLaunchKernelExC", 0)
    print(f"  runtime calls: {calls} ({launches / max(frames, 1):.0f} launches per frame, "
          f"{launches / max(rounds, 1):.0f} per round; stream syncs inside the rounds: {loop_syncs}, "
          f"{loop_syncs / max(rounds, 1):.2f} per round; the rest are set-up)")
    for key, n in sorted(callers.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {n:>6}  {key}")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12))


# ------------------------------------------------------------ multi path

def run_multi(torch, setup, plan_dict, device, classes=MULTI_CLASSES, around=contextlib.nullcontext):
    """The multi kind as its CLI runs it: one class-agnostic oracle,
    ``class_select`` per query, keys ``fold_in(PRNGKey(0), q)``.  Returns
    as :func:`run_search` does."""
    from repro_torch.core import SearchPlan, init_carry_multi, init_matcher, init_state, prng
    from repro_torch.sim import class_select, generate, oracle_detect

    repo, chunks = generate(setup.repo, device=device)
    plan = SearchPlan.from_dict(plan_dict)
    key = prng.PRNGKey(0, device=device)
    carry = init_carry_multi(init_state(chunks.length, device=device),
                             init_matcher(max_results=MATCHER_CAPACITY, device=device),
                             torch.stack([prng.fold_in(key, q) for q in range(len(classes))]))

    def det(keys, frames):
        return oracle_detect(repo, frames, query_class=None)

    select = class_select(repo, classes)
    if device.type == "cuda":
        torch.cuda.synchronize()
    with around():
        t0 = time.perf_counter()
        res = plan.run(carry, chunks, detector=det, select=select)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return res, wall, chunks.num_chunks


def multi_path(torch, name, setup) -> dict:
    """The full-width multi-query search on the card, held exactly to the
    same search on the CPU; B2 must run once per round and the batched B3
    once per cohort slot."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    reset_launches()
    gpu, gpu_s, m = run_multi(torch, setup, MULTI_PLAN, cuda)
    launches = read_launches()
    ref, cpu_s, _ = run_multi(torch, setup, MULTI_PLAN, cpu)
    st = gpu.stats
    rounds, frames, cohorts = st.rounds, st.frames_sampled, MULTI_PLAN["cohorts"]
    for trace in gpu.traces:
        if not trace or any(s < 0 or r < 0 for s, r in trace):
            fail(f"{name}: malformed trace {trace}")
    if not all(math.isfinite(v) for v in gpu.carry.sampler.n1.reshape(-1).tolist()):
        fail(f"{name}: non-finite sampler state")
    if min(gpu.results) <= 0 or rounds <= 0 or st.cache_hits <= 0:
        fail(f"{name}: the search found too little ({gpu.results}, {st})")
    if frames != sum(gpu.steps) or st.detector_invocations > frames:
        fail(f"{name}: inconsistent accounting {st}")
    diffs = same_search(gpu, ref)
    if diffs:
        fail(f"{name}: card run != CPU run on {diffs}")
    if (launches["thompson_choose_batched"] != rounds
            or launches["iou_matrix_batched"] != rounds * cohorts
            or launches["thompson_choose"] or launches["iou_matrix"]):
        fail(f"{name}: launches {launches} != {rounds} rounds / {rounds * cohorts} cohort slots")
    print(f"  {name}: M={m} chunks, Q={len(MULTI_CLASSES)} classes {list(MULTI_CLASSES)}; results "
          f"{list(gpu.results)} in steps {list(gpu.steps)}; {rounds} rounds; card == CPU exactly "
          f"(steps, results, traces, stats, samplers, rings, keys, cache tag)")
    print(f"    card {frames / gpu_s:.1f} frames/s {rounds / gpu_s:.2f} rounds/s ({gpu_s:.2f} s); "
          f"CPU {frames / cpu_s:.1f} frames/s {rounds / cpu_s:.2f} rounds/s ({cpu_s:.2f} s); "
          f"{frames} frames sampled, {st.detector_invocations} detector invocations, "
          f"{st.cache_hits} cache hits (hit rate {st.cache_hit_rate:.4f}), "
          f"amortization {st.amortization:.4f}x; launches {launches}")
    return launches


def per_query_contract(torch, name, setup) -> None:
    """Each query of a multi run on the card equals its own solo scan run
    with ``filter_class`` over the same class-agnostic oracle."""
    from repro_torch.core import SearchPlan, init_carry, init_matcher, init_state, prng
    from repro_torch.sim import filter_class, generate, oracle_detect

    cuda = torch.device("cuda")
    plan = dict(MULTI_PLAN, max_steps=SOLO_CHECK_STEPS)
    multi, multi_s, _ = run_multi(torch, setup, plan, cuda)
    repo, chunks = generate(setup.repo, device=cuda)
    solo_plan = SearchPlan.from_dict(dict(
        result_limit=plan["result_limit"], max_steps=plan["max_steps"], cohorts=plan["cohorts"],
        method=plan["method"], trace_every=plan["trace_every"], execution=dict(strategy="scan")))
    solo_s = 0.0
    for q, cls in enumerate(MULTI_CLASSES):
        carry = init_carry(init_state(chunks.length, device=cuda),
                           init_matcher(max_results=MATCHER_CAPACITY, device=cuda),
                           prng.fold_in(prng.PRNGKey(0, device=cuda), q))
        t0 = time.perf_counter()
        solo = solo_plan.run(carry, chunks, detector=lambda k, f, c=cls: filter_class(
            repo, oracle_detect(repo, f, query_class=None), c))
        solo_s += time.perf_counter() - t0
        same = (solo.steps[0], solo.results[0], solo.trace) == (multi.steps[q], multi.results[q],
                                                                 multi.traces[q])
        pairs = [(getattr(solo.carry.sampler, f), getattr(multi.carry.sampler, f)[q]) for f in ("n1", "n")]
        pairs += [(getattr(solo.carry.matcher, f), getattr(multi.carry.matcher, f)[q])
                  for f in ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor",
                            "total_inserted")]
        pairs.append((solo.carry.key, multi.carry.key[q]))
        if not same or not all(bits_equal(a.cpu(), b.cpu()) for a, b in pairs):
            fail(f"{name}: query {q} (class {cls}) != its solo scan run")
    st = multi.stats
    print(f"  {name}: each of {len(MULTI_CLASSES)} queries == its solo scan run (steps "
          f"{list(multi.steps)}, results {list(multi.results)}); multi {multi_s:.2f} s with "
          f"{st.detector_invocations} detector invocations vs {sum(multi.steps)} frames over "
          f"8 solo runs in {solo_s:.2f} s")


def main() -> int:
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: FAIL: no repro_torch package under {SRC}", file=sys.stderr)
        return 2
    from repro_torch.configs.exsample_paper import bdd, dashcam
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device: {kind}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} kernels in parallel")
    for name, info in built.items():
        print(f"  {name}: {info['seconds']:.1f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")

    print("kernels vs plain versions on the card:")
    rows = check_kernels(torch)

    # warm the card's lazily loaded PyTorch kernels outside the timed runs
    run_search(torch, dashcam(scale=1.0), dict(MAIN_PLAN, max_steps=100), torch.device("cuda"))
    print("main path: scan search, full size, card vs CPU:")
    scan_launches = {}
    for name, setup in (("dashcam(scale=1.0)", dashcam(scale=1.0)), ("bdd(scale=1.0)", bdd(scale=1.0))):
        for k, v in main_path(torch, name, setup).items():
            scan_launches[k] = scan_launches.get(k, 0) + v

    host, host_s, _ = run_search(torch, dashcam(scale=1.0), HOST_CHECK_PLAN, torch.device("cuda"), "host")
    scan, scan_s, _ = run_search(torch, dashcam(scale=1.0), HOST_CHECK_PLAN, torch.device("cuda"), "scan")
    diffs = [d for d in same_search(host, scan) if d != "stats"]
    if diffs or host.stats.frames_sampled != scan.stats.frames_sampled:
        fail(f"host kind != scan kind on the card: {diffs}")
    print(f"  host == scan on the card ({host.steps[0]} frames, {host.results[0]} results; "
          f"host {host_s:.2f} s, scan {scan_s:.2f} s)")

    profile_plan = dict(MAIN_PLAN, max_steps=500)
    profile_path(torch, "bdd scan", lambda around: run_search(
        torch, bdd(scale=1.0), profile_plan, torch.device("cuda"), around=around)[:2], MAIN_PLAN["cohorts"])

    print("multi path: Q-axis multi-query search, full width, card vs CPU:")
    multi_launches = multi_path(torch, "bdd(scale=1.0) multi", bdd(scale=1.0))
    per_query_contract(torch, "dashcam(scale=1.0) multi", dashcam(scale=1.0))
    multi_profile = dict(MULTI_PLAN, max_steps=500)
    profile_path(torch, "bdd multi Q=8", lambda around: run_multi(
        torch, bdd(scale=1.0), multi_profile, torch.device("cuda"), around=around)[:2],
        MULTI_PLAN["cohorts"])

    summary = []
    for kname, key, src, replaces, launches in (
        ("thompson_choose", ("thompson_choose", 50, 1000), "src/repro_torch/csrc/thompson_choose.cu",
         "src/repro/kernels/thompson/kernel.py:73", scan_launches),
        ("thompson_choose_batched", ("thompson_choose_batched", 8, 50, 1000),
         "src/repro_torch/csrc/thompson_choose.cu", "src/repro/kernels/thompson/kernel.py:114",
         multi_launches),
        ("iou_matrix", ("iou_matrix", 16, 8192), "src/repro_torch/csrc/iou_matrix.cu",
         "src/repro/kernels/iou_match/kernel.py:37", scan_launches),
        ("iou_matrix_batched", ("iou_matrix_batched", 8, 16, 8192), "src/repro_torch/csrc/iou_matrix.cu",
         "src/repro/kernels/iou_match/kernel.py:37", multi_launches),
    ):
        row = rows[key]
        summary.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=launches[kname], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None, shape=row["shape"],
            call_ms=row["call_ms"], plain_call_ms=row["plain_call_ms"],
        ))
    print(json.dumps({"launches": {"scan": scan_launches, "multi": multi_launches}}))
    print(f"{smi}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
