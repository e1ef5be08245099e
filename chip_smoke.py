"""Chip smoke for repro_torch: build the CUDA kernels, check each against its
plain PyTorch version on the card, drive the full-size scan search on the
card and hold it against the same search on the CPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout's ``src/``.  Exits non-zero on
any failure (no card, build error, kernel mismatch, search mismatch).  The
last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the per-kernel JSON summary and, before that, the
card's name and power limit as nvidia-smi reports them.
"""
from __future__ import annotations

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
    return rows


# ------------------------------------------------------------- main path

def run_search(torch, setup, plan_dict, device, kind="scan"):
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
    t0 = time.perf_counter()
    res = plan.run(carry, chunks, detector=det)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0, chunks.num_chunks


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
    pairs += [("key", a.carry.key, b.carry.key), ("step", a.carry.step, b.carry.step)]
    for name, x, y in pairs:
        if not bits_equal(x.cpu(), y.cpu()):
            diffs.append(name)
    return diffs


def main_path(torch, name, setup) -> dict:
    from repro_torch.kernels.iou_match.kernel import iou_matrix
    from repro_torch.kernels.thompson.kernel import thompson_choose

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    thompson_choose.launches = 0
    iou_matrix.launches = 0
    gpu, gpu_s, m = run_search(torch, setup, MAIN_PLAN, cuda)
    launches = {"thompson_choose": thompson_choose.launches, "iou_matrix": iou_matrix.launches}
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
    if launches["thompson_choose"] != rounds or launches["iou_matrix"] != frames:
        fail(f"{name}: launches {launches} != rounds {rounds} / frames {frames}")
    print(f"  {name}: M={m} chunks, {gpu.results[0]} results in {frames} frames / {rounds} rounds; "
          f"card == CPU exactly; card {frames / gpu_s:.1f} frames/s {rounds / gpu_s:.2f} rounds/s "
          f"({gpu_s:.2f} s), CPU {frames / cpu_s:.1f} frames/s {rounds / cpu_s:.2f} rounds/s "
          f"({cpu_s:.2f} s); launches {launches}")
    return launches


def profile_main_path(torch, setup) -> None:
    """Where the time goes: torch.profiler over a short bdd scan search on
    the card, by driver layer (the ``exsample.*`` ranges), with the device's
    busy time and the host syncs."""
    from torch.profiler import ProfilerActivity, profile

    plan = dict(MAIN_PLAN, max_steps=500)
    run_search(torch, setup, plan, torch.device("cuda"))      # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res, wall, _ = run_search(torch, setup, plan, torch.device("cuda"))
    frames = res.steps[0]
    busy_us = sum(e.time_range.elapsed_us() for e in device_events(prof))
    print(f"profile: bdd scan, {frames} frames / {frames // plan['cohorts']} rounds in {wall:.3f} s "
          f"({frames / wall:.1f} frames/s under the profiler); device busy {busy_us / 1e3:.1f} ms "
          f"= {100 * busy_us / 1e6 / wall:.1f}% of wall, idle {100 - 100 * busy_us / 1e6 / wall:.1f}%")
    from torch.autograd import DeviceType

    ranges = {}
    for e in prof.events():
        if e.name.startswith("exsample.") and e.device_type == DeviceType.CPU:
            r = ranges.setdefault(e.name, [0, 0.0, 0.0])
            r[0] += 1
            r[1] += e.cpu_time_total
            r[2] += e.device_time_total
    for name, (count, cpu_us, dev_us) in sorted(ranges.items(), key=lambda kv: -kv[1][1]):
        print(f"  {name:<20} {count:>6} calls  host {cpu_us / 1e3:9.1f} ms "
              f"({100 * cpu_us / 1e6 / wall:5.1f}% of wall)  device {dev_us / 1e3:8.2f} ms")
    calls, callers = {}, {}
    for e in prof.events():
        if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync",
                      "cudaLaunchKernel", "cudaLaunchKernelExC"):
            calls[e.name] = calls.get(e.name, 0) + 1
            if e.name != "cudaLaunchKernel":
                chain, p = [], e.cpu_parent
                while p is not None and len(chain) < 3:
                    chain.append(p.name)
                    p = p.cpu_parent
                key = f"{e.name} <- {' <- '.join(chain)}"
                callers[key] = callers.get(key, 0) + 1
    print(f"  runtime calls: {calls} ({calls.get('cudaLaunchKernel', 0) / max(frames, 1):.0f} launches per frame)")
    for key, n in sorted(callers.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {n:>6}  {key}")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12))


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
    launches = {"thompson_choose": 0, "iou_matrix": 0}
    for name, setup in (("dashcam(scale=1.0)", dashcam(scale=1.0)), ("bdd(scale=1.0)", bdd(scale=1.0))):
        for k, v in main_path(torch, name, setup).items():
            launches[k] += v

    host, host_s, _ = run_search(torch, dashcam(scale=1.0), HOST_CHECK_PLAN, torch.device("cuda"), "host")
    scan, scan_s, _ = run_search(torch, dashcam(scale=1.0), HOST_CHECK_PLAN, torch.device("cuda"), "scan")
    diffs = [d for d in same_search(host, scan) if d != "stats"]
    if diffs or host.stats.frames_sampled != scan.stats.frames_sampled:
        fail(f"host kind != scan kind on the card: {diffs}")
    print(f"  host == scan on the card ({host.steps[0]} frames, {host.results[0]} results; "
          f"host {host_s:.2f} s, scan {scan_s:.2f} s)")

    profile_main_path(torch, bdd(scale=1.0))

    summary = []
    for kname, key, src, replaces in (
        ("thompson_choose", ("thompson_choose", 50, 1000), "src/repro_torch/csrc/thompson_choose.cu",
         "src/repro/kernels/thompson/kernel.py:73"),
        ("iou_matrix", ("iou_matrix", 16, 8192), "src/repro_torch/csrc/iou_matrix.cu",
         "src/repro/kernels/iou_match/kernel.py:37"),
    ):
        row = rows[key]
        summary.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=launches[kname], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None, shape=row["shape"],
            call_ms=row["call_ms"], plain_call_ms=row["plain_call_ms"],
        ))
    print(json.dumps({"launches": launches}))
    print(f"{smi}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
