"""ExSample Algorithm 1 — single-step, batched-cohort and search drivers.

Counterpart of ``repro.core.exsample`` for the single-query drivers:

  * ``_host_search`` — the reference loop; reads the carry back every step.
  * ``_scan_search`` — the resident search.  JAX runs it as one
    ``lax.while_loop`` with a single host sync; here it is a Python loop
    over rounds whose exit test (results < limit, step < max_steps, some
    chunk not exhausted) is computed on the device and read back once per
    round.  That is one sync per round where JAX has one in total; the
    (step, results) trajectory, the trace and the final carry are the same.
    The step counter advances by ``cohorts`` every round, so trace
    checkpoints are decided on the host and their (step, results) pairs
    are written to a device buffer that is read once at the end.

Randomness follows the reference's key order exactly: each round splits
``carry.key`` into (key, k_choice, k_det); ``k_choice`` draws the cohort
normals and, for cohorts > 1, ``k_det`` splits into one key per frame.

Detector protocol: ``detector(key, frame_id) -> Detections``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch.core import prng, thompson
from repro_torch.core.chunks import ChunkIndex, randomplus_frame
from repro_torch.core.matcher import MatcherState, match_and_update
from repro_torch.core.state import SamplerState, apply_cross_chunk_decrement, apply_update

DetectorFn = Callable[[torch.Tensor, torch.Tensor], "Detections"]  # noqa: F821


@dataclasses.dataclass(frozen=True)
class ExSampleCarry:
    sampler: SamplerState
    matcher: MatcherState
    key: torch.Tensor          # int64[2] — two uint32 words
    step: torch.Tensor         # i32[] — frames processed
    results: torch.Tensor      # i32[] — distinct results found

    def to(self, device) -> "ExSampleCarry":
        return ExSampleCarry(
            sampler=self.sampler.to(device), matcher=self.matcher.to(device),
            key=self.key.to(device), step=self.step.to(device),
            results=self.results.to(device),
        )


def init_carry(sampler: SamplerState, matcher: MatcherState, key: torch.Tensor) -> ExSampleCarry:
    dev = sampler.n.device
    return ExSampleCarry(
        sampler=sampler, matcher=matcher, key=key.to(dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        results=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _process_frame(
    carry: ExSampleCarry,
    chunks: ChunkIndex,
    detector: DetectorFn,
    chunk_id: torch.Tensor,
    det_key: torch.Tensor,
) -> ExSampleCarry:
    """Algorithm 1 lines 9-16 for one frame of ``chunk_id``.  The
    ``exsample.*`` ranges name the layers in a torch.profiler trace."""
    with record_function("exsample.detect"):
        # torch.take keeps the 0-dim chunk id on the device (t[idx] would sync)
        rank = torch.take(carry.sampler.n, chunk_id.long()).long()
        frame_id = randomplus_frame(chunks, chunk_id, rank)
        video_id = torch.take(chunks.video_id, chunk_id.long())
        dets = detector(det_key, frame_id)
    with record_function("exsample.match"):
        m = match_and_update(carry.matcher, dets.boxes, dets.feats, dets.valid,
                             video_id, frame_id, chunk_id)
    with record_function("exsample.update"):
        sampler = apply_update(carry.sampler, chunk_id, m.d0, m.d1 - m.cross_chunk)
        valid_home = m.cross_home >= 0
        sampler = apply_cross_chunk_decrement(
            sampler,
            torch.where(valid_home, m.cross_home, torch.zeros_like(m.cross_home)),
            valid_home.to(sampler.n1.dtype),
        )
    return dataclasses.replace(
        carry, sampler=sampler, matcher=m.new_state,
        step=carry.step + 1, results=carry.results + m.d0,
    )


def exsample_step(
    carry: ExSampleCarry, chunks: ChunkIndex, *, detector: DetectorFn, method: str = "exact"
) -> ExSampleCarry:
    """One iteration of Algorithm 1 (choose → process → update)."""
    with record_function("exsample.choose"):
        key, k_choice, k_det = prng.split(carry.key, 3)
        carry = dataclasses.replace(carry, key=key)
        chunk_id = thompson.choose_chunks(k_choice, carry.sampler, cohorts=1, method=method)[0]
    return _process_frame(carry, chunks, detector, chunk_id, k_det)


def exsample_batch_step(
    carry: ExSampleCarry,
    chunks: ChunkIndex,
    *,
    detector: DetectorFn,
    cohorts: int,
    method: str = "exact",
) -> ExSampleCarry:
    """§3.7.1 batched execution: ``cohorts`` Thompson draws pick the round's
    frames, which the matcher folds in order."""
    with record_function("exsample.choose"):
        key, k_choice, k_det = prng.split(carry.key, 3)
        carry = dataclasses.replace(carry, key=key)
        chunk_ids = thompson.choose_chunks(k_choice, carry.sampler, cohorts=cohorts, method=method)
        det_keys = prng.split(k_det, cohorts)
    for i in range(cohorts):
        carry = _process_frame(carry, chunks, detector, chunk_ids[i], det_keys[i])
    return carry


def _step_fn(detector, cohorts, method):
    if cohorts == 1:
        return lambda c, chunks: exsample_step(c, chunks, detector=detector, method=method)
    return lambda c, chunks: exsample_batch_step(
        c, chunks, detector=detector, cohorts=cohorts, method=method)


def _host_search(
    carry: ExSampleCarry,
    chunks: ChunkIndex,
    *,
    detector: DetectorFn,
    result_limit: int,
    max_steps: int,
    cohorts: int = 1,
    method: str = "exact",
    trace_every: int = 0,
):
    """Reference driver: iterate until ``result_limit`` results,
    ``max_steps`` frames or exhaustion, reading the carry back every step.
    Returns (final_carry, trace) with trace a list of (frames, results)
    checkpoints on boundary crossings of ``trace_every`` plus a final one."""
    trace = []
    step_fn = _step_fn(detector, cohorts, method)
    while (
        int(carry.results) < result_limit
        and int(carry.step) < max_steps
        and not bool(torch.all(carry.sampler.exhausted()))
    ):
        prev_step = int(carry.step)
        carry = step_fn(carry, chunks)
        if trace_every and (int(carry.step) // trace_every) > (prev_step // trace_every):
            trace.append((int(carry.step), int(carry.results)))
    trace.append((int(carry.step), int(carry.results)))
    return carry, trace


def _scan_search(
    carry: ExSampleCarry,
    chunks: ChunkIndex,
    *,
    detector: DetectorFn,
    result_limit: int,
    max_steps: int,
    cohorts: int = 1,
    method: str = "exact",
    trace_every: int = 0,
):
    """Resident driver: the host driver's (step, results) trajectory and
    trace for the same key, with one exit-test sync per round and the trace
    read once at the end.  Returns (final_carry, trace)."""
    dev = carry.step.device
    # worst case one crossing per trace_every frames, the last round may
    # overshoot max_steps by cohorts-1, plus the unconditional final entry
    cap = (max_steps + cohorts - 1) // trace_every + 1 if trace_every else 1
    buf = torch.zeros((cap + 1, 2), dtype=torch.int32, device=dev)  # row cap: dropped writes
    n = 0
    step = int(carry.step)        # advances by exactly `cohorts` per round
    step_fn = _step_fn(detector, cohorts, method)
    limit = torch.tensor(result_limit, dtype=torch.int32, device=dev)

    def go(c: ExSampleCarry) -> torch.Tensor:
        return (c.results < limit) & (c.step < max_steps) & ~torch.all(c.sampler.exhausted())

    while True:
        with record_function("exsample.exit_test"):
            if not bool(go(carry)):   # the one device→host read per round
                break
        carry = step_fn(carry, chunks)
        prev, step = step, step + cohorts
        if trace_every and step // trace_every > prev // trace_every:
            buf[min(n, cap)] = torch.stack([carry.step, carry.results])
            n += 1
    buf[min(n, cap - 1)] = torch.stack([carry.step, carry.results])
    n = min(n + 1, cap)
    trace = [(int(s), int(r)) for s, r in buf[:n].tolist()]
    return carry, trace
