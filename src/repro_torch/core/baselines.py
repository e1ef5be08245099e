"""Baseline frame-selection policies (paper §2.3, §4); counterpart of
``repro.core.baselines``.

Every baseline shares ExSample's frame processing (detector, matcher,
sampler update: ``core.exsample._process_frame``, so each frame is one
launch of B3's fused ``match_update`` on the card) and differs only in
which frame comes next:

  * ``random``      — uniform with replacement over all frames.
  * ``randomplus``  — §3.7.2's stratified bit-reversal order over the
                      dataset, the denominator of every savings number.
  * ``sequential``  — frames in order (the naive full scan).
  * ``skip``        — sequential with a fixed stride.
  * ``greedy``      — argmax of the point estimate (N¹+α₀)/(n+β₀), no
                      Thompson noise.
  * ``surrogate``   — BlazeIt-style descending-score order; its preamble's
                      cost is priced in ``sim.costmodel``.

A scheduled frame picks its chunk; the frame processed is that chunk's
next random+ frame, as in the reference's ``fixed_frame_step``.  The
drivers are host loops that read the carry back every frame, as the
reference's are.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.chunks import ChunkIndex, global_randomplus_order
from repro_torch.core.exsample import DetectorFn, ExSampleCarry, _process_frame
from repro_torch.core.state import point_estimate


def _chunk_of_frame(chunks: ChunkIndex, frame: torch.Tensor) -> torch.Tensor:
    """The chunk (i32) holding global frame ``frame``: the last chunk whose
    start is at or before it."""
    frame = torch.as_tensor(frame, device=chunks.start.device).to(chunks.start.dtype)
    return (torch.searchsorted(chunks.start, frame.reshape(1), right=True).int() - 1).reshape(frame.shape)


def fixed_frame_step(carry: ExSampleCarry, chunks: ChunkIndex, frame_id: torch.Tensor, *,
                     detector: DetectorFn) -> ExSampleCarry:
    """Process one externally chosen frame (drives every static policy)."""
    key, k_det = prng.split(carry.key, 2)
    carry = dataclasses.replace(carry, key=key)
    return _process_frame(carry, chunks, detector, _chunk_of_frame(chunks, frame_id), k_det)


def greedy_step(carry: ExSampleCarry, chunks: ChunkIndex, *, detector: DetectorFn) -> ExSampleCarry:
    """Greedy point-estimate policy (ties to the lowest chunk id)."""
    key, k_det = prng.split(carry.key, 2)
    carry = dataclasses.replace(carry, key=key)
    chunk_id = torch.argmax(point_estimate(carry.sampler)).int()
    return _process_frame(carry, chunks, detector, chunk_id, k_det)


class FrameSchedule:
    """Host-side frame orders of the static policies (numpy, the
    reference's own generators)."""

    @staticmethod
    def random(total_frames: int, max_steps: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.integers(0, total_frames, size=max_steps, dtype=np.int64)

    @staticmethod
    def randomplus(total_frames: int, max_steps: int, seed: int = 0) -> np.ndarray:
        order = global_randomplus_order(total_frames, seed=seed)
        reps = int(np.ceil(max_steps / len(order)))
        return np.tile(order, reps)[:max_steps]

    @staticmethod
    def sequential(total_frames: int, max_steps: int, seed: int = 0) -> np.ndarray:
        return np.arange(max_steps, dtype=np.int64) % total_frames

    @staticmethod
    def skip(total_frames: int, max_steps: int, stride: int = 30, seed: int = 0) -> np.ndarray:
        return (np.arange(max_steps, dtype=np.int64) * stride) % total_frames


def _progress(carry: ExSampleCarry) -> tuple[int, int]:
    """(step, results), read back in one transfer."""
    step, results = torch.stack([carry.step, carry.results]).tolist()
    return step, results


def run_schedule(carry: ExSampleCarry, chunks: ChunkIndex, schedule: np.ndarray, *, detector: DetectorFn,
                 result_limit: int, trace_every: int = 0):
    """Drive a static policy until ``result_limit`` results or the end of
    the schedule.  Returns (final carry, trace of (step, results))."""
    trace = []
    frames = torch.as_tensor(np.asarray(schedule), dtype=torch.int32, device=carry.step.device)
    for i in range(frames.shape[0]):
        carry = fixed_frame_step(carry, chunks, frames[i], detector=detector)
        step, results = _progress(carry)
        if trace_every and step % trace_every == 0:
            trace.append((step, results))
        if results >= result_limit:
            break
    trace.append(_progress(carry))
    return carry, trace


def run_greedy(carry: ExSampleCarry, chunks: ChunkIndex, *, detector: DetectorFn, result_limit: int,
               max_steps: int, trace_every: int = 0):
    """Drive the greedy policy until ``result_limit`` results or
    ``max_steps`` frames.  Returns (final carry, trace)."""
    trace = []
    step, results = _progress(carry)
    while results < result_limit and step < max_steps:
        carry = greedy_step(carry, chunks, detector=detector)
        step, results = _progress(carry)
        if trace_every and step % trace_every == 0:
            trace.append((step, results))
    trace.append((step, results))
    return carry, trace


def surrogate_schedule(scores: np.ndarray, *, dedup_window: int = 0) -> np.ndarray:
    """BlazeIt-style descending-score order, with optional fixed-window
    suppression around taken frames (BlazeIt skips a window around a
    returned frame to avoid obvious duplicates); the suppressed frames
    follow, by score."""
    order = np.argsort(-scores, kind="stable")
    if dedup_window <= 1:
        return order.astype(np.int64)
    taken: list[int] = []
    blocked = np.zeros(len(scores), bool)
    for f in order:
        if not blocked[f]:
            taken.append(int(f))
            lo = max(0, f - dedup_window)
            hi = min(len(scores), f + dedup_window)
            blocked[lo:hi] = True
    taken_set = set(taken)
    rest = [int(f) for f in order if int(f) not in taken_set]
    return np.asarray(taken + rest, dtype=np.int64)
