"""Query-cost model (paper §4.6, Fig. 6): the part of ``repro.sim.costmodel``
that prices a pure sampling search (ExSample, random+), which the
single-query CLI reports.  Surrogate, full-scan and service-budget pricing
come with the slices that use them.

A sampled frame costs one random-access decode plus one detector run, at
configurable per-worker rates (the paper's reported rates by default).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CostRates:
    """Per-frame processing rates (frames/second/worker)."""

    detect_fps: float = 10.0          # full model (Faster-RCNN class)
    surrogate_fps: float = 1000.0     # cheap scorer, compute only
    scan_fps: float = 100.0           # sequential I/O + decode bound
    random_read_fps: float = 50.0     # keyframe-seek random decode
    train_examples_per_s: float = 2000.0
    workers: int = 1

    @staticmethod
    def from_backbone(flops_per_frame: float, *, peak_flops: float = 197e12,
                      mfu: float = 0.4, workers: int = 1,
                      surrogate_flops_per_frame: Optional[float] = None) -> "CostRates":
        """Derive detector/surrogate fps from model FLOPs at an assumed MFU."""
        detect = peak_flops * mfu / max(flops_per_frame, 1.0)
        sur = (
            peak_flops * mfu / max(surrogate_flops_per_frame, 1.0)
            if surrogate_flops_per_frame
            else 1000.0
        )
        return CostRates(detect_fps=detect, surrogate_fps=sur, workers=workers)


@dataclasses.dataclass(frozen=True)
class PhaseCosts:
    label_s: float = 0.0
    train_s: float = 0.0
    score_s: float = 0.0
    sample_s: float = 0.0

    @property
    def total_s(self) -> float:
        return self.label_s + self.train_s + self.score_s + self.sample_s

    @property
    def fixed_s(self) -> float:
        """Up-front cost paid before the first result can be returned."""
        return self.label_s + self.train_s + self.score_s


def sampling_cost(frames_processed: int, rates: CostRates) -> PhaseCosts:
    """Cost of a pure sampling policy (ExSample, random+, greedy):
    random-access decode + full-model inference per processed frame."""
    per_frame = 1.0 / rates.detect_fps + 1.0 / rates.random_read_fps
    return PhaseCosts(sample_s=frames_processed * per_frame / rates.workers)
