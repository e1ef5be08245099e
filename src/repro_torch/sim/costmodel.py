"""Query-cost model (paper §4.6, Fig. 6); counterpart of
``repro.sim.costmodel``.

ExSample's metric is frames processed, but the paper's wall-clock
comparison with surrogate systems rests on the phases each plan pays:
labelling (detector-bound), training the surrogate, scoring every frame
(scan-bound) and sampling (detector-bound, the only phase ExSample and
random+ pay).  This module prices a plan at configurable per-worker rates
(the paper's reported rates by default), and keeps the service's
admission ledger (``plan_projected_cost``, ``CostBudget``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


# NVIDIA H100 SXM's dense bf16 tensor-core peak (data sheet), the card the
# port runs on: the default rate of a backbone detector
H100_BF16_FLOPS = 989e12


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
    def from_backbone(flops_per_frame: float, *, peak_flops: float = H100_BF16_FLOPS,
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


def surrogate_cost(
    frames_processed: int,
    total_frames: int,
    *,
    rates: CostRates,
    label_fraction: float = 0.01,
    train_epochs: float = 2.0,
) -> PhaseCosts:
    """BlazeIt-style plan: label a fraction with the full model, fit the
    surrogate, score EVERY frame (scan-bound), then sample by score."""
    labeled = total_frames * label_fraction
    label_s = labeled * (1.0 / rates.detect_fps + 1.0 / rates.scan_fps)
    train_s = labeled * train_epochs / rates.train_examples_per_s
    # scoring is a full sequential scan; throughput min(scan, surrogate)
    score_fps = min(rates.scan_fps, rates.surrogate_fps)
    score_s = total_frames / score_fps
    sample = sampling_cost(frames_processed, rates).sample_s
    return PhaseCosts(
        label_s=label_s / rates.workers,
        train_s=train_s / rates.workers,
        score_s=score_s / rates.workers,
        sample_s=sample,
    )


def full_scan_cost(total_frames: int, rates: CostRates) -> PhaseCosts:
    """Naive plan: run the detector on every frame sequentially."""
    per_frame = 1.0 / rates.detect_fps + 1.0 / rates.scan_fps
    return PhaseCosts(sample_s=total_frames * per_frame / rates.workers)


# ---------------------------------------------------------------------------
# Service-side budget accounting (DESIGN.md §12)
# ---------------------------------------------------------------------------


def plan_projected_cost(
    plan,
    rates: CostRates,
    *,
    index=None,
    total_frames: Optional[int] = None,
) -> PhaseCosts:
    """Conservative admission-time price of a :class:`SearchPlan`: every
    query runs its full ``max_steps`` frame budget as a pure sampling
    policy.  An upper bound by construction — queries that hit their
    result limit early, and frames served from the detection cache, only
    make the realized cost cheaper — so pricing it BEFORE admission is
    race-free: the service debits the projection and credits the unspent
    remainder at retirement.

    When the plan binds an ``IndexSpec`` and the
    caller passes the live ``index`` (anything with ``entries(version)``) plus the repository ``total_frames``,
    the detector component is discounted by the index's measured coverage
    for the plan's declared ``detector_version`` — a fully-persisted warm
    replay needs ~0 fresh detector calls, and pricing it cold rejects
    plans that cost nearly nothing.  Still an upper bound: coverage is a
    frame-population fraction (sampling without the exact hit set can only
    do better on average than the uniform discount assumes is certain),
    and the projection is clamped to ≥ the scan-only cost — every sampled
    frame pays its random-access read even when its detection replays."""
    frames = plan.queries * plan.max_steps
    cold = sampling_cost(frames, rates)
    spec = getattr(plan.execution, "index", None)
    if index is None or spec is None or not total_frames:
        return cold
    coverage = min(
        1.0, index.entries(spec.detector_version) / float(total_frames)
    )
    if coverage <= 0.0:
        return cold
    detect_s = frames * (1.0 - coverage) / rates.detect_fps
    scan_only_s = frames / rates.random_read_fps
    sample_s = max(detect_s + scan_only_s, scan_only_s) / rates.workers
    return PhaseCosts(sample_s=min(sample_s, cold.sample_s))


@dataclasses.dataclass
class CostBudget:
    """Admission-controlled spend ledger for the search service.

    ``total_s`` is the wall-clock (priced, not measured) budget the
    operator grants; ``committed_s`` holds projections of admitted,
    still-running plans; ``spent_s`` holds settled actuals.  ``debit``
    reserves a projection atomically-enough for the service's single
    admission thread; ``settle`` converts a reservation into its realized
    cost, crediting the difference back to headroom."""

    total_s: float
    committed_s: float = 0.0
    spent_s: float = 0.0

    @property
    def remaining_s(self) -> float:
        return self.total_s - self.committed_s - self.spent_s

    def admits(self, projected_s: float) -> bool:
        return projected_s <= self.remaining_s

    def debit(self, projected_s: float) -> bool:
        """Reserve ``projected_s`` of headroom; False (no state change)
        when the projection does not fit."""
        if not self.admits(projected_s):
            return False
        self.committed_s += projected_s
        return True

    def settle(self, projected_s: float, actual_s: float) -> None:
        """Release the ``projected_s`` reservation and record the realized
        ``actual_s`` spend (the projection is an upper bound, so settling
        normally credits headroom back).

        Hardened against ledger corruption: settling more than is
        committed (a double-``settle`` of the same tenant, or a credit
        that was never debited) would silently mint headroom —
        ``remaining_s`` grows past what the operator granted and later
        admissions overrun the budget.  Such a call raises instead of
        corrupting the ledger, as do negative amounts."""
        if projected_s < 0 or actual_s < 0:
            raise ValueError(
                f"settle amounts must be non-negative; got "
                f"projected_s={projected_s!r}, actual_s={actual_s!r}")
        if projected_s > self.committed_s + 1e-9:
            raise ValueError(
                f"settle({projected_s:.3f}s) exceeds the committed "
                f"reservation {self.committed_s:.3f}s — double-settle or "
                "never-debited credit would mint budget headroom")
        self.committed_s = max(0.0, self.committed_s - projected_s)
        self.spent_s += actual_s
