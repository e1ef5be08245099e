"""The paper's own evaluation setup (§4), as a selectable config.

Counterpart of ``repro.configs.exsample_paper``, field for field.
Dashcam-scale: 10 h of 30 fps video (1.08 M frames) in variable-length
drives, ≤30-minute chunks; plus the BDD-style variant of 1000 × 40 s clips
(one chunk per clip).
"""
from __future__ import annotations

import dataclasses

from repro_torch.sim.repository import RepoSpec


@dataclasses.dataclass(frozen=True)
class PaperSetup:
    repo: RepoSpec
    result_limits: tuple = (0.1, 0.5, 0.9)
    num_classes: int = 8
    cohorts: int = 50


def dashcam(seed: int = 0, scale: float = 1.0) -> PaperSetup:
    """~10 h across 8 drives of 20 min – 3 h (scaled); the chunk count
    (~20) is kept at any scale."""
    minutes = [20, 45, 60, 90, 120, 60, 45, 160]
    lengths = [int(m * 60 * 30 * scale) for m in minutes]
    return PaperSetup(
        repo=RepoSpec(
            video_lengths=lengths,
            num_instances=int(4000 * scale),
            num_classes=8,
            duration_mu=4.5 + (0 if scale >= 1 else -1.0),
            duration_sigma=1.6,
            locality=3.0,
            chunk_frames=max(int(54_000 * scale), 1_000),
            seed=seed,
        )
    )


def bdd(seed: int = 0, scale: float = 1.0) -> PaperSetup:
    """1000 × 40 s clips; chunk = clip (short chunks, many of them)."""
    n_clips = int(1000 * scale)
    return PaperSetup(
        repo=RepoSpec(
            video_lengths=[40 * 30] * n_clips,
            num_instances=int(3000 * scale),
            num_classes=8,
            duration_mu=3.5,
            duration_sigma=1.3,
            locality=2.0,
            chunk_frames=40 * 30,
            seed=seed,
        )
    )
