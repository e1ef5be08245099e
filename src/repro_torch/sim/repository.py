"""Synthetic video repository (paper §3.3.2 with temporal locality).

Counterpart of ``repro.sim.repository``.  ``generate`` is the same numpy
program, draw for draw, so the two packages build identical arrays from
one seed; only the container differs (torch tensors on ``device``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.chunks import ChunkIndex, build_chunks
from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class Repository:
    """Dense ground truth for a synthetic repository (N instances)."""

    inst_video: torch.Tensor     # i32[N]
    inst_start: torch.Tensor     # i32[N]
    inst_end: torch.Tensor       # i32[N]  (exclusive)
    inst_box: torch.Tensor       # f32[N, 4]  box(t) = base + (t - start) * drift
    inst_drift: torch.Tensor     # f32[N, 4]
    inst_feat: torch.Tensor      # f32[N, F]
    inst_class: torch.Tensor     # i32[N]
    video_of_frame: torch.Tensor  # i32[T]
    total_frames: int = 0
    num_videos: int = 0

    @property
    def num_instances(self) -> int:
        return self.inst_video.shape[0]

    def to(self, device) -> "Repository":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


@dataclasses.dataclass(frozen=True)
class RepoSpec:
    """Generation parameters."""

    video_lengths: Sequence[int]
    num_instances: int = 500
    num_classes: int = 4
    duration_mu: float = 5.0
    duration_sigma: float = 1.5
    locality: float = 3.0
    feat_dim: int = 8
    chunk_frames: int = 54_000
    seed: int = 0


def generate(spec: RepoSpec, *, device: str | torch.device | None = None) -> tuple[Repository, ChunkIndex]:
    device = resolve(device)
    rng = np.random.default_rng(spec.seed)
    lengths = np.asarray(spec.video_lengths, np.int64)
    total = int(lengths.sum())
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    chunks = build_chunks(
        [int(l) for l in lengths], chunk_frames=spec.chunk_frames, seed=spec.seed, device="cpu"
    )
    c_start = chunks.start.numpy()
    c_len = chunks.length.numpy()
    M = len(c_start)

    if spec.locality > 0:
        alpha = np.full(M, 1.0 / spec.locality)
        intensity = rng.dirichlet(alpha)
    else:
        intensity = np.full(M, 1.0 / M)
    inst_chunk = rng.choice(M, size=spec.num_instances, p=intensity)

    dur = np.exp(rng.normal(spec.duration_mu, spec.duration_sigma, spec.num_instances))
    dur = np.clip(dur, 1, None).astype(np.int64)

    inst_start = np.empty(spec.num_instances, np.int64)
    inst_end = np.empty(spec.num_instances, np.int64)
    inst_video = np.empty(spec.num_instances, np.int64)
    vid_of_chunk = chunks.video_id.numpy()
    for i in range(spec.num_instances):
        c = inst_chunk[i]
        v = vid_of_chunk[c]
        vlo, vhi = starts[v], starts[v] + lengths[v]
        anchor = c_start[c] + rng.integers(0, c_len[c])
        s = max(vlo, anchor - dur[i] // 2)
        e = min(vhi, s + dur[i])
        inst_start[i], inst_end[i], inst_video[i] = s, e, v

    boxes = rng.uniform(0.05, 0.75, (spec.num_instances, 2))
    sizes = rng.uniform(0.05, 0.2, (spec.num_instances, 2))
    base = np.concatenate([boxes, boxes + sizes], axis=1).astype(np.float32)
    drift = rng.normal(0, 1e-4, (spec.num_instances, 4)).astype(np.float32)
    feats = rng.normal(0, 1, (spec.num_instances, spec.feat_dim)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    classes = rng.integers(0, spec.num_classes, spec.num_instances)

    video_of_frame = np.repeat(np.arange(len(lengths)), lengths)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype)).to(device)

    repo = Repository(
        inst_video=t(inst_video, np.int32),
        inst_start=t(inst_start, np.int32),
        inst_end=t(inst_end, np.int32),
        inst_box=t(base, np.float32),
        inst_drift=t(drift, np.float32),
        inst_feat=t(feats, np.float32),
        inst_class=t(classes, np.int32),
        video_of_frame=t(video_of_frame, np.int32),
        total_frames=total,
        num_videos=len(lengths),
    )
    return repo, chunks.to(device)


def instances_visible(repo: Repository, frame) -> torch.Tensor:
    """bool[N] — ground-truth visibility of each instance in ``frame``; a
    batch of frames ``[B]`` gives bool[B, N]."""
    frame = torch.as_tensor(frame, device=repo.inst_start.device)[..., None]
    return (repo.inst_start <= frame) & (frame < repo.inst_end)
