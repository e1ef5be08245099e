"""Detection matcher (paper §2.3, Algorithm 1 line 12).

Counterpart of ``repro.core.matcher`` for the single-query path: a
fixed-capacity ring of results, matched by IoU plus same-video and
temporal gating and, optionally, appearance cosine similarity.  It yields
d₀ (new results) and d₁ (results seen for the second time), the only two
numbers the sampler update consumes.

The D×R IoU matrix goes through ``kernels.iou_match`` (kernel B3 on CUDA,
its plain version on the CPU).  Every other step is integer or boolean
tensor code, so the ring's contents are exact on either device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.device import resolve
from repro_torch.kernels.iou_match.ops import iou as _iou

NEG = -1e9


@dataclasses.dataclass(frozen=True)
class MatcherState:
    """Ring-buffer result memory (capacity R)."""

    boxes: torch.Tensor        # f32[R, 4] — box of first sighting
    feats: torch.Tensor        # f32[R, F]
    video: torch.Tensor        # i32[R]
    frame: torch.Tensor        # i32[R]
    chunk: torch.Tensor        # i32[R] — chunk of first sighting (§3.4)
    times_seen: torch.Tensor   # i32[R] — 0 = empty slot
    cursor: torch.Tensor       # i32[] — ring insert position
    total_inserted: torch.Tensor  # i32[] — monotone insertion count
    iou_thresh: float = 0.5
    time_gate: int = 900
    feat_thresh: float = -1.0

    @property
    def capacity(self) -> int:
        return self.boxes.shape[0]

    def to(self, device) -> "MatcherState":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def init_matcher(
    *,
    max_results: int,
    feat_dim: int = 8,
    iou_thresh: float = 0.5,
    time_gate: int = 900,
    feat_thresh: float = -1.0,
    device: str | torch.device | None = None,
) -> MatcherState:
    device = resolve(device)
    i32 = dict(dtype=torch.int32, device=device)
    return MatcherState(
        boxes=torch.zeros((max_results, 4), dtype=torch.float32, device=device),
        feats=torch.zeros((max_results, feat_dim), dtype=torch.float32, device=device),
        video=torch.full((max_results,), -1, **i32),
        frame=torch.full((max_results,), -(10**9), **i32),
        chunk=torch.full((max_results,), -1, **i32),
        times_seen=torch.zeros((max_results,), **i32),
        cursor=torch.zeros((), **i32),
        total_inserted=torch.zeros((), **i32),
        iou_thresh=iou_thresh,
        time_gate=time_gate,
        feat_thresh=feat_thresh,
    )


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix f32[D, R] for boxes a f32[D, 4], b f32[R, 4] (x0, y0, x1, y1)."""
    return _iou(a, b)


class MatchResult(NamedTuple):
    d0: torch.Tensor           # i32[] — detections matching nothing (new results)
    d1: torch.Tensor           # i32[] — results going from seen-once to seen-twice
    cross_chunk: torch.Tensor  # i32[] — of d1, first seen in another chunk (§3.4)
    cross_home: torch.Tensor   # i32[R] — home chunks to decrement (-1 = none)
    is_new: torch.Tensor       # bool[D]
    new_state: MatcherState


def _put(mem: torch.Tensor, slot: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Scatter ``values`` into ``mem`` at ``slot``; slot == R is a pad row
    that absorbs every non-new detection and is then dropped, so its
    duplicate writes are harmless."""
    pad = torch.zeros((1,) + tuple(mem.shape[1:]), dtype=mem.dtype, device=mem.device)
    out = torch.cat([mem, pad])
    out[slot] = values.to(mem.dtype)
    return out[:-1]


def match_and_update(
    state: MatcherState,
    boxes: torch.Tensor,     # f32[D, 4]
    feats: torch.Tensor,     # f32[D, F]
    valid: torch.Tensor,     # bool[D]
    video_id,                # i[] — video of the frame
    frame_id,                # i[] — global frame id
    chunk_id,                # i[] — chunk the frame came from
) -> MatchResult:
    """Match one frame's detections against the ring and update it.

    A detection matches entry r iff same video, |Δframe| ≤ time_gate,
    IoU ≥ iou_thresh (or cosine ≥ feat_thresh when enabled); ties go to
    the first entry.  Unmatched valid detections are inserted with
    times_seen = 1; matched entries have times_seen bumped.
    """
    cap = state.capacity
    occupied = state.times_seen > 0
    iou = pairwise_iou(boxes, state.boxes)
    same_video = state.video[None, :] == video_id
    in_gate = (state.frame[None, :].long() - frame_id).abs() <= state.time_gate
    match_ok = iou >= state.iou_thresh
    score_val = iou
    if state.feat_thresh > -1.0:
        an = feats / torch.clamp_min(torch.linalg.vector_norm(feats, dim=-1, keepdim=True), 1e-9)
        bn = state.feats / torch.clamp_min(
            torch.linalg.vector_norm(state.feats, dim=-1, keepdim=True), 1e-9)
        sim = an @ bn.T
        match_ok = match_ok | (sim >= state.feat_thresh)
        score_val = torch.maximum(iou, sim)
    eligible = occupied[None, :] & same_video & in_gate & match_ok
    scores = torch.where(eligible, score_val, torch.full_like(score_val, NEG))

    best = torch.argmax(scores, dim=-1)                        # first maximum
    has_match = (scores.gather(1, best[:, None])[:, 0] > NEG / 2) & valid
    is_new = valid & ~has_match

    bump = torch.zeros((cap,), dtype=torch.int32, device=iou.device)
    bump.index_add_(0, best, has_match.int())
    new_seen = state.times_seen + torch.where(occupied, bump, torch.zeros_like(bump))
    went_twice = occupied & (state.times_seen == 1) & (new_seen >= 2)
    d1 = went_twice.sum().int()
    crossed = went_twice & (state.chunk != chunk_id)
    cross_chunk = crossed.sum().int()
    cross_home = torch.where(crossed, state.chunk, torch.full_like(state.chunk, -1))

    new_i = is_new.int()
    d0 = new_i.sum().int()
    order = torch.cumsum(new_i, 0) - new_i
    slot = torch.where(is_new, torch.remainder(state.cursor + order, cap),
                       torch.full_like(order, cap)).long()
    n_det = slot.shape[0]

    def col(v):
        return torch.as_tensor(v, device=iou.device).expand(n_det)

    new_state = dataclasses.replace(
        state,
        boxes=_put(state.boxes, slot, boxes),
        feats=_put(state.feats, slot, feats),
        video=_put(state.video, slot, col(video_id)),
        frame=_put(state.frame, slot, col(frame_id)),
        chunk=_put(state.chunk, slot, col(chunk_id)),
        times_seen=_put(new_seen, slot, torch.ones_like(slot)),
        cursor=torch.remainder(state.cursor + d0, cap).int(),
        total_inserted=(state.total_inserted + d0).int(),
    )
    return MatchResult(d0=d0, d1=d1, cross_chunk=cross_chunk, cross_home=cross_home,
                       is_new=is_new, new_state=new_state)


def num_results(state: MatcherState) -> torch.Tensor:
    return (state.times_seen > 0).sum().int()
