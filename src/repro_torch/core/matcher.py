"""Detection matcher (paper §2.3, Algorithm 1 line 12).

Counterpart of ``repro.core.matcher``: a fixed-capacity ring of results,
matched by IoU plus same-video and temporal gating and, optionally,
appearance cosine similarity.  It yields d₀ (new results) and d₁ (results
seen for the second time), the only two numbers the sampler update
consumes.

The multi-query carry holds Q rings as one ``MatcherState`` with a
leading ``[Q]`` on every tensor (``init_matcher_multi``), and
``match_and_update`` folds one frame per query into all Q rings at once;
the single-query call is the same code without the leading axis.  The
D×R IoU matrix goes through ``kernels.iou_match`` (kernel B3 on CUDA, its
plain version on the CPU; one launch per call, batched over Q).  Every
other step is integer or boolean tensor code, so the rings' contents are
exact on either device.
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
    """Ring-buffer result memory (capacity R); Q rings carry a leading
    ``[Q]`` on every tensor."""

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
        return self.boxes.shape[-2]

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


def broadcast_leading(obj, num_queries: int):
    """``obj`` (a state dataclass) with every tensor repeated along a new
    leading ``[Q]`` axis; static fields pass through.  The layout of the
    multi-query carry."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).expand((num_queries,) + getattr(obj, f.name).shape).clone()
        for f in dataclasses.fields(obj) if isinstance(getattr(obj, f.name), torch.Tensor)
    })


def init_matcher_multi(num_queries: int, **kwargs) -> MatcherState:
    """Q independent result rings as one ``MatcherState`` with a leading
    ``[Q]``; the static thresholds are shared."""
    return broadcast_leading(init_matcher(**kwargs), num_queries)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix f32[D, R] for boxes a f32[D, 4], b f32[R, 4] (x0, y0, x1, y1);
    f32[Q, D, R] for a batch of Q pairs."""
    return _iou(a, b)


class MatchResult(NamedTuple):
    """Per frame; each field gains a leading ``[Q]`` in the batched call."""

    d0: torch.Tensor           # i32[] — detections matching nothing (new results)
    d1: torch.Tensor           # i32[] — results going from seen-once to seen-twice
    cross_chunk: torch.Tensor  # i32[] — of d1, first seen in another chunk (§3.4)
    cross_home: torch.Tensor   # i32[R] — home chunks to decrement (-1 = none)
    is_new: torch.Tensor       # bool[D]
    new_state: MatcherState


def _flat_slots(slot: torch.Tensor, cap: int) -> torch.Tensor:
    """Ring slots ``[..., D]`` (``cap`` = the pad row) as positions in the
    flattened padded rings ``[B·(cap+1)]``, each ring with its own pad row:
    the only repeated positions are pad rows, so no write's winner is left
    to the device's scatter order."""
    if slot.dim() == 1:
        return slot
    lead = slot.shape[:-1]
    base = torch.arange(slot[..., 0].numel(), device=slot.device).reshape(lead + (1,)) * (cap + 1)
    return (base + slot).reshape(-1)


def _put(mem: torch.Tensor, flat: torch.Tensor, values: torch.Tensor, nlead: int) -> torch.Tensor:
    """Scatter ``values`` (``[*lead, D, *tail]``) into rings ``mem``
    (``[*lead, R, *tail]``, ``nlead`` leading axes) at ``flat``
    (``_flat_slots``).  Each ring gets a pad row R that absorbs every
    non-new detection and is then dropped."""
    lead, r, tail = mem.shape[:nlead], mem.shape[nlead], mem.shape[nlead + 1:]
    pad = torch.zeros(lead + (1,) + tail, dtype=mem.dtype, device=mem.device)
    out = torch.cat([mem, pad], dim=nlead).reshape((-1,) + tail)
    out[flat] = values.to(mem.dtype).expand(lead + (values.shape[nlead],) + tail).reshape((-1,) + tail)
    return out.reshape(lead + (r + 1,) + tail).narrow(nlead, 0, r)


def match_and_update(
    state: MatcherState,
    boxes: torch.Tensor,     # f32[D, 4]   (f32[Q, D, 4])
    feats: torch.Tensor,     # f32[D, F]   (f32[Q, D, F])
    valid: torch.Tensor,     # bool[D]     (bool[Q, D])
    video_id,                # i[] — video of the frame (i[Q])
    frame_id,                # i[] — global frame id (i[Q])
    chunk_id,                # i[] — chunk the frame came from (i[Q])
) -> MatchResult:
    """Match one frame's detections against the ring and update it; with
    a leading ``[Q]`` on the state and every argument, one frame per query
    against that query's own ring.

    A detection matches entry r iff same video, |Δframe| ≤ time_gate,
    IoU ≥ iou_thresh (or cosine ≥ feat_thresh when enabled); ties go to
    the first entry.  Unmatched valid detections are inserted with
    times_seen = 1; matched entries have times_seen bumped.
    """
    cap = state.capacity
    dev = state.times_seen.device
    video_id, frame_id, chunk_id = (torch.as_tensor(v, device=dev) for v in (video_id, frame_id, chunk_id))
    occupied = state.times_seen > 0                                   # [..., R]
    iou = pairwise_iou(boxes, state.boxes)                            # [..., D, R]
    same_video = state.video[..., None, :] == video_id[..., None, None]
    in_gate = (state.frame[..., None, :].long() - frame_id[..., None, None]).abs() <= state.time_gate
    match_ok = iou >= state.iou_thresh
    score_val = iou
    if state.feat_thresh > -1.0:
        an = feats / torch.clamp_min(torch.linalg.vector_norm(feats, dim=-1, keepdim=True), 1e-9)
        bn = state.feats / torch.clamp_min(
            torch.linalg.vector_norm(state.feats, dim=-1, keepdim=True), 1e-9)
        sim = an @ bn.transpose(-1, -2)
        match_ok = match_ok | (sim >= state.feat_thresh)
        score_val = torch.maximum(iou, sim)
    eligible = occupied[..., None, :] & same_video & in_gate & match_ok
    scores = torch.where(eligible, score_val, torch.full_like(score_val, NEG))

    best = torch.argmax(scores, dim=-1)                               # first maximum, [..., D]
    has_match = (scores.gather(-1, best[..., None])[..., 0] > NEG / 2) & valid
    is_new = valid & ~has_match

    bump = torch.zeros_like(state.times_seen).scatter_add_(-1, best, has_match.int())
    new_seen = state.times_seen + torch.where(occupied, bump, torch.zeros_like(bump))
    went_twice = occupied & (state.times_seen == 1) & (new_seen >= 2)
    d1 = went_twice.sum(-1).int()
    crossed = went_twice & (state.chunk != chunk_id[..., None])
    cross_chunk = crossed.sum(-1).int()
    cross_home = torch.where(crossed, state.chunk, torch.full_like(state.chunk, -1))

    new_i = is_new.int()
    d0 = new_i.sum(-1).int()
    order = torch.cumsum(new_i, -1) - new_i
    slot = torch.where(is_new, torch.remainder(state.cursor[..., None] + order, cap),
                       torch.full_like(order, cap)).long()
    flat, nlead = _flat_slots(slot, cap), slot.dim() - 1

    def put(mem, values):
        return _put(mem, flat, values, nlead)

    def col(v):
        return v[..., None].expand(slot.shape)

    new_state = dataclasses.replace(
        state,
        boxes=put(state.boxes, boxes),
        feats=put(state.feats, feats),
        video=put(state.video, col(video_id)),
        frame=put(state.frame, col(frame_id)),
        chunk=put(state.chunk, col(chunk_id)),
        times_seen=put(new_seen, torch.ones_like(slot)),
        cursor=torch.remainder(state.cursor + d0, cap).int(),
        total_inserted=(state.total_inserted + d0).int(),
    )
    return MatchResult(d0=d0, d1=d1, cross_chunk=cross_chunk, cross_home=cross_home,
                       is_new=is_new, new_state=new_state)


def num_results(state: MatcherState) -> torch.Tensor:
    return (state.times_seen > 0).sum(-1).int()
