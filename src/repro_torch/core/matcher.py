"""Detection matcher (paper §2.3, Algorithm 1 line 12).

Counterpart of ``repro.core.matcher``: a fixed-capacity ring of results,
matched by IoU plus same-video and temporal gating and, optionally,
appearance cosine similarity.  It yields d₀ (new results) and d₁ (results
seen for the second time), the only two numbers the sampler update
consumes.

The multi-query carry holds Q rings as one ``MatcherState`` with a
leading ``[Q]`` on every tensor (``init_matcher_multi``), and
``match_and_update`` folds one frame per query into all Q rings at once;
the single-query call is the same code without the leading axis.

The step goes through ``kernels.iou_match``, chosen on the static
``feat_thresh``:
- IoU only (``feat_thresh`` = -1, every entry point's matcher): the whole
  step is ``match_update``, on CUDA one fused launch of kernel B3 (IoU,
  gating, first-max argmax, counts and ring insert, batched over Q), on
  the CPU its plain version ``match_update_ref``.
- With the appearance cosine (``feat_thresh`` > -1, which no plan, CLI or
  config sets): ``match_update_ref`` op by op on either device, its D×R
  IoU matrix through ``pairwise_iou`` (B3's ``iou_matrix`` on CUDA).
The IoU's arithmetic is the same on both paths and devices, and every
other step is integer or boolean, so the rings' contents are exact.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve
from repro_torch.kernels.iou_match.ops import iou as _iou
from repro_torch.kernels.iou_match.ops import match_update
from repro_torch.kernels.iou_match.ref import MatchResult, match_update_ref


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
    if state.feat_thresh > -1.0:
        return match_update_ref(state, boxes, feats, valid, video_id, frame_id, chunk_id, iou=pairwise_iou)
    return match_update(state, boxes, feats, valid, video_id, frame_id, chunk_id)


def num_results(state: MatcherState) -> torch.Tensor:
    return (state.times_seen > 0).sum(-1).int()
