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

The merge (``merge_matcher``, ``merge_stats``, ``eviction_mask`` and the
host-side ``ResultLog``) folds a worker's ring into a shared one, for the
async runtime; like the step it takes one ring or Q rings with a leading
``[Q]``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
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


# ---------------------------------------------------------------------------
# The merge of a worker's ring into a shared one (async runtime)
# ---------------------------------------------------------------------------

class MergeStats(NamedTuple):
    """Ring-pressure diagnostics of one ``merge_matcher`` application."""

    inserted: torch.Tensor   # i32[] — true insertions src made since snap
    overflow: torch.Tensor   # bool[] — inserted ≥ capacity: src's ring wrapped
    #                          and dropped entries the merge cannot recover
    clobbered: torch.Tensor  # i32[] — live dst entries this merge overwrites


def _ring_window(dst: MatcherState, n_new: torch.Tensor) -> torch.Tensor:
    """bool[..., R]: the slots ``[dst.cursor, dst.cursor + n_new) mod R``."""
    cap = dst.capacity
    idx = torch.arange(cap, dtype=torch.int32, device=dst.cursor.device)
    return (idx - dst.cursor[..., None]) % cap < n_new[..., None]


def merge_stats(dst: MatcherState, src: MatcherState, snap: MatcherState) -> MergeStats:
    """``merge_matcher`` assumes fewer insertions a merge than the capacity:
    the cursor delta it appends from is taken mod capacity.  The monotone
    ``total_inserted`` makes the true count observable, so a caller can
    flag an overflow instead of losing ``capacity·k`` entries."""
    cap = dst.capacity
    inserted = src.total_inserted - snap.total_inserted
    hit = _ring_window(dst, inserted % cap)
    clobbered = (hit & (dst.times_seen > 0)).sum(-1).int()
    return MergeStats(inserted=inserted, overflow=inserted >= cap, clobbered=clobbered)


def eviction_mask(dst: MatcherState, n_new) -> torch.Tensor:
    """bool[R]: the live ``dst`` entries that appending ``n_new`` insertions
    at ``dst.cursor`` overwrites, the entries ``merge_stats.clobbered``
    counts.  A caller spills them to a ``ResultLog`` before the merge
    lands, so a fixed ring holds an unbounded result set (while one merge
    window inserts fewer than R entries)."""
    n_new = torch.as_tensor(n_new, dtype=torch.int32, device=dst.cursor.device)
    return _ring_window(dst, torch.clamp_max(n_new, dst.capacity)) & (dst.times_seen > 0)


class ResultLog:
    """Append-only host-side log of results evicted from a device ring.

    The ring is a recent window; entries pushed out by new insertions
    drain here at merge boundaries (``spill``), so a long search's
    distinct results are the ring's live entries plus the log.  numpy on
    the host: spills happen between device calls."""

    _FIELDS = ("boxes", "feats", "video", "frame", "chunk", "times_seen")

    def __init__(self):
        self._chunks: list[dict] = []
        self.count = 0

    def __len__(self) -> int:
        return self.count

    def spill(self, matcher: MatcherState, mask) -> int:
        """Append ``matcher``'s entries selected by ``mask`` (bool[R]);
        returns how many were spilled."""
        mask_np = _host(mask)
        k = int(mask_np.sum())
        if k:
            self._chunks.append({f: _host(getattr(matcher, f))[mask_np] for f in self._FIELDS})
            self.count += k
        return k

    def as_arrays(self) -> dict:
        """The whole log as one dict of concatenated numpy arrays."""
        if not self._chunks:
            return {
                "boxes": np.zeros((0, 4), np.float32),
                "feats": np.zeros((0, 0), np.float32),
                "video": np.zeros((0,), np.int32),
                "frame": np.zeros((0,), np.int32),
                "chunk": np.zeros((0,), np.int32),
                "times_seen": np.zeros((0,), np.int32),
            }
        return {f: np.concatenate([c[f] for c in self._chunks]) for f in self._FIELDS}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ring_axis_index(slot: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``slot`` (int[..., R]) shaped to gather or scatter along the ring
    axis of ``x`` (f[..., R, *rest])."""
    rest = x.shape[slot.dim():]
    return slot.long().reshape(slot.shape + (1,) * len(rest)).expand(slot.shape + rest)


def merge_matcher(dst: MatcherState, src: MatcherState, snap: MatcherState) -> MatcherState:
    """Merge a worker's ring ``src`` into the shared ``dst``, both diverged
    from the snapshot ``snap`` (async runtime).

    * The entries ``src`` inserted since the snapshot (ring slots
      ``[snap.cursor, src.cursor)``) are appended at ``dst.cursor``: no
      worker's insertions are lost.
    * ``times_seen`` bumps to entries that existed at the snapshot are
      added, only where ``dst`` still holds the snapshot's entry (the same
      (video, frame) of first sighting): commutative, and exact in the
      sequential case.

    Two overlapping workers can both insert the same object (the
    at-most-once-effect tolerance).  Assumes fewer insertions a merge
    than the capacity, which ``merge_stats`` checks.  Appends past the
    window go to a spare row that is then cut off (the reference's
    ``mode="drop"``)."""
    cap = dst.capacity
    dev = dst.cursor.device
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    n_new = ((src.cursor - snap.cursor) % cap)[..., None]
    src_slot = (snap.cursor[..., None] + idx) % cap
    valid = idx < n_new
    dst_slot = torch.where(valid, (dst.cursor[..., None] + idx) % cap, torch.full_like(src_slot, cap))

    # additive seen-count bumps for the entries that existed at the snapshot
    src_inserted = torch.zeros_like(valid).scatter(-1, src_slot.long(), valid)
    same_as_snap = (dst.video == snap.video) & (dst.frame == snap.frame) & (snap.times_seen > 0)
    bump = torch.where(same_as_snap & ~src_inserted, src.times_seen - snap.times_seen,
                       torch.zeros_like(src.times_seen))
    times = dst.times_seen + bump

    def put(d: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        ring = dst_slot.dim() - 1
        spare = torch.zeros(d.shape[:ring] + (1,) + d.shape[ring + 1:], dtype=d.dtype, device=dev)
        out = torch.cat([d, spare], dim=ring)
        moved = torch.gather(s, ring, _ring_axis_index(src_slot, s))
        return out.scatter(ring, _ring_axis_index(dst_slot, out), moved).narrow(ring, 0, cap).contiguous()

    return dataclasses.replace(
        dst,
        boxes=put(dst.boxes, src.boxes),
        feats=put(dst.feats, src.feats),
        video=put(dst.video, src.video),
        frame=put(dst.frame, src.frame),
        chunk=put(dst.chunk, src.chunk),
        times_seen=put(times, src.times_seen),
        cursor=(dst.cursor + n_new[..., 0]) % cap,
        total_inserted=dst.total_inserted + (src.total_inserted - snap.total_inserted),
    )


def merge_matcher_checked(dst: MatcherState, src: MatcherState,
                          snap: MatcherState) -> tuple[MatcherState, MergeStats]:
    """``merge_matcher`` and its ``MergeStats``."""
    return merge_matcher(dst, src, snap), merge_stats(dst, src, snap)
