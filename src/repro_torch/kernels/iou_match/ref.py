"""Plain PyTorch versions of kernel B3: the matcher's IoU matrix and its
match-and-update step.

``iou_ref`` follows ``repro.core.matcher.pairwise_iou`` as the jitted
reference computes it: XLA's CPU backend fuses area_b's multiply into
``area_a + area_b`` (one FMA), so this version does the same with an exact
float32 FMA and agrees with it bit for bit.

``match_update_ref`` is the matcher step of ``repro.core.matcher.
match_and_update`` op by op, and ``match_update_split_ref`` the same step as
the fused kernel ``match_update`` decomposes it (block-partial maxima, their
combine, each block's own insert order), for the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.numerics import fma32

NEG = -1e9
_NONE = 2**31 - 1   # the split's "no eligible slot" index


def iou_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix f32[..., D, R] of boxes a f32[..., D, 4], b f32[..., R, 4]
    (x0, y0, x1, y1); leading axes (the multi kind's ``[Q]``) broadcast."""
    aw = torch.clamp_min(a[..., 2] - a[..., 0], 0.0)
    ah = torch.clamp_min(a[..., 3] - a[..., 1], 0.0)
    bw = torch.clamp_min(b[..., 2] - b[..., 0], 0.0)
    bh = torch.clamp_min(b[..., 3] - b[..., 1], 0.0)
    area_a = aw * ah
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = fma32(bw[..., None, :].expand(inter.shape), bh[..., None, :], area_a[..., :, None]) - inter
    return inter / torch.clamp_min(union, 1e-9)


class MatchResult(NamedTuple):
    """Per frame; each field gains a leading ``[Q]`` in the batched call."""

    d0: torch.Tensor           # i32[] — detections matching nothing (new results)
    d1: torch.Tensor           # i32[] — results going from seen-once to seen-twice
    cross_chunk: torch.Tensor  # i32[] — of d1, first seen in another chunk (§3.4)
    cross_home: torch.Tensor   # i32[R] — home chunks to decrement (-1 = none)
    is_new: torch.Tensor       # bool[D]
    new_state: Any             # the matcher's state after the frame (a ``MatcherState``)


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


def match_update_ref(state, boxes, feats, valid, video_id, frame_id, chunk_id, *, iou=iou_ref) -> MatchResult:
    """The matcher step op by op: ``state`` a ``MatcherState`` (with a
    leading ``[Q]`` on its tensors and on every argument for Q rings at
    once), ``iou`` the IoU matrix to use (the plain one, or the dispatching
    ``pairwise_iou`` on the cosine path).  See ``core.matcher.
    match_and_update`` for the rule."""
    cap = state.capacity
    dev = state.times_seen.device
    video_id, frame_id, chunk_id = (torch.as_tensor(v, device=dev) for v in (video_id, frame_id, chunk_id))
    occupied = state.times_seen > 0                                   # [..., R]
    iou_val = iou(boxes, state.boxes)                                 # [..., D, R]
    same_video = state.video[..., None, :] == video_id[..., None, None]
    in_gate = (state.frame[..., None, :].long() - frame_id[..., None, None]).abs() <= state.time_gate
    match_ok = iou_val >= state.iou_thresh
    score_val = iou_val
    if state.feat_thresh > -1.0:
        an = feats / torch.clamp_min(torch.linalg.vector_norm(feats, dim=-1, keepdim=True), 1e-9)
        bn = state.feats / torch.clamp_min(
            torch.linalg.vector_norm(state.feats, dim=-1, keepdim=True), 1e-9)
        sim = an @ bn.transpose(-1, -2)
        match_ok = match_ok | (sim >= state.feat_thresh)
        score_val = torch.maximum(iou_val, sim)
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


RING_FIELDS = (   # a ring's tensors, in the kernel's argument order
    "boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted")


def _split_one(state, boxes, feats, valid, video_id, frame_id, chunk_id, blocks: int) -> MatchResult:
    """One ring, as the kernel's cluster of ``blocks`` blocks computes it."""
    cap, d = state.capacity, boxes.shape[0]
    dev = state.times_seen.device
    vid, fid, cid = (torch.as_tensor(v, device=dev).long() for v in (video_id, frame_id, chunk_id))
    per = -(-cap // blocks)
    ranges = [(min(b * per, cap), min(b * per + per, cap)) for b in range(blocks)]
    gate = ((state.times_seen > 0) & (state.video.long() == vid)
            & ((state.frame.long() - fid).abs() <= state.time_gate))
    iou_val = iou_ref(boxes, state.boxes)
    thresh = torch.tensor(state.iou_thresh, dtype=torch.float32, device=dev)
    score = torch.where(gate[None, :] & (iou_val >= thresh), iou_val,
                        torch.full_like(iou_val, -torch.inf))               # [D, R]

    # phase A: each block's first maximum a detection, (-inf, _NONE) where
    # the block has no eligible slot (or no slot at all)
    partials = []
    for lo, hi in ranges:
        v = torch.full((d,), -torch.inf, device=dev)
        i = torch.full((d,), _NONE, dtype=torch.int64, device=dev)
        if hi > lo:
            at = torch.argmax(score[:, lo:hi], dim=-1)
            v = score[:, lo:hi].gather(-1, at[:, None])[:, 0]
            i = torch.where(v > -torch.inf, lo + at, i)
        partials.append((v, i))

    out = {f: torch.empty_like(getattr(state, f)) for f in RING_FIELDS[:6]}
    cross_home = torch.empty_like(state.chunk)
    d1 = cross = 0
    for lo, hi in ranges:
        # every block combines the partials in rank order, the larger IoU or
        # at an equal one the lower slot first, and derives the rest itself
        bv = torch.full((d,), -torch.inf, device=dev)
        bi = torch.full((d,), _NONE, dtype=torch.int64, device=dev)
        for v, i in partials:
            take = (v > bv) | ((v == bv) & (i < bi))
            bv, bi = torch.where(take, v, bv), torch.where(take, i, bi)
        found = bi != _NONE
        best = torch.where(valid & found, bi, torch.full_like(bi, -1))
        new = valid & ~found
        d0 = int(new.sum())
        new_at = torch.nonzero(new).flatten()                           # the k-th new detection
        cursor = int(state.cursor) % cap

        # phase B: this block's slots
        slots = torch.arange(lo, hi, device=dev)
        ts = state.times_seen[lo:hi]
        occ = ts > 0
        bump = (best[:, None] == slots[None, :]).sum(0).int()
        new_seen = ts + torch.where(occ, bump, torch.zeros_like(bump))
        twice = occ & (ts == 1) & (new_seen >= 2)
        crossed = twice & (state.chunk[lo:hi].long() != cid)
        cross_home[lo:hi] = torch.where(crossed, state.chunk[lo:hi], torch.full_like(ts, -1))
        d1, cross = d1 + int(twice.sum()), cross + int(crossed.sum())
        rows = dict(boxes=state.boxes[lo:hi], feats=state.feats[lo:hi], video=state.video[lo:hi],
                    frame=state.frame[lo:hi], chunk=state.chunk[lo:hi], times_seen=new_seen)
        k = torch.remainder(slots - cursor, cap)                       # the insert order landing here
        ins = k < d0
        if d0:
            last = k + cap * torch.div(d0 - 1 - k, cap, rounding_mode="floor")   # the last one wins
            who = new_at[torch.where(ins, last, torch.zeros_like(last))]
            put = dict(boxes=boxes[who], feats=feats[who], video=vid.int().expand(hi - lo),
                       frame=fid.int().expand(hi - lo), chunk=cid.int().expand(hi - lo),
                       times_seen=torch.ones_like(ts))
            rows = {f: torch.where(ins.reshape((-1,) + (1,) * (v.dim() - 1)), put[f], v)
                    for f, v in rows.items()}
        for f, v in rows.items():
            out[f][lo:hi] = v
    d0_t = torch.tensor(d0, dtype=torch.int32, device=dev)
    new_state = dataclasses.replace(
        state, **out,
        cursor=torch.tensor((cursor + d0) % cap, dtype=torch.int32, device=dev),
        total_inserted=(state.total_inserted + d0_t).int(),
    )
    return MatchResult(d0=d0_t, d1=torch.tensor(d1, dtype=torch.int32, device=dev),
                       cross_chunk=torch.tensor(cross, dtype=torch.int32, device=dev),
                       cross_home=cross_home, is_new=new, new_state=new_state)


def match_update_split_ref(state, boxes, feats, valid, video_id, frame_id, chunk_id, *,
                           blocks: int) -> MatchResult:
    """``match_update_ref`` (IoU only) as the kernel ``match_update``
    decomposes it: the ring's slots split into ``blocks`` contiguous
    ranges of ceil(R / blocks) (empty past R); each range's first maximum
    (IoU, slot) a detection; the partials combined in rank order, ties to
    the lower slot; each range deriving best, novelty and the insert order
    itself and writing its own slots, the last new detection of a slot
    winning where more than R are new.  With a leading ``[Q]``, each ring
    on its own.  Used by the tests alone."""
    if state.times_seen.dim() == 1:
        return _split_one(state, boxes, feats, valid, video_id, frame_id, chunk_id, blocks)
    ids = [torch.as_tensor(v) for v in (video_id, frame_id, chunk_id)]
    parts = []
    for q in range(state.times_seen.shape[0]):
        ring = dataclasses.replace(state, **{f: getattr(state, f)[q] for f in RING_FIELDS})
        parts.append(_split_one(ring, boxes[q], feats[q], valid[q],
                                *(v if v.dim() == 0 else v[q] for v in ids), blocks))
    new_state = dataclasses.replace(state, **{
        f: torch.stack([getattr(p.new_state, f) for p in parts]) for f in RING_FIELDS})
    return MatchResult(*(torch.stack([p[k] for p in parts]) for k in range(5)), new_state=new_state)
