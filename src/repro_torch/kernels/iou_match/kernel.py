"""ctypes bindings of ``csrc/iou_matrix.cu`` (see the source's note): the
2-D ``iou_matrix`` and ``iou_matrix_batched`` over a leading query axis, and
the fused matcher step ``match_update`` and ``match_update_batched``."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels._launch import bind, check_status, require_cuda_f32
from repro_torch.kernels.iou_match.ref import RING_FIELDS, MatchResult

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _I, _I, _P, _P]
_ARGTYPES_BATCHED = [_P, _P, _I, _I, _I, _P, _P]
_MATCH_ARGTYPES = ([_I] * 4 + [_P, _L] * 3 + [_P, _I, _L] * 3 + [_P] * 8 + [ctypes.c_float, _L]
                   + [_P] * 13 + [_P])
MAX_DETECTIONS = 64   # detections a frame the fused step takes (its shared memory)


def _check_boxes(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> tuple[int, int]:
    d, r = boxes_a.shape[-2], boxes_b.shape[-2]
    if boxes_a.shape[-1] != 4 or boxes_b.shape[-1] != 4:
        raise ValueError(f"boxes must be [..., N, 4]; got {tuple(boxes_a.shape)}, {tuple(boxes_b.shape)}")
    if boxes_a.data_ptr() % 16 or boxes_b.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (float4 loads)")
    if d >= 8 * 65535 or r >= 2**31 - 32:
        raise ValueError(f"IoU shape ({d}, {r}) exceeds the kernel's grid")
    return d, r


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """boxes_a f32[D, 4], boxes_b f32[R, 4] (CUDA, contiguous) → f32[D, R].
    One launch; counted in ``iou_matrix.launches``."""
    require_cuda_f32("boxes_a", boxes_a, 2)
    require_cuda_f32("boxes_b", boxes_b, 2, boxes_a.device)
    d, r = _check_boxes(boxes_a, boxes_b)
    out = torch.empty((d, r), dtype=torch.float32, device=boxes_a.device)
    if d == 0 or r == 0:
        return out
    fn = bind("iou_matrix", "iou_matrix_f32", _ARGTYPES)
    with torch.cuda.device(boxes_a.device):
        stream = torch.cuda.current_stream(boxes_a.device).cuda_stream
        rc = fn(boxes_a.data_ptr(), boxes_b.data_ptr(), d, r, out.data_ptr(), stream)
    check_status("iou_matrix", rc)
    iou_matrix.launches += 1
    return out


iou_matrix.launches = 0


def iou_matrix_batched(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """boxes_a f32[Q, D, 4], boxes_b f32[Q, R, 4] (CUDA, contiguous) →
    f32[Q, D, R], slice q equal to ``iou_matrix(boxes_a[q], boxes_b[q])``.
    One launch; counted in ``iou_matrix_batched.launches``."""
    require_cuda_f32("boxes_a", boxes_a, 3)
    require_cuda_f32("boxes_b", boxes_b, 3, boxes_a.device)
    q = boxes_a.shape[0]
    if boxes_b.shape[0] != q:
        raise ValueError(f"batch sizes differ: {boxes_a.shape[0]} vs {boxes_b.shape[0]}")
    if q >= 65536:
        raise ValueError(f"{q} queries exceed the kernel's grid")
    d, r = _check_boxes(boxes_a, boxes_b)
    out = torch.empty((q, d, r), dtype=torch.float32, device=boxes_a.device)
    if q == 0 or d == 0 or r == 0:
        return out
    fn = bind("iou_matrix", "iou_matrix_batched_f32", _ARGTYPES_BATCHED)
    with torch.cuda.device(boxes_a.device):
        stream = torch.cuda.current_stream(boxes_a.device).cuda_stream
        rc = fn(boxes_a.data_ptr(), boxes_b.data_ptr(), q, d, r, out.data_ptr(), stream)
    check_status("iou_matrix_batched", rc)
    iou_matrix_batched.launches += 1
    return out


iou_matrix_batched.launches = 0


def _det_operand(name: str, t: torch.Tensor, lead: int, width: int | None, dtype, device) -> torch.Tensor:
    """A detection input ``[*lead, D(, width)]`` on ``device`` with each
    query's rows contiguous (copied where they are not); the query stride
    is free, so a cohort slot's view of the multi kind's detections goes in
    as it is."""
    if not isinstance(t, torch.Tensor) or t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} must be a {dtype} tensor on {device}, got "
                         f"{getattr(t, 'dtype', type(t))} on {getattr(t, 'device', None)}")
    if t.dim() != lead + 1 + (width is not None) or (width is not None and t.shape[-1] != width):
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    step = 1
    for size, stride in zip(reversed(t.shape[lead:]), reversed(t.stride()[lead:])):
        if size != 1 and stride != step:
            return t.contiguous()
        step *= size
    return t


def _id_operand(name: str, v, q: int | None, device) -> tuple[torch.Tensor, int, int]:
    """An id (0-dim, or ``[Q]`` with ``q``) as (tensor, bytes, query stride)."""
    t = torch.as_tensor(v, device=device)
    if t.device != device or t.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name} must be an int32 or int64 tensor on {device}, got {t.dtype} on {t.device}")
    if t.dim() != 0 and (q is None or tuple(t.shape) != (q,)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    return t, t.element_size(), t.stride(0) if t.dim() else 0


def _match_update(state, boxes, feats, valid, video_id, frame_id, chunk_id, q: int | None) -> MatchResult:
    """One launch of the fused step over ``q`` rings (None: one ring, no
    leading axis)."""
    if state.feat_thresh > -1.0:
        raise ValueError("match_update computes the IoU-only matcher; feat_thresh > -1 takes "
                         "the matcher's op-by-op cosine path")
    lead_shape = () if q is None else (q,)
    lead, nq = len(lead_shape), 1 if q is None else q
    ring = {name: getattr(state, name) for name in RING_FIELDS}
    require_cuda_f32("state.boxes", ring["boxes"], lead + 2)
    dev = ring["boxes"].device
    r, f = ring["boxes"].shape[-2], ring["feats"].shape[-1]
    tails = dict(boxes=(r, 4), feats=(r, f), video=(r,), frame=(r,), chunk=(r,), times_seen=(r,),
                 cursor=(), total_inserted=())
    for name, t in ring.items():
        want = torch.float32 if name in ("boxes", "feats") else torch.int32
        shape = lead_shape + tails[name]
        if t.device != dev or t.dtype != want or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"state.{name} must be a contiguous {want}{list(shape)} on {dev}, got "
                             f"{t.dtype}{list(t.shape)} on {t.device}")
    boxes = _det_operand("boxes", boxes, lead, 4, torch.float32, dev)
    feats = _det_operand("feats", feats, lead, f, torch.float32, dev)
    valid = _det_operand("valid", valid, lead, None, torch.bool, dev)
    d = boxes.shape[-2]
    if boxes.shape[:lead] != lead_shape or feats.shape[:-1] != boxes.shape[:-1] or valid.shape != boxes.shape[:-1]:
        raise ValueError(f"detections {tuple(boxes.shape)}, {tuple(feats.shape)}, {tuple(valid.shape)} "
                         f"do not match {nq} rings")
    if d > MAX_DETECTIONS or not 1 <= r < 2**31 - 8 or not 1 <= nq < 2**28:
        raise ValueError(f"match_update takes at most {MAX_DETECTIONS} detections, 1 to 2^31 - 9 slots "
                         f"and 1 to 2^28 - 1 rings; got D={d}, R={r}, Q={nq}")
    box_sq = boxes.stride(0) if lead else 0
    if boxes.data_ptr() % 16 or box_sq % 4 or ring["boxes"].data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (float4 loads)")
    ids = [_id_operand(n, v, q, dev) for n, v in (("video_id", video_id), ("frame_id", frame_id),
                                                   ("chunk_id", chunk_id))]
    fbuf = torch.empty(nq * r * (4 + f), dtype=torch.float32, device=dev)
    ibuf = torch.empty(5 * nq * r + 5 * nq, dtype=torch.int32, device=dev)
    o_boxes = fbuf[:nq * r * 4].view(lead_shape + (r, 4))
    o_feats = fbuf[nq * r * 4:].view(lead_shape + (r, f))
    o_video, o_frame, o_chunk, o_seen, cross_home = ibuf[:5 * nq * r].view((5,) + lead_shape + (r,)).unbind(0)
    d0, d1, cross_chunk, o_cursor, o_total = ibuf[5 * nq * r:].view((5,) + lead_shape).unbind(0)
    is_new = torch.empty(lead_shape + (d,), dtype=torch.bool, device=dev)
    fn = bind("iou_matrix", "match_update_f32", _MATCH_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(nq, d, r, f,
                boxes.data_ptr(), box_sq, feats.data_ptr(), feats.stride(0) if lead else 0,
                valid.data_ptr(), valid.stride(0) if lead else 0,
                *(x for t, nbytes, sq in ids for x in (t.data_ptr(), nbytes, sq)),
                *(t.data_ptr() for t in ring.values()),
                float(state.iou_thresh), int(state.time_gate),
                *(t.data_ptr() for t in (o_boxes, o_feats, o_video, o_frame, o_chunk, o_seen, o_cursor,
                                         o_total, cross_home, is_new, d0, d1, cross_chunk)),
                stream)
    check_status("match_update", rc)
    new_state = dataclasses.replace(state, boxes=o_boxes, feats=o_feats, video=o_video, frame=o_frame,
                                    chunk=o_chunk, times_seen=o_seen, cursor=o_cursor,
                                    total_inserted=o_total)
    return MatchResult(d0=d0, d1=d1, cross_chunk=cross_chunk, cross_home=cross_home, is_new=is_new,
                       new_state=new_state)


def match_update(state, boxes, feats, valid, video_id, frame_id, chunk_id) -> MatchResult:
    """The IoU-only matcher step, fused: one frame's detections (boxes
    f32[D, 4], feats f32[D, F], valid bool[D], D <= 64) against one ring
    (``state``, a ``MatcherState`` on the card, ``feat_thresh`` off), ids
    0-dim int32/int64 tensors on the card.  Equal, field for field, to
    ``ref.match_update_ref``; the new state and every output are fresh
    tensors.  One launch; counted in ``match_update.launches``."""
    out = _match_update(state, boxes, feats, valid, video_id, frame_id, chunk_id, None)
    match_update.launches += 1
    return out


match_update.launches = 0


def match_update_batched(state, boxes, feats, valid, video_id, frame_id, chunk_id) -> MatchResult:
    """``match_update`` for Q rings at once: a leading ``[Q]`` on the
    state's tensors and on the detections, ids ``[Q]`` or 0-dim.  Query q
    equals ``match_update`` on its own ring.  One launch; counted in
    ``match_update_batched.launches``."""
    out = _match_update(state, boxes, feats, valid, video_id, frame_id, chunk_id, state.times_seen.shape[0])
    match_update_batched.launches += 1
    return out


match_update_batched.launches = 0
