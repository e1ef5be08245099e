"""ctypes bindings of ``csrc/iou_matrix.cu`` (see the source's note): the
2-D ``iou_matrix`` and ``iou_matrix_batched`` over a leading query axis."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import bind, check_status, require_cuda_f32

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _I, _I, _P, _P]
_ARGTYPES_BATCHED = [_P, _P, _I, _I, _I, _P, _P]


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
