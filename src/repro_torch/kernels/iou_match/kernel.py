"""ctypes binding of ``csrc/iou_matrix.cu`` (see the source's note)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import bind, check_status, require_cuda_f32

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P]


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """boxes_a f32[D, 4], boxes_b f32[R, 4] (CUDA, contiguous) → f32[D, R].
    One launch; counted in ``iou_matrix.launches``."""
    require_cuda_f32("boxes_a", boxes_a, 2)
    require_cuda_f32("boxes_b", boxes_b, 2, boxes_a.device)
    d, r = boxes_a.shape[0], boxes_b.shape[0]
    if boxes_a.shape[1] != 4 or boxes_b.shape[1] != 4:
        raise ValueError(f"boxes must be [N, 4]; got {tuple(boxes_a.shape)}, {tuple(boxes_b.shape)}")
    if boxes_a.data_ptr() % 16 or boxes_b.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (float4 loads)")
    if d >= 8 * 65535 or r >= 2**31 - 32:
        raise ValueError(f"IoU shape ({d}, {r}) exceeds the kernel's grid")
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
