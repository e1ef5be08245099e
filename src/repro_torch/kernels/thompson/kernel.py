"""ctypes binding of ``csrc/thompson_choose.cu`` (see the source's note)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import bind, check_status, require_cuda_f32

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P]


def thompson_choose(alpha: torch.Tensor, beta: torch.Tensor, z: torch.Tensor):
    """alpha, beta f32[M]; z f32[C, M] (CUDA, contiguous) →
    (idx i32[C], val f32[C]).  One launch; counted in
    ``thompson_choose.launches``."""
    require_cuda_f32("z", z, 2)
    require_cuda_f32("alpha", alpha, 1, z.device)
    require_cuda_f32("beta", beta, 1, z.device)
    c, m = z.shape
    if alpha.shape[0] != m or beta.shape[0] != m:
        raise ValueError(f"alpha/beta length {alpha.shape[0]}/{beta.shape[0]} != z width {m}")
    if m >= 2**31 or c >= 2**31:
        raise ValueError(f"z shape {tuple(z.shape)} exceeds the kernel's int32 sizes")
    idx = torch.empty((c,), dtype=torch.int32, device=z.device)
    val = torch.empty((c,), dtype=torch.float32, device=z.device)
    if c == 0:
        return idx, val
    fn = bind("thompson_choose", "thompson_choose_f32", _ARGTYPES)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = fn(alpha.data_ptr(), beta.data_ptr(), z.data_ptr(), c, m,
                idx.data_ptr(), val.data_ptr(), stream)
    check_status("thompson_choose", rc)
    thompson_choose.launches += 1
    return idx, val


thompson_choose.launches = 0
