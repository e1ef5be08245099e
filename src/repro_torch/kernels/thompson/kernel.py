"""ctypes bindings of ``csrc/thompson_choose.cu`` (see the source's note):
B1 ``thompson_choose`` and B2 ``thompson_choose_batched``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import bind, check_status, require_cuda_f32

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _P, _P, _P]
_ARGTYPES_BATCHED = [_P, _P, _P, _I, _I, _I, _P, _P, _P]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
        rc = fn(alpha.data_ptr(), beta.data_ptr(), z.data_ptr(), c, m,
                idx.data_ptr(), val.data_ptr(), _stream(z))
    check_status("thompson_choose", rc)
    thompson_choose.launches += 1
    return idx, val


thompson_choose.launches = 0


def thompson_choose_batched(alpha: torch.Tensor, beta: torch.Tensor, z: torch.Tensor):
    """alpha, beta f32[Q, M]; z f32[Q, C, M] (CUDA, contiguous) →
    (idx i32[Q, C], val f32[Q, C]); row (q, c) equals ``thompson_choose``
    on query q's statistics.  One launch for all Q·C rows; counted in
    ``thompson_choose_batched.launches``."""
    require_cuda_f32("z", z, 3)
    require_cuda_f32("alpha", alpha, 2, z.device)
    require_cuda_f32("beta", beta, 2, z.device)
    q, c, m = z.shape
    if tuple(alpha.shape) != (q, m) or tuple(beta.shape) != (q, m):
        raise ValueError(f"alpha/beta shapes {tuple(alpha.shape)}/{tuple(beta.shape)} != ({q}, {m})")
    if m >= 2**31 or q * c >= 2**31:
        raise ValueError(f"z shape {tuple(z.shape)} exceeds the kernel's int32 sizes")
    idx = torch.empty((q, c), dtype=torch.int32, device=z.device)
    val = torch.empty((q, c), dtype=torch.float32, device=z.device)
    if q * c == 0:
        return idx, val
    fn = bind("thompson_choose", "thompson_choose_batched_f32", _ARGTYPES_BATCHED)
    with torch.cuda.device(z.device):
        rc = fn(alpha.data_ptr(), beta.data_ptr(), z.data_ptr(), q, c, m,
                idx.data_ptr(), val.data_ptr(), _stream(z))
    check_status("thompson_choose_batched", rc)
    thompson_choose_batched.launches += 1
    return idx, val


thompson_choose_batched.launches = 0
