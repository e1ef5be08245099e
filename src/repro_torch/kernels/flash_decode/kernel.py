"""ctypes binding of ``csrc/flash_decode.cu`` (kernel B5; see the source's
note): one query token per sequence against a [B, T, KV, d] cache, float32
or bfloat16, d a multiple of 8 up to 256."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._launch import bind, check_status
from repro_torch.kernels.flash_attention.kernel import DTYPES, check_head_dim, check_operand

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_L] * 8 + [ctypes.c_float, _P]


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cache_len: torch.Tensor) -> torch.Tensor:
    """q [B,H,d]; caches [B,T,KV,d]; cache_len int32[B] (CUDA) → [B,H,d]
    in q.dtype.  One launch; counted in ``flash_decode.launches``.  A group
    of H/KV heads too wide for one block's shared memory (above 227 KB,
    e.g. 48 heads of 256) makes the launch fail with a RuntimeError."""
    b, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    check_head_dim(d)
    check_operand("q", q, 3, q)
    check_operand("k_cache", k_cache, 4, q)
    check_operand("v_cache", v_cache, 4, q)
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} KV heads")
    if t == 0:
        raise ValueError("decode against an empty cache")
    if (cache_len.dtype != torch.int32 or cache_len.shape != (b,) or not cache_len.is_contiguous()
            or cache_len.device != q.device):
        raise ValueError(f"cache_len must be a contiguous int32[{b}] on {q.device}")
    if b * kv >= 2**31 or t >= 2**31:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} exceeds the kernel's grid")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    fn = bind("flash_decode", "flash_decode_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                cache_len.data_ptr(), out.data_ptr(), b, t, h, kv, d, *q.stride()[:2],
                *k_cache.stride()[:3], *v_cache.stride()[:3], 1.0 / math.sqrt(d), stream)
    check_status("flash_decode", rc)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
