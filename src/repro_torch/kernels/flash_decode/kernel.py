"""ctypes binding of ``csrc/flash_decode.cu`` (kernel B5; see the source's
note): one query token per sequence against a [B, T, KV, d] cache, float32
or bfloat16, d a multiple of 8 up to 256, any group of H/KV heads.  The
cache's length is split across ``decode_splits`` blocks a (batch, KV head,
head group), combined in the kernel: one launch a call."""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels._launch import bind, check_status, count_launch
from repro_torch.kernels.flash_attention.kernel import DTYPES, check_head_dim, check_operand

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I] + [_L] * 8 + [ctypes.c_float, _P]

TILE = 32          # cache positions a tile of the kernel
MAX_GROUP = 4      # query heads a block
MAX_SPLITS = 8     # blocks a cluster
SPLIT_SPAN = 1024  # cache positions a split, beyond which a cache earns another


def head_groups(g: int) -> int:
    """Blocks a split takes for a group of ``g`` query heads."""
    return -(-g // MAX_GROUP)


def decode_splits(b: int, t: int, h: int, kv: int, sms: int) -> int:
    """The blocks across which B5 splits each (batch, KV head, head group)'s
    cache of ``t`` positions on a card of ``sms`` SMs: enough for half the
    SMs, or one a ``SPLIT_SPAN`` positions of ``t`` where that is more;
    at most 8 (a cluster) and ``ceil(t / TILE)``."""
    units = b * kv * head_groups(h // kv)
    want = max(-(-sms // (2 * units)), t // SPLIT_SPAN)
    return max(1, min(MAX_SPLITS, -(-t // TILE), want))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cache_len: torch.Tensor) -> torch.Tensor:
    """q [B,H,d]; caches [B,T,KV,d]; cache_len int32[B] (CUDA) → [B,H,d]
    in q.dtype.  One launch; counted in ``flash_decode.launches`` and per
    (B, H, KV, d, T, dtype) in ``flash_decode.launches_by_shape``."""
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
    if b * kv * head_groups(h // kv) * MAX_SPLITS >= 2**31 or t >= 2**31:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} exceeds the kernel's grid")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    splits = decode_splits(b, t, h, kv, _sm_count(q.device.index))
    fn = bind("flash_decode", "flash_decode_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                cache_len.data_ptr(), out.data_ptr(), b, t, h, kv, d, splits, *q.stride()[:2],
                *k_cache.stride()[:3], *v_cache.stride()[:3], 1.0 / math.sqrt(d), stream)
    check_status("flash_decode", rc)
    count_launch(flash_decode, shape=(b, h, kv, d, t, str(q.dtype).removeprefix("torch.")))
    return out


flash_decode.launches = 0
flash_decode.launches_by_shape = {}
