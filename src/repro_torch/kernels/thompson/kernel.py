"""ctypes bindings of ``csrc/thompson_choose.cu`` (see the source's note):
B1 ``thompson_choose`` and B2 ``thompson_choose_batched``, which take the
normals z, and the fused round ``thompson_round`` and
``thompson_round_batched``, which make them from the choice key."""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels._launch import bind, check_status, count_launch, require_cuda_f32

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _I, _I, _P, _P, _P]
_ARGTYPES_BATCHED = [_P, _P, _P, _I, _I, _I, _P, _P, _P]
_ROUND_ARGTYPES = [_P, _P, _P, _P, _F, _F, _F, _I, _I, _I, _P, _P, _P]
_ROUND_ARGTYPES_BATCHED = [_P, _L, _P, _P, _P, _F, _F, _F, _I, _I, _I, _I, _P, _P, _P]
MAX_SPLITS = 8          # blocks a cohort row: one portable cluster
MIN_SPLIT = 64          # chunks a block takes at least


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
    count_launch(thompson_choose)
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
    count_launch(thompson_choose_batched)
    return idx, val


thompson_choose_batched.launches = 0


# ---- the fused round: key -> normals -> Wilson–Hilferty -> first max


def round_splits(rows: int, m: int, sms: int) -> int:
    """The blocks across which the fused round splits each of ``rows``
    cohort rows of ``m`` chunks on a card of ``sms`` SMs: enough blocks to
    cover the SMs, at most 8 (a cluster) and at most one a ``MIN_SPLIT``
    chunks."""
    return max(1, min(MAX_SPLITS, -(-sms // max(rows, 1)), -(-m // MIN_SPLIT)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _scalars(alpha0: float, beta0: float) -> tuple[float, float, float]:
    """α₀, the clamp α₀/2 and β₀ as float32, as PyTorch rounds a Python
    scalar against a float32 tensor (``core.thompson.gamma_params``)."""
    return float(np.float32(alpha0)), float(np.float32(alpha0 * 0.5)), float(np.float32(beta0))


def _round(keys: torch.Tensor, state, cohorts: int, lead: tuple):
    """Checks, outputs and the one launch of the fused round over
    ``lead`` = () (one query) or (Q,), split as ``round_splits`` says."""
    n1, n, frames = state.n1, state.n, state.frames
    require_cuda_f32("state.n1", n1, len(lead) + 1)
    dev = n1.device
    m = n1.shape[-1]
    shape = lead + (m,)
    if (n.device != dev or n.dtype != torch.float32 or tuple(n.shape) != shape or not n.is_contiguous()
            or frames.device != dev or frames.dtype != torch.int32 or tuple(frames.shape) != shape
            or not frames.is_contiguous() or not n1.is_contiguous()):
        raise ValueError(f"state.n1/n f32{list(shape)} and state.frames i32{list(shape)} must be contiguous on "
                         f"{dev}; got {n.dtype}{list(n.shape)}, {frames.dtype}{list(frames.shape)}")
    if (keys.device != dev or keys.dtype != torch.int64 or tuple(keys.shape) != lead + (2,)
            or keys.stride(-1) != 1):
        raise ValueError(f"keys must be int64{list(lead + (2,))} on {dev} with unit last stride, got "
                         f"{keys.dtype}{list(keys.shape)} on {keys.device}")
    q = lead[0] if lead else 1
    if not 1 <= cohorts or cohorts * m >= 2**32 or q * cohorts * MAX_SPLITS >= 2**31 or m == 0:
        raise ValueError(f"fused round shape (Q={q}, C={cohorts}, M={m}) is outside the kernel's range")
    splits = round_splits(q * cohorts, m, _sm_count(dev.index if dev.index is not None
                                                    else torch.cuda.current_device()))
    idx = torch.empty(lead + (cohorts,), dtype=torch.int32, device=dev)
    val = torch.empty(lead + (cohorts,), dtype=torch.float32, device=dev)
    a0, floor, b0 = _scalars(state.alpha0, state.beta0)
    with torch.cuda.device(dev):
        if lead:
            fn = bind("thompson_choose", "thompson_round_batched_f32", _ROUND_ARGTYPES_BATCHED)
            rc = fn(keys.data_ptr(), keys.stride(0), n1.data_ptr(), n.data_ptr(), frames.data_ptr(),
                    a0, floor, b0, q, cohorts, m, splits, idx.data_ptr(), val.data_ptr(), _stream(n1))
        else:
            fn = bind("thompson_choose", "thompson_round_f32", _ROUND_ARGTYPES)
            rc = fn(keys.data_ptr(), n1.data_ptr(), n.data_ptr(), frames.data_ptr(), a0, floor, b0,
                    cohorts, m, splits, idx.data_ptr(), val.data_ptr(), _stream(n1))
    check_status("thompson_round", rc)
    return idx, val


def thompson_round(key: torch.Tensor, state, cohorts: int):
    """The whole Thompson choice of a round in one launch: key int64[2] and
    a ``SamplerState`` of M chunks (n1, n f32[M], frames i32[M], on the
    card, contiguous) → (idx i32[C], val f32[C]), equal bit for bit to
    ``ref.thompson_round_ref`` (and to ``ref.thompson_round_split_ref`` at
    ``round_splits``'s S).  Counted in ``thompson_round.launches``."""
    out = _round(key, state, cohorts, ())
    count_launch(thompson_round)
    return out


thompson_round.launches = 0


def thompson_round_batched(keys: torch.Tensor, state, cohorts: int):
    """``thompson_round`` for Q queries in one launch: keys int64[Q, 2]
    (rows at any stride) and statistics [Q, M] → (idx i32[Q, C],
    val f32[Q, C]); row q equals ``thompson_round`` on key q and query q's
    statistics.  Counted in ``thompson_round_batched.launches``."""
    out = _round(keys, state, cohorts, tuple(state.n1.shape[:1]))
    count_launch(thompson_round_batched)
    return out


thompson_round_batched.launches = 0
