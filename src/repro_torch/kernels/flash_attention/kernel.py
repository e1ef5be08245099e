"""ctypes binding of ``csrc/flash_attention.cu`` (kernel B4; see the
source's note): causal or full GQA attention forward, float32 or
bfloat16, d a multiple of 8 up to 256.

The source has three bodies, and ``select_body`` picks one from the
dtype and the head dim before the launch: "wgmma" (the tensor cores, bf16
products) for bfloat16 with d a multiple of 16 up to 128, "wgmma_f32"
(the tensor cores, three TF32 products for each float32 one) for float32
at every width, gemma's 256 included, "simt" (float32 FMAs on the CUDA
cores) for bfloat16 at the other widths, gemma's among them.  This is a
dispatch by type and width, not a fallback: a launch that fails raises."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._launch import bind, check_status, count_launch

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I] + [_L] * 9 + [_I, ctypes.c_float, _P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = {"simt": 0, "wgmma": 1, "wgmma_f32": 2}


def select_body(dtype: torch.dtype, d: int) -> str:
    """B4's body for inputs of ``dtype`` and head dim ``d`` (a multiple of 8)."""
    if dtype == torch.bfloat16 and d % 16 == 0 and d <= 128:
        return "wgmma"
    if dtype == torch.float32 and d % 8 == 0 and d <= 256:
        return "wgmma_f32"
    return "simt"


def check_head_dim(d: int) -> None:
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"head dim {d} unsupported: the kernels take a multiple of 8 up to 256")


def check_operand(name: str, t: torch.Tensor, ndim: int, like: torch.Tensor) -> None:
    """Type, rank and layout checks shared by B4 and B5: the kernels read
    rows of d elements with 16-byte loads through the other strides."""
    if t.dtype not in DTYPES:
        raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {like.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if t.device.type != "cuda" or t.device != like.device:
        raise ValueError(f"{name} must be a CUDA tensor on {like.device}, got {t.device}")
    per16 = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % per16 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a unit last stride and 16-byte aligned rows, "
                         f"got strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B,S,H,d]; k, v [B,T,KV,d] (CUDA, one dtype) → [B,S,H,d] in
    q.dtype, on the body ``select_body(q.dtype, d)``.  One launch; counted
    in ``flash_attention.launches`` and, per body, in
    ``flash_attention.launches_by_body``."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    check_head_dim(d)
    body = select_body(q.dtype, d)
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(name, x, 4, q)
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} KV heads")
    if t == 0:
        raise ValueError("attention over an empty key sequence")
    if b * h > 65535 or s >= 2**31 or t >= 2**31:
        raise ValueError(f"shape {tuple(q.shape)} x {tuple(k.shape)} exceeds the kernel's grid")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if b * s * h == 0:
        return out
    fn = bind("flash_attention", "flash_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(BODIES[body], DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), b, s, t, h, kv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                int(causal), 1.0 / math.sqrt(d), stream)
    check_status("flash_attention", rc)
    count_launch(flash_attention, body)
    return out


flash_attention.launches = 0
flash_attention.launches_by_body = dict.fromkeys(BODIES, 0)
