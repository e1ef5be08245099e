"""ctypes binding of ``csrc/flash_attention.cu`` (kernel B4; see the
source's note): causal or full GQA attention forward, float32 or
bfloat16, d a multiple of 8 up to 256.

The source has three bodies, and ``select_body`` picks one from the
dtype and the head dim before the launch: "wgmma" (the tensor cores, bf16
products) for bfloat16 with d a multiple of 16 up to 128, "wgmma_f32"
(the tensor cores, three TF32 products for each float32 one) for float32
at every width, gemma's 256 included, "simt" (float32 FMAs on the CUDA
cores) for bfloat16 at the other widths, gemma's among them.  This is a
dispatch by type and width, not a fallback: a launch that fails raises.

Asked for it (``lse=``), "wgmma_f32" also writes each row's log-sum-exp
in base 2 (``lse2 = lse·log2(e)``, the form its softmax uses), and its
output keeps the same bits.  ``flash_attention_bwd`` binds
``csrc/flash_attention_bwd.cu``, the gradient of the same function
(float32 only), which ``ops.attention``'s autograd function runs on the
card from the forward's output and lse2: its body is "wgmma_f32" (3xTF32
on the tensor cores) up to d = 128 and "simt" above (``select_bwd_body``)."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._launch import bind, check_status, count_launch, require_cuda_f32

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I] + [_L] * 9 + [_I, ctypes.c_float, _P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = {"simt": 0, "wgmma": 1, "wgmma_f32": 2}


def select_body(dtype: torch.dtype, d: int) -> str:
    """B4's body for inputs of ``dtype`` and head dim ``d`` (a multiple of 8)."""
    if dtype == torch.bfloat16 and d % 16 == 0 and d <= 128:
        return "wgmma"
    if dtype == torch.float32 and d % 8 == 0 and d <= 256:
        return "wgmma_f32"
    return "simt"


def select_bwd_body(d: int) -> str:
    """The backward's body for head dim ``d`` (a multiple of 8 up to 256):
    "wgmma_f32" up to 128, "simt" above.  The C side makes the same choice
    from d; this names it for the counters."""
    return "wgmma_f32" if d <= 128 else "simt"


def bwd_tiles(d: int) -> dict:
    """The "wgmma_f32" backward's tiling at head dim ``d`` (up to 128), as
    the built library reports it: the width bucket, the keys of a dK/dV
    block and the query rows of its tiles, the query rows of a dQ block and
    the keys of its tiles."""
    out = (ctypes.c_int * 5)()
    check_status("flash_attention_bwd_tiles",
                 bind("flash_attention_bwd", "flash_attention_bwd_tiles",
                      [_I, ctypes.POINTER(_I)])(d, out))
    return dict(zip(("width", "keys", "q_tile", "q_rows", "k_tile"), out))


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
                    causal: bool = True, lse: torch.Tensor | None = None) -> torch.Tensor:
    """q [B,S,H,d]; k, v [B,T,KV,d] (CUDA, one dtype) → [B,S,H,d] in
    q.dtype, on the body ``select_body(q.dtype, d)``.  ``lse``, where given
    (float32, contiguous [B,H,S], on the "wgmma_f32" body only), receives
    each row's lse2.  One launch; counted in ``flash_attention.launches``,
    per body in ``flash_attention.launches_by_body`` and per
    (B, S, T, H, KV, d, dtype, causal) in
    ``flash_attention.launches_by_shape``."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    check_head_dim(d)
    body = select_body(q.dtype, d)
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(name, x, 4, q)
    if lse is not None:
        if body != "wgmma_f32":
            raise ValueError(f"lse is written by the \"wgmma_f32\" body only, not {body!r}")
        require_cuda_f32("lse", lse, 3, q.device)
        if lse.shape != (b, h, s):
            raise ValueError(f"lse: shape {tuple(lse.shape)}, expected {(b, h, s)}")
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
                out.data_ptr(), None if lse is None else lse.data_ptr(), b, s, t, h, kv, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal), 1.0 / math.sqrt(d), stream)
    check_status("flash_attention", rc)
    count_launch(flash_attention, body,
                 (b, s, t, h, kv, d, str(q.dtype).removeprefix("torch."), bool(causal)))
    return out


flash_attention.launches = 0
flash_attention.launches_by_body = dict.fromkeys(BODIES, 0)
flash_attention.launches_by_shape = {}


_BWD_ARGTYPES = [_P] * 10 + [_I] * 7 + [ctypes.c_float, _P]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor, *, causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v, causal=
    causal, lse=lse)`` = ``o`` for the output gradient ``do``, by
    ``csrc/flash_attention_bwd.cu`` (see the source's note): float32,
    contiguous, q/o/do [B,S,H,d], k/v [B,T,KV,d], lse [B,H,S] (the
    forward's lse2).  Three launches (the rows' D, then dK/dV, then dQ)
    over [B, H, S] float32 scratch, on the body ``select_bwd_body(d)``;
    counted once a call in ``flash_attention_bwd.launches``, per body in
    ``launches_by_body`` and per (B, S, T, H, KV, d, dtype, causal) in
    ``launches_by_shape``."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    check_head_dim(d)
    for name, x, shape in (("q", q, q.shape), ("k", k, k.shape), ("v", v, k.shape), ("o", o, q.shape),
                           ("do", do, q.shape)):
        require_cuda_f32(name, x, 4, q.device)
        if x.shape != shape or x.data_ptr() % 16:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)} 16-byte aligned")
    require_cuda_f32("lse", lse, 3, q.device)
    if lse.shape != (b, h, s):
        raise ValueError(f"lse: shape {tuple(lse.shape)}, expected {(b, h, s)}")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} KV heads")
    if t == 0 or b * h > 65535 or s >= 2**31 or t >= 2**31 or max(s, t) > 16 * 65535:
        raise ValueError(f"shape {tuple(q.shape)} x {tuple(k.shape)} is outside the kernel's grid")
    body = select_bwd_body(d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b * s * h == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = bind("flash_attention_bwd", "flash_attention_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), b, s, t, h,
                kv, d, int(causal), 1.0 / math.sqrt(d), stream)
    check_status("flash_attention_bwd", rc)
    count_launch(flash_attention_bwd, body, (b, s, t, h, kv, d, "float32", bool(causal)))
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_body = {"wgmma_f32": 0, "simt": 0}
flash_attention_bwd.launches_by_shape = {}
