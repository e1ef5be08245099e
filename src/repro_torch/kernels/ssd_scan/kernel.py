"""ctypes binding of ``csrc/ssd_scan.cu`` (kernel B6; see the source's
note): the Mamba-2 SSD chunk scan in float32, in the model's layout, as
five launches (acs, cb, chunk_state, state_pass, chunk_scan) on the
current stream that run the chunks in parallel and carry only the state
in order."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import bind, check_status, count_launch
from repro_torch.kernels.ssd_scan.ref import chunk_len

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P] * 8 + [_I] * 6 + [_L] * 11 + [_P]
SMEM_LIMIT = 232_448            # bytes of shared memory a block may use on the H100


def smem_bytes() -> int:
    """The largest dynamic shared memory of the five launches, from the
    source; no width or chunk changes it."""
    return int(bind("ssd_scan", "ssd_scan_smem_bytes", [], restype=_L)())


def scratch_floats(b: int, s: int, h: int, p: int, n: int, q: int) -> int:
    """Floats of scratch a launch at these sizes needs (the chunks' acs, dt
    and state weights, the C·Bᵀ tiles, the chunk states and incoming
    states); -1 where the kernels cannot run."""
    fn = bind("ssd_scan", "ssd_scan_scratch_floats", [_I] * 6, restype=_L)
    return int(fn(b, s, h, p, n, q))


def _check(name: str, t: torch.Tensor, shape: tuple, device, *, rows: bool) -> None:
    """float32 on ``device`` with ``shape``; with ``rows``, a unit last
    stride and 16-byte aligned rows (the kernel reads them as float4)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {getattr(t, 'device', type(t))}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if rows and (t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:-1]) or t.data_ptr() % 16):
        raise ValueError(f"{name} needs a unit last stride and 16-byte aligned rows, "
                         f"got strides {t.stride()}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
             a: torch.Tensor, *, chunk: int):
    """x [B,S,H,P], dt [B,S,H], B/C [B,S,N] (shared by the heads; column
    slices of one projection are read in place), a [H] → (y [B,S,H,P],
    final state [B,H,P,N]), the state starting at zero.  CUDA float32; P a
    multiple of 4 up to 64, N a multiple of 4 up to 256, S a multiple of
    min(chunk, S).  Five launches and a scratch buffer from
    ``torch.empty`` (0.14 GB at (4, 8192, 32, 64, 128, Q 1024));
    counted once in ``ssd_scan.launches``."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B,S,H,P], got shape {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    dev = x.device
    _check("x", x, tuple(x.shape), dev, rows=True)
    _check("dt", dt, (bsz, s, h), dev, rows=False)
    _check("B", bmat, (bsz, s, n), dev, rows=True)
    _check("C", cmat, (bsz, s, n), dev, rows=True)
    _check("a", a, (h,), dev, rows=False)
    if p % 4 or not 4 <= p <= 64 or n % 4 or not 4 <= n <= 256:
        raise ValueError(f"(P, N) = ({p}, {n}) unsupported: the kernel takes multiples of 4, "
                         f"P up to 64 and N up to 256")
    q = chunk_len(s, chunk)
    if smem_bytes() > SMEM_LIMIT:
        raise ValueError(f"the kernels need {smem_bytes()} bytes of shared memory, above the card's "
                         f"{SMEM_LIMIT}")
    floats = scratch_floats(bsz, s, h, p, n, q)
    if floats < 0:
        raise ValueError(f"(B, S, H, Q) = ({bsz}, {s}, {h}, {q}) exceeds the kernels' grids")
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=dev)
    h_out = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    fn = bind("ssd_scan", "ssd_scan_fwd", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), a.data_ptr(),
                y.data_ptr(), h_out.data_ptr(), scratch.data_ptr(), bsz, s, h, p, n, q, *x.stride()[:3],
                *dt.stride(), *bmat.stride()[:2], *cmat.stride()[:2], a.stride(0), stream)
    check_status("ssd_scan", rc)
    count_launch(ssd_scan)
    return y, h_out


ssd_scan.launches = 0
