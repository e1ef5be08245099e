"""ctypes binding of ``csrc/ssd_scan.cu`` (kernel B6; see the source's
note): the Mamba-2 SSD chunk scan in float32, in the model's layout, as
five launches (acs, cb, chunk_state, state_pass, chunk_scan) on the
current stream that run the chunks in parallel and carry only the state
in order; and of ``csrc/ssd_scan_bwd.cu``, its backward (``ssd_scan_bwd``,
which replaces no TPU kernel: the reference takes that gradient from
``jax.grad``), the chunks in parallel and only the carry of the state's
gradient in reverse."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import bind, check_status, count_launch
from repro_torch.kernels.ssd_scan.ref import chunk_len

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P] * 9 + [_I] * 6 + [_L] * 11 + [_P]
_BWD_ARGTYPES = [_P] * 14 + [_I] * 6 + [_L] * 11 + [_P]
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


def _check_inputs(x, dt, bmat, cmat, a, chunk: int) -> tuple:
    """The forward's inputs as both kernels read them → (B, S, H, P, N, Q)."""
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
    return bsz, s, h, p, n, chunk_len(s, chunk)


def _strides(x, dt, bmat, cmat, a) -> tuple:
    return (*x.stride()[:3], *dt.stride(), *bmat.stride()[:2], *cmat.stride()[:2], a.stride(0))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
             a: torch.Tensor, *, chunk: int, h_in: torch.Tensor | None = None):
    """x [B,S,H,P], dt [B,S,H], B/C [B,S,N] (shared by the heads; column
    slices of one projection are read in place), a [H] → (y [B,S,H,P],
    final state [B,H,P,N]), the state starting at zero.  CUDA float32; P a
    multiple of 4 up to 64, N a multiple of 4 up to 256, S a multiple of
    min(chunk, S).  Five launches and a scratch buffer from
    ``torch.empty`` (0.14 GB at (4, 8192, 32, 64, 128, Q 1024));
    counted once in ``ssd_scan.launches``.  ``h_in``, a contiguous
    [B, nc, H, N, P] float32 buffer, receives each chunk's incoming state
    (transposed) for ``ssd_scan_bwd``; None (a serve) keeps them in the
    scratch."""
    bsz, s, h, p, n, q = _check_inputs(x, dt, bmat, cmat, a, chunk)
    dev = x.device
    if h_in is not None:
        _check("h_in", h_in, (bsz, s // q, h, n, p), dev, rows=False)
        if not h_in.is_contiguous():
            raise ValueError("h_in must be contiguous")
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
                y.data_ptr(), h_out.data_ptr(), None if h_in is None else h_in.data_ptr(), scratch.data_ptr(),
                bsz, s, h, p, n, q, *_strides(x, dt, bmat, cmat, a), stream)
    check_status("ssd_scan", rc)
    count_launch(ssd_scan)
    return y, h_out


ssd_scan.launches = 0


def bwd_smem_bytes() -> int:
    """The largest dynamic shared memory of the backward's launches."""
    return int(bind("ssd_scan_bwd", "ssd_scan_bwd_smem_bytes", [], restype=_L)())


def bwd_scratch_floats(b: int, s: int, h: int, p: int, n: int, q: int) -> int:
    """Floats of scratch the backward needs at these sizes; -1 where it cannot run."""
    fn = bind("ssd_scan_bwd", "ssd_scan_bwd_scratch_floats", [_I] * 6, restype=_L)
    return int(fn(b, s, h, p, n, q))


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor, a: torch.Tensor,
                 dy: torch.Tensor, dh_final: torch.Tensor | None, h_in: torch.Tensor, *, chunk: int):
    """The gradient of ``ssd_scan`` (``ref.ssd_bwd_ref``'s function): the
    forward's inputs (read as it reads them), dy [B,S,H,P] and d(final
    state) [B,H,P,N] (None: zero), both contiguous, and the forward's
    ``h_in`` → (dx [B,S,H,P], ddt [B,S,H], dB [B,S,N], dC [B,S,N], da [H]),
    dB and dC dense.  Ten or eleven launches (see the source's note) and a
    scratch buffer from ``torch.empty``; counted once in
    ``ssd_scan_bwd.launches``.  No atomics: the same inputs give the same
    bits."""
    bsz, s, h, p, n, q = _check_inputs(x, dt, bmat, cmat, a, chunk)
    dev = x.device
    _check("dy", dy, (bsz, s, h, p), dev, rows=True)
    _check("h_in", h_in, (bsz, s // q, h, n, p), dev, rows=False)
    for name, t in (("dy", dy), ("dh_final", dh_final), ("h_in", h_in)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dh_final is not None:
        _check("dh_final", dh_final, (bsz, h, p, n), dev, rows=False)
    if bwd_smem_bytes() > SMEM_LIMIT:
        raise ValueError(f"the backward needs {bwd_smem_bytes()} bytes of shared memory, above the card's "
                         f"{SMEM_LIMIT}")
    floats = bwd_scratch_floats(bsz, s, h, p, n, q)
    if floats < 0:
        raise ValueError(f"(B, S, H, Q) = ({bsz}, {s}, {h}, {q}) exceeds the backward's grids")
    dx = torch.empty((bsz, s, h, p), dtype=torch.float32, device=dev)
    ddt = torch.empty((bsz, s, h), dtype=torch.float32, device=dev)
    db = torch.empty((bsz, s, n), dtype=torch.float32, device=dev)
    dc = torch.empty((bsz, s, n), dtype=torch.float32, device=dev)
    da = torch.empty((h,), dtype=torch.float32, device=dev)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    fn = bind("ssd_scan_bwd", "ssd_scan_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), a.data_ptr(), dy.data_ptr(),
                None if dh_final is None else dh_final.data_ptr(), h_in.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                db.data_ptr(), dc.data_ptr(), da.data_ptr(), scratch.data_ptr(), bsz, s, h, p, n, q,
                *_strides(x, dt, bmat, cmat, a), stream)
    check_status("ssd_scan_bwd", rc)
    count_launch(ssd_scan_bwd)
    return dx, ddt, db, dc, da


ssd_scan_bwd.launches = 0
