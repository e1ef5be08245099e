"""Dispatch for the SSD chunk scan: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches
kernel B6, or raises if it cannot (an unsupported width or chunk is an
error, never a fallback).  ``ssd`` is differentiable: one
``torch.autograd.Function`` whose forward is ``ssd_ref`` or B6 and whose
backward is ``ssd_bwd_ref`` or ``ssd_scan_bwd``, the kernel of
``csrc/ssd_scan_bwd.cu``.  The forward keeps each chunk's incoming state
for the backward only when an input needs a gradient; a serve (no input
needs one) launches B6 as before and keeps nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bwd
from repro_torch.kernels.ssd_scan.ref import chunk_len, ssd_bwd_ref, ssd_ref


def _forward(x, dt, bmat, cmat, a, chunk: int, keep: bool):
    """(y, final state, h_in or None); h_in in the layout the device's
    backward reads: [B,nc,H,P,N] on the CPU, the kernel's [B,nc,H,N,P] on
    the card."""
    if x.device.type == "cpu":
        if keep:
            return ssd_ref(x, dt, bmat, cmat, a, chunk=chunk, states=True)
        return (*ssd_ref(x, dt, bmat, cmat, a, chunk=chunk), None)
    if x.device.type == "cuda":
        h_in = None
        if keep:
            b, s, h, p = x.shape
            h_in = torch.empty((b, s // chunk_len(s, chunk), h, bmat.shape[-1], p), dtype=torch.float32,
                               device=x.device)
        return (*ssd_scan(x, dt, bmat, cmat, a, chunk=chunk, h_in=h_in), h_in)
    raise ValueError(f"no SSD scan for device {x.device}")


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, bmat, cmat, a, chunk: int):
        y, hs, h_in = _forward(x, dt, bmat, cmat, a, chunk, keep=True)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, bmat, cmat, a, h_in)
        ctx.set_materialize_grads(False)
        return y, hs

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, bmat, cmat, a, h_in = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        if x.device.type == "cpu":
            grads = ssd_bwd_ref(x, dt, bmat, cmat, a, dy, dh, h_in, chunk=ctx.chunk)
        else:
            grads = ssd_scan_bwd(x, dt, bmat, cmat, a, dy.contiguous(), None if dh is None else dh.contiguous(),
                                 h_in, chunk=ctx.chunk)
        return (*grads, None)


def ssd(x, dt, bmat, cmat, a, *, chunk: int):
    """(y, final state) of x [B,S,H,P], dt [B,S,H], B/C [B,S,N], a [H];
    see ``ref.ssd_ref``.  Differentiable in every input when one requires
    a gradient; dB and dC come back dense, and autograd's slice backward
    places them where B and C were column slices."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, bmat, cmat, a)):
        return _SSD.apply(x, dt, bmat, cmat, a, chunk)
    return _forward(x, dt, bmat, cmat, a, chunk, keep=False)[:2]
