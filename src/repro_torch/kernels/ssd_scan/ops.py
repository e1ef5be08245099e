"""Dispatch for the SSD chunk scan: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches
kernel B6, or raises if it cannot (an unsupported width or chunk is an
error, never a fallback).  B6 has no backward yet: a CUDA input that
requires a gradient raises (ROADMAP A13.6b) rather than cut the gradient;
on the CPU the plain version is differentiable by autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_ref


def ssd(x, dt, bmat, cmat, a, *, chunk: int):
    """(y, final state) of x [B,S,H,P], dt [B,S,H], B/C [B,S,N], a [H];
    see ``ref.ssd_ref``."""
    if x.device.type == "cpu":
        return ssd_ref(x, dt, bmat, cmat, a, chunk=chunk)
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, bmat, cmat, a)):
            raise NotImplementedError("the SSD scan's backward on the card (kernel B6) is ROADMAP A13.6b")
        return ssd_scan(x, dt, bmat, cmat, a, chunk=chunk)
    raise ValueError(f"no SSD scan for device {x.device}")
