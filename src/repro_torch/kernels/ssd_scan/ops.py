"""Dispatch for the SSD chunk scan: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches
kernel B6, or raises if it cannot (an unsupported width or chunk is an
error, never a fallback).
"""
from __future__ import annotations

from repro_torch.kernels.ssd_scan.kernel import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_ref


def ssd(x, dt, bmat, cmat, a, *, chunk: int):
    """(y, final state) of x [B,S,H,P], dt [B,S,H], B/C [B,S,N], a [H];
    see ``ref.ssd_ref``."""
    if x.device.type == "cpu":
        return ssd_ref(x, dt, bmat, cmat, a, chunk=chunk)
    if x.device.type == "cuda":
        return ssd_scan(x, dt, bmat, cmat, a, chunk=chunk)
    raise ValueError(f"no SSD scan for device {x.device}")
