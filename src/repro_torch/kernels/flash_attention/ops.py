"""Dispatch for attention: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches
kernel B4, or raises if it cannot (an unsupported head dim or dtype is an
error, never a fallback).  ``attention`` is differentiable: one
``torch.autograd.Function`` whose forward is ``attention_ref`` or B4 and
whose backward is ``attention_bwd_ref`` or ``flash_attention_bwd``, the
kernel of ``csrc/flash_attention_bwd.cu`` (float32 on the card; a CUDA
input of another dtype that requires a gradient raises).  On the card the
forward keeps its rows' lse2 for the backward only when an input needs a
gradient; a serve (no input needs one) launches B4 as before.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        lse = None
        if q.device.type == "cpu":
            o = attention_ref(q, k, v, causal=causal)
        elif q.device.type == "cuda":
            if any(ctx.needs_input_grad[:3]):
                b, s, h, _ = q.shape
                lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
            o = flash_attention(q, k, v, causal=causal, lse=lse)
        else:
            raise ValueError(f"no attention for device {q.device}")
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = attention_bwd_ref(q, k, v, o, do, causal=ctx.causal)
        else:
            dq, dk, dv = flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), o,
                                             do.contiguous(), lse, causal=ctx.causal)
        return dq, dk, dv, None


def attention(q, k, v, *, causal: bool = True):
    """q [B,S,H,d]; k, v [B,T,KV,d] → [B,S,H,d] in q.dtype."""
    if (q.device.type == "cuda" and q.dtype != torch.float32 and torch.is_grad_enabled()
            and any(x.requires_grad for x in (q, k, v))):
        raise NotImplementedError(f"attention's backward on the card takes float32, got {q.dtype}")
    return _Attention.apply(q, k, v, causal)
