"""AdamW with optional block-wise 8-bit moments.

Counterpart of ``repro.train.optimizer``, the same arithmetic in float32
and the same state: the moments m and v in float32, or as ``QTensor``s
(int8 with a float32 absmax scale a block of ``q_block`` along the last
dim where it divides, flat otherwise), v then kept in the square-root
domain.  ``quantize_blockwise`` gives JAX's q and scale bit for bit
(round half to even, true division on every device).

The state is a ``NamedTuple`` like the reference's, its moments dicts
keyed by the parameter's dotted path (``layer_0.attn.wq``).  Unlike the
reference's pure function, ``apply_adamw`` updates the parameters and the
float32 moments in place and returns them: at full width they are the
only copies the card holds (a 2-layer qwen2.5-32b: 7.0 GB of parameters,
14.0 of moments).  The step count is a host ``int`` and the schedule's
learning rate and bias corrections are float32 values computed on the
host as the reference computes them on its device; the gradient norm and
clip stay on the device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.numerics import sqrt32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_state: bool = False
    q_block: int = 256
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Block-wise int8 tensor: blocked along the last dim when the block
    divides it (q the data's shape, scale [..., last / block]), flat
    otherwise (q int8[n padded to blocks], scale [nblocks])."""

    q: torch.Tensor
    scale: torch.Tensor
    shape: tuple
    block: int

    @property
    def blocked(self) -> bool:
        return tuple(self.q.shape) == tuple(self.shape)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (PyTorch's CPU one is not:
    ``numerics``)."""
    return sqrt32(x) if x.device.type == "cpu" else torch.sqrt(x)


def _quantize_blocks(blocks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale) of float32 ``blocks`` [..., block]: scale = max(
    absmax / 127, 1e-12), q = round-half-even(x / scale) clipped to ±127.
    The divisions are by tensors: CUDA divides by a Python scalar through
    its reciprocal."""
    absmax = torch.amax(torch.abs(blocks), dim=-1)
    scale = torch.clamp_min(absmax / torch.full((), 127.0, device=blocks.device), 1e-12)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_blockwise(x: torch.Tensor, block: int) -> QTensor:
    shape = tuple(x.shape)
    last = shape[-1] if shape else 0
    if shape and last % block == 0:
        q, scale = _quantize_blocks(x.float().reshape(*shape[:-1], last // block, block))
        return QTensor(q=q.reshape(shape), scale=scale, shape=shape, block=block)
    flat = x.reshape(-1).float()
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    q, scale = _quantize_blocks(flat.reshape(-1, block))
    return QTensor(q=q.reshape(-1), scale=scale, shape=shape, block=block)


def dequantize_blockwise(t: QTensor) -> torch.Tensor:
    if t.blocked:
        nb = t.shape[-1] // t.block
        blocks = t.q.float().reshape(*t.shape[:-1], nb, t.block)
        return (blocks * t.scale[..., None]).reshape(t.shape)
    blocks = t.q.reshape(-1, t.block).float() * t.scale[:, None]
    n = int(np.prod(t.shape, dtype=np.int64))
    return blocks.reshape(-1)[:n].reshape(t.shape)


class AdamWState(NamedTuple):
    step: int
    m: dict             # path -> float32 tensor or QTensor
    v: dict


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup → cosine decay to ``min_lr_ratio``, in float32 (the
    value as a Python float)."""
    f = np.float32
    s = f(step)
    warm = np.minimum(s / f(max(cfg.warmup_steps, 1)), f(1.0))
    prog = np.clip((s - f(cfg.warmup_steps)) / f(max(cfg.decay_steps - cfg.warmup_steps, 1)), f(0), f(1))
    cos = f(0.5) * (f(1) + np.cos(f(np.pi) * prog))
    return float(f(cfg.learning_rate) * warm * (f(cfg.min_lr_ratio) + f(1 - cfg.min_lr_ratio) * cos))


def named_leaves(params) -> list[tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf of a ``ParamNode`` (its
    ``named_parameters``) or of a dict keyed by path."""
    if isinstance(params, torch.nn.Module):
        return list(params.named_parameters())
    return list(params.items())


def _zeros_like_state(p: torch.Tensor, cfg: AdamWConfig):
    z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return quantize_blockwise(z, cfg.q_block) if cfg.quantize_state else z


def init_adamw(params, cfg: AdamWConfig) -> AdamWState:
    leaves = named_leaves(params)
    return AdamWState(step=0, m={n: _zeros_like_state(p, cfg) for n, p in leaves},
                      v={n: _zeros_like_state(p, cfg) for n, p in leaves})


def global_norm(tree: dict) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), float32, on the leaves' device."""
    return _sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


@torch.no_grad()
def apply_adamw(params, grads: dict, state: AdamWState, cfg: AdamWConfig) -> tuple[object, AdamWState, dict]:
    """One optimizer step: (params, state, {"lr", "grad_norm"}).  The
    parameters and the float32 moments are updated in place (a quantized
    moment is replaced); ``grads`` (by path) are read, not changed.  The
    order of every float32 operation is the reference's."""
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    clip = torch.clamp_max(torch.full_like(gnorm, cfg.grad_clip) / torch.clamp_min(gnorm, 1e-9), 1.0)
    f = np.float32
    bc1 = float(f(1.0) - f(cfg.b1) ** f(step))
    bc2 = float(f(1.0) - f(cfg.b2) ** f(step))
    new_m, new_v = dict(state.m), dict(state.v)
    for name, p in named_leaves(params):
        m, v = state.m[name], state.v[name]
        g = grads[name].float() * clip
        m_f = dequantize_blockwise(m) if isinstance(m, QTensor) else m
        # v lives in the sqrt domain when quantized (the reference's note: int8 on raw v
        # corrupts the denominator)
        v_f = torch.square(dequantize_blockwise(v)) if isinstance(v, QTensor) else v
        m_f.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v_f.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
        u = m_f / bc1
        u.div_(_sqrt(v_f / bc2).add_(cfg.eps))
        pf = p.float()
        u.add_(pf * cfg.weight_decay).mul_(lr)
        p.copy_(pf - u)
        if isinstance(m, QTensor):
            new_m[name] = quantize_blockwise(m_f, cfg.q_block)
            new_v[name] = quantize_blockwise(_sqrt(v_f), cfg.q_block)
    return params, AdamWState(step=step, m=new_m, v=new_v), {"lr": lr, "grad_norm": gnorm}


def state_bytes(state: AdamWState) -> int:
    """Bytes of the state's arrays (a ``QTensor``: its int8 q and float32
    scale; the step counts as the reference's int32)."""
    total = 4
    for leaf in list(state.m.values()) + list(state.v.values()):
        if isinstance(leaf, QTensor):
            total += leaf.q.numel() + leaf.scale.numel() * 4
        else:
            total += leaf.numel() * leaf.element_size()
    return total
