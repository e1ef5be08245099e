"""Train steps: the LM's (AdamW over k microbatches) and the surrogate's.

Counterpart of ``repro.train.train_step``.  ``build_train_step`` returns
``step(state, batch) -> (state, metrics)`` for (ModelConfig, RunConfig):
the batch's leading axis split into ``run.microbatches`` slices, each
slice's loss and gradients by autograd (``microbatch_grad``), summed into
float32 accumulators in order and scaled by 1/k, then one ``apply_adamw``.
On the card the attention's backward is ``flash_attention_bwd`` (through
``kernels/flash_attention/ops.py``) and the SSD scan's is ``ssd_scan_bwd``
(through ``kernels/ssd_scan/ops.py``); the decode kernel B5 has no
backward (no train path reaches it) and raises; the CPU runs the plain
versions and their hand-written backwards.  The mesh
and the cross-pod gradient compression are ROADMAP A13.6c.

The parameters are a ``ParamNode`` whose leaves ``init_train_state``
makes require a gradient; the optimizer updates them in place, so a step
returns the state it was given with its leaves advanced.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.detection import surrogate_loss
from repro_torch.models.stacked import forward_lm_stacked
from repro_torch.models.transformer import forward_lm, lm_loss
from repro_torch.train.optimizer import AdamWConfig, AdamWState, apply_adamw, init_adamw, named_leaves


class TrainState(NamedTuple):
    params: object          # ParamNode
    opt: AdamWState
    step: int


def make_adamw_config(run: RunConfig) -> AdamWConfig:
    return AdamWConfig(learning_rate=run.learning_rate, weight_decay=run.weight_decay,
                       grad_clip=run.grad_clip, quantize_state=run.adam_8bit)


def _mesh_unported(what: str):
    return NotImplementedError(f"{what} (the mesh and gradient compression) is ROADMAP A13.6c")


def init_train_state(params, run: RunConfig, *, with_ef: bool = False) -> TrainState:
    """The state at step 0: ``params`` (its leaves set to require a
    gradient) and zeroed moments."""
    if with_ef:
        raise _mesh_unported("with_ef")
    for p in params.parameters():
        p.requires_grad_(True)
    return TrainState(params=params, opt=init_adamw(params, make_adamw_config(run)), step=0)


def loss_fn(params, batch: dict, cfg: ModelConfig, run: RunConfig, *, moe_groups: int) -> torch.Tensor:
    """Mean token cross-entropy of the ``train`` forward against
    ``batch["labels"]``; the vlm's patch positions carry no loss."""
    fwd = forward_lm_stacked if run.stacked else forward_lm
    logits = fwd(params, batch, cfg, run, mode="train", moe_groups=moe_groups)
    if cfg.family == "vlm":
        logits = logits[:, cfg.num_patches:]
    return lm_loss(logits, batch["labels"])


def microbatch_grad(params, mb: dict, cfg: ModelConfig, run: RunConfig, *, moe_groups: int):
    """(loss, {path: gradient}) of one microbatch; a leaf the loss does not
    reach gets zeros, as under ``jax.grad``."""
    names, leaves = zip(*named_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(params, mb, cfg, run, moe_groups=moe_groups)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, leaves, grads)}


def build_train_step(cfg: ModelConfig, run: RunConfig, *, moe_groups: int = 1,
                     mesh=None) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    if mesh is not None:
        raise _mesh_unported("a mesh")
    adamw_cfg = make_adamw_config(run)
    k = max(run.microbatches, 1)

    def grads_of(params, batch: dict):
        if k == 1:
            return microbatch_grad(params, batch, cfg, run, moe_groups=moe_groups)
        b = next(iter(batch.values())).shape[0]
        if b % k:
            raise ValueError(f"a batch of {b} does not split into {k} microbatches")
        loss_sum, acc = None, None
        for i in range(k):
            mb = {key: x.reshape(k, b // k, *x.shape[1:])[i] for key, x in batch.items()}
            loss, g = microbatch_grad(params, mb, cfg, run, moe_groups=moe_groups)
            if acc is None:          # 0 + g is g: the first microbatch's gradients start the sums
                loss_sum, acc = loss, {n: x.float() for n, x in g.items()}
            else:
                loss_sum = loss_sum + loss
                for n, x in g.items():
                    acc[n].add_(x.float())
            del g
        inv = 1.0 / k
        return loss_sum * inv, {n: a.mul_(inv) for n, a in acc.items()}

    def step(state: TrainState, batch: dict):
        loss, grads = grads_of(state.params, batch)
        params, opt, om = apply_adamw(state.params, grads, state.opt, adamw_cfg)
        return TrainState(params=params, opt=opt, step=state.step + 1), {"loss": loss, **om}

    return step


# --------------------------------------------------------------------------
# surrogate training (the BlazeIt baseline's scorer)
# --------------------------------------------------------------------------

def build_surrogate_train_step(lr: float = 1e-3):
    """SGD with momentum 0.9 on ``surrogate_loss``: ``step(params, momentum,
    emb, labels) -> (params, momentum, loss)``, ``momentum`` a dict by path
    (zeros to start); the parameters are updated in place."""

    def step(params, momentum: dict, emb: torch.Tensor, labels: torch.Tensor):
        names, leaves = zip(*named_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = surrogate_loss(params, emb, labels)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            momentum = {n: 0.9 * momentum[n] + g for n, g in zip(names, grads)}
            for n, p in zip(names, leaves):
                p.sub_(lr * momentum[n])
        return params, momentum, loss.detach()

    return step
