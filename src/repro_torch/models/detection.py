"""Detection head and surrogate scorer.

Counterpart of ``repro.models.detection``.  ``apply_head`` maps a frame's
pooled backbone features to D detection slots (box, objectness, class
logits, appearance feature), a light anchor-free head in the spirit of
DETR's box MLP: what makes a backbone of ``ARCHS`` the expensive detector
of the ExSample loop (``serve.serve_step.build_detect_step``).  The
surrogate is the BlazeIt-style baseline's cheap model, a two-layer MLP
over frame embeddings giving a scalar relevance score; here forward only
(score and loss).  Plain PyTorch products, no kernel of their own.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.models.layers import ParamNode, ParamSpec, Schema, materialize


class HeadOutput(NamedTuple):
    boxes: torch.Tensor       # f32[B, D, 4]
    scores: torch.Tensor      # f32[B, D]   (objectness, post-sigmoid)
    cls_logits: torch.Tensor  # f32[B, D, C]
    feats: torch.Tensor       # f32[B, D, F], unit norm


def head_schema(d_model: int, *, max_dets: int, num_classes: int, feat_dim: int) -> Schema:
    width = 4 + 1 + num_classes + feat_dim
    return {
        "w1": ParamSpec((d_model, 4 * d_model)),
        "w2": ParamSpec((4 * d_model, max_dets * width)),
        "b2": ParamSpec((max_dets * width,), init="zeros"),
    }


def init_head(d_model: int, *, max_dets: int, num_classes: int, feat_dim: int, seed: int = 1,
              device=None) -> ParamNode:
    """Random float32 head weights from ``seed``, made on ``device`` (default: the card)."""
    schema = head_schema(d_model, max_dets=max_dets, num_classes=num_classes, feat_dim=feat_dim)
    return materialize(schema, seed, torch.float32, resolve(device))


def apply_head(p, feats: torch.Tensor, *, max_dets: int, num_classes: int,
               feat_dim: int) -> HeadOutput:
    """feats f32[B, d_model] (pooled backbone features) → detections:
    GELU (tanh) MLP, sigmoid boxes and scores, features divided by
    max(‖f‖, 1e-9)."""
    h = F.gelu(feats @ p["w1"], approximate="tanh")
    out = (h @ p["w2"] + p["b2"]).reshape(feats.shape[0], max_dets, 4 + 1 + num_classes + feat_dim)
    boxes = torch.sigmoid(out[..., :4])
    scores = torch.sigmoid(out[..., 4])
    cls_logits = out[..., 5:5 + num_classes]
    f = out[..., 5 + num_classes:]
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-9)
    return HeadOutput(boxes=boxes, scores=scores, cls_logits=cls_logits, feats=f)


def pool_features(hidden: torch.Tensor) -> torch.Tensor:
    """Mean-pool sequence features [B, S, D] → [B, D], in float32."""
    return torch.mean(hidden.float(), dim=1)


# --------------------------------------------------------------------------
# surrogate (BlazeIt-style specialized model)
# --------------------------------------------------------------------------

def surrogate_schema(embed_dim: int, hidden: int = 128) -> Schema:
    return {
        "w1": ParamSpec((embed_dim, hidden)),
        "b1": ParamSpec((hidden,), init="zeros"),
        "w2": ParamSpec((hidden, hidden)),
        "b2": ParamSpec((hidden,), init="zeros"),
        "w3": ParamSpec((hidden, 1)),
        "b3": ParamSpec((1,), init="zeros"),
    }


def init_surrogate(seed: int, embed_dim: int, hidden: int = 128, device=None) -> ParamNode:
    """Random float32 surrogate weights from ``seed`` on ``device`` (default: the card)."""
    return materialize(surrogate_schema(embed_dim, hidden), seed, torch.float32, resolve(device))


def surrogate_score(p, emb: torch.Tensor) -> torch.Tensor:
    """emb f32[..., E] → relevance score f32[...]."""
    h = torch.relu(emb @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    return (h @ p["w3"] + p["b3"])[..., 0]


def surrogate_loss(p, emb: torch.Tensor, has_object: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy against 'the frame holds at least one query object'."""
    logit = surrogate_score(p, emb)
    y = has_object.float()
    return -torch.mean(y * F.logsigmoid(logit) + (1 - y) * F.logsigmoid(-logit))


def surrogate_flops(embed_dim: int, hidden: int = 128) -> float:
    return 2.0 * (embed_dim * hidden + hidden * hidden + hidden)
