"""Oracle and noisy detectors over the synthetic repository.

Counterpart of ``repro.sim.oracle``: ``oracle_detect``, ``noisy_detect``,
``class_select``, ``filter_class`` and ``frame_embedding``.  Detections
use a fixed number of slots D so every frame has the same shapes.  A
detector takes one frame (a 0-dim tensor, detections ``[D]``) or a batch
of frames ``[B]`` (detections with a leading ``[B]``; ``noisy_detect``
then takes keys ``[B, 2]``): the reference ``jax.vmap``s a per-frame
detector over the multi-query round's frames, and the port writes that
batch axis out.  Nothing here reads a value back to the host, so the
resident loop can capture a round that calls them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.numerics import fma32, sqrt32
from repro_torch.sim.repository import Repository, instances_visible


class Detections(NamedTuple):
    boxes: torch.Tensor     # f32[..., D, 4]
    feats: torch.Tensor     # f32[..., D, F]
    valid: torch.Tensor     # bool[..., D]
    inst_id: torch.Tensor   # i32[..., D] — ground-truth id (-1 invalid)


def _topk_slots(repo: Repository, frame, mask: torch.Tensor, max_dets: int) -> Detections:
    """Pack visible instances (``mask`` bool[..., N]) into D slots,
    earliest ids first."""
    n = repo.num_instances
    ids = torch.arange(n, device=mask.device)
    # the sort key is unique, so sort stability does not matter
    take = torch.argsort(torch.where(mask, ids, n + ids), dim=-1)[..., :max_dets]
    valid = mask.gather(-1, take)
    frame = torch.as_tensor(frame, device=mask.device)[..., None]
    t = (frame - repo.inst_start[take]).float()[..., None]
    # ``box + t * drift`` is one contracted FMA in the jitted reference
    boxes = fma32(t, repo.inst_drift[take], repo.inst_box[take])
    return Detections(
        boxes=torch.where(valid[..., None], boxes, torch.zeros_like(boxes)),
        feats=torch.where(valid[..., None], repo.inst_feat[take], torch.zeros((), device=mask.device)),
        valid=valid,
        inst_id=torch.where(valid, take.int(), torch.full_like(take, -1, dtype=torch.int32)),
    )


def oracle_detect(repo: Repository, frame, *, query_class: int | None, max_dets: int = 16) -> Detections:
    """Perfect detector for one query class, or every visible instance
    with ``query_class=None`` (the class-agnostic detector whose output
    the multi-query driver filters per query with ``class_select``)."""
    mask = instances_visible(repo, frame)
    if query_class is not None:
        mask = mask & (repo.inst_class == query_class)
    return _topk_slots(repo, frame, mask, max_dets)


def _class_keep(repo: Repository, dets: Detections, classes: torch.Tensor) -> torch.Tensor:
    """bool[..., D]: the detection's ground-truth instance is of
    ``classes[...]`` (one class per leading row).  Detections without an
    instance id carry no class and are rejected."""
    cls = repo.inst_class[torch.clamp_min(dets.inst_id, 0).long()]
    return (dets.inst_id >= 0) & (cls == classes[..., None])


def class_select(repo: Repository, query_classes):
    """Per-query predicate over class-agnostic detections for the
    multi-query driver: ``select(q, dets) -> bool[Q, D]`` with ``q`` the
    queries' indices i32[Q] and ``dets`` one cohort slot of every query
    (leading ``[Q]``) keeps the detections whose instance is of
    ``query_classes[q]``."""
    qclasses = torch.as_tensor(query_classes, dtype=torch.int32).to(repo.inst_class.device)

    def select(q: torch.Tensor, dets: Detections) -> torch.Tensor:
        return _class_keep(repo, dets, qclasses[q.long()])

    return select


def filter_class(repo: Repository, dets: Detections, query_class: int) -> Detections:
    """``dets`` restricted to one class: the single-query counterpart of
    ``class_select`` (the same mask applied to ``valid``), so a per-class
    detector built from a detect-all pass matches the multi-query
    driver's ``select`` exactly."""
    cls = torch.full((), int(query_class), dtype=torch.int32, device=dets.inst_id.device)
    return dets._replace(valid=dets.valid & _class_keep(repo, dets, cls))


def _normalized(x: torch.Tensor) -> torch.Tensor:
    """``x / max(‖x‖, 1e-9)`` over the last axis (a power of two wide).
    The squares are summed by halves, the order XLA's vectorised reduction
    takes in the jitted noisy detector; an order-free sum would also
    differ between the CPU and the card."""
    acc = x * x
    while acc.shape[-1] > 1:
        if acc.shape[-1] % 2:
            raise ValueError(f"feature width {x.shape[-1]} is not a power of two")
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return x / torch.clamp_min(sqrt32(acc), 1e-9)


def noisy_detect(
    key: torch.Tensor,
    repo: Repository,
    frame,
    *,
    query_class: int | None,
    max_dets: int = 16,
    miss_rate: float = 0.1,
    fp_rate: float = 0.05,
    jitter: float = 0.01,
) -> Detections:
    """Detector with misses, box jitter and false positives, drawn from
    ``key`` (int64[2], or [B, 2] with frames [B]) as the reference draws
    them; ``query_class=None`` is class-agnostic, as in ``oracle_detect``.
    False positives take empty trailing slots, with random boxes and unit
    features, and ``inst_id`` -2.

    The reference draws the false positives' corners and sizes from one
    key (ROADMAP C9); so does the port, to give the same detections."""
    k = prng.split(key, 5)
    k_miss, k_jit, k_fp, k_fpbox, k_fpfeat = (k[..., i, :] for i in range(5))
    mask = instances_visible(repo, frame)
    if query_class is not None:
        mask = mask & (repo.inst_class == query_class)
    miss = prng.bernoulli(k_miss, miss_rate, (repo.num_instances,))
    dets = _topk_slots(repo, frame, mask & ~miss, max_dets)

    # ``boxes + normal · jitter``, where XLA folds the normal's √2 into
    # ``jitter`` (one float32 constant) and contracts the add into an FMA
    scale = float(np.float32(math.sqrt(2.0)) * np.float32(jitter))
    u = prng.uniform(k_jit, (max_dets, 4), prng.NORMAL_LO, 1.0)
    boxes = fma32(prng.erfinv_f32(u), scale, dets.boxes)
    fp_slot = ~dets.valid & prng.bernoulli(k_fp, fp_rate, (max_dets,))
    fp_xy = prng.uniform(k_fpbox, (max_dets, 2), 0.0, 0.8)
    fp_wh = prng.uniform(k_fpbox, (max_dets, 2), 0.05, 0.2)
    fp_boxes = torch.cat([fp_xy, fp_xy + fp_wh], dim=-1)
    fp_feats = _normalized(prng.normal(k_fpfeat, tuple(dets.feats.shape[-2:])))
    fp = fp_slot[..., None]
    return Detections(
        boxes=torch.where(fp, fp_boxes, boxes),
        feats=torch.where(fp, fp_feats, dets.feats),
        valid=dets.valid | fp_slot,
        inst_id=torch.where(fp_slot, torch.full_like(dets.inst_id, -2), dets.inst_id),
    )


def frame_embedding(repo: Repository, frame, *, dim: int, patches: int = 0) -> torch.Tensor:
    """Deterministic pseudo-embedding of one frame (a stand-in for pixels):
    the features of the visible instances summed over a sinusoidal
    background.  f32[dim], or f32[patches, dim] with ``patches``."""
    dev = repo.inst_feat.device
    vis = instances_visible(repo, frame).float()
    sig = vis @ repo.inst_feat                                     # f32[F]
    f = torch.as_tensor(frame, device=dev).float()
    idx = torch.arange(dim, dtype=torch.float32, device=dev)
    base = torch.sin(f * 1e-3 + idx * 0.7) * 0.3
    base[: sig.shape[0]] += sig
    if patches == 0:
        return base
    p = torch.arange(patches, dtype=torch.float32, device=dev)[:, None]
    return base[None, :] + 0.05 * torch.sin(p * 0.13 + idx[None, :])
