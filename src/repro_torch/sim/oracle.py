"""Oracle detector over the synthetic repository.

Counterpart of ``repro.sim.oracle`` (``oracle_detect``, ``class_select``
and ``filter_class``; the noisy detector comes with a later slice).
Detections use a fixed number of slots D so every frame has the same
shapes.  ``oracle_detect`` takes one frame (a 0-dim tensor, detections
``[D]``) or a batch of frames ``[B]`` (detections with a leading ``[B]``):
the reference ``jax.vmap``s a per-frame detector over the multi-query
round's frames, and the port writes that batch axis out.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.numerics import fma32
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
