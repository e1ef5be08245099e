"""Oracle detector over the synthetic repository.

Counterpart of ``repro.sim.oracle`` (``oracle_detect``; the noisy detector
comes with a later slice).  Detections use a fixed number of slots D so
every frame has the same shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.numerics import fma32
from repro_torch.sim.repository import Repository, instances_visible


class Detections(NamedTuple):
    boxes: torch.Tensor     # f32[D, 4]
    feats: torch.Tensor     # f32[D, F]
    valid: torch.Tensor     # bool[D]
    inst_id: torch.Tensor   # i32[D] — ground-truth id (-1 invalid)


def _topk_slots(repo: Repository, frame, mask: torch.Tensor, max_dets: int) -> Detections:
    """Pack visible instances into D slots, earliest ids first."""
    n = repo.num_instances
    ids = torch.arange(n, device=mask.device)
    # the sort key is unique, so sort stability does not matter
    take = torch.argsort(torch.where(mask, ids, n + ids))[:max_dets]
    valid = mask[take]
    t = (frame - repo.inst_start[take]).float()[:, None]
    # ``box + t * drift`` is one contracted FMA in the jitted reference
    boxes = fma32(t, repo.inst_drift[take], repo.inst_box[take])
    return Detections(
        boxes=torch.where(valid[:, None], boxes, torch.zeros_like(boxes)),
        feats=torch.where(valid[:, None], repo.inst_feat[take], torch.zeros((), device=mask.device)),
        valid=valid,
        inst_id=torch.where(valid, take.int(), torch.full_like(take, -1, dtype=torch.int32)),
    )


def oracle_detect(repo: Repository, frame, *, query_class: int | None, max_dets: int = 16) -> Detections:
    """Perfect detector for one query class, or every visible instance
    with ``query_class=None``."""
    mask = instances_visible(repo, frame)
    if query_class is not None:
        mask = mask & (repo.inst_class == query_class)
    return _topk_slots(repo, frame, mask, max_dets)
