"""Batched detector serving: a backbone and a detection head behind the
request batcher, the production path the ExSample loop calls.

Counterpart of ``examples/serve_detector.py``, with the same flow and
prints.  Frames come from the simulated store as patch-embedding
sequences (``sim.frame_embedding``) and phi-3-vision plays the detector
through ``serve.serve_step.build_detect_step``: the reduced config (2
layers, d_model 64, 8 patches and 8 tokens a frame) on the CPU, the full
config (576 patches of 1,024 and 16 tokens a frame) on the card.  Weights are random (backbone seed 0, head seed 1).  Prints each
valid frame's detections above 0.5 and the batches' occupancy.

    python -m repro_torch.examples.serve_detector                # full width, on the card
    python -m repro_torch.examples.serve_detector --device cpu

Without ``--device cpu`` a missing card is an error.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCHS, RunConfig, scale_down
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models.detection import init_head
from repro_torch.models.transformer import init_params
from repro_torch.serve.batcher import RequestBatcher
from repro_torch.serve.serve_step import build_detect_step
from repro_torch.sim import RepoSpec, frame_embedding, generate

RUN = RunConfig(param_dtype="float32", remat=False)
MAX_DETS, NUM_CLASSES, FEAT_DIM = 8, 4, 8
BATCH = 4
SEQ = 16           # a frame's rows: its patches, then tokens up to 16; 16 tokens where the patches fill them


def detector_config(*, reduced: bool) -> ModelConfig:
    cfg = ARCHS["phi-3-vision-4.2b"]
    return scale_down(cfg, layers=2, d_model=64, heads=4, d_ff=128, vocab=256) if reduced else cfg


def text_tokens(cfg: ModelConfig) -> int:
    return SEQ - cfg.num_patches if cfg.num_patches < SEQ else SEQ


def serve_frames(cfg: ModelConfig, params, head, repo, device) -> dict:
    """The example's flow on the given weights: five frame requests through
    ``RequestBatcher(batch_size=4)``, one detector call a batch.  Returns
    the batches, the occupancy and, per valid frame in order, (frame, the
    detections above 0.5, the largest score)."""
    detect = build_detect_step(cfg, RUN, max_dets=MAX_DETS, num_classes=NUM_CLASSES, feat_dim=FEAT_DIM)
    batcher = RequestBatcher(batch_size=BATCH)
    batcher.submit([10, 500, 990, 2400, 3100], [0, 0, 0, 2, 3], cohort=0)
    rounds, frames = 0, []
    tokens = torch.ones((BATCH, text_tokens(cfg)), dtype=torch.int32, device=device)
    while batcher.ready():
        batch = batcher.next_batch()
        patches = torch.stack([frame_embedding(repo, max(int(f), 0), dim=cfg.patch_dim, patches=cfg.num_patches)
                               for f in batch.frame_ids])
        out = detect(params, head, {"tokens": tokens, "patches": patches})
        rounds += 1
        scores = out.scores.cpu()
        for i in range(BATCH):
            if not batch.valid[i]:
                continue
            s = scores[i]
            frames.append((int(batch.frame_ids[i]), int((s > 0.5).sum()), float(s.max())))
            print(f"frame {frames[-1][0]:5d}: {frames[-1][1]} detections (max score {frames[-1][2]:.2f})")
    print(f"\nbatches={rounds} occupancy={batcher.occupancy:.2f}")
    return dict(batches=rounds, occupancy=batcher.occupancy, frames=frames)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Batched detector serving over the simulated store.")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg = detector_config(reduced=device.type == "cpu")
    params = init_params(cfg, seed=0, dtype=RUN.dtype(), device=device)
    head = init_head(cfg.d_model, max_dets=MAX_DETS, num_classes=NUM_CLASSES, feat_dim=FEAT_DIM, seed=1,
                     device=device)
    repo, _ = generate(RepoSpec(video_lengths=[5000], num_instances=60, chunk_frames=1000), device=device)
    return serve_frames(cfg, params, head, repo, device)


if __name__ == "__main__":
    main()
