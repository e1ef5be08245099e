"""Training launcher for the LMs of ``ARCHS``, on the card.

Counterpart of ``repro.launch.train``, with its flags, flow and loss
lines: deterministic token batches (``DeterministicTokenPipeline``, seed
0), k microbatches a step, AdamW (``--adam-8bit``: its 8-bit moments),
float32 without remat, and a checkpoint every ``--ckpt-every`` steps
through ``CheckpointManager`` (the last 2 kept) under ``RestartPolicy``.
A run over a directory that holds a checkpoint resumes from it.  The
reference resumes at the checkpoint's own step and so applies that step's
batch twice (ROADMAP C15); the port resumes at the step after it, so a
resumed run equals the uninterrupted one.  Weights are random (seed 0).

  python -m repro_torch.launch.train --arch qwen2.5-32b --steps 50 --reduced
  python -m repro_torch.launch.train --device cpu --steps 20

``--device`` defaults to ``cuda`` and fails without a card.  With
``--reduced``, or on the CPU, the config is the reference launcher's
reduced one (4 layers, d_model 128, 4 heads, d_ff 256, vocab 512); a full
config must fit the card with its AdamW state.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import ARCHS, RunConfig, scale_down
from repro_torch.data.pipeline import DeterministicTokenPipeline, TrainBatchSpec
from repro_torch.device import resolve
from repro_torch.distributed.fault_tolerance import RestartPolicy
from repro_torch.models.transformer import init_params
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import build_train_step, init_train_state


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", default="qwen2.5-32b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--adam-8bit", action="store_true")
    ap.add_argument("--reduced", action="store_true", help="the reduced config (always on the CPU)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced or device.type == "cpu":
        cfg = scale_down(cfg, layers=4, d_model=128, heads=4, d_ff=256, vocab=512)
    run = RunConfig(param_dtype="float32", remat=False, learning_rate=args.lr,
                    microbatches=args.microbatches, adam_8bit=args.adam_8bit)
    pipe = DeterministicTokenPipeline(TrainBatchSpec(args.batch, args.seq, cfg.vocab), seed=0, device=device)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    policy = RestartPolicy(checkpoint_every_steps=args.ckpt_every)

    state = init_train_state(init_params(cfg, 0, torch.float32, device), run)
    resumed = mgr.restore_latest(state)
    if resumed:
        state = resumed[1]
        print(f"resumed from step {state.step} (lose_at_most={policy.lose_at_most_steps} steps by "
              f"construction)")
    start = state.step
    step_fn = build_train_step(cfg, run)
    t0 = time.time()
    for step in range(start, args.steps):
        state, metrics = step_fn(state, pipe.batch_at(step))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"({(time.time() - t0) / max(step - start + 1, 1):.2f}s/step)", flush=True)
        if step and step % policy.checkpoint_every_steps == 0:
            mgr.save(step, state, extra={"arch": args.arch})


if __name__ == "__main__":
    main()
