"""Serving launcher: prefill + greedy decode for any ``--arch``, on the card.

Counterpart of ``repro.launch.serve``, with the same flags, flow and
prints.  Weights are random (seed 0), made on the device; the prompt is
random tokens (seed 1), and as in the reference a vlm prompt is its first
``prompt_len - num_patches`` tokens after ``num_patches`` zero patches,
and an audio model's encoder reads ``prompt_len`` zero frames.  As in the
reference, decode starts from an empty cache at position 0 with the
prefill's argmax token: the prompt's own K/V (attention layers) or conv
window and state (Mamba-2 layers) never reach the decode cache (ROADMAP
C5), nor do the frames reach the zeroed cross caches (C14).  An ssm or
hybrid prompt must be a multiple of min(chunk_len, length).  The MoE
layers route each step's tokens as one group (``moe_groups`` 1, the
reference launcher's).

  python -m repro_torch.launch.serve --arch phi3-medium-14b --batch 4 --prompt-len 2048 --tokens 64
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --batch 4 --prompt-len 2048 --tokens 64
  python -m repro_torch.launch.serve --arch mamba2-370m --batch 4 --prompt-len 8192 --tokens 64
  python -m repro_torch.launch.serve --device cpu --arch mamba2-370m --prompt-len 64 --tokens 8
  python -m repro_torch.launch.serve --device cpu --arch jamba-1.5-large-398b --tokens 8
  python -m repro_torch.launch.serve --arch phi-3-vision-4.2b --batch 4 --prompt-len 2048 --tokens 64
  python -m repro_torch.launch.serve --device cpu --arch whisper-base --tokens 8

``--device`` defaults to ``cuda`` and fails without a card.  With
``--reduced``, or on the CPU, the config is ``scale_down``'s reduced one.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ARCHS, RunConfig, scale_down
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models.transformer import DecodeCache, init_decode_cache, init_params
from repro_torch.serve.serve_step import build_decode_step, build_prefill_step

RUN = RunConfig(param_dtype="float32", remat=False)


@dataclasses.dataclass
class ServeResult:
    prefill_logits: torch.Tensor          # [B, V]
    tokens: torch.Tensor                  # int32[B, 1 + n]: the prefill's argmax, then n decoded
    step_logits: list                     # per decode step, [B, V] (when kept)
    cache: DecodeCache
    prefill_s: float
    decode_s: float


def model_config(arch: str, *, reduced: bool, device: torch.device) -> ModelConfig:
    cfg = ARCHS[arch]
    return scale_down(cfg) if reduced or device.type == "cpu" else cfg


def make_prompt(cfg: ModelConfig, batch: int, prompt_len: int, device, seed: int = 1) -> dict:
    """The reference launcher's batch: ``prompt_len`` random tokens; a vlm
    keeps the first ``prompt_len - num_patches`` after zero patches, an
    audio model adds zero frames [batch, prompt_len, d_model]."""
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g, dtype=torch.int32)
    out = {"tokens": tokens.to(device)}
    if cfg.family == "vlm":
        out = {"tokens": out["tokens"][:, :prompt_len - cfg.num_patches].contiguous(),
               "patches": torch.zeros((batch, cfg.num_patches, cfg.patch_dim), device=device)}
    if cfg.encoder_layers:
        out["frames"] = torch.zeros((batch, prompt_len, cfg.d_model), device=device)
    return out


def prompt_len(batch: dict) -> int:
    """The decoder's input rows a sequence: the tokens, after the patches of a vlm batch."""
    return batch["tokens"].shape[1] + (batch["patches"].shape[1] if "patches" in batch else 0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(params, cfg: ModelConfig, run: RunConfig, batch: dict, tokens: int, *,
          keep_logits: bool = False, moe_stats: list | None = None) -> ServeResult:
    """Prefill the prompt, then decode ``tokens`` greedy tokens per
    sequence from a zeroed cache (KV layers of length prompt + tokens + 1,
    the prompt's patches counted; Mamba-2 layers a zero conv window and
    state; zeroed cross caches of ``encoder_len``).  With a ``moe_stats``
    list, each step (the prefill, then every decode step) appends the list
    of its MoE layers' ``MoEStats``."""
    prefill = build_prefill_step(cfg, run)
    decode = build_decode_step(cfg, run)
    device = batch["tokens"].device
    b, s = batch["tokens"].shape[0], prompt_len(batch)

    _sync(device)
    t0 = time.perf_counter()
    logits = prefill(params, batch, moe_stats=_step_stats(moe_stats))
    _sync(device)
    prefill_s = time.perf_counter() - t0

    cache = init_decode_cache(cfg, b, s + tokens + 1, torch.float32, device)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out, step_logits = [tok], []
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(tokens):
        tok, lg, cache = decode(params, tok, cache, moe_stats=_step_stats(moe_stats))
        out.append(tok)
        if keep_logits:
            step_logits.append(lg)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return ServeResult(prefill_logits=logits, tokens=torch.cat(out, dim=1), step_logits=step_logits,
                       cache=cache, prefill_s=prefill_s, decode_s=decode_s)


def _step_stats(moe_stats: list | None) -> list | None:
    """A new list for one step's MoE stats, appended to ``moe_stats``."""
    if moe_stats is None:
        return None
    moe_stats.append([])
    return moe_stats[-1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Prefill + greedy decode of an LM of any family with random weights.")
    ap.add_argument("--arch", default="gemma-7b", choices=sorted(ARCHS),
                    help="model; dense (phi3, qwen2.5, granite-20b, gemma), ssm (mamba2-370m), "
                         "moe (dbrx-132b, granite-moe-1b-a400m), hybrid (jamba-1.5-large-398b), "
                         "vlm (phi-3-vision-4.2b: zero patches) or audio (whisper-base: zero frames)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = model_config(args.arch, reduced=args.reduced, device=device)
    params = init_params(cfg, seed=0, dtype=RUN.dtype(), device=device)
    b, s = args.batch, args.prompt_len
    res = serve(params, cfg, RUN, make_prompt(cfg, b, s, device), args.tokens)
    print(f"prefill [{b}×{s}] → logits {tuple(res.prefill_logits.shape)} in {res.prefill_s:.2f}s")
    dt = res.decode_s
    print(f"decoded {args.tokens} tokens/seq in {dt:.2f}s "
          f"({args.tokens * b / dt:.1f} tok/s on {device})")
    print("sample:", res.tokens[0].tolist())


if __name__ == "__main__":
    main()
