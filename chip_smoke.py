"""Chip smoke for repro_torch: build the CUDA kernels, check each against its
plain PyTorch version on the card (the fused Thompson round, B1/B2's
``thompson_round``, and the matcher's fused match-and-update step, B3's
``match_update``, bit for bit on every output), drive the full-size scan
search and the full-width multi-query search on the card, every round after
the first a replay of one captured CUDA graph (the resident loop), hold each
against the same search on the CPU and require one fused Thompson launch a
round and one fused matcher launch a frame (batched: a cohort slot), each
replay counted, then sweep the rounds between two reads of the exit test on
the bdd scan; then the
matcher's cosine path (B3's IoU matrix, op by op) the same way; then the bdd scan and
multi paths with the noisy detector (its draws inside the captured round), each held
to the CPU, beside the oracle's frames/s and device activities a replayed round; then
random+ and greedy (the baselines' host loops, one fused matcher launch a frame) held
to the CPU, with the savings against ExSample; then repro_torch.bench.multiquery's full
workload against counts pinned from CPU runs of both packages; then the repository index on
the bdd multi path (cold equal to no index, warm with no detector call and one captured graph,
a prior-warmed scan card against CPU), the async_multi kind (8 queries, 4 worker threads on
their own streams, each query equal to the multi run), the async kind (its merge invariants,
and a synchronous drive card against CPU) and repro_torch.bench.async_compose --quick (its 2x
gate); then the mesh (bdd(1.0) over 8 shards of the card: the sharded kind at sync_every 1 and 4 and
the composed multi_sharded kind, each held exactly to the same run on the CPU through that run's
pinned digest; repro_torch.bench.plan_compose's full workload against pinned counts; the CLI's
--kill-worker path, resharded 8 -> 6, replayed and held to the CPU's digest);
then the tenant service (8 tenants of bdd(1.0) in two waves of 4 on one live driver: no result
lost, the pool no larger than a wave, the overdraft plan rejected, the ledger settled, a tenant of each
wave equal to its solo scan) and its HTTP front; then serve the full-width
phi3-medium-14b and gemma-7b LMs (prefill through kernel B4, greedy decode
through kernel B5), the full-width mamba2-370m (prefill through kernel
B6, the SSD chunk scan), granite-moe-1b-a400m at full width and depth (its
experts in plain PyTorch between B4 and B5; its prefill also through the
stacked forward against the unrolled one) and jamba-1.5-large-398b at full
width cut to 2 layers (B6 in both Mamba-2 layers, the MoE on the second),
phi-3-vision-4.2b at full width and depth (576 patches before each prompt's
tokens; its prefill also stacked) and whisper-base (an encoder over 1,500
frames with B4 full, B5 over the cross caches read whole), hold each one's
decode to teacher forcing (an MoE model on its drop-free copy, the vlm
without patches, whisper over zero frames), and each reduced LM on the card
to the same on the CPU; then the detector step on phi-3-vision at full
width over one cohort of 50 bdd(1.0) frames (each call's rows independent,
the reduced step card against CPU); then prefill
phi3-medium-14b in bfloat16 at full depth, whose attention runs on B4's
bf16 tensor-core ("wgmma") body; last, training: qwen2.5-32b at full width
cut to 2 layers, 5 AdamW steps of 4 microbatches of 4,096 tokens (the loss
falling, B4 and its hand-written backward once a layer and a microbatch,
every gradient finite, the attention projections' nonzero, one step
profiled) and 2 with the 8-bit moments; the reduced dense, moe, vlm and
audio models trained on the card against the CPU (ssm and hybrid raise:
B6 has no backward yet); the train launcher on the card with a checkpoint
and a resume.  B4's backward is checked against its plain version, beside
SDPA's backward, in the kernel phase.  The multi path's CPU checks are
pinned as digests (MULTI_PINNED, like the mesh cells'), and so are
the main path's and the baselines' (SCAN_PINNED).  The float32 prefills' attention, gemma's
heads of 256 included, runs on B4's 3xTF32 tensor-core body ("wgmma_f32").

    python3 chip_smoke.py
    python3 chip_smoke.py --loop-c16 N   # ROADMAP C16: jamba's teacher forcing N times, nothing else

Needs one CUDA card, nvcc and the checkout's ``src/``.  Exits non-zero on
any failure (no card, build error, kernel mismatch, search mismatch).  The
last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the per-kernel JSON summary and, before that, the
card's name and power limit as nvidia-smi reports them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import hashlib
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# (non-tensor-core) rate, used for each kernel's lower-bound time.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12          # dense tensor-core rate
TF32_OPS_PER_S = 495e12          # dense tensor-core rate; 3xTF32 issues 3 products a float32 one
# one operation a lane a clock on every SM (132 SMs x 128 float32 lanes at 1.98 GHz): the float32
# rate above counts an FMA as two operations
ISSUE_OPS_PER_S = F32_OPS_PER_S / 2

MAIN_PLAN = dict(result_limit=200, max_steps=5000, cohorts=50, method="pallas", trace_every=256)
# the frames over which the scan and multi paths are held to the CPU (the card runs the plans' full budgets
# beside): the CPU's plain matcher step at ring 8,192 makes the full budgets ~40 s and ~110-150 s of CPU,
# and 2,000 and 500 frames still ~20 s and ~80-170 s, which the script's 1,200 s has no room for beside
# the mesh phase; 20 rounds of the bdd scan and 4 of each multi query
MAIN_CHECK_STEPS, MULTI_CHECK_STEPS = 1000, 200
HOST_CHECK_PLAN = dict(result_limit=40, max_steps=400, cohorts=8, method="pallas", trace_every=64)
MATCHER_CAPACITY = 8192
# the multi-query path: 2 predicates x 4 users, the mix of
# benchmarks/bench_multiquery.py, sharing one repository-sized cache
MULTI_CLASSES = (0, 0, 0, 0, 1, 1, 1, 1)
MULTI_PLAN = dict(queries=len(MULTI_CLASSES), result_limit=200, max_steps=2000, cohorts=50,
                  method="pallas", trace_every=256,
                  execution=dict(queries_axis=True, cache=-1))
SOLO_CHECK_STEPS = 400
# the baselines (core/baselines.py) at the main path's query: bdd(1.0), class 0, the
# oracle; random+ held to the CPU over its first BASELINE_CHECK_STEPS frames (~11 ms of CPU a frame)
BASELINE_LIMIT, BASELINE_STEPS, BASELINE_CHECK_STEPS = 200, 5000, 500
# repro_torch.bench.multiquery's full workload, from CPU runs of the JAX package's
# benchmarks/bench_multiquery.py multi arm and of the port's run(quick=False), which agree
MULTIQUERY_PINNED = dict(seq_results=[31, 31, 31, 31, 30, 30, 30, 30], multi_results=[31, 31, 31, 31, 30, 30, 30, 30],
                         seq_steps=[8192] * 8, multi_steps=[8192] * 8, detector_invocations=9520,
                         cache_hits=53207, rounds=1024, frames_sampled=65536)
# rounds between two reads of the exit test, swept on the bdd scan
ROUNDS_PER_SYNC_SWEEP = (1, 4, 16)
# the async runtime's worker threads, each on its own CUDA stream
ASYNC_WORKERS = 4
# the async kind's synchronous drive, card against CPU: cohorts issued, processed and merged in one order
ASYNC_SYNC_COHORTS = 4
# the tenant service (benchmarks/bench_service.py's shape): the eight MULTI_CLASSES tenants at
# MULTI_PLAN's limit and cohorts, in two waves of four over one live driver of ASYNC_WORKERS workers,
# two slots a batch, the cache repository-sized, the ring MATCHER_CAPACITY, the service's "exact".
# A tenant admitted at pool round r loses cohorts x r frames (the reference's debit), and the first
# wave runs MULTI_PLAN's 2,000 frames (40 rounds); so the second wave, each tenant submitted as a
# first-wave tenant retires, asks for twice that and keeps 2,000 after the debit.  The budget covers
# the eight projections; the overdraft plan projects 50 times it and must be rejected.
SERVICE_WAVE = 4
SERVICE_PLANS = (dict(result_limit=MULTI_PLAN["result_limit"], max_steps=MULTI_PLAN["max_steps"],
                      cohorts=MULTI_PLAN["cohorts"]),
                 dict(result_limit=MULTI_PLAN["result_limit"], max_steps=2 * MULTI_PLAN["max_steps"],
                      cohorts=MULTI_PLAN["cohorts"]))
SERVICE_SLOTS_PER_BATCH = 2
SERVICE_SLO_S = 60.0
# the mesh kinds at full width: bdd(1.0) on 8 shards of the card, 48 cohorts a round
# (the paper's 50 does not divide by 8), the sharded cells at sync_every 1 and 4 and the
# composed cell over the MULTI_CLASSES queries with a repository-sized cache (hash-sharded)
MESH_SHARDS, MESH_COHORTS = 8, 48
SHARDED_PLAN = dict(result_limit=200, max_steps=5000, cohorts=MESH_COHORTS)
MULTI_SHARDED_PLAN = dict(queries=len(MULTI_CLASSES), result_limit=200, max_steps=2000, cohorts=MESH_COHORTS,
                          execution=dict(queries_axis=True, shards=MESH_SHARDS, cache=-1))
# repro_torch.bench.plan_compose's full workload (dashcam(0.05), Q = 8 x 8 shards): the composed arm's
# per-query results and steps, detector invocations and cache hits from a CPU run of the JAX package's
# composed plan (benchmarks/bench_plan_compose.py's, 8 forced host devices)
PLAN_COMPOSE_PINNED = dict(comp_results=[23, 22, 23, 23, 20, 19, 20, 21], comp_steps=[2048] * 8,
                           detector_invocations=2989, cache_hits=13205)
# the elastic CLI: the MULTI_CLASSES queries on bdd(1.0), worker 7 of 8 silenced after 2 windows; the
# verdict lands at window 4, the mesh shrinks to 6 shards (48 % 6 == 0) and runs windows 5-10
ELASTIC_ARGV = ["--dataset", "bdd", "--scale", "1.0", "--queries", *map(str, MULTI_CLASSES), "--kill-worker", "7",
                "--kill-after-windows", "2", "--plan",
                json.dumps(dict(queries=len(MULTI_CLASSES), result_limit=200, max_steps=480, cohorts=MESH_COHORTS,
                                execution=dict(queries_axis=True, shards=MESH_SHARDS, cache=-1)))]
# the mesh cells' CPU runs as SHA-256 digests of what same_search compares (result_digest; the elastic CLI's
# record: elastic_digest), printed by `python chip_smoke.py --mesh-cpu CELL` on two machines' CPUs, which
# agree: run live, the four CPU references (~60-160 s each, the plain matcher step at ring 8,192) pushed this
# script past 1,100 s of its 1,200
MESH_PINNED = dict(sharded1="d6268cf5cd7b75c08dec05e0e2046aff7c8e3d5375d8ebd7d7283453953ead13",
                   sharded4="2d9eec59857f4219b9c5ae48b576cb0cbc1c780e452296fb59fa6ace6f7c457f",
                   multi_sharded="a534d5878c16f22a18ba7bb3a40bc5ed70015caee8650b6020784aa221515c75",
                   elastic="5c61a453da64e4217c2dfcc06bf5f09a5fdf945fb3b8da70f47e5cb2fb736726")
# the bdd(1.0) multi path's check on the CPU (MULTI_PLAN cut to MULTI_CHECK_STEPS frames a query), oracle
# and noisy detector, as result_digest's SHA-256, printed by `python chip_smoke.py --multi-cpu DETECTOR` on
# the card machine's CPU (47.9 and 51.0 s there): run live, they left no room for the training phases
MULTI_PINNED = dict(oracle="16c1b4f383f6f6b6bdb52bc296f3266d12c4dc229b707d8836bf73cbd7daebe7",
                    noisy="7e4e144f6e923b7df3e7ba19b589994c995e508cc8fac8f86cbcb3a9cad098a8")
# the main path's checks on the CPU (MAIN_PLAN cut to MAIN_CHECK_STEPS frames: dashcam and bdd with the
# oracle, bdd with the noisy detector) as result_digest's SHA-256, and the baselines' (random+ over
# BASELINE_CHECK_STEPS frames, greedy's whole run) as baseline_digest's, printed by
# `python chip_smoke.py --scan-cpu` on a CPU whose --multi-cpu oracle digest equals MULTI_PINNED's, at 1
# and 4 threads alike: run live they took ~40-55 s of this script, which the live plan_compose arms need
SCAN_PINNED = {"dashcam(scale=1.0)": "302bf2855ac604ec86e5f92a81ec3aaf20088466539b2113bac2a335ae840a09",
               "bdd(scale=1.0)": "43a0d0a3cdd4e4d7d3dcc99773667e2b62f498d332e8aa6fc3bf404726d31349",
               "bdd(scale=1.0) noisy": "23da1967ae254dab7f920258cca2cd9150f455eb4af4c67c284b6d534d979c4a",
               "randomplus": "83cc1cc7f7e65d9a4ecf046fba6f6757203477bb909683f86e4416949f78dfd9",
               "greedy": "d2cbc0c6bf31331bd50f21023a485448517d4f554120a97eeabf1d635ca753e5"}
# the scan whose Thompson prior the repository index warms (prior_weight > 0), card against CPU
PRIOR_SCAN_PLAN = dict(MAIN_PLAN, max_steps=1000)
PRIOR_WEIGHT = 50.0
# the matcher's cosine path (feat_thresh > -1, which no plan, CLI or config
# sets): op by op, with B3's iou_matrix for its IoU; driven on dashcam, card
# against CPU, so that the kernel it keeps is launched and checked
COSINE_FEAT_THRESH = 0.9
COSINE_SCAN_PLAN = dict(HOST_CHECK_PLAN)
COSINE_MULTI_PLAN = dict(MULTI_PLAN, max_steps=SOLO_CHECK_STEPS)
# the fused matcher step's kernel-phase rows: (D, R) and (Q, D, R); the
# main path's (16, 8192) and, batched, the multi path's (8, 16, 8192)
MATCH_SHAPES = ((16, 8192), (13, 1000), (1, 1))
MATCH_BATCHED_SHAPES = ((8, 16, 8192), (3, 13, 1000))
# the fused Thompson round's kernel-phase rows, (C, M) and (Q, C, M): the scan's
# dashcam (50, 22) and bdd (50, 1000), the multi path's (8, 50, 1000) and a
# small batch (3, 50, 22) (the mesh paths' shard shares, (48, 125) and
# (8, 48, 125), are checked in the mesh phase: mesh_winners_check); each on a search's statistics ("sampler", ~20% of
# chunks exhausted) and on a fresh state ("fresh", chunk 0 exhausted: about
# half the draws exactly 0, tied); batched, the last query has every chunk
# exhausted
ROUND_SHAPES = ((50, 22), (50, 1000))
ROUND_BATCHED_SHAPES = ((8, 50, 1000), (3, 50, 22))
# operations an element of the fused round takes, counted from
# csrc/thompson_choose.cu's source (a rounded division or square root counts
# as one; its SASS takes several instructions): every (row, chunk) visit
# converts and compares frames; a chunk not exhausted forms and clamps alpha;
# a live one runs threefry (73 integer operations), the uniform and the
# scaling (8), log1p by its branch, ErfInv by its branch, and the
# Wilson-Hilferty draw with beta and the running maximum (17)
ROUND_OPS = dict(visit=2, stats=4, live=73 + 8 + 17, log1p_small=19, log1p_large=33, erfinv_lt=22,
                 erfinv_ge=23)
# the LM serving paths, at full width in the launcher's float32, 64 greedy
# tokens each: phi3-medium-14b (dense), gemma-7b (dense, the launcher's
# default arch, heads of 256) and granite-moe-1b-a400m (moe) with 4 requests
# of a 2,048-token prompt; mamba2-370m (ssm) with 4 requests of 8,192
# tokens, so that each (batch, head) carries its state across 8 chunks of
# 1,024; jamba-1.5-large-398b (hybrid), cut in depth, one request of 2,048
# tokens and 8 greedy tokens.  ``prefill`` and ``decode`` name the kernel of
# the family's attention or Mamba-2 layers in each step (wrapper, a key that
# every device kernel of it holds in its name, label), ``prefill_body`` the
# B4 body every prefill launch must take (full width and reduced),
# ``layers`` (where given) the depth the full-width model is cut to,
# ``reduced_layers`` (where given) the depth of the reduced model (else
# ``scale_down``'s 2), ``reduced_prompt`` the prompt of the reduced model's
# card-against-CPU check and ``reduced_head_dim`` its head width where it
# must stay the full model's (``scale_down`` sets 64); ``stacked`` runs the
# prefill through the stacked forward too.  "ssd_scan" is in the names of
# all five of B6's launches, "flash_attention" in those of B4's three
# bodies.
SERVE_CELLS = {
    "dense": dict(arch="phi3-medium-14b", batch=4, prompt=2048, tokens=64, reduced_prompt=32,
                  reduced_head_dim=None, prefill=("flash_attention", "flash_attention", "B4"),
                  prefill_body="wgmma_f32", decode=("flash_decode", "flash_decode_kernel", "B5")),
    "gemma": dict(arch="gemma-7b", batch=4, prompt=2048, tokens=64, reduced_prompt=32,
                  reduced_head_dim=256, prefill=("flash_attention", "flash_attention", "B4"),
                  prefill_body="wgmma_f32", decode=("flash_decode", "flash_decode_kernel", "B5")),
    "ssm": dict(arch="mamba2-370m", batch=4, prompt=8192, tokens=64, reduced_prompt=64,
                reduced_head_dim=None, prefill=("ssd_scan", "ssd_scan", "B6"), prefill_body=None,
                decode=None),
    # granite-moe-1b-a400m at full width and depth (5.3 GB of float32 weights); its prefill also
    # runs through the stacked forward on the same weights restacked, against the unrolled one
    "moe": dict(arch="granite-moe-1b-a400m", batch=4, prompt=2048, tokens=64, reduced_prompt=32,
                reduced_head_dim=None, prefill=("flash_attention", "flash_attention", "B4"),
                prefill_body="wgmma_f32", decode=("flash_decode", "flash_decode_kernel", "B5"),
                stacked=True),
    # jamba-1.5-large-398b at full width, its 72 layers cut to 2 (the whole model does not fit
    # one card): layer 0 Mamba-2 + the dense MLP, layer 1 Mamba-2 + the MoE (46.5 GB of float32
    # weights); no attention layer, so no B4 or B5.  Its reduced check keeps 8 layers, which
    # hold the attention layer (layer 7).
    "hybrid": dict(arch="jamba-1.5-large-398b", layers=2, batch=1, prompt=2048, tokens=8, reduced_layers=8,
                   reduced_prompt=64, reduced_head_dim=None, prefill=("ssd_scan", "ssd_scan", "B6"),
                   prefill_body=None, decode=None),
    # phi-3-vision-4.2b at full width and depth (14.90 GB of float32 weights): each prompt of 2,048
    # rows is 576 patches (a seeded normal) then 1,472 tokens; its prefill also stacked
    "vlm": dict(arch="phi-3-vision-4.2b", batch=4, prompt=2048, tokens=64, reduced_prompt=32,
                reduced_head_dim=None, prefill=("flash_attention", "flash_attention", "B4"),
                prefill_body="wgmma_f32", decode=("flash_decode", "flash_decode_kernel", "B5"),
                stacked=True),
    # whisper-base at full width and depth: 16 prompts of 384 tokens over 1,500 frames (30 s at
    # 50 Hz, a seeded normal), then 64 greedy tokens (384 + 64 = 448, whisper's text context); B4
    # full in the encoder and the cross-attention, causal in the decoder; B5 over the self and the
    # cross caches
    "audio": dict(arch="whisper-base", batch=16, prompt=384, frames=1500, tokens=64, reduced_prompt=32,
                  reduced_head_dim=None, prefill=("flash_attention", "flash_attention", "B4"),
                  prefill_body="wgmma_f32", decode=("flash_decode", "flash_decode_kernel", "B5")),
}
# the detector step (``serve_step.build_detect_step``) on phi-3-vision at full width and depth: one
# cohort of 50 bdd(1.0) frames through RequestBatcher(batch_size=50), each 576 patch embeddings of
# 1,024 (``sim.frame_embedding``) and 16 tokens, so S = 592; the head at the repo's widths:
# ``max_dets`` 16 (the oracle's), ``num_classes`` 8 (PaperSetup), ``feat_dim`` 8 (RepoSpec)
DETECT = dict(arch="phi-3-vision-4.2b", frames=50, tokens=16, alone=4, max_dets=16, num_classes=8, feat_dim=8,
              seed=29)
# B4/B5 against their plain versions, element by element: float32 within
# 1e-4; bfloat16 within 1e-4 + 8e-3·|ref| (one bf16 ulp is at most
# 2^-7·|ref|: both sides compute in float32 and round once) and never
# above 2e-2
ATTN_ATOL, ATTN_CAP = 1e-4, 2e-2
ATTN_RTOL = {"float32": 0.0, "bfloat16": 8e-3}
# (B, S, T, H, KV, d, dtype, causal); B4_SERVE, B4_GEMMA and B4_BF16 are the
# prefills' own (phi3 float32, gemma float32, phi3 bfloat16).  The body is
# kernel.select_body's: bfloat16 with d a multiple of 16 up to 128 runs on
# B4's "wgmma" body, float32 on "wgmma_f32", the rest on "simt"
B4_SERVE = (4, 2048, 2048, 40, 10, 128, "float32", True)
B4_GEMMA = (4, 2048, 2048, 16, 16, 256, "float32", True)
B4_BF16 = (1, 8192, 8192, 40, 10, 128, "bfloat16", True)
B4_MOE = (4, 2048, 2048, 16, 8, 64, "float32", True)     # granite-moe-1b-a400m's prefill
B4_VLM = (4, 2048, 2048, 32, 32, 96, "float32", True)    # phi-3-vision-4.2b's prefill
B4_DETECT = (50, 592, 592, 32, 32, 96, "float32", True)   # its detector step: 50 frames of 576 + 16 rows
B4_AUDIO = (16, 1500, 1500, 8, 8, 64, "float32", False)  # whisper-base's encoder: full, ragged T
B4_AUDIO_SELF = (16, 384, 384, 8, 8, 64, "float32", True)  # its decoder's self-attention: G = 1, d = 64
B4_CROSS = (16, 384, 1500, 8, 8, 64, "float32", False)   # its cross-attention
B4_SHAPES = (
    B4_SERVE,
    (1, 2048, 2048, 40, 10, 128, "float32", True),
    (1, 2048, 2048, 40, 10, 128, "bfloat16", True),
    B4_BF16,
    B4_GEMMA,
    B4_MOE,
    (1, 2048, 2048, 16, 16, 256, "float32", True),       # gemma-7b's heads
    (1, 2048, 2048, 16, 16, 256, "bfloat16", True),
    (1, 1000, 1000, 40, 10, 128, "float32", True),       # ragged
    (1, 1000, 1000, 40, 10, 128, "float32", False),
    (1, 256, 1024, 40, 10, 128, "float32", True),        # S != T: the top-left rule
    (1, 1000, 1000, 40, 10, 128, "bfloat16", True),      # ragged, on the tensor cores
    (1, 1000, 1000, 40, 10, 128, "bfloat16", False),
    (1, 256, 1024, 40, 10, 128, "bfloat16", True),
    (1, 2048, 2048, 16, 8, 64, "bfloat16", True),        # granite-moe's heads
    (1, 2048, 2048, 32, 32, 96, "bfloat16", True),       # phi3-vision's heads
    (1, 2048, 2048, 16, 8, 64, "float32", True),         # granite-moe's heads
    (1, 2048, 2048, 32, 32, 96, "float32", True),        # phi3-vision's heads
    B4_VLM,
    B4_DETECT,
    B4_AUDIO,
    B4_AUDIO_SELF,
    B4_CROSS,
)
# the dense prefill in bfloat16 (the reference's default param_dtype): one
# prompt of 8,192 tokens, so each layer's attention is B4_BF16; all 40
# layers (28.3 GB of bf16 weights)
BF16_PREFILL = dict(arch="phi3-medium-14b", batch=1, prompt=8192, reduced_prompt=64)
# (B, H, KV, d, T, dtype, cache_len per sequence); B5_SERVE and B5_GEMMA are
# the serve paths' last decode steps (64 tokens in a cache of 2048 + 64 + 1)
B5_SERVE = (4, 40, 10, 128, 2113, "float32", (64,) * 4)
B5_GEMMA = (4, 16, 16, 256, 2113, "float32", (64,) * 4)
B5_MOE = (4, 16, 8, 64, 2113, "float32", (64,) * 4)        # granite-moe-1b-a400m's decode
B5_VLM = (4, 32, 32, 96, 2113, "float32", (64,) * 4)       # phi-3-vision-4.2b's decode: G = 1, d = 96
B5_AUDIO_SELF = (16, 8, 8, 64, 449, "float32", (64,) * 16)  # whisper-base's self decode: 384 + 64 + 1
B5_CROSS = (16, 8, 8, 64, 1500, "float32", (1500,) * 16)   # its cross decode, read whole
B5_SHAPES = (
    B5_SERVE,
    B5_GEMMA,
    B5_MOE,
    B5_VLM,
    B5_AUDIO_SELF,
    B5_CROSS,
    (4, 40, 10, 128, 2113, "float32", (2113,) * 4),            # phi3's serve shape, full cache
    (8, 40, 10, 128, 32768, "float32", (0, 1, 32768, 16384, 777, 32767, 4096, 12345)),
    (8, 40, 10, 128, 32768, "bfloat16", (0, 1, 32768, 16384, 777, 32767, 4096, 12345)),
    (4, 48, 1, 128, 8192, "float32", (0, 1, 8192, 3000)),     # granite-20b's MQA group
    (4, 16, 16, 256, 8192, "float32", (0, 1, 8192, 3000)),    # gemma-7b
    (4, 40, 8, 128, 8192, "bfloat16", (0, 1, 8192, 3000)),    # qwen2.5-32b's group of 5
    (1, 48, 1, 256, 4096, "float32", (3001,)),                # 48 heads of 256: 12 blocks a split
)
# B6 against its plain version, element by element within 1e-4 + 1e-4·|ref|:
# both are float32 and sum the chunk's cumulative log-decay in float64, so
# only the order of the float32 products and sums differs
SSD_ATOL, SSD_RTOL = 1e-4, 1e-4
# (B, S, H, P, N, chunk, a_log, dt); a = -exp(a_log), the model's init at
# a_log = 1; None draws a_log per head as the reference's kernel test.  dt
# "softplus" is softplus of a normal (~0.8): at a = -e, exp(acs) underflows
# to 0 within ~50 positions, so the far tiles of a chunk of 1,024 and the
# state of all but its last tile carry no weight.  dt "weak" is log-uniform
# in [1e-3, 0.1], Mamba-2's dt init: with a = -1 no decay underflows, which
# the check requires, so every tile pair and every chunk's state counts.
# The first row is the serve path's prefill; the last the same prompt at
# batch 1, where B6 trailed its plain version before its chunks ran in
# parallel.
B6_HYBRID = (1, 2048, 256, 64, 128, 1024, 1.0, "softplus")   # jamba's Mamba-2 layers: 256 heads
B6_SHAPES = (
    (4, 8192, 32, 64, 128, 1024, 1.0, "softplus"),
    (1, 1024, 32, 64, 128, 1024, 1.0, "softplus"),           # one chunk
    (2, 512, 8, 64, 128, 256, 1.0, "softplus"),              # Mamba-2's own chunk of 256
    (3, 128, 1, 16, 32, 32, None, "softplus"),               # the reference's kernel test's widths
    (2, 2048, 8, 64, 128, 1024, math.log(8.0), "softplus"),  # a = -8: exp(acs) underflows
    (2, 4096, 8, 64, 128, 1024, 0.0, "weak"),                # serve widths, 4 chunks, no underflow
    (1, 8192, 32, 64, 128, 1024, 0.0, "weak"),               # the batch-1 prefill, no underflow
    B6_HYBRID,
)
# B6's five launches, by the word between "ssd_scan_" and "_kernel" in their names
B6_PHASES = ("acs", "cb", "chunk_state", "state_pass", "chunk_scan")


# training.  B4's backward (csrc/flash_attention_bwd.cu) against its plain version at
# (B, S, T, H, KV, d, causal): the train cell's (one microbatch of qwen2.5-32b), whisper-base's
# encoder (full, T ragged to the tiles) and cross-attention (S != T), one G = 1 row at d = 256; each
# of dQ, dK, dV within BWD_RTOL·max |ref| (float32 FMAs against float32 einsums, summed in other orders)
BWD_TRAIN = (1, 4096, 4096, 40, 8, 128, True)
BWD_SHAPES = (BWD_TRAIN, (16, 1500, 1500, 8, 8, 64, False), (16, 384, 1500, 8, 8, 64, False),
              (1, 2048, 2048, 16, 16, 256, True))
BWD_RTOL = 1e-4
# the train cell: qwen2.5-32b (the reference train launcher's default arch) at full width, its 64
# layers cut to 2 (the whole model does not fit one card with its AdamW state), float32 (the
# launcher's), the train_4k sequence, 4 microbatches of 1 a step, lr 1e-2 on one fixed batch, then
# 2 steps with the 8-bit moments
TRAIN = dict(arch="qwen2.5-32b", layers=2, batch=4, seq=4096, microbatches=4, lr=1e-2, steps=5, steps_8bit=2)
# reduced training, card against CPU: the families whose kernels have a backward (dense, moe, vlm,
# audio: B4 only); ssm and hybrid need B6's (ROADMAP A13.6b) and must raise on the card
TRAIN_REDUCED = ("qwen2.5-32b", "granite-moe-1b-a400m", "phi-3-vision-4.2b", "whisper-base")
TRAIN_RAISES = ("mamba2-370m", "jamba-1.5-large-398b")
# the train launcher on the card, its reduced config, checkpoints at steps 5 and 10
LAUNCH_ARGV = ["--reduced", "--steps", "12", "--ckpt-every", "5", "--batch", "8", "--seq", "64"]


_T0 = time.perf_counter()


def phase(title: str) -> None:
    """A phase's header, with the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:.0f} s] {title}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def median_ms(fn, *, inner: int = 20, reps: int = 7) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


# Host time a short profile spends before and after its device work.  The
# device's timestamps reach the profile shifted by milliseconds against the
# host's, and an activity outside the host's window is dropped: now and then
# a capture of one short call, unpadded, kept no device activity at all.
CAPTURE_PAD_S = 0.05


def device_events(prof):
    """The device-side activities (kernels, copies, fills) of a profile,
    without the device-timeline copies of ``record_function`` ranges and
    CUPTI's "Command Buffer Full" (the host waiting on a full launch
    queue, not device work)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("exsample.", "serve.")) and e.name != "Command Buffer Full"]


def device_ms(fn, *, n: int = 50) -> float | None:
    """Device time per call of ``fn``: the summed durations of the device
    activities its ``n`` calls launch, from torch.profiler (CUPTI), counted
    between witness kernels (:func:`witnessed_events`), so that a capture
    that lost activities is taken again rather than read low.  None when
    none of 3 captures was whole (late in the script whole runs of
    captures lose their first activities: :func:`timed_row` then takes
    the whole row from CUDA events) or it holds no device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = witnessed_events(lambda: [fn() for _ in range(n)], tries=3)
    total_us = sum(e.time_range.elapsed_us() for e in events or [])
    return total_us / n / 1e3 if total_us > 0 else None


def bits_equal(x, y) -> bool:
    """Same shape, dtype and bit pattern (so -0.0 != 0.0 and NaN == NaN)."""
    import torch

    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dtype == torch.float32:
        return torch.equal(x.view(torch.int32), y.view(torch.int32))
    return torch.equal(x, y)


def ptxas_entries(log: str) -> list[dict]:
    """Per kernel in nvcc's ``-Xptxas -v`` log: its (mangled) name,
    registers and spill bytes."""
    entries = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entries.append(dict(name=m.group(1), registers=None, spill_stores=None, spill_loads=None))
        elif entries and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            entries[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif entries and (m := re.search(r"Used (\d+) registers", line)):
            entries[-1]["registers"] = int(m.group(1))
    return entries


def sass_opcodes(lib: str) -> dict | None:
    """How many instructions of each opcode (with its modifiers) the
    library's SASS holds (``cuobjdump -sass``); None when the toolkit has
    no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                     "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    ops = {}
    for line in sass.splitlines():
        parts = line.split()
        if line.strip().startswith("/*") and len(parts) > 1:
            ops[parts[1]] = ops.get(parts[1], 0) + 1
    return ops


# B4's tensor-core bodies: (label, a key its kernels hold in their names,
# the type of its HGMMA instructions in SASS)
B4_TC_BODIES = (("wgmma", "flash_attention_wgmma", "BF16"), ("wgmma_f32", "flash_attention_tf32", "TF32"))
# "wgmma_f32" keeps a warpgroup's causal skip only up to d = 64, where the
# products it skips outweigh ptxas' serializing every wgmma behind the branch
B4_SERIALIZED_MAX_D = 64


def check_b4_build(info: dict) -> None:
    """B4's tensor-core bodies as built: ptxas reports each without spills,
    "wgmma_f32" has its d = 256 instantiation (gemma's float32 prefill),
    ptxas serializes the wgmmas of none but the "wgmma_f32" widths up to 64
    (B4_SERIALIZED_MAX_D: the causal skip they keep), and the library's SASS
    holds HGMMA instructions of each one's type (where cuobjdump is there
    to say)."""
    ops = sass_opcodes(info["path"])
    entries = ptxas_entries(info["log"])
    serialized = set()
    for line in info["log"].splitlines():
        m = re.search(r"wgmma\.mma_async instructions are serialized.*function '([^']+)'", line)
        if m:
            width = re.search(r"ILi(\d+)E", m.group(1))
            label = "wgmma_f32" if "flash_attention_tf32" in m.group(1) else m.group(1)
            serialized.add((label, int(width.group(1)) if width else None))
    allowed = {("wgmma_f32", d) for d in range(8, B4_SERIALIZED_MAX_D + 1, 8)}
    print(f"  B4: ptxas serializes the wgmmas of {sorted(serialized, key=str)}")
    if serialized - allowed:
        fail(f"ptxas serializes B4's wgmmas in {sorted(serialized - allowed, key=str)}")
    for label, key, kind in B4_TC_BODIES:
        bodies = [e for e in entries if key in e["name"]]
        if not bodies:
            fail(f"ptxas reported no kernel of B4's {label} body")
        widths = set()
        for e in bodies:
            width = re.search(r"ILi(\d+)E", e["name"])
            widths.add(int(width.group(1)) if width else None)
            print(f"  B4 {label} body, d = {width.group(1) if width else '?'}: {e['registers']} registers, "
                  f"spill stores {e['spill_stores']} B, spill loads {e['spill_loads']} B")
            if e["spill_stores"] or e["spill_loads"] or e["registers"] is None:
                fail(f"B4's {label} body spills or went unreported: {e}")
        if label == "wgmma_f32" and 256 not in widths:
            fail(f"ptxas reported no d = 256 instantiation of B4's {label} body (widths {sorted(widths)})")
        if ops is None:
            print(f"  B4 library: {kind} HGMMA not checked (no cuobjdump)")
            continue
        hgmma = {op: n for op, n in ops.items() if op.startswith("HGMMA") and kind in op.split(".")}
        if not hgmma:
            fail(f"B4's library holds no {kind} HGMMA instruction: the {label} body is not on the "
                 f"tensor cores (HGMMA: {[op for op in ops if op.startswith('HGMMA')]})")
        print(f"  B4 library, {label}: {sum(hgmma.values())} {kind} HGMMA instructions {hgmma}")


def check_b5_build(info: dict) -> None:
    """Each of B5's instantiations as built: ptxas reports it, without
    spills."""
    entries = [e for e in ptxas_entries(info["log"]) if "flash_decode_kernel" in e["name"]]
    if not entries:
        fail("ptxas reported no kernel of B5")
    for e in entries:
        inst = re.search(r"flash_decode_kernelI(.*?)EEv", e["name"])
        print(f"  B5 {inst.group(1) if inst else e['name'][:60]}: {e['registers']} registers, "
              f"spill stores {e['spill_stores']} B, spill loads {e['spill_loads']} B")
        if e["spill_stores"] or e["spill_loads"] or e["registers"] is None:
            fail(f"B5's kernel spills or went unreported: {e}")


def check_b3_build(info: dict) -> None:
    """Each of B3's kernels as built (the IoU matrix and the fused matcher
    step): ptxas reports it, without spills."""
    for key in ("iou_matrix_kernel", "match_update_kernel"):
        found = [e for e in ptxas_entries(info["log"]) if key in e["name"]]
        if not found:
            fail(f"ptxas reported no {key}")
        for e in found:
            print(f"  B3 {key}: {e['registers']} registers, spill stores {e['spill_stores']} B, "
                  f"spill loads {e['spill_loads']} B")
            if e["spill_stores"] or e["spill_loads"] or e["registers"] is None:
                fail(f"B3's {key} spills or went unreported: {e}")


def check_b1_build(info: dict) -> None:
    """B1/B2's kernels as built (the z-taking choice and the fused round):
    ptxas reports each, without spills."""
    for key in ("thompson_choose_kernel", "thompson_round_kernel"):
        found = [e for e in ptxas_entries(info["log"]) if key in e["name"]]
        if not found:
            fail(f"ptxas reported no {key}")
        for e in found:
            print(f"  B1/B2 {key}: {e['registers']} registers, spill stores {e['spill_stores']} B, "
                  f"spill loads {e['spill_loads']} B")
            if e["spill_stores"] or e["spill_loads"] or e["registers"] is None:
                fail(f"{key} spills or went unreported: {e}")


WITNESS = "spin_kernel"        # the kernel of torch.cuda._sleep
SPARE = "FillFunctor"          # in the name of the kernel of Tensor.fill_
# fills a capture of kernels_a_call launches, and waits for, before its witnesses
SPARES = 16
# kernels_a_call's tally: its captures, the fewest leading fills one of them kept, its retakes
CAPTURES = dict(captures=0, fewest_fills_kept=SPARES, retakes=0)


def witnessed_events(run, *, tries: int = 5) -> list | None:
    """The device activities that ``run()`` launches, in time order, from
    a capture in which they are bracketed by witness kernels
    (``torch.cuda._sleep``), two on each side on the same stream, padded
    with host time (CAPTURE_PAD_S, longer at each try).  A capture that
    lacks any of the four witnesses, or holds an activity of ``run``
    outside them, lost device activities and is taken again, up to
    ``tries`` times; None if none was whole.  A capture has been seen to
    lose its first device activities, one, two or more of them, and in
    every try of one call: so each starts with SPARES fills, waited for
    before the witnesses, which take that loss; the fills that remain
    ahead of the first witness are not counted.  Before a retake a
    throwaway capture of one fill closes the profiler's session once more.
    CAPTURES tallies the captures, the fewest fills one kept, the retakes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    spare = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    for attempt in range(tries):
        pad = CAPTURE_PAD_S * 2 ** attempt
        if attempt:
            CAPTURES["retakes"] += 1
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                spare.fill_(0.0)
                torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(SPARES):
                spare.fill_(0.0)
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda._sleep(1000)
            run()
            torch.cuda._sleep(1000)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(pad)
        events = sorted(device_events(prof), key=lambda e: e.time_range.start)
        kept = next((i for i, e in enumerate(events) if SPARE not in e.name), len(events))
        events = events[kept:]
        CAPTURES["captures"] += 1
        CAPTURES["fewest_fills_kept"] = min(CAPTURES["fewest_fills_kept"], kept)
        spin = [WITNESS in e.name for e in events]
        if sum(spin) == 4 and spin[:2] == [True, True] and spin[-2:] == [True, True]:
            return events[2:-2]
        print(f"  (profiler capture kept {kept} of its {SPARES} leading fills and saw {sum(spin)} of its 4 "
              f"witness kernels among {len(events)} device activities after them, in the order "
              f"{['w' if w else 'k' for w in spin][:40]}; taken again)")
    return None


def kernels_a_call(fn, *, tries: int = 5) -> list[str]:
    """The device kernels one call of ``fn`` launches, by name, from a
    witnessed capture (:func:`witnessed_events`); fails if no capture of
    ``tries`` was whole."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = witnessed_events(fn, tries=tries)
    if events is None:
        fail(f"the profiler saw {fn} bracketed by its 4 witness kernels in none of {tries} captures")
    return [e.name for e in events]


def check_b6_build(info: dict) -> None:
    """Each of B6's five kernels as built: ptxas reports it, without spills."""
    entries = [e for e in ptxas_entries(info["log"]) if "ssd_scan" in e["name"]]
    for phase in B6_PHASES:
        found = [e for e in entries if f"ssd_scan_{phase}_kernel" in e["name"]]
        if not found:
            fail(f"ptxas reported no kernel of B6's {phase} phase")
        for e in found:
            print(f"  B6 {phase}: {e['registers']} registers, spill stores {e['spill_stores']} B, "
                  f"spill loads {e['spill_loads']} B")
            if e["spill_stores"] or e["spill_loads"] or e["registers"] is None:
                fail(f"B6's {phase} kernel spills or went unreported: {e}")


# ----------------------------------------------------------------- kernels

def thompson_inputs(c: int, m: int, seed: int, *, all_exhausted: bool = False):
    import torch

    g = torch.Generator().manual_seed(seed)
    n1 = torch.randint(0, 30, (m,), generator=g).float()
    n = torch.randint(0, 400, (m,), generator=g).float()
    alpha = torch.clamp_min(n1 + 0.1, 0.05)
    beta = n + 1.0
    z = torch.randn((c, m), generator=g)
    alpha[torch.rand((m,), generator=g) < 0.2] = -1.0        # exhausted sentinels
    if all_exhausted:
        alpha[:] = -1.0
    if m >= 4 and not all_exhausted:
        # forced exact ties at the row maximum: chunks 1 and m-1 share a
        # dominant (alpha, beta) and the same normals in every row, so the
        # argmax is a tie across thread strides that the lower index wins
        j, k = 1, m - 1
        alpha[j] = alpha[k] = 1000.0
        beta[j] = beta[k] = 1.0
        z[:, k] = z[:, j]
    return alpha.cuda(), beta.cuda(), z.cuda()


def iou_inputs(d: int, r: int, seed: int):
    import torch

    g = torch.Generator().manual_seed(seed)

    def boxes(k):
        xy = torch.rand((k, 2), generator=g) * 0.7 + 0.05
        wh = torch.rand((k, 2), generator=g) * 0.15 + 0.05
        b = torch.cat([xy, xy + wh], dim=1)
        flat = torch.rand((k,), generator=g) < 0.1
        b[flat, 2] = b[flat, 0]                                   # zero-area boxes
        return b

    a, b = boxes(d), boxes(r)
    if r > d:
        b[:d] = a + 0.002 * torch.randn((d, 4), generator=g)   # real overlaps
    b[-1] = 0.0                                                 # empty ring slot
    return a.contiguous().cuda(), b.contiguous().cuda()


def thompson_batched_inputs(q: int, c: int, m: int, seed: int):
    """Q queries of ``thompson_inputs`` (each with its forced ties across
    thread strides); the last query has every chunk exhausted."""
    import torch

    rows = [thompson_inputs(c, m, seed + i, all_exhausted=(i == q - 1)) for i in range(q)]
    return tuple(torch.stack([r[k] for r in rows]).contiguous() for k in range(3))


def timed_row(kernel, plain, *, library=None, n=50, plain_n=None, inner=20, reps=7, ops_per_s=F32_OPS_PER_S,
              **row) -> dict:
    """Device time per call (profiler, mean of ``n``; of the plain version,
    of ``plain_n`` where it is given) of the kernel, of its plain version
    and of the one PyTorch call that computes the same function
    (``library``, where there is one), and the host-inclusive time per call
    of the first two (CUDA events around ``inner`` calls, median of
    ``reps``; the host's launch rate bounds it for small kernels).  The
    bound is the larger of the bytes over HBM's rate and the operations
    over ``ops_per_s``.  Where the profiler kept no whole capture of the
    kernel, of its plain version or of the library call, all three are
    taken from CUDA events, so that a row never sets a device time beside
    a host-inclusive one; ``source`` says which clock the row read."""
    row.update(ms=device_ms(kernel, n=n), plain_ms=device_ms(plain, n=plain_n or n),
               call_ms=median_ms(kernel, inner=inner, reps=reps),
               plain_call_ms=median_ms(plain, inner=inner, reps=reps),
               library_ms=None if library is None else device_ms(library, n=n), source="profiler")
    if row["ms"] is None or row["plain_ms"] is None or (library is not None and row["library_ms"] is None):
        print("    (the profiler kept no whole capture: the kernel, its plain version and the library call all "
              "from CUDA events)")
        row.update(ms=row["call_ms"], plain_ms=row["plain_call_ms"], source="CUDA events",
                   library_ms=None if library is None else median_ms(library, inner=inner, reps=reps))
    t_bytes = row["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = row["ops"] / ops_per_s * 1e3
    row.update(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    return row


def describe(row) -> str:
    lib = "" if row.get("library_ms") is None else f", library {row['library_ms'] * 1e3:.2f} us"
    return (f"{'device' if row['source'] == 'profiler' else 'CUDA events'} {row['ms'] * 1e3:.2f} us "
            f"(plain {row['plain_ms'] * 1e3:.2f} us{lib}), "
            f"per call with launch {row['call_ms'] * 1e3:.1f} us (plain {row['plain_call_ms'] * 1e3:.1f} us), "
            f"bound {row['bound_ms'] * 1e3:.3f} us by {row['bound_by']}, {row['bytes']} B")


def check_kernels(torch) -> dict:
    from repro_torch.kernels.iou_match.kernel import iou_matrix
    from repro_torch.kernels.iou_match.ref import iou_ref
    from repro_torch.kernels.thompson.kernel import thompson_choose
    from repro_torch.kernels.thompson.ref import thompson_ref

    rows = {}
    for c, m, all_ex in ((50, 22, False), (50, 1000, False), (50, 10000, False),
                         (7, 1025, False), (3, 64, True)):
        alpha, beta, z = thompson_inputs(c, m, seed=c * 7919 + m, all_exhausted=all_ex)
        ki, kv = thompson_choose(alpha, beta, z)
        ri, rv = thompson_ref(alpha, beta, z)
        torch.cuda.synchronize()
        if not torch.equal(ki, ri) or not bits_equal(kv, rv):
            fail(f"thompson_choose != plain at (C={c}, M={m}): idx {ki.tolist()} vs {ri.tolist()}")
        if all_ex and not (bool((ki == -1).all()) and bool((kv == -1e30).all())):
            fail("thompson_choose on an all-exhausted row must give (-1, -1e30)")
        live = int((alpha > 0).sum())
        nbytes = 8 * m + 4 * c * m + 8 * c
        ops = 14 * c * live
        row = timed_row(lambda: thompson_choose(alpha, beta, z), lambda: thompson_ref(alpha, beta, z),
                        shape=[c, m], bytes=nbytes, ops=ops,
                        max_abs_err=float((kv - rv).abs().max()) if live else 0.0)
        rows[("thompson_choose", c, m)] = row
        print(f"  thompson_choose C={c:>3} M={m:>5}{' all-exhausted' if all_ex else ''}: equal; "
              + describe(row))
    for d, r in ((16, 8192), (13, 1000), (1, 1)):
        a, b = iou_inputs(d, r, seed=d * 131 + r)
        k = iou_matrix(a, b)
        p = iou_ref(a, b)
        torch.cuda.synchronize()
        if not bits_equal(k, p):
            bad = int((k.view(torch.int32) != p.view(torch.int32)).sum())
            fail(f"iou_matrix != plain at (D={d}, R={r}): {bad} entries differ")
        nbytes = 16 * d + 16 * r + 4 * d * r
        row = timed_row(lambda: iou_matrix(a, b), lambda: iou_ref(a, b), shape=[d, r],
                        bytes=nbytes, ops=20 * d * r, max_abs_err=float((k - p).abs().max()))
        rows[("iou_matrix", d, r)] = row
        print(f"  iou_matrix D={d:>3} R={r:>5}: bit-equal; " + describe(row))
    check_batched_kernels(torch, rows)
    check_match_update(torch, rows)
    check_round_kernels(torch, rows)
    print(f"  kernels_a_call so far: {CAPTURES['captures']} profiler captures, the fewest leading fills one kept "
          f"{CAPTURES['fewest_fills_kept']} of {SPARES}, {CAPTURES['retakes']} retakes")
    return rows


def check_batched_kernels(torch, rows) -> None:
    """B2 against its plain version (index exact, value bitwise) and the
    batched B3 against its plain version and the 2-D kernel per slice."""
    from repro_torch.kernels.iou_match.kernel import iou_matrix, iou_matrix_batched
    from repro_torch.kernels.iou_match.ref import iou_ref
    from repro_torch.kernels.thompson.kernel import thompson_choose, thompson_choose_batched
    from repro_torch.kernels.thompson.ref import thompson_ref

    for q, c, m in ((8, 50, 22), (8, 50, 1000), (8, 50, 10000), (3, 7, 1025)):
        alpha, beta, z = thompson_batched_inputs(q, c, m, seed=q * 131 + c * 7919 + m)
        ki, kv = thompson_choose_batched(alpha, beta, z)
        ri, rv = thompson_ref(alpha, beta, z)
        torch.cuda.synchronize()
        if not torch.equal(ki, ri) or not bits_equal(kv, rv):
            bad = int((ki != ri).sum())
            fail(f"thompson_choose_batched != plain at (Q={q}, C={c}, M={m}): {bad} indices differ")
        if not (bool((ki[-1] == -1).all()) and bool((kv[-1] == -1e30).all())):
            fail("thompson_choose_batched on an all-exhausted query must give (-1, -1e30)")
        for i in range(q):
            bi, bv = thompson_choose(alpha[i].contiguous(), beta[i].contiguous(), z[i].contiguous())
            if not torch.equal(ki[i], bi) or not bits_equal(kv[i], bv):
                fail(f"thompson_choose_batched query {i} != thompson_choose at (C={c}, M={m})")
        live = int((alpha > 0).sum())
        nbytes = 8 * q * m + 4 * q * c * m + 8 * q * c
        row = timed_row(lambda: thompson_choose_batched(alpha, beta, z),
                        lambda: thompson_ref(alpha, beta, z),
                        shape=[q, c, m], bytes=nbytes, ops=14 * c * live,
                        max_abs_err=float((kv - rv).abs().max()))
        rows[("thompson_choose_batched", q, c, m)] = row
        print(f"  thompson_choose_batched Q={q} C={c:>3} M={m:>5} (last query all exhausted): equal, "
              f"and equal to B1 per query; " + describe(row))
    for q, d, r in ((8, 16, 8192), (3, 13, 1000)):
        pairs = [iou_inputs(d, r, seed=q * 977 + i * 131 + d + r) for i in range(q)]
        a = torch.stack([p[0] for p in pairs]).contiguous()
        b = torch.stack([p[1] for p in pairs]).contiguous()
        k = iou_matrix_batched(a, b)
        p = iou_ref(a, b)
        torch.cuda.synchronize()
        if not bits_equal(k, p):
            bad = int((k.view(torch.int32) != p.view(torch.int32)).sum())
            fail(f"iou_matrix_batched != plain at (Q={q}, D={d}, R={r}): {bad} entries differ")
        for i in range(q):
            if not bits_equal(k[i], iou_matrix(a[i].contiguous(), b[i].contiguous())):
                fail(f"iou_matrix_batched slice {i} != iou_matrix at (D={d}, R={r})")
        nbytes = q * (16 * d + 16 * r + 4 * d * r)
        row = timed_row(lambda: iou_matrix_batched(a, b), lambda: iou_ref(a, b),
                        shape=[q, d, r], bytes=nbytes, ops=20 * q * d * r,
                        max_abs_err=float((k - p).abs().max()))
        rows[("iou_matrix_batched", q, d, r)] = row
        print(f"  iou_matrix_batched Q={q} D={d:>3} R={r:>5}: bit-equal, and equal to the 2-D kernel "
              f"per slice; " + describe(row))


def match_case(torch, case, *, query_stride=False):
    """A state of ``tests/_match_states.py`` (``frame_case`` or
    ``batch_case``) on the card: (MatcherState, detections and ids as the
    scan path gives them: video and chunk int32, frame int64); with
    ``query_stride`` the detections are a cohort slot's view of a [Q, 2, D]
    batch, as the multi path gives them."""
    from repro_torch.core.matcher import MatcherState
    from repro_torch.kernels.iou_match.ref import RING_FIELDS

    cuda = torch.device("cuda")
    state = MatcherState(**{k: torch.as_tensor(case["ring"][k]).to(cuda) for k in RING_FIELDS},
                         time_gate=case["time_gate"])
    det = [torch.as_tensor(case["det"][k]).to(cuda) for k in ("boxes", "feats", "valid")]
    if query_stride:
        det = [torch.stack([torch.zeros_like(v), v], 1)[:, 1] for v in det]
    ids = [torch.as_tensor(v, dtype=t, device=cuda)
           for v, t in zip(case["ids"], (torch.int32, torch.int64, torch.int32))]
    return state, (*det, *ids)


def step_diffs(got, want) -> list[str]:
    """The outputs and ring fields on which two matcher steps differ (bits
    and dtype)."""
    from repro_torch.kernels.iou_match.ref import RING_FIELDS

    pairs = [(n, getattr(got, n), getattr(want, n)) for n in got._fields if n != "new_state"]
    pairs += [(n, getattr(got.new_state, n), getattr(want.new_state, n)) for n in RING_FIELDS]
    return [n for n, a, b in pairs if not bits_equal(a, b)]


def match_bytes(q: int, d: int, r: int, f: int) -> int:
    """Bytes the fused step must move: per slot the ring's box, features,
    video, frame, chunk and times_seen read and written and cross_home
    written; per detection its box, features and valid read and is_new
    written; per query the three ids (at most 8 bytes each), cursor and
    total read and five int32 scalars written."""
    return q * (r * (2 * (32 + 4 * f) + 4) + d * (16 + 4 * f + 2) + 24 + 8 + 20)


def round_inputs(q, c: int, m: int, seed: int, kind: str):
    """A key (int64[2]; ``q`` None) or Q keys (``fold_in`` of one) and a
    ``SamplerState`` of M chunks on the card (see ROUND_SHAPES); with Q
    queries the last has every chunk exhausted."""
    import numpy as np
    import torch

    from repro_torch.core import prng
    from repro_torch.core.state import SamplerState

    rng = np.random.default_rng(seed)
    shape = (1 if q is None else q, m)
    if kind == "sampler":
        n1 = rng.integers(0, 30, shape).astype(np.float32)
        n = rng.integers(0, 400, shape).astype(np.float32)
        frames = np.where(rng.random(shape) < 0.2, n, n + rng.integers(1, 500, shape)).astype(np.int32)
    else:
        n1, n = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
        frames = np.full(shape, 100, np.int32)
        frames[:, 0] = 0
    if q is not None:
        n[-1] = frames[-1]
    key = prng.PRNGKey(seed % 2**31, device="cuda")
    if q is None:
        n1, n, frames = n1[0], n[0], frames[0]
    else:
        key = torch.stack([prng.fold_in(key, i) for i in range(q)])
    state = SamplerState(n1=torch.from_numpy(n1).cuda(), n=torch.from_numpy(n).cuda(),
                         frames=torch.from_numpy(frames).cuda())
    return key, state


def round_ops(key, state, cohorts: int) -> int:
    """The operations the fused round does on these inputs (ROUND_OPS a
    visit, a chunk not exhausted and a live element, each live element's
    log1p and ErfInv by the branch its uniform takes)."""
    import numpy as np

    from repro_torch.core import prng
    from repro_torch.core.thompson import gamma_params

    alpha, _ = gamma_params(state)
    open_ = ~state.exhausted()
    live = open_ & (alpha > 0)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = prng.uniform(key, (cohorts, state.num_chunks), lo, 1.0)
    t = u * -u
    small = t.abs() < prng._f32(0.41421356237309504880)
    lt = -prng._xla_log1p_f32(t) < 5.0
    live = live[..., None, :].expand_as(u)
    o = ROUND_OPS
    per_live = (o["live"] + (small * o["log1p_small"] + ~small * o["log1p_large"])
                + (lt * o["erfinv_lt"] + ~lt * o["erfinv_ge"]))
    return int(o["visit"] * u.numel() + o["stats"] * cohorts * int(open_.sum()) + per_live[live].sum())


def check_round_kernels(torch, rows) -> None:
    """The fused round (``thompson_round``, batched ``thompson_round_batched``)
    against its plain version on the card, bit for bit on idx and val; one
    device kernel a call; batched, each query equal to the single round on
    its key.  Beside each row, the old path for the same work: the normal
    op by op, then B1 (B2)."""
    from repro_torch.core.thompson import _kernel_inputs
    from repro_torch.kernels.thompson.kernel import (round_splits, thompson_choose, thompson_choose_batched,
                                                     thompson_round, thompson_round_batched)
    from repro_torch.kernels.thompson.ref import thompson_round_ref

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(q, c, m, kind) for q, c, m in [(None, c, m) for c, m in ROUND_SHAPES] + list(ROUND_BATCHED_SHAPES)
             for kind in ("sampler", "fresh")]
    checked = []
    # every row's checks first: the timing's profiles of the op-by-op paths
    # (~850 launches a call) come after every one-kernel-a-call capture
    for (q, c, m, kind) in cases:
        key, state = round_inputs(q, c, m, seed=(q or 1) * 131 + c * 7919 + m, kind=kind)
        fn = thompson_round if q is None else thompson_round_batched
        ki, kv = fn(key, state, c)
        ri, rv = thompson_round_ref(key, state, c)
        torch.cuda.synchronize()
        if not torch.equal(ki, ri) or not bits_equal(kv, rv):
            fail(f"{fn.__name__} != plain at (Q={q}, C={c}, M={m}, {kind}): "
                 f"{int((ki != ri).sum())} indices differ")
        if q is not None:
            if not (bool((ki[-1] == -1).all()) and bool((kv[-1] == -1e30).all())):
                fail(f"{fn.__name__} on an all-exhausted query must give (-1, -1e30)")
            for i in range(q):
                one = dataclasses.replace(state, n1=state.n1[i], n=state.n[i], frames=state.frames[i])
                bi, bv = thompson_round(key[i].contiguous(), one, c)
                if not torch.equal(ki[i], bi) or not bits_equal(kv[i], bv):
                    fail(f"thompson_round_batched query {i} != thompson_round at (C={c}, M={m}, {kind})")
        names = kernels_a_call(lambda: fn(key, state, c))
        if len(names) != 1:
            fail(f"{fn.__name__} at (Q={q}, C={c}, M={m}) launched {names}, not one kernel")
        checked.append((q, c, m, kind, key, state, fn, int((rv == 0.0).sum())))
    for (q, c, m, kind, key, state, fn, zero_rows) in checked:
        old = thompson_choose if q is None else thompson_choose_batched
        qn = q or 1
        row = timed_row(lambda: fn(key, state, c), lambda: thompson_round_ref(key, state, c), n=50, plain_n=5,
                        inner=10, reps=5, ops_per_s=ISSUE_OPS_PER_S, shape=[c, m] if q is None else [q, c, m],
                        state=kind, bytes=16 * qn + 12 * qn * m + 8 * qn * c, ops=round_ops(key, state, c),
                        max_abs_err=0.0, splits=round_splits(qn * c, m, sms))
        row.update(old_ms=device_ms(lambda: old(*_kernel_inputs(key, state, c)), n=5),
                   old_call_ms=median_ms(lambda: old(*_kernel_inputs(key, state, c)), inner=5, reps=5))
        old_device = "not measured" if row["old_ms"] is None else f"{row['old_ms'] * 1e3:.2f} us"
        name = fn.__name__
        rows[(name, c, m, kind) if q is None else (name, q, c, m, kind)] = row
        print(f"  {name} {'' if q is None else f'Q={q} '}C={c:>3} M={m:>5} {kind:<7} "
              f"({row['splits']} blocks a row, {zero_rows} rows drawing 0"
              f"{', last query all exhausted' if q else ''}): bit-equal, one kernel a call; "
              + describe(row) + f"; {row['ops']} operations; old path (normal op by op + "
              f"{old.__name__}) device {old_device}, per call {row['old_call_ms'] * 1e3:.1f} us")


def check_match_update(torch, rows) -> None:
    """The fused matcher step (B3's match_update, 2-D and batched) against
    its plain version on the card, bit for bit on every output and ring
    field, on states built to hit each of its rules (tests/_match_states.py:
    ties across the cluster's block boundaries, an IoU exactly at the
    threshold, |Δframe| at and one past the gate, another video, an empty
    slot, invalid detections, 1 -> 2 from another chunk, several detections
    on one entry, a full ring wrapping over a slot bumped in the same
    frame, and, batched, an inactive query); one device kernel a call;
    each batched slice equal to the 2-D kernel."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _match_states import batch_case, frame_case
    from repro_torch.kernels.iou_match.kernel import match_update, match_update_batched
    from repro_torch.kernels.iou_match.ref import RING_FIELDS, match_update_ref

    for d, r in MATCH_SHAPES:
        case = frame_case(d * 131 + r, d, r)
        state, args = match_case(torch, case)
        k = match_update(state, *args)
        p = match_update_ref(state, *args)
        torch.cuda.synchronize()
        diffs = step_diffs(k, p)
        if diffs:
            fail(f"match_update != plain at (D={d}, R={r}) on {diffs}")
        names = kernels_a_call(lambda: match_update(state, *args))
        if len(names) != 1:
            fail(f"match_update at (D={d}, R={r}) launched {names}, not one kernel")
        f = state.feats.shape[-1]
        row = timed_row(lambda: match_update(state, *args), lambda: match_update_ref(state, *args),
                        shape=[d, r], bytes=match_bytes(1, d, r, f), ops=25 * d * r, max_abs_err=0.0)
        rows[("match_update", d, r)] = row
        print(f"  match_update D={d:>3} R={r:>5}: bit-equal on every output (d0 {int(k.d0)}, d1 {int(k.d1)}, "
              f"cross_chunk {int(k.cross_chunk)}, roles {sorted(case['roles'])}), one kernel a call; "
              + describe(row))
    for q, d, r in MATCH_BATCHED_SHAPES:
        case = batch_case(q * 977 + d + r, q, d, r)
        state, args = match_case(torch, case, query_stride=True)
        k = match_update_batched(state, *args)
        p = match_update_ref(state, *args)
        torch.cuda.synchronize()
        diffs = step_diffs(k, p)
        if diffs:
            fail(f"match_update_batched != plain at (Q={q}, D={d}, R={r}) on {diffs}")
        if bool(k.is_new[-1].any()) or int(k.d0[-1]) or int(k.d1[-1]):
            fail("match_update_batched: the inactive query's detections counted")
        for i, one in enumerate(case["cases"]):
            one_state, one_args = match_case(torch, one)
            solo = match_update(one_state, *one_args)
            sliced = k._replace(**{n: getattr(k, n)[i] for n in k._fields[:5]}, new_state=dataclasses.replace(
                k.new_state, **{n: getattr(k.new_state, n)[i] for n in RING_FIELDS}))
            if step_diffs(sliced, solo):
                fail(f"match_update_batched query {i} != match_update at (D={d}, R={r})")
        names = kernels_a_call(lambda: match_update_batched(state, *args))
        if len(names) != 1:
            fail(f"match_update_batched at (Q={q}, D={d}, R={r}) launched {names}, not one kernel")
        f = state.feats.shape[-1]
        row = timed_row(lambda: match_update_batched(state, *args), lambda: match_update_ref(state, *args),
                        shape=[q, d, r], bytes=match_bytes(q, d, r, f), ops=25 * q * d * r, max_abs_err=0.0)
        rows[("match_update_batched", q, d, r)] = row
        print(f"  match_update_batched Q={q} D={d:>3} R={r:>5} (last query inactive): bit-equal on every "
              f"output, and equal to the 2-D kernel per query; one kernel a call; " + describe(row))


def sdpa_backend(fn) -> tuple[str, list[str]]:
    """Which backend ``scaled_dot_product_attention`` ran, read from the
    names of the device kernels of one call."""
    names = sorted(set(kernels_a_call(fn)))
    low = " ".join(names).lower()
    for key, label in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                       ("mem_eff", "efficient"), ("efficient", "efficient")):
        if key in low:
            return label, names
    return "math", names


def visible_pairs(s: int, t: int, causal: bool) -> int:
    """(row, column) pairs the top-left causal rule leaves live."""
    if not causal:
        return s * t
    m = min(s, t)
    return m * (m + 1) // 2 + (s - m) * t


def attn_compare(out, ref, dtype: str) -> tuple:
    """(max |out - ref|, mean |ref|, largest |out - ref| / limit), the limit
    being ATTN_ATOL + ATTN_RTOL·|ref| capped at ATTN_CAP, per element."""
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    limit = (ATTN_ATOL + ATTN_RTOL[dtype] * mag).clamp(max=ATTN_CAP)
    return float(diff.max()), float(mag.mean()), float((diff / limit).max())


# the forward's lse2 (base 2) times ln 2 against attention_lse_ref: within LSE_RTOL of max |lse|
LSE_RTOL = 1e-5


def check_forward_lse(torch, q, k, v, out, causal: bool, label) -> float:
    """B4's "wgmma_f32" body asked for its rows' lse2: the output keeps its
    bits (``out`` came without lse), and lse2·ln 2 is ``attention_lse_ref``
    within ``LSE_RTOL`` of its largest magnitude.  Returns that error over
    the magnitude."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref

    b, s, h, _ = q.shape
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with_lse = flash_attention(q, k, v, causal=causal, lse=lse)
    if not bits_equal(with_lse, out):
        fail(f"flash_attention at {label}: the output with lse differs from the output without it")
    want = attention_lse_ref(q, k, causal=causal)
    rel = float((lse * math.log(2.0) - want).abs().max()) / float(want.abs().max())
    if not (math.isfinite(rel) and rel <= LSE_RTOL):
        fail(f"flash_attention at {label}: lse2 x ln 2 off the plain lse by {rel:.3g} x max |lse| "
             f"(limit {LSE_RTOL})")
    return rel


def check_attention_kernels(torch, rows) -> None:
    """B4 and B5 against their plain versions on the card (float32 within
    1e-4; bfloat16 within about one bf16 ulp, see ATTN_RTOL), each B4 row on
    the body ``select_body`` names, timed beside SDPA, the PyTorch call that
    computes the same function (never used by the port).  SDPA's GQA keeps
    its memory-efficient backend away from float32, so a float32 B4 row and
    every B5 row also time SDPA on K/V repeated to H heads outside the
    timed call, and the library time is the faster of the two.  A "wgmma_f32" row's bound is
    its 3xTF32 products at the TF32 rate (or its bytes), printed beside the
    float32-FMA bound.  A B5 row prints its splits and the device kernels
    of one call, and fails unless that is one kernel and the row beats its
    plain version."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention, select_body
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.flash_decode.kernel import decode_splits, flash_decode
    from repro_torch.kernels.flash_decode.ref import decode_ref

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(g, shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(getattr(torch, dtype))

    for b, s, t, h, kv, d, dtype, causal in B4_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(b * s + t + h + d)
        q, k, v = randn(g, (b, s, h, d), dtype), randn(g, (b, t, kv, d), dtype), randn(g, (b, t, kv, d), dtype)
        before = dict(flash_attention.launches_by_body)
        out = flash_attention(q, k, v, causal=causal)
        ref = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        body = [n for n, c in flash_attention.launches_by_body.items() if c != before[n]]
        want = select_body(q.dtype, d)
        if body != [want]:
            fail(f"flash_attention at {(b, s, t, h, kv, d, dtype, causal)} ran body {body}, expected {want}")
        err, mag, worst = attn_compare(out, ref, dtype)
        if not worst <= 1.0:
            fail(f"flash_attention != plain at {(b, s, t, h, kv, d, dtype, causal)}: max |diff| {err}, "
                 f"mean |ref| {mag}, largest |diff| / limit {worst}")
        lse_text = ""
        if want == "wgmma_f32":
            lse_err = check_forward_lse(torch, q, k, v, out, causal, (b, s, t, h, kv, d, dtype, causal))
            lse_text = f"; lse2 x ln 2 within {lse_err:.3g} x max |lse| of the plain one, the output's bits unchanged"
        del out, ref
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

        backend, names = sdpa_backend(library)
        ops = 4 * d * visible_pairs(s, t, causal) * b * h
        big = ops > 5e10
        n_avg = 3 if big else 20
        if want == "wgmma_f32":            # 3 TF32 products for each float32 one
            issued, ops_per_s = 3 * ops, TF32_OPS_PER_S
        else:
            issued, ops_per_s = ops, F32_OPS_PER_S if dtype == "float32" else BF16_OPS_PER_S
        row = timed_row(lambda: flash_attention(q, k, v, causal=causal),
                        lambda: attention_ref(q, k, v, causal=causal), library=library,
                        n=n_avg, inner=2 if big else 10, reps=3 if big else 5, ops_per_s=ops_per_s,
                        shape=[b, s, t, h, kv, d], dtype=dtype, causal=causal,
                        bytes=(2 * q.numel() + k.numel() + v.numel()) * q.element_size(), ops=issued,
                        needed_ops=ops, max_abs_err=err, mean_abs_ref=mag, diff_over_limit=worst,
                        sdpa_backend=backend, body=want)
        row["library_gqa_ms"] = row["library_ms"]
        lib_text = f"SDPA (GQA) {backend} {row['library_ms'] * 1e3:.2f} us"
        if dtype == "float32":
            kr, vr = (x.repeat_interleave(h // kv, dim=1) for x in (kt, vt))

            def repeated():
                return F.scaled_dot_product_attention(qt, kr, vr, is_causal=causal)

            rep_backend, _ = sdpa_backend(repeated)
            # by the row's clock (timed_row's source)
            rep_ms = (device_ms(repeated, n=n_avg) if row["source"] == "profiler" else None) or \
                median_ms(repeated, inner=2 if big else 10, reps=3 if big else 5)
            row.update(sdpa_repeat_backend=rep_backend, library_repeat_ms=rep_ms,
                       library_ms=min(row["library_ms"], rep_ms),
                       fma_bound_ms=max(row["bytes"] / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3)
            lib_text += f", on K/V repeated to H heads {rep_backend} {rep_ms * 1e3:.2f} us"
            del kr, vr
        fma = "" if "fma_bound_ms" not in row else f", float32-FMA bound {row['fma_bound_ms'] * 1e3:.1f} us"
        rows[("flash_attention", b, s, t, h, kv, d, dtype, causal)] = row
        print(f"  flash_attention (B,S,T,H,KV,d)=({b},{s},{t},{h},{kv},{d}) {dtype} "
              f"{'causal' if causal else 'full'} [{want}]: max |diff| {err:.3g} (mean |ref| {mag:.3g}, "
              f"largest |diff| / limit {worst:.3g}){lse_text}; " + describe(row)
              + f" ({issued:.4g} operations at {ops_per_s / 1e12:g} TFLOP/s{fma}); {lib_text} "
              f"({', '.join(n[:60] for n in names[:3])})")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    print(f"  B4 launches by body in this phase (comparisons and timing): {flash_attention.launches_by_body}")

    for b, h, kv, d, t, dtype, lens in B5_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(b * h + kv + d + t)
        q, kc, vc = randn(g, (b, h, d), dtype), randn(g, (b, t, kv, d), dtype), randn(g, (b, t, kv, d), dtype)
        cache_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = flash_decode(q, kc, vc, cache_len)
        ref = decode_ref(q, kc, vc, cache_len)
        torch.cuda.synchronize()
        err, mag, worst = attn_compare(out, ref, dtype)
        if not worst <= 1.0:
            fail(f"flash_decode != plain at {(b, h, kv, d, t, dtype, lens)}: max |diff| {err}, "
                 f"mean |ref| {mag}, largest |diff| / limit {worst}")
        for i, n in enumerate(lens):
            if n == 0:       # an empty cache gives the mean of V over all T, as the reference
                mean = vc[i].float().mean(dim=0).repeat_interleave(h // kv, dim=0).to(out.dtype)
                if not attn_compare(out[i], mean, dtype)[2] <= 1.0:
                    fail(f"flash_decode with cache_len 0 is not the mean of V at {(b, h, kv, d, t)}")
        del out, ref
        q4 = q[:, :, None, :].contiguous()
        kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
        mask = (torch.arange(t, device="cuda")[None, :] < cache_len[:, None])[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask, enable_gqa=True)

        kr, vr = (x.repeat_interleave(h // kv, dim=1) for x in (kt, vt))

        def repeated():
            return F.scaled_dot_product_attention(q4, kr, vr, attn_mask=mask)

        backend, names = sdpa_backend(library)
        rep_backend, _ = sdpa_backend(repeated)
        # the positions whose V (every live one) and K (only where cache_len
        # > 0: an empty cache's output is the mean of V) the function reads
        v_live = sum(t if n <= 0 else min(n, t) for n in lens)
        k_live = sum(min(n, t) for n in lens if n > 0)
        es = q.element_size()
        splits = decode_splits(b, t, h, kv, sms)
        launched = kernels_a_call(lambda: flash_decode(q, kc, vc, cache_len))
        row = timed_row(lambda: flash_decode(q, kc, vc, cache_len),
                        lambda: decode_ref(q, kc, vc, cache_len), library=library,
                        n=20, inner=10, reps=5,
                        ops_per_s=F32_OPS_PER_S if dtype == "float32" else BF16_OPS_PER_S,
                        shape=[b, h, kv, d, t], dtype=dtype, cache_len=list(lens),
                        bytes=2 * q.numel() * es + (k_live + v_live) * kv * d * es,
                        ops=2 * d * h * (k_live + v_live), splits=splits,
                        kernels_a_call=len(launched), max_abs_err=err, mean_abs_ref=mag,
                        diff_over_limit=worst, sdpa_backend=backend)
        rep_ms = (device_ms(repeated, n=20) if row["source"] == "profiler" else None) or \
            median_ms(repeated, inner=10, reps=5)
        row.update(library_gqa_ms=row["library_ms"], sdpa_repeat_backend=rep_backend,
                   library_repeat_ms=rep_ms, library_ms=min(row["library_ms"], rep_ms))
        # keyed by the lengths too: the serve row and its full-cache twin share every other field
        rows[("flash_decode", b, h, kv, d, t, dtype, tuple(lens))] = row
        print(f"  flash_decode (B,H,KV,d,T)=({b},{h},{kv},{d},{t}) {dtype} cache_len {list(lens)}: "
              f"max |diff| {err:.3g} (mean |ref| {mag:.3g}, largest |diff| / limit {worst:.3g}); "
              + describe(row)
              + f"; SDPA (GQA) {backend} {row['library_gqa_ms'] * 1e3:.2f} us "
              f"({', '.join(n[:60] for n in names[:3])}), on K/V repeated to H heads {rep_backend} "
              f"{rep_ms * 1e3:.2f} us; {splits} splits a (batch, KV head, head group), "
              f"{len(launched)} device kernel(s) a call {sorted(set(n[:40] for n in launched))}")
        if len(launched) != 1:
            fail(f"flash_decode at {(b, h, kv, d, t, dtype)} launched {len(launched)} device kernels a call")
        if row["ms"] > row["plain_ms"]:
            fail(f"flash_decode at {(b, h, kv, d, t, dtype, lens)}: {row['ms'] * 1e3:.1f} us, slower than "
                 f"its plain version's {row['plain_ms'] * 1e3:.1f} us (both by {row['source']})")
        del q, kc, vc, q4, kt, vt, kr, vr
        torch.cuda.empty_cache()


# ------------------------------------------------------------- main path

def reset_launches() -> None:
    from repro_torch.kernels import counted_wrappers

    for fn in counted_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_body"):
            fn.launches_by_body = dict.fromkeys(fn.launches_by_body, 0)
        if hasattr(fn, "launches_by_shape"):
            fn.launches_by_shape = {}


def read_launches() -> dict:
    from repro_torch.kernels import launch_counts

    return launch_counts()


def detector_of(name: str, repo, query_class):
    """The CLI's ``--detector``: "oracle" or "noisy" (misses, jitter and
    false positives drawn from the key stream inside the round)."""
    from repro_torch.sim import noisy_detect, oracle_detect

    if name == "noisy":
        return lambda key, frame: noisy_detect(key, repo, frame, query_class=query_class)
    return lambda key, frame: oracle_detect(repo, frame, query_class=query_class)


def run_search(torch, setup, plan_dict, device, kind="scan", around=contextlib.nullcontext,
               feat_thresh=-1.0, detector="oracle"):
    """One search; ``around()`` is entered around ``plan.run`` alone (set-up
    excluded); ``feat_thresh`` the matcher's (-1: IoU only, every entry
    point's); ``detector`` as :func:`detector_of`; the plan's execution
    (a repository index) is kept, its strategy set to ``kind``.  Returns
    (SearchResult, wall seconds of plan.run, M)."""
    from repro_torch.core import SearchPlan, init_carry, init_matcher, init_state, prng
    from repro_torch.sim import generate

    repo, chunks = generate(setup.repo, device=device)
    plan = SearchPlan.from_dict(dict(plan_dict, execution=dict(plan_dict.get("execution", {}), strategy=kind)))
    det = detector_of(detector, repo, 0)

    carry = init_carry(init_state(chunks.length, device=device),
                       init_matcher(max_results=MATCHER_CAPACITY, feat_thresh=feat_thresh, device=device),
                       prng.PRNGKey(0, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize()
    with around():
        t0 = time.perf_counter()
        res = plan.run(carry, chunks, detector=det)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return res, wall, chunks.num_chunks


def same_search(a, b) -> list[str]:
    """Field names on which two SearchResults differ."""
    diffs = [f for f in ("steps", "results", "traces") if getattr(a, f) != getattr(b, f)]
    if dataclasses.asdict(a.stats) != dataclasses.asdict(b.stats):
        diffs.append("stats")
    diffs += same_carry(a.carry, b.carry)
    if a.final_cache is not None or b.final_cache is not None:
        if a.final_cache is None or b.final_cache is None:
            return diffs + ["final_cache"]
        cap = a.final_cache.capacity
        if not bits_equal(a.final_cache.tag[:cap].cpu(), b.final_cache.tag[:cap].cpu()):
            diffs.append("cache.tag")
    return diffs


def same_carry(a, b) -> list[str]:
    """Field names on which two carries differ, bit for bit."""
    pairs = [("sampler." + f, getattr(a.sampler, f), getattr(b.sampler, f)) for f in ("n1", "n", "frames")]
    pairs += [("matcher." + f, getattr(a.matcher, f), getattr(b.matcher, f))
              for f in ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted")]
    pairs += [("key", a.key, b.key), ("step", a.step, b.step), ("results", a.results, b.results)]
    return [name for name, x, y in pairs if not bits_equal(x.cpu(), y.cpu())]


def loop_launches(name, res, counted: dict, per_round: dict, live_rounds: int) -> dict:
    """The kernels' launches on the card in one search through the resident
    loop.  Its first round runs op by op, then one round captured as a CUDA
    graph is replayed; the wrappers count a captured call once, and each
    replay launches it again.  Fails unless the round was captured holding
    ``per_round`` launches, the replays came K at a time with one read of
    the exit test after each K, and every kernel of ``per_round`` ran once
    a round for the eager round and each replay; prints the capture's
    time, K, the replays and the syncs."""
    loop = res.loop
    if loop is None or not loop.captured:
        fail(f"{name}: the rounds were not replayed from a CUDA graph ({loop})")
    if loop.captured_launches != per_round:
        fail(f"{name}: the captured round holds {loop.captured_launches}, want {per_round}")
    k, run = loop.rounds_per_sync, loop.eager_rounds + loop.replays
    if loop.eager_rounds != 1 or loop.replays != k * (loop.syncs - 1) or not live_rounds <= run <= live_rounds + k:
        fail(f"{name}: {loop} for {live_rounds} rounds with a live query")
    launches = dict(counted)
    for kernel, n in per_round.items():
        launches[kernel] += n * (loop.replays - 1)
        if launches[kernel] != n * run:
            fail(f"{name}: {kernel} launched {launches[kernel]} times in {run} rounds, want {n} a round")
    print(f"    resident loop: capture {loop.capture_s * 1e3:.1f} ms, K = {k}; 1 eager round + {loop.replays} "
          f"replays = {run} rounds, {run - live_rounds} of them past the exit (masked); {loop.syncs} reads of "
          f"the exit test ({loop.syncs / max(live_rounds, 1):.3f} a live round)")
    return launches


def main_path(torch, name, setup, detector="oracle") -> tuple[dict, dict]:
    """The scan kind at ``MAIN_PLAN`` on the card; the same search cut to
    ``MAIN_CHECK_STEPS`` frames held exactly to the CPU (through the CPU
    run's pinned digest, ``SCAN_PINNED``); returns (launches, metrics)."""
    cuda = torch.device("cuda")
    cohorts = MAIN_PLAN["cohorts"]
    reset_launches()
    gpu, gpu_s, m = run_search(torch, setup, MAIN_PLAN, cuda, detector=detector)
    counted = read_launches()
    check = dict(MAIN_PLAN, max_steps=MAIN_CHECK_STEPS)
    card_check = run_search(torch, setup, check, cuda, detector=detector)[0]
    frames = gpu.steps[0]
    rounds = frames // cohorts
    for (s, r) in gpu.trace:
        if s < 0 or r < 0:
            fail(f"{name}: malformed trace entry {(s, r)}")
    if not all(math.isfinite(v) for v in gpu.carry.sampler.n1.tolist()):
        fail(f"{name}: non-finite sampler state")
    if gpu.results[0] <= 0 or frames <= 0:
        fail(f"{name}: the search found nothing ({gpu.results}, {gpu.steps})")
    digest = result_digest(card_check)
    if digest != SCAN_PINNED[name]:
        fail(f"{name}: card run's digest {digest} != the CPU run's pinned {SCAN_PINNED[name]}")
    print(f"  {name}: M={m} chunks, {gpu.results[0]} results in {frames} frames / {rounds} rounds; "
          f"card {frames / gpu_s:.1f} frames/s {rounds / gpu_s:.2f} rounds/s ({gpu_s:.2f} s); cut to "
          f"{MAIN_CHECK_STEPS} frames, card == CPU exactly ({card_check.steps[0]} frames: steps, results, trace, "
          f"stats, sampler, ring, key: the CPU run's pinned digest)")
    launches = loop_launches(name, gpu, counted, {"thompson_round": 1, "match_update": cohorts}, rounds)
    if any(v for k, v in launches.items() if k not in ("thompson_round", "match_update")):
        fail(f"{name}: launches {launches}: only thompson_round and match_update may run")
    print(f"    launches {launches}")
    return launches, dict(frames=frames, results=gpu.results[0], frames_per_s=frames / gpu_s,
                          capture_ms=gpu.loop.capture_s * 1e3, wall_s=gpu_s)


def rounds_per_sync_sweep(torch, name, setup) -> None:
    """Frames/s of the full-size scan (``MAIN_PLAN``) on the card through
    ``_scan_search`` at each of ``ROUNDS_PER_SYNC_SWEEP`` rounds a read of
    the exit test, two runs each, the second pass in reverse order; every
    run's trajectory and trace must be the same."""
    from repro_torch.core import exsample, init_carry, init_matcher, init_state, prng
    from repro_torch.sim import generate, oracle_detect

    cuda = torch.device("cuda")
    repo, chunks = generate(setup.repo, device=cuda)
    rates, first = {}, None
    for order in (ROUNDS_PER_SYNC_SWEEP, tuple(reversed(ROUNDS_PER_SYNC_SWEEP))):
        for k in order:
            carry = init_carry(init_state(chunks.length, device=cuda),
                               init_matcher(max_results=MATCHER_CAPACITY, device=cuda), prng.PRNGKey(0, device=cuda))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, trace, loop = exsample._scan_search(
                carry, chunks, detector=lambda key, f: oracle_detect(repo, f, query_class=0),
                rounds_per_sync=k, **MAIN_PLAN)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = (int(out.step), int(out.results), trace)
            if first is not None and got != first:
                fail(f"{name}: the scan at {k} rounds a sync differs from the first run: {got[:2]} != {first[:2]}")
            first = got
            rates.setdefault(k, []).append((got[0] / wall, loop.syncs, loop.replays, loop.capture_s))
    for k, runs in rates.items():
        print(f"  {name} at K = {k}: frames/s {', '.join(f'{r[0]:.1f}' for r in runs)}; {runs[0][1]} reads of "
              f"the exit test, {runs[0][2]} replays; capture {', '.join(f'{r[3] * 1e3:.1f}' for r in runs)} ms")


def profile_path(torch, label: str, run, cohorts: int, warm: bool = True) -> dict:
    """Where the time goes: torch.profiler over one search on the card
    (``run(around) -> (SearchResult, wall seconds)``, profiling only
    ``plan.run``, not the repository's generation).  The first round runs
    op by op; the rest are replays of one captured CUDA graph, which leave
    no host ranges.  So the device's busy and idle shares are read over
    the replays' span, from the first batch of replays to the end of the
    last read of the exit test, from CUPTI's kernel records; graph
    launches, kernel launches and syncs are counted per round run; and
    the ``exsample.*`` layer shares are those of the eager first round.
    ``warm`` runs the search once first, unprofiled.  Returns the device
    activities a replayed round, the replays' idle share and the capture's
    ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        run(contextlib.nullcontext)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    res, wall = run(lambda: prof)
    loop = res.loop
    frames = res.stats.frames_sampled
    live = res.stats.rounds or frames // cohorts
    rounds_run = loop.eager_rounds + loop.replays
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    eager = [e for e in host if e.name == "exsample.eager_round"]
    batches = [e for e in host if e.name == "exsample.rounds"]
    tests = [e for e in host if e.name == "exsample.exit_test"]
    if len(eager) != 1 or not batches:
        fail(f"profile {label}: {len(eager)} eager rounds and {len(batches)} batches of replays in the trace")
    lo, hi = min(e.time_range.start for e in batches), max(e.time_range.end for e in tests)
    span_us = hi - lo
    dev = device_events(prof)
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    busy_span_us = sum(max(0, min(e.time_range.end, hi) - max(e.time_range.start, lo)) for e in dev)
    in_replays = sum(1 for e in dev if lo <= e.time_range.start < hi)
    print(f"profile: {label}, {frames} frames / {live} live rounds ({rounds_run} run: 1 eager, {loop.replays} "
          f"replays of the captured round, K = {loop.rounds_per_sync}; capture {loop.capture_s * 1e3:.1f} ms); "
          f"plan.run {wall:.3f} s ({frames / wall:.1f} frames/s under the profiler), device busy "
          f"{busy_us / 1e3:.1f} ms of it; the replays' span {span_us / 1e3:.1f} ms "
          f"({100 * span_us / 1e6 / wall:.1f}% of plan.run): device busy {busy_span_us / 1e3:.1f} ms "
          f"= {100 * busy_span_us / span_us:.1f}%, idle {100 - 100 * busy_span_us / span_us:.1f}%; "
          f"{in_replays} device activities there, {in_replays / max(loop.replays, 1):.0f} a replayed round, "
          f"{busy_span_us / max(in_replays, 1):.2f} us busy and {(span_us - busy_span_us) / max(in_replays, 1):.2f} "
          f"us idle each")
    e0 = eager[0].time_range
    ranges = {}
    for e in host:
        if (e.name.startswith("exsample.") and e.name != "exsample.eager_round"
                and e0.start <= e.time_range.start and e.time_range.end <= e0.end):
            r = ranges.setdefault(e.name, [0, 0.0, 0.0])
            r[0] += 1
            r[1] += e.cpu_time_total
            r[2] += e.device_time_total
    eager_us = e0.elapsed_us()
    print(f"  the eager round, op by op: {eager_us / 1e3:.1f} ms of host time; its layers:")
    for name, (count, cpu_us, dev_us) in sorted(ranges.items(), key=lambda kv: -kv[1][1]):
        print(f"  {name:<20} {count:>6} calls  host {cpu_us / 1e3:9.1f} ms "
              f"({100 * cpu_us / eager_us:5.1f}% of the eager round)  device {dev_us / 1e3:8.2f} ms")
    calls, in_span, loop_syncs = {}, {}, 0
    for e in host:
        if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync", "cudaLaunchKernel",
                      "cudaLaunchKernelExC", "cudaGraphLaunch"):
            calls[e.name] = calls.get(e.name, 0) + 1
            if lo <= e.time_range.start <= hi:
                in_span[e.name] = in_span.get(e.name, 0) + 1
            chain, p = [], e.cpu_parent
            while p is not None:
                chain.append(p.name)
                p = p.cpu_parent
            if e.name == "cudaStreamSynchronize" and "exsample.exit_test" in chain:
                loop_syncs += 1
    replays = max(loop.replays, 1)
    graphs = in_span.get("cudaGraphLaunch", 0)
    kernels = in_span.get("cudaLaunchKernel", 0) + in_span.get("cudaLaunchKernelExC", 0)
    print(f"  runtime calls in plan.run: {calls}; in the replays' span: {in_span}: {graphs / replays:.2f} graph "
          f"launches and {kernels / replays:.2f} kernel launches a replayed round; exit-test syncs "
          f"{loop_syncs} ({loop_syncs / max(rounds_run, 1):.3f} a round run, {loop.syncs} by the loop's count)")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12))
    return dict(activities_a_round=in_replays / max(loop.replays, 1), idle=1 - busy_span_us / span_us,
                capture_ms=loop.capture_s * 1e3)


# ------------------------------------------------------------ multi path

def run_multi(torch, setup, plan_dict, device, classes=MULTI_CLASSES, around=contextlib.nullcontext,
              feat_thresh=-1.0, detector="oracle"):
    """The multi kind as its CLI runs it: one class-agnostic detector,
    ``class_select`` per query, keys ``fold_in(PRNGKey(0), q)``.  Returns
    as :func:`run_search` does."""
    from repro_torch.core import SearchPlan, init_carry_multi, init_matcher, init_state, prng
    from repro_torch.sim import class_select, generate

    repo, chunks = generate(setup.repo, device=device)
    plan = SearchPlan.from_dict(plan_dict)
    key = prng.PRNGKey(0, device=device)
    carry = init_carry_multi(init_state(chunks.length, device=device),
                             init_matcher(max_results=MATCHER_CAPACITY, feat_thresh=feat_thresh,
                                          device=device),
                             torch.stack([prng.fold_in(key, q) for q in range(len(classes))]))

    det = detector_of(detector, repo, None)
    select = class_select(repo, classes)
    if device.type == "cuda":
        torch.cuda.synchronize()
    with around():
        t0 = time.perf_counter()
        res = plan.run(carry, chunks, detector=det, select=select)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return res, wall, chunks.num_chunks


def multi_path(torch, name, setup, detector="oracle") -> tuple[dict, dict, object]:
    """The full-width multi-query search on the card, and the same search
    cut to ``MULTI_CHECK_STEPS`` frames a query held exactly to the CPU
    (through the CPU run's pinned digest, ``MULTI_PINNED``);
    the batched fused round must run once per round
    (the z-taking B2 never) and the batched fused matcher step once per
    cohort slot.  Returns (launches, metrics, the card's SearchResult)."""
    cuda = torch.device("cuda")
    reset_launches()
    gpu, gpu_s, m = run_multi(torch, setup, MULTI_PLAN, cuda, detector=detector)
    counted = read_launches()
    card_check = run_multi(torch, setup, dict(MULTI_PLAN, max_steps=MULTI_CHECK_STEPS), cuda, detector=detector)[0]
    st = gpu.stats
    rounds, frames, cohorts = st.rounds, st.frames_sampled, MULTI_PLAN["cohorts"]
    for trace in gpu.traces:
        if not trace or any(s < 0 or r < 0 for s, r in trace):
            fail(f"{name}: malformed trace {trace}")
    if not all(math.isfinite(v) for v in gpu.carry.sampler.n1.reshape(-1).tolist()):
        fail(f"{name}: non-finite sampler state")
    if min(gpu.results) <= 0 or rounds <= 0 or st.cache_hits <= 0:
        fail(f"{name}: the search found too little ({gpu.results}, {st})")
    if frames != sum(gpu.steps) or st.detector_invocations > frames:
        fail(f"{name}: inconsistent accounting {st}")
    digest = result_digest(card_check)
    if digest != MULTI_PINNED[detector]:
        fail(f"{name}: card run's digest {digest} != the CPU run's pinned {MULTI_PINNED[detector]}")
    print(f"  {name}: M={m} chunks, Q={len(MULTI_CLASSES)} classes {list(MULTI_CLASSES)}; results "
          f"{list(gpu.results)} in steps {list(gpu.steps)}; {rounds} rounds; cut to {MULTI_CHECK_STEPS} frames a "
          f"query, card == CPU exactly (steps, results, traces, stats, samplers, rings, keys, cache tag: the "
          f"CPU run's pinned digest)")
    print(f"    card {frames / gpu_s:.1f} frames/s {rounds / gpu_s:.2f} rounds/s ({gpu_s:.2f} s); "
          f"{frames} frames sampled, {st.detector_invocations} detector invocations, "
          f"{st.cache_hits} cache hits (hit rate {st.cache_hit_rate:.4f}), "
          f"amortization {st.amortization:.4f}x")
    per_round = {"thompson_round_batched": 1, "match_update_batched": cohorts}
    launches = loop_launches(name, gpu, counted, per_round, rounds)
    if any(v for k, v in launches.items() if k not in per_round):
        fail(f"{name}: launches {launches}: only {sorted(per_round)} may run")
    print(f"    launches {launches}")
    return launches, dict(frames=frames, results=list(gpu.results), frames_per_s=frames / gpu_s,
                          amortization=st.amortization, invocations=st.detector_invocations,
                          cache_hits=st.cache_hits, capture_ms=gpu.loop.capture_s * 1e3, wall_s=gpu_s), gpu


def cosine_path(torch, name, setup) -> dict:
    """The matcher's cosine path (``COSINE_FEAT_THRESH``): a scan and a
    multi search on the card, each held exactly to the same search on the
    CPU, through the same captured round; the op-by-op step runs B3's
    iou_matrix once a frame (scan) and its batched form once a cohort slot
    (multi), and the fused step never.  Returns the launches of the two
    runs."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    out = {}
    for kind, plan, run in (("scan", COSINE_SCAN_PLAN, run_search), ("multi", COSINE_MULTI_PLAN, run_multi)):
        reset_launches()
        gpu, gpu_s, _ = run(torch, setup, plan, cuda, feat_thresh=COSINE_FEAT_THRESH)
        counted = read_launches()
        ref, _, _ = run(torch, setup, plan, cpu, feat_thresh=COSINE_FEAT_THRESH)
        diffs = same_search(gpu, ref)
        if diffs:
            fail(f"{name} {kind}, cosine matcher: card run != CPU run on {diffs}")
        frames = gpu.stats.frames_sampled
        print(f"  {name} {kind}, feat_thresh {COSINE_FEAT_THRESH}: results {list(gpu.results)} in "
              f"{frames} frames; card == CPU exactly; card {gpu_s:.2f} s")
        choose, kernel = (("thompson_round", "iou_matrix") if kind == "scan"
                          else ("thompson_round_batched", "iou_matrix_batched"))
        per_round = {choose: 1, kernel: plan["cohorts"]}
        live = frames // plan["cohorts"] if kind == "scan" else gpu.stats.rounds
        launches = loop_launches(f"{name} {kind}, cosine matcher", gpu, counted, per_round, live)
        if any(v for k, v in launches.items() if k not in per_round):
            fail(f"{name} {kind}, cosine matcher: launches {launches}: only {sorted(per_round)} may run")
        print(f"    launches {launches}")
        out[kind] = launches
    return out


def per_query_contract(torch, name, setup) -> None:
    """Each query of a multi run on the card equals its own solo scan run
    with ``filter_class`` over the same class-agnostic oracle."""
    from repro_torch.core import SearchPlan, init_carry, init_matcher, init_state, prng
    from repro_torch.sim import filter_class, generate, oracle_detect

    cuda = torch.device("cuda")
    plan = dict(MULTI_PLAN, max_steps=SOLO_CHECK_STEPS)
    multi, multi_s, _ = run_multi(torch, setup, plan, cuda)
    repo, chunks = generate(setup.repo, device=cuda)
    solo_plan = SearchPlan.from_dict(dict(
        result_limit=plan["result_limit"], max_steps=plan["max_steps"], cohorts=plan["cohorts"],
        method=plan["method"], trace_every=plan["trace_every"], execution=dict(strategy="scan")))
    solo_s = 0.0
    for q, cls in enumerate(MULTI_CLASSES):
        carry = init_carry(init_state(chunks.length, device=cuda),
                           init_matcher(max_results=MATCHER_CAPACITY, device=cuda),
                           prng.fold_in(prng.PRNGKey(0, device=cuda), q))
        t0 = time.perf_counter()
        solo = solo_plan.run(carry, chunks, detector=lambda k, f, c=cls: filter_class(
            repo, oracle_detect(repo, f, query_class=None), c))
        solo_s += time.perf_counter() - t0
        same = (solo.steps[0], solo.results[0], solo.trace) == (multi.steps[q], multi.results[q],
                                                                 multi.traces[q])
        pairs = [(getattr(solo.carry.sampler, f), getattr(multi.carry.sampler, f)[q]) for f in ("n1", "n")]
        pairs += [(getattr(solo.carry.matcher, f), getattr(multi.carry.matcher, f)[q])
                  for f in ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor",
                            "total_inserted")]
        pairs.append((solo.carry.key, multi.carry.key[q]))
        if not same or not all(bits_equal(a.cpu(), b.cpu()) for a, b in pairs):
            fail(f"{name}: query {q} (class {cls}) != its solo scan run")
    st = multi.stats
    print(f"  {name}: each of {len(MULTI_CLASSES)} queries == its solo scan run (steps "
          f"{list(multi.steps)}, results {list(multi.results)}); multi {multi_s:.2f} s with "
          f"{st.detector_invocations} detector invocations vs {sum(multi.steps)} frames over "
          f"8 solo runs in {solo_s:.2f} s")


# ------------------------------------------------- noisy detector, baselines

def one_replay_profile(torch, run) -> dict:
    """The device work of one replay of the captured round: ``run()`` drives
    one search, and the profiler (device activities only) is on around its
    first graph replay alone, so that a round of ~10^5 nodes is parsed once,
    not with the eager round, the capture and every other replay.  Returns
    the activities, the replay's device span in ms and its idle share."""
    from torch.profiler import ProfilerActivity, profile

    graph_cls = torch.cuda.CUDAGraph
    replay, out = graph_cls.replay, {}

    def first_replay_profiled(graph):
        if out:
            return replay(graph)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            replay(graph)
            torch.cuda.synchronize()
        ev = device_events(prof)
        lo, hi = min(e.time_range.start for e in ev), max(e.time_range.end for e in ev)
        busy = sum(e.time_range.elapsed_us() for e in ev)
        out.update(activities_a_round=len(ev), replay_ms=(hi - lo) / 1e3, replay_idle=1 - busy / (hi - lo))

    graph_cls.replay = first_replay_profiled
    try:
        run()
    finally:
        graph_cls.replay = replay
    if not out:
        fail("one_replay_profile: the search replayed no round")
    return out


def noisy_vs_oracle(label: str, noisy: dict, oracle: dict, keys) -> None:
    print(f"  {label}, noisy (oracle): " + "; ".join(
        f"{k} {noisy[k]:.4f} ({oracle[k]:.4f})" if isinstance(noisy[k], float) else f"{k} {noisy[k]} ({oracle[k]})"
        for k in keys))


def baseline_run(torch, setup, device, policy: str, steps: int):
    """One baseline on bdd-like ``setup``, class 0, the oracle, the ring at
    ``MATCHER_CAPACITY``: "randomplus" over the first ``steps`` frames of
    ``FrameSchedule.randomplus``, or "greedy" up to ``steps`` frames.
    Returns (carry, trace, wall seconds)."""
    from repro_torch.core import init_carry, init_matcher, init_state, prng
    from repro_torch.core.baselines import FrameSchedule, run_greedy, run_schedule
    from repro_torch.sim import generate

    repo, chunks = generate(setup.repo, device=device)
    det = detector_of("oracle", repo, 0)
    carry = init_carry(init_state(chunks.length, device=device),
                       init_matcher(max_results=MATCHER_CAPACITY, device=device), prng.PRNGKey(0, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if policy == "greedy":
        out, trace = run_greedy(carry, chunks, detector=det, result_limit=BASELINE_LIMIT, max_steps=steps,
                                trace_every=MAIN_PLAN["trace_every"])
    else:
        out, trace = run_schedule(carry, chunks, FrameSchedule.randomplus(chunks.total_frames, steps), detector=det,
                                  result_limit=BASELINE_LIMIT, trace_every=MAIN_PLAN["trace_every"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, trace, time.perf_counter() - t0


def baselines_path(torch, name, setup, exsample_frames: int) -> dict:
    """random+ (``run_schedule``) and greedy (``run_greedy``) on the card at
    class 0, limit ``BASELINE_LIMIT``, ``BASELINE_STEPS`` frames; each frame
    one ``match_update`` launch and nothing else.  Card == CPU on the
    trace and the final carry: greedy's whole run, random+'s first
    ``BASELINE_CHECK_STEPS`` frames (the CPU's random+ takes several ms a
    frame at bdd(1.0)), through the CPU runs' pinned digests
    (``SCAN_PINNED``).  Prints the frames each took and the savings against
    ExSample's ``exsample_frames`` (the oracle bdd scan's).  Returns the
    launches of the two full runs."""
    cuda = torch.device("cuda")
    launches, frames = {}, {}
    for policy in ("randomplus", "greedy"):
        reset_launches()
        out, trace, wall = baseline_run(torch, setup, cuda, policy, BASELINE_STEPS)
        counted = read_launches()
        steps, results = int(out.step), int(out.results)
        if counted.get("match_update") != steps or any(v for k, v in counted.items() if k != "match_update"):
            fail(f"{name} {policy}: launches {counted} in {steps} frames: want match_update once a frame")
        check = steps if policy == "greedy" else min(steps, BASELINE_CHECK_STEPS)
        card, card_trace, _ = (out, trace, wall) if check == steps else baseline_run(torch, setup, cuda, policy, check)
        digest = baseline_digest(card, card_trace)
        if digest != SCAN_PINNED[policy]:
            fail(f"{name} {policy}: card run's digest over {check} frames {digest} != the CPU run's pinned "
                 f"{SCAN_PINNED[policy]}")
        launches[policy], frames[policy] = counted, steps
        print(f"  {name} {policy}: {results} results in {steps} frames (limit {BASELINE_LIMIT}, budget "
              f"{BASELINE_STEPS}); card {wall:.2f} s = {steps / wall:.1f} frames/s, {counted['match_update'] / steps:.2f} "
              f"match_update launches a frame; card == CPU over {check} frames (trace, carry: the CPU run's pinned "
              f"digest); "
              f"trace {card_trace[-3:]}")
    print(f"  {name}: savings = random+ frames / ExSample frames = {frames['randomplus']} / {exsample_frames} = "
          f"{frames['randomplus'] / max(exsample_frames, 1):.4f}x; greedy / ExSample "
          f"{frames['greedy'] / max(exsample_frames, 1):.4f}x")
    return launches


def multiquery_bench_path(torch) -> None:
    """``repro_torch.bench.multiquery`` at its full workload (dashcam(0.05),
    Q = 8, budget 8,192) on the card, held to ``MULTIQUERY_PINNED``: counts
    pinned from CPU runs of the JAX package and of the port, which agree."""
    from repro_torch.bench import multiquery

    r = multiquery.run(quick=False, device="cuda")
    got = {k: r[k] for k in MULTIQUERY_PINNED}
    if got != MULTIQUERY_PINNED:
        fail(f"bench multiquery: {got} != the pinned {MULTIQUERY_PINNED}")
    seq_inv = sum(r["seq_steps"])
    ratio = (seq_inv / sum(r["seq_results"])) / (r["detector_invocations"] / sum(r["multi_results"]))
    print(f"  bench multiquery (full): counts == the pinned CPU counts {got}; amortization ratio {ratio:.4f}x "
          f"(gate 2x); sequential arm {seq_inv / r['seq_wall']:.1f} frames/s ({r['seq_wall']:.2f} s), multi arm "
          f"{r['frames_sampled'] / r['multi_wall']:.1f} frames/s ({r['multi_wall']:.2f} s)")
    if ratio < 2.0:
        fail(f"bench multiquery: amortization {ratio:.2f}x below the 2x gate")


# ------------------------------------------------------------------- the mesh

def mesh_inputs(name: str, device):
    """(repository, chunks, carry, detector, select) of a mesh cell on
    ``device``: bdd(1.0), a ring of MATCHER_CAPACITY, the keys the CLI
    uses; ``sharded*`` one query of class 0, ``multi_sharded`` the
    MULTI_CLASSES queries over one class-agnostic detector."""
    import torch

    from repro_torch.configs.exsample_paper import bdd
    from repro_torch.core import init_carry, init_carry_multi, init_matcher, init_state, prng
    from repro_torch.sim import class_select, generate, oracle_detect

    repo, chunks = generate(bdd(scale=1.0).repo, device=device)
    state = init_state(chunks.length, device=device)
    matcher = init_matcher(max_results=MATCHER_CAPACITY, device=device)
    key = prng.PRNGKey(0, device=device)
    if name.startswith("sharded"):
        return (repo, chunks, init_carry(state, matcher, key), lambda k, f: oracle_detect(repo, f, query_class=0),
                None)
    keys = torch.stack([prng.fold_in(key, q) for q in range(len(MULTI_CLASSES))])
    return (repo, chunks, init_carry_multi(state, matcher, keys),
            lambda k, f: oracle_detect(repo, f, query_class=None), class_select(repo, MULTI_CLASSES))


def mesh_plan(name: str) -> dict:
    if name == "multi_sharded":
        return MULTI_SHARDED_PLAN
    return dict(SHARDED_PLAN, execution=dict(shards=MESH_SHARDS, sync_every=int(name[len("sharded"):])))


def mesh_run(torch, name: str, device):
    """One mesh cell through ``SearchPlan.run`` on ``device`` (8 shards
    there).  Returns (SearchResult, wall seconds of plan.run)."""
    from repro_torch.core import SearchPlan

    _, chunks, carry, det, select = mesh_inputs(name, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = SearchPlan.from_dict(mesh_plan(name)).run(carry, chunks, detector=det, select=select)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def elastic_cli(device: str):
    """The search CLI's ``--kill-worker`` path (ELASTIC_ARGV) on ``device``,
    in this process.  Returns (the runner, its standard output)."""
    import io

    from repro_torch.launch import search

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runner = search.main(ELASTIC_ARGV + ["--device", device])
    return runner, out.getvalue()


def elastic_record(runner) -> dict:
    """What the card's elastic run is held to: the final carry, the traces,
    the counters, the reshard events and the final cache's tags."""
    st = runner.stats
    return dict(carry=runner.carry, traces=runner.traces, num_shards=runner.num_shards,
                stats={k: st[k] for k in ("detector_invocations", "cache_hits", "index_hits", "rounds", "merges",
                                          "merge_high_water", "merge_overflow", "frames_sampled", "reshard_events")},
                tag=runner._cache.tag[:runner._cache.capacity])


def _hash_tensors(h, tensors) -> None:
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.numpy().tobytes())


def carry_tensors(c) -> list:
    """The carry's tensors :func:`same_carry` compares, in its order."""
    return ([getattr(c.sampler, f) for f in ("n1", "n", "frames")]
            + [getattr(c.matcher, f) for f in ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor",
                                               "total_inserted")]
            + [c.key, c.step, c.results])


def result_digest(res) -> str:
    """SHA-256 of what :func:`same_search` compares: steps, results, traces,
    every ``SearchStats`` field, the carry's tensors bit for bit and the
    final cache's tags."""
    h = hashlib.sha256(json.dumps([list(res.steps), list(res.results), res.traces,
                                   dataclasses.asdict(res.stats)]).encode())
    _hash_tensors(h, carry_tensors(res.carry))
    if res.final_cache is not None:
        _hash_tensors(h, [res.final_cache.tag[:res.final_cache.capacity]])
    return h.hexdigest()


def baseline_digest(carry, trace) -> str:
    """SHA-256 of what :func:`baselines_path` compares: a baseline's trace
    and its final carry bit for bit."""
    h = hashlib.sha256(json.dumps(trace).encode())
    _hash_tensors(h, carry_tensors(carry))
    return h.hexdigest()


def elastic_digest(rec: dict) -> str:
    """SHA-256 of an :func:`elastic_record`: carry, traces, shard count,
    counters and reshard events, cache tags."""
    h = hashlib.sha256(json.dumps([rec["traces"], rec["num_shards"], rec["stats"]]).encode())
    _hash_tensors(h, carry_tensors(rec["carry"]) + [rec["tag"]])
    return h.hexdigest()


def mesh_cpu_cell(name: str) -> int:
    """``python chip_smoke.py --mesh-cpu NAME``: one mesh cell on the CPU;
    prints its digest, which MESH_PINNED holds for the card's run."""
    import torch

    t0 = time.perf_counter()
    if name == "elastic":
        runner, _ = elastic_cli("cpu")
        runner.close_traces()
        digest = elastic_digest(elastic_record(runner))
    else:
        digest = result_digest(mesh_run(torch, name, torch.device("cpu"))[0])
    print(json.dumps({"cell": name, "digest": digest, "cpu_s": round(time.perf_counter() - t0, 1)}))
    return 0


def multi_cpu_cell(detector: str) -> int:
    """``python chip_smoke.py --multi-cpu DETECTOR``: the bdd(1.0) multi
    path's check (``MULTI_PLAN`` cut to ``MULTI_CHECK_STEPS`` frames a
    query) on the CPU; prints its digest, which MULTI_PINNED holds for the
    card's run."""
    import torch

    from repro_torch.configs.exsample_paper import bdd

    t0 = time.perf_counter()
    res = run_multi(torch, bdd(scale=1.0), dict(MULTI_PLAN, max_steps=MULTI_CHECK_STEPS), torch.device("cpu"),
                    detector=detector)[0]
    print(json.dumps({"cell": f"multi {detector}", "digest": result_digest(res),
                      "cpu_s": round(time.perf_counter() - t0, 1)}))
    return 0


def scan_cpu_cells() -> int:
    """``python chip_smoke.py --scan-cpu``: the main path's checks and the
    baselines' on the CPU, as :func:`main_path` and
    :func:`baselines_path` take them; prints their digests, which
    SCAN_PINNED holds for the card's runs."""
    import torch

    from repro_torch.configs.exsample_paper import bdd, dashcam

    cpu = torch.device("cpu")
    check = dict(MAIN_PLAN, max_steps=MAIN_CHECK_STEPS)
    for name, setup, detector in (("dashcam(scale=1.0)", dashcam(scale=1.0), "oracle"),
                                  ("bdd(scale=1.0)", bdd(scale=1.0), "oracle"),
                                  ("bdd(scale=1.0) noisy", bdd(scale=1.0), "noisy")):
        t0 = time.perf_counter()
        digest = result_digest(run_search(torch, setup, check, cpu, detector=detector)[0])
        print(json.dumps({"cell": name, "digest": digest, "cpu_s": round(time.perf_counter() - t0, 1)}))
    for policy in ("randomplus", "greedy"):
        t0 = time.perf_counter()
        steps = BASELINE_CHECK_STEPS
        if policy == "greedy":          # the card checks greedy's whole run, as many frames as it took
            steps = int(baseline_run(torch, bdd(scale=1.0), cpu, policy, BASELINE_STEPS)[0].step)
        out, trace, _ = baseline_run(torch, bdd(scale=1.0), cpu, policy, steps)
        print(json.dumps({"cell": policy, "frames": steps, "digest": baseline_digest(out, trace),
                          "cpu_s": round(time.perf_counter() - t0, 1)}))
    return 0


def mesh_winners_check(torch) -> None:
    """The sharded choice at the mesh path's shapes: bdd(1.0)'s 1,000 chunks
    over 8 shards (125 a shard), 48 cohorts, single and batched over the
    MULTI_CLASSES queries; through the fused round (one launch a shard,
    its marks mapped back) against the reference's shard body op by op on
    the same card tensors, bit for bit, with shard 0 all exhausted and with
    every chunk exhausted."""
    import numpy as np

    from repro_torch.core.distributed import local_cohort_winners, shard_sampler_state
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(MESH_SHARDS)
    for q in (None, len(MULTI_CLASSES)):
        for dead in ("shard 0", "every chunk"):
            key, state = round_inputs(q, MESH_COHORTS, 1000, seed=(q or 1) * 17 + len(dead), kind="sampler")
            exh = torch.zeros(state.n.shape, dtype=torch.bool, device="cuda")
            exh[..., : 1000 // MESH_SHARDS] = True
            if dead == "every chunk":
                exh[...] = True
            state = dataclasses.replace(state, n=torch.where(exh, state.frames.float(), state.n))
            views = shard_sampler_state(state, mesh)
            got = local_cohort_winners(key, views, mesh, cohorts=MESH_COHORTS)
            want = local_cohort_winners(key, views, mesh, cohorts=MESH_COHORTS, plain=True)
            if not (torch.equal(got[0], want[0]) and bits_equal(got[1], want[1]) and torch.equal(got[2], want[2])):
                fail(f"mesh: local_cohort_winners (Q={q}, {dead} exhausted) != its plain version")
            # round_inputs exhausts the last of Q queries everywhere
            live = torch.full(got[1].shape[:-1], dead == "shard 0", dtype=torch.bool, device="cuda")
            if q is not None:
                live[-1] = False
            if not torch.equal(torch.isfinite(got[1]).all(-1), live) or bool((torch.isinf(got[1]).any(-1) & live).any()):
                fail(f"mesh: local_cohort_winners (Q={q}, {dead} exhausted): live rows {live.tolist()}, scores "
                     f"{got[1].tolist()}")
            if bool((got[0][live] < 1000 // MESH_SHARDS).any()) or bool(got[0][~live].any()):
                fail(f"mesh: local_cohort_winners (Q={q}, {dead} exhausted) chose {got[0].tolist()}")
    print(f"  local_cohort_winners at ({MESH_COHORTS}, {1000 // MESH_SHARDS}) a shard x {MESH_SHARDS}, single and "
          f"Q={len(MULTI_CLASSES)}: the fused round's path == the reference's shard body op by op, bit for bit, "
          "with shard 0 exhausted and with every chunk exhausted")


def mesh_launch_check(name, counted: dict, want: dict) -> dict:
    got = {k: v for k, v in counted.items() if v}
    if got != want:
        fail(f"mesh: {name} launched {got}, want {want}")
    return got


def mesh_path(torch) -> tuple[dict, dict]:
    """The mesh kinds at full width on 8 shards of the card: the bdd(1.0)
    sharded cells at sync_every 1 and 4 and the composed cell, each held
    exactly to the same run on the CPU through its pinned digest
    (MESH_PINNED); repro_torch.bench.plan_compose full against the pinned
    counts; the elastic CLI killing worker 7 of 8, replayed, and held to
    the CPU's digest.  Returns (launches by cell, metrics)."""
    cuda = torch.device("cuda")
    mesh_winners_check(torch)
    launches, metrics, digests = {}, {}, {}
    for name in ("sharded1", "sharded4", "multi_sharded"):
        reset_launches()
        res, wall = mesh_run(torch, name, cuda)
        counted = read_launches()
        st = res.stats
        rounds = st.merges * (1 if name == "multi_sharded" else int(name[len("sharded"):]))
        if name == "multi_sharded":
            want = {"thompson_round_batched": MESH_SHARDS * rounds,
                    "match_update_batched": MESH_COHORTS * rounds}
        else:
            want = {"thompson_round": MESH_SHARDS * rounds, "match_update": MESH_COHORTS * rounds}
        launches[name] = mesh_launch_check(name, counted, want)
        frames = st.frames_sampled
        if min(res.results) <= 0 or frames <= 0 or st.merges <= 0:
            fail(f"mesh: {name} found nothing ({res.results}, {st})")
        if not all(math.isfinite(v) for v in res.carry.sampler.n1.reshape(-1).tolist()):
            fail(f"mesh: {name}: non-finite sampler state")
        digests[name] = result_digest(res)
        metrics[name] = dict(frames=frames, results=list(res.results), wall_s=wall, frames_per_s=frames / wall,
                             merges=st.merges, merge_high_water=st.merge_high_water, rounds=rounds,
                             invocations=st.detector_invocations, cache_hits=st.cache_hits)
        extra = (f"; {st.detector_invocations} detector invocations, {st.cache_hits} cache hits (hit rate "
                 f"{st.cache_hit_rate:.4f}), amortization {st.amortization:.4f}x" if name == "multi_sharded" else "")
        print(f"  {name}: bdd(scale=1.0), {MESH_SHARDS} shards x {MESH_COHORTS // MESH_SHARDS} cohorts, results "
              f"{list(res.results)} in {frames} frames; {st.merges} merges, ring high water {st.merge_high_water}"
              f"{', OVERFLOW' if st.merge_overflow else ''}; card {frames / wall:.1f} frames/s ({wall:.2f} s)"
              f"{extra}; launches {launches[name]}")

    from repro_torch.bench import plan_compose

    reset_launches()
    t0 = time.perf_counter()
    r = plan_compose.run(quick=False, device="cuda")
    pc_wall = time.perf_counter() - t0
    launches["plan_compose"] = {k: v for k, v in read_launches().items() if v}
    got = {k: r[k] for k in PLAN_COMPOSE_PINNED}
    if got != PLAN_COMPOSE_PINNED:
        fail(f"mesh: bench plan_compose {got} != the pinned {PLAN_COMPOSE_PINNED}")
    ratio = plan_compose.gates(r)
    metrics["plan_compose"] = dict(ratio=ratio, seq_wall_s=r["seq_wall"], comp_wall_s=r["comp_wall"],
                                   invocations=r["detector_invocations"], cache_hits=r["cache_hits"])
    print(f"  bench plan_compose (full): composed == sequential-sharded per query {r['comp_results']}; "
          f"{r['detector_invocations']} detector invocations and {r['cache_hits']} cache hits == the pinned counts; "
          f"ratio {ratio:.4f}x (gate 2x); sequential arm {sum(r['seq_steps']) / r['seq_wall']:.1f} frames/s "
          f"({r['seq_wall']:.2f} s), composed {r['frames_sampled'] / r['comp_wall']:.1f} frames/s "
          f"({r['comp_wall']:.2f} s), {pc_wall:.1f} s in all")

    reset_launches()
    t0 = time.perf_counter()
    runner, text = elastic_cli("cuda")
    el_wall = time.perf_counter() - t0
    shards, merges, windows = MESH_SHARDS, runner.stats["merges"], 0
    want = {"thompson_round_batched": 0, "match_update_batched": MESH_COHORTS * merges}
    for ev in runner.stats["reshard_events"] + [dict(window=merges, to_shards=None)]:
        want["thompson_round_batched"] += shards * (ev["window"] - windows)
        shards, windows = ev["to_shards"], ev["window"]
    launches["elastic"] = mesh_launch_check("elastic", read_launches(), want)
    runner.close_traces()
    first = elastic_record(runner)
    digests["elastic"] = elastic_digest(first)
    if "8 -> 6 shards" not in text or "finished on 6 shards" not in text:
        fail(f"mesh: the elastic CLI did not reshard 8 -> 6 and finish on 6 shards:\n{text}")
    replay, text2 = elastic_cli("cuda")
    replay.close_traces()
    diffs = elastic_diffs(elastic_record(replay), first)
    if diffs or text2.splitlines()[:-1] != text.splitlines()[:-1]:
        fail(f"mesh: the elastic replay differs on {diffs}")
    for line in text.splitlines():
        if line.startswith("elastic:"):
            print(f"    {line}")
    metrics["elastic"] = dict(wall_s=el_wall, results=runner.carry.results.tolist(),
                              invocations=runner.stats["detector_invocations"], events=runner.stats["reshard_events"])
    print(f"  elastic CLI on the card: {el_wall:.2f} s; the replay of the death schedule == the first run "
          "(carry, traces, counters, reshard events, cache tags)")

    diffs = [name for name, d in digests.items() if d != MESH_PINNED[name]]
    if diffs:
        fail(f"mesh: the card's runs of {diffs} != the CPU's: digests {digests}, pinned {MESH_PINNED}")
    print(f"  card == CPU exactly on {sorted(digests)} (their digests == the pinned digests of CPU runs: trace, "
          "steps, results, stats, samplers, rings, keys, cache tags; elastic: carry, traces, counters, events)")
    return launches, metrics


def elastic_diffs(a: dict, b: dict) -> list[str]:
    diffs = same_carry(a["carry"], b["carry"])
    diffs += [k for k in ("traces", "num_shards", "stats") if a[k] != b[k]]
    if not bits_equal(a["tag"].cpu(), b["tag"].cpu()):
        diffs.append("cache.tag")
    return diffs


# ------------------------------------------- repository index, async runtime

def index_path(torch, name, setup, no_index) -> dict:
    """``MULTI_PLAN`` bound to a repository index in a fresh directory, on
    the card.  The cold run must equal ``no_index`` (the phase's card run,
    held to the CPU) on every field but the persisted count; the warm run
    over its snapshot must call the detector on no frame, every cache hit
    an index hit, with the same trajectories, every round after the first
    a replay of one captured graph.  The write-back and the preload are
    timed alone.  Then ``PRIOR_SCAN_PLAN``'s scan, its Thompson prior
    warmed from the snapshot's evidence (read-only), card against CPU."""
    import tempfile

    from repro_torch.index import RepositoryIndex
    from repro_torch.serve.batcher import tree_map

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    per_round = {"thompson_round_batched": 1, "match_update_batched": MULTI_PLAN["cohorts"]}
    with tempfile.TemporaryDirectory() as tmp:
        plan = dict(MULTI_PLAN, execution=dict(MULTI_PLAN["execution"], index=dict(path=tmp)))
        cold, cold_s, _ = run_multi(torch, setup, plan, cuda)
        persisted = cold.stats.persisted_detections
        diffs = same_search(cold, no_index)
        if [d for d in diffs if d != "stats"] or \
                cold.stats != dataclasses.replace(no_index.stats, persisted_detections=persisted):
            fail(f"{name}, cold index: != the run without an index on {diffs} ({cold.stats} vs {no_index.stats})")
        if persisted != no_index.stats.detector_invocations:
            fail(f"{name}, cold index: persisted {persisted} of {no_index.stats.detector_invocations} detections")
        snapshot_bytes = sum(f.stat().st_size for f in Path(tmp).iterdir())
        cache = cold.final_cache
        cap = cache.capacity
        t0 = time.perf_counter()
        fresh = RepositoryIndex()
        if fresh.publish_cache(cache) != persisted:
            fail(f"{name}: publish_cache persisted another count than the run")
        publish_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp2:
            t0 = time.perf_counter()
            fresh.save(tmp2)
            save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx = RepositoryIndex(tmp)
        load_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm_cache, warm_frames = idx.warm(tree_map(lambda x: x[0], cache.store), cap)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        if len(warm_frames) != persisted or not bits_equal(warm_cache.tag[:cap].cpu(), cache.tag[:cap].cpu()) or \
                not all(bits_equal(a[:cap].cpu(), b[:cap].cpu()) for a, b in zip(warm_cache.store, cache.store)):
            fail(f"{name}: the preload differs from the cold run's final cache")
        del warm_cache, cache, fresh
        print(f"  {name}, cold index: == the run without an index (steps, results, traces, stats, samplers, rings, "
              f"keys, cache tag); {persisted} detections persisted, snapshot {snapshot_bytes} bytes; "
              f"publish_cache {publish_s:.3f} s, save {save_s:.3f} s, load {load_s:.3f} s, warm "
              f"{warm_s:.3f} s ({cap} slots); run {cold_s:.2f} s (no index {no_index.stats.frames_sampled} frames)")
        reset_launches()
        warm, warm_run_s, _ = run_multi(torch, setup, plan, cuda)
        counted = read_launches()
        st = warm.stats
        diffs = same_search(warm, no_index)
        if [d for d in diffs if d != "stats"]:
            fail(f"{name}, warm index: trajectories differ from the cold run on {diffs}")
        if st.detector_invocations != 0 or st.index_hits != st.cache_hits or \
                st.cache_hits != no_index.stats.detector_invocations + no_index.stats.cache_hits or \
                st.persisted_detections != 0:
            fail(f"{name}, warm index: {st}")
        launches = loop_launches(f"{name}, warm index", warm, counted, per_round, st.rounds)
        if any(v for k, v in launches.items() if k not in per_round):
            fail(f"{name}, warm index: launches {launches}: only {sorted(per_round)} may run")
        print(f"  {name}, warm index: 0 detector calls, {st.index_hits} index hits == cache hits; trajectories "
              f"== the cold run; {st.frames_sampled / warm_run_s:.1f} frames/s ({warm_run_s:.2f} s, the preload "
              f"included)")
        print(f"    launches {launches}")
        scan_plan = dict(PRIOR_SCAN_PLAN, execution=dict(index=dict(path=tmp, prior_weight=PRIOR_WEIGHT,
                                                                    read_only=True)))
        gscan, gscan_s, _ = run_search(torch, setup, scan_plan, cuda)
        cscan, cscan_s, _ = run_search(torch, setup, scan_plan, cpu)
    diffs = same_search(gscan, cscan)
    if diffs:
        fail(f"{name}, warm-started scan: card != CPU on {diffs}")
    if gscan.stats.warm_rounds_saved <= 0:
        fail(f"{name}, warm-started scan: no prior was injected ({gscan.stats})")
    print(f"  bdd(scale=1.0) scan, prior_weight {PRIOR_WEIGHT} from the snapshot: {gscan.results[0]} results in "
          f"{gscan.steps[0]} frames, {gscan.stats.warm_rounds_saved} warm rounds saved; card == CPU exactly "
          f"(card {gscan_s:.2f} s, CPU {cscan_s:.2f} s)")
    return dict(launches=launches, persisted_detections=persisted, snapshot_bytes=snapshot_bytes,
                publish_cache_s=publish_s, save_s=save_s, load_s=load_s, warm_s=warm_s, cold_run_s=cold_s,
                warm_run_s=warm_run_s, warm_frames_per_s=st.frames_sampled / warm_run_s,
                prior_scan=dict(frames=gscan.steps[0], results=gscan.results[0],
                                warm_rounds_saved=gscan.stats.warm_rounds_saved))


def async_multi_path(torch, name, setup, want, multi_metrics) -> tuple[dict, dict]:
    """``AsyncMultiSearchDriver`` at ``MULTI_PLAN``'s queries, limits,
    budget, cohorts and cache, ``ASYNC_WORKERS`` worker threads each on its
    own stream, ``method="pallas"``: every query must equal ``want``, the
    card's multi run of the plan, on every per-query field (its metrics
    ``multi_metrics``), the counters must obey
    the scheduler's invariants, the batched fused round must run once a
    slot batch and the batched fused step once a cohort slot of every
    processed batch.  Returns (launches, metrics)."""
    from repro_torch.core import init_carry_multi, init_matcher, init_state, prng
    from repro_torch.core.runtime import AsyncMultiSearchDriver
    from repro_torch.core.runtime import _lane as lane
    from repro_torch.sim import class_select, generate

    cuda = torch.device("cuda")
    cohorts = MULTI_PLAN["cohorts"]
    repo, chunks = generate(setup.repo, device=cuda)
    key = prng.PRNGKey(0, device=cuda)
    carry = init_carry_multi(init_state(chunks.length, device=cuda),
                             init_matcher(max_results=MATCHER_CAPACITY, device=cuda),
                             torch.stack([prng.fold_in(key, q) for q in range(len(MULTI_CLASSES))]))
    driver = AsyncMultiSearchDriver(
        carry, chunks, detector_of("oracle", repo, None), cohorts=cohorts, num_workers=ASYNC_WORKERS,
        result_limits=MULTI_PLAN["result_limit"], max_steps=MULTI_PLAN["max_steps"], method="pallas",
        select=class_select(repo, MULTI_CLASSES), cache_frames=chunks.total_frames,
        trace_every=MULTI_PLAN["trace_every"])
    processed, process = [], driver._process_batch

    def counted_batch(wid, batch):
        res = process(wid, batch)
        processed.append(batch.batch_id)
        return res

    driver._process_batch = counted_batch
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = driver.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = driver.stats
    for q in range(len(MULTI_CLASSES)):
        diffs = same_carry(lane(out, q), lane(want.carry, q))
        if diffs or driver.traces[q] != want.traces[q]:
            fail(f"{name}: query {q} != the multi run on {diffs or ['trace']}")
    frames = int(out.step.sum())
    rounds = sum(r.rounds for r in driver.rows)
    bad = []
    if st["merges"] != st["slots"] or st["duplicate_drops"] > st["reissues"]:
        bad.append("merges")
    if rounds != st["lanes_issued"] or frames != cohorts * rounds or frames != sum(want.steps):
        bad.append("rounds/frames")
    if sum(r.fresh_calls for r in driver.rows) != st["detector_invocations"] or \
            sum(r.cache_hits for r in driver.rows) != st["cache_hits"] or st["detector_invocations"] > frames:
        bad.append("detector accounting")
    if st["spilled"] or st["index_hits"] or st["merge_high_water"] >= MATCHER_CAPACITY:
        bad.append("ring/index")
    if launches["thompson_round_batched"] != st["slots"] or \
            launches["match_update_batched"] != cohorts * len(processed) or \
            any(v for k, v in launches.items() if k not in ("thompson_round_batched", "match_update_batched")):
        bad.append(f"launches {launches}")
    if bad:
        fail(f"{name}: invariants broken: {bad}; stats {st}")
    print(f"  {name}: each query == the card's multi run (steps {list(out.step.tolist())}, results "
          f"{list(out.results.tolist())}, traces, samplers, rings, keys); {st['slots']} slot batches of "
          f"{driver.slots_per_batch} lanes, {st['reissues']} reissues, {st['duplicate_drops']} duplicates dropped; "
          f"{st['detector_invocations']} detector calls, {st['cache_hits']} cache hits over {frames} frames")
    print(f"    card {frames / wall:.1f} frames/s ({wall:.2f} s; the multi kind's replayed rounds: "
          f"{multi_metrics['frames_per_s']:.1f}); launches {launches}: "
          f"{launches['thompson_round_batched'] / st['slots']:.2f} thompson_round_batched and "
          f"{launches['match_update_batched'] / max(len(processed), 1):.2f} match_update_batched a processed batch")
    return launches, dict(frames=frames, wall_s=wall, frames_per_s=frames / wall, slot_batches=st["slots"],
                          processed_batches=len(processed), reissues=st["reissues"],
                          invocations=st["detector_invocations"], cache_hits=st["cache_hits"])


def async_path(torch, name, setup) -> tuple[dict, dict]:
    """``AsyncSearchDriver`` on the main path's query (class 0,
    ``MAIN_PLAN``'s cohorts, limit and budget), ``ASYNC_WORKERS`` worker
    threads on their own streams: each cohort merged at most once, Σ merged
    frames = step = Σ n, every result in the ring, no
    ``MatcherRingOverflow``, B3's fused step once a processed frame.  Then
    a synchronous drive of ``ASYNC_SYNC_COHORTS`` cohorts (two against one
    snapshot, merged out of order), card against CPU, the card taking the
    CPU's chunk ids.  Returns (launches, metrics)."""
    from repro_torch.core import init_carry, init_matcher, init_state, prng
    from repro_torch.core.runtime import AsyncSearchDriver
    from repro_torch.sim import generate

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cohorts = MAIN_PLAN["cohorts"]

    def make(device):
        repo, chunks = generate(setup.repo, device=device)
        carry = init_carry(init_state(chunks.length, device=device),
                           init_matcher(max_results=MATCHER_CAPACITY, device=device), prng.PRNGKey(0, device=device))
        return carry, chunks, detector_of("oracle", repo, 0)

    carry, chunks, det = make(cuda)
    driver = AsyncSearchDriver(carry, chunks, det, cohort_size=cohorts, num_workers=ASYNC_WORKERS,
                               result_limit=MAIN_PLAN["result_limit"], max_frames=MAIN_PLAN["max_steps"])
    merged, processed = [], []
    merge, process = driver._merge, driver._process_one

    def spy_merge(res):
        if res.cohort_id in driver._inflight:
            merged.append((res.cohort_id, res.frames))
        merge(res)

    def spy_process(wid, cohort):
        res = process(wid, cohort)
        processed.append(res.frames)
        return res

    driver._merge, driver._process_one = spy_merge, spy_process
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = driver.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st, step = driver.stats, int(out.step)
    ids = [c for c, _ in merged]
    bad = []
    if len(ids) != len(set(ids)) or st["merges"] != len(ids):
        bad.append("a cohort merged twice")
    if not step == int(out.sampler.n.sum()) == sum(f for _, f in merged):
        bad.append("Σ merged frames != step")
    if int((out.matcher.times_seen > 0).sum()) != int(out.results) or st["spilled"]:
        bad.append("ring")
    if launches["match_update"] != sum(processed) or \
            any(v for k, v in launches.items() if k != "match_update"):
        bad.append(f"launches {launches}")
    if bad:
        fail(f"{name}: {bad}; stats {st}")
    print(f"  {name}: {int(out.results)} results in {step} frames; {st['merges']} cohorts of {cohorts} merged once "
          f"each ({st['reissues']} reissues, {st['duplicate_drops']} duplicates dropped, ring high-water "
          f"{st['merge_high_water']}/{MATCHER_CAPACITY}); card {step / wall:.1f} frames/s ({wall:.2f} s); "
          f"match_update {launches['match_update'] / max(sum(processed), 1):.2f} a processed frame "
          f"({sum(processed)} processed)")
    # the synchronous drive: the same cohorts, snapshots and merges in one order on both devices
    drivers = [AsyncSearchDriver(*make(dev), cohort_size=cohorts, num_workers=1, result_limit=10**9,
                                 max_frames=10**9) for dev in (cpu, cuda)]

    def issue():
        got = []
        for d in drivers:
            d._issue_cohort()
            got.append(d._work.get_nowait())
        got[1].chunk_ids = got[0].chunk_ids.copy()
        return got

    (c0, g0), (c1, g1) = issue(), issue()
    pending = [(drivers[0]._process_one(0, c0), drivers[1]._process_one(0, g0)),
               (drivers[0]._process_one(1, c1), drivers[1]._process_one(1, g1))]
    for a, b in reversed(pending):
        drivers[0]._merge(a)
        drivers[1]._merge(b)
    for _ in range(ASYNC_SYNC_COHORTS - 2):
        c, g = issue()
        drivers[0]._merge(drivers[0]._process_one(0, c))
        drivers[1]._merge(drivers[1]._process_one(0, g))
    diffs = same_carry(drivers[1].carry, drivers[0].carry)
    if diffs or drivers[1].stats != drivers[0].stats:
        fail(f"{name}: the synchronous drive, card != CPU on {diffs or 'stats'}")
    print(f"  {name}: a synchronous drive of {ASYNC_SYNC_COHORTS} cohorts (two on one snapshot, merged out of "
          f"order): card == CPU exactly ({int(drivers[1].carry.step)} frames, {int(drivers[1].carry.results)} results)")
    return launches, dict(frames=step, results=int(out.results), wall_s=wall, frames_per_s=step / wall,
                          merges=st["merges"], reissues=st["reissues"], processed_frames=sum(processed))


def service_path(torch, name, setup) -> tuple[dict, dict]:
    """The tenant service on the card (``SERVICE_*``): ``SearchService``
    over ``setup`` with the class-agnostic oracle, ``class_select`` over
    every class and the background pump; the first wave submitted, the
    overdraft plan rejected, each second-wave tenant submitted once a
    first-wave tenant has retired, then the drain.  Fails on a lost
    result (results != live ring entries + spilled log), a pool past the
    wave, a rejected plan with a row, a ledger that does not settle, a
    launch other than ``match_update_batched`` once a processed cohort
    slot, or the first tenant of either wave != its solo scan on the card
    (kind scan, "exact", the same key) at its debited budget.  Returns
    (launches, metrics)."""
    from repro_torch.core import Execution, SearchPlan, init_carry, init_carry_multi, init_matcher, init_state, prng
    from repro_torch.core.plan import ServiceConfig
    from repro_torch.serve.service import FINISHED, REJECTED, SearchService
    from repro_torch.sim import class_select, filter_class, generate, oracle_detect
    from repro_torch.sim.costmodel import CostRates, plan_projected_cost

    cuda = torch.device("cuda")
    cohorts = MULTI_PLAN["cohorts"]
    repo, chunks = generate(setup.repo, device=cuda)
    num_classes = int(repo.inst_class.max()) + 1
    rates = CostRates()

    def plan(wave):
        return SearchPlan(**SERVICE_PLANS[wave], execution=Execution(
            queries_axis=True, service=ServiceConfig(slo_latency_s=SERVICE_SLO_S, queue_on_reject=True)))

    budget_s = SERVICE_WAVE * sum(plan_projected_cost(plan(w), rates).total_s for w in (0, 1)) + 1.0
    proto = init_carry_multi(init_state(chunks.length, device=cuda),
                             init_matcher(max_results=MATCHER_CAPACITY, device=cuda),
                             torch.stack([prng.PRNGKey(0, device=cuda)]))
    service = SearchService(
        proto, chunks, detector_of("oracle", repo, None), select=class_select(repo, list(range(num_classes))),
        budget_s=budget_s, rates=rates, cohorts=cohorts, num_workers=ASYNC_WORKERS,
        max_steps=MULTI_PLAN["max_steps"], cache_frames=chunks.total_frames, slots_per_batch=SERVICE_SLOTS_PER_BATCH)
    driver = service.driver
    processed, process = [], driver._process_batch

    def counted_batch(wid, batch):
        res = process(wid, batch)
        processed.append(batch.batch_id)
        return res

    driver._process_batch = counted_batch
    keys = [prng.fold_in(prng.PRNGKey(0, device=cuda), q) for q in range(len(MULTI_CLASSES))]
    wave1 = [f"t{q}" for q in range(SERVICE_WAVE)]
    wave2 = [f"t{q}" for q in range(SERVICE_WAVE, len(MULTI_CLASSES))]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    service.start(pump=True)
    try:
        for q, tid in enumerate(wave1):
            service.submit(tid, plan(0), key=keys[q], select_id=MULTI_CLASSES[q])
        # 50 times the frames of the eight projections, as bench_service's
        overdraft = service.submit("overdraft", SearchPlan(
            result_limit=MULTI_PLAN["result_limit"], cohorts=cohorts, execution=Execution(queries_axis=True),
            max_steps=50 * SERVICE_WAVE * sum(p["max_steps"] for p in SERVICE_PLANS)), seed=99, select_id=0)
        for q, tid in enumerate(wave2, start=SERVICE_WAVE):
            while sum(service.tenants[t].state == FINISHED for t in wave1) <= q - SERVICE_WAVE:
                if service.failure is not None:
                    service.drain()       # raises the failure
                if time.perf_counter() - t0 > 600:
                    fail(f"{name}: the first wave did not retire within 600 s")
                time.sleep(0.002)
            service.submit(tid, plan(1), key=keys[q], select_id=MULTI_CLASSES[q])
        service.drain(deadline_s=600.0)
    finally:
        service.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = service.stats()
    tenants = {tid: service.tenants[tid] for tid in wave1 + wave2}
    bad = []
    if overdraft.state != REJECTED or overdraft.row is not None or overdraft.row_obj is not None:
        bad.append(f"the overdraft plan was not rejected ({overdraft.state})")
    if len(driver.rows) > SERVICE_WAVE:
        bad.append(f"the pool grew to {len(driver.rows)} rows")
    for tid, t in tenants.items():
        row = t.row_obj
        live = int((row.carry.matcher.times_seen > 0).sum())
        if t.state != FINISHED or int(row.carry.results) != live + len(row.log):
            bad.append(f"{tid}: {t.state}, {int(row.carry.results)} results != {live} live + {len(row.log)} spilled")
    settled = sum(t.actual_s for t in tenants.values())
    if abs(st["budget"]["committed_s"]) > 1e-6 or not math.isclose(st["budget"]["spent_s"], settled, rel_tol=1e-9):
        bad.append(f"ledger {st['budget']} against {settled} settled")
    if launches["match_update_batched"] != cohorts * len(processed) or \
            any(v for k, v in launches.items() if k != "match_update_batched"):
        bad.append(f"launches {launches} for {len(processed)} processed batches")
    if bad:
        fail(f"{name}: {bad}")
    frames = sum(int(t.row_obj.carry.step) for t in tenants.values())
    d = st["driver"]
    print(f"  {name}: {len(tenants)} tenants in two waves of {SERVICE_WAVE}, the overdraft plan rejected; every "
          f"result kept (live ring + spilled log), the pool {len(driver.rows)} rows, the ledger settled "
          f"({st['budget']['spent_s']:.1f} s spent of {st['budget']['total_s']:.1f}); {d['slots']} slot batches, "
          f"{len(processed)} processed, {d['reissues']} reissues")
    print(f"    wall {wall:.2f} s; {frames} frames, {frames / wall:.1f} frames/s; {d['detector_invocations']} detector "
          f"calls, {d['cache_hits']} cache hits, amortization {frames / max(d['detector_invocations'], 1):.4f}x; "
          f"lane occupancy {st['batch']['occupancy']:.4f}; launches {launches}")
    for tid, t in tenants.items():
        rep = t.to_dict()
        print(f"    {tid} (class {t.select_id}, budget {t.row_obj.budget}): {rep['results']} results in {rep['steps']} "
              f"frames; first result {rep['ttfr_s'] if rep['ttfr_s'] is None else round(rep['ttfr_s'], 3)} s; "
              f"projected {t.projected_s:.1f} s, settled {t.actual_s:.1f} s")
    solo_s = 0.0
    for tid in (wave1[0], wave2[0]):
        t = tenants[tid]
        row = t.row_obj
        carry = init_carry(init_state(chunks.length, device=cuda),
                           init_matcher(max_results=MATCHER_CAPACITY, device=cuda), t.key)
        t1 = time.perf_counter()
        solo = SearchPlan(result_limit=MULTI_PLAN["result_limit"], max_steps=row.budget, cohorts=cohorts,
                          method="exact").run(carry, chunks, detector=lambda k, f, c=t.select_id: filter_class(
                              repo, oracle_detect(repo, f, query_class=None), c))
        solo_s += time.perf_counter() - t1
        a, b = row.carry, solo.carry
        pairs = [("step", a.step, b.step), ("results", a.results, b.results), ("key", a.key, b.key),
                 ("n1", a.sampler.n1, b.sampler.n1), ("n", a.sampler.n, b.sampler.n),
                 ("times_seen", a.matcher.times_seen, b.matcher.times_seen)]
        diffs = [f for f, x, y in pairs if not bits_equal(x.cpu(), y.cpu())]
        if diffs:
            fail(f"{name}: {tid} (budget {row.budget}) != its solo scan on {diffs}")
    late = tenants[wave2[0]].row_obj.budget
    if late >= SERVICE_PLANS[1]["max_steps"]:
        fail(f"{name}: {wave2[0]} was not debited ({late})")
    print(f"  {name}: {wave1[0]} and {wave2[0]} (admitted late, debited to {late} frames) == their solo scans on "
          f"the card (step, results, key, n1, n, times_seen; {solo_s:.2f} s)")
    ttfr = [t.slo_report()["ttfr_s"] for t in tenants.values()]
    return launches, dict(wall_s=wall, frames=frames, frames_per_s=frames / wall, tenants=len(tenants),
                          pool_rows=len(driver.rows), slot_batches=d["slots"], processed_batches=len(processed),
                          invocations=d["detector_invocations"], cache_hits=d["cache_hits"],
                          amortization=frames / max(d["detector_invocations"], 1),
                          occupancy=st["batch"]["occupancy"], ttfr_max_s=max((v for v in ttfr if v is not None), default=None),
                          spent_s=st["budget"]["spent_s"])


def service_http_path(torch) -> None:
    """The HTTP front on 127.0.0.1, port 0, over a small service on the
    card (the front's own ``build_service``, dashcam(0.02)): two submits by
    POST, ``GET /stats``, a drain; every answer ``ok`` JSON, then
    ``shutdown()``."""
    import argparse
    import threading
    import urllib.request

    from repro_torch.launch.serve_http import make_server
    from repro_torch.launch.serve_search import build_service

    args = argparse.Namespace(dataset="dashcam", scale=0.02, seed=0, budget_s=float("inf"), cohorts=4, workers=2,
                              max_steps=100_000, max_results=512, slots_per_batch=4, cache=True, device="cuda")
    service = build_service(args)
    server = make_server(service, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    service.start()
    t0 = time.perf_counter()

    def call(obj=None, path=""):
        req = urllib.request.Request(base + path, data=None if obj is None else json.dumps(obj).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="GET" if obj is None else "POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read().decode())
        if out.get("ok") is not True:
            fail(f"HTTP front: {obj or path} answered {out}")
        return out

    try:
        for tid, cls in (("h0", 0), ("h1", 7)):
            call({"op": "submit", "tenant": tid, "class": cls, "seed": cls, "plan": {
                "result_limit": 10, "max_steps": 1200, "cohorts": 4, "execution": {"queries_axis": True}}})
        call(path="/stats")
        done = call({"op": "drain", "deadline_s": 120})
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
        thread.join(timeout=5.0)
    got = {tid: (t["state"], t["results"], t["steps"]) for tid, t in done["tenants"].items()}
    if any(state != "finished" or results < 1 for state, results, _ in got.values()):
        fail(f"HTTP front: {got}")
    print(f"  HTTP front on the card: 2 submits, GET /stats and a drain, every answer ok JSON; {got}; "
          f"{time.perf_counter() - t0:.2f} s; shut down")


def async_compose_bench_path(torch) -> None:
    """``repro_torch.bench.async_compose --quick`` on the card; its 2x gate
    raises."""
    from repro_torch.bench import async_compose

    t0 = time.perf_counter()
    ratio = async_compose.main(["--quick"])
    print(f"  bench async_compose --quick: ratio {ratio:.4f}x (gate 2x), {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------ serve paths

def ssd_inputs(torch, b, s, h, p, n, a_log, dt_kind, seed):
    """B6's inputs on the card in the model's layout: x, dt (see
    B6_SHAPES), B and C as column slices of one [B, S, 2N] tensor (as the
    model's split), a [H] < 0."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device="cuda")
    if dt_kind == "weak":
        u = torch.rand((b, s, h), generator=g, device="cuda")
        dt = torch.exp(math.log(1e-3) + math.log(100.0) * u)
    else:
        dt = F.softplus(torch.randn((b, s, h), generator=g, device="cuda"))
    bc = 0.3 * torch.randn((b, s, 2 * n), generator=g, device="cuda")
    if a_log is None:
        a = -torch.exp(0.3 * torch.randn((h,), generator=g, device="cuda"))
    else:
        a = torch.full((h,), -math.exp(a_log), device="cuda")
    return x, dt, bc[..., :n], bc[..., n:], a


def ssd_work(b, s, h, p, n, q) -> tuple[int, int]:
    """(bytes, operations) the SSD scan needs: x, dt, B, C and a read once,
    y and the final state written once; per chunk the causal half of C·Bᵀ
    once for all heads that share B and C (2N a pair), and per head the
    decay and the product with x·dt (2P + 3 a pair) and the inter-chunk and
    state products (4QPN) with their scalings (3QP)."""
    nc, pairs = s // q, q * (q + 1) // 2
    nbytes = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * n + b * h * p * n + h)
    ops = b * nc * (pairs * 2 * n + h * (pairs * (2 * p + 3) + 4 * q * p * n + 3 * q * p))
    return nbytes, ops


def ssd_kernel_ops(b, s, h, p, n, q, tile=64) -> int:
    """The operations B6's five launches issue (a multiply-add counts 2; a
    subtraction, an exp or a multiply 1), as the source tiles the work: 64 x 64
    tiles of y and of C·Bᵀ with the P columns padded to 64, the chunk's
    positions padded to whole stages, each thread an 8 x 8 block.
    - cb: per (b, chunk), each tile on and below the diagonal, 64·64·N
      multiply-adds;
    - chunk_state: per (b, chunk, h) and 128 state columns, 128 threads each
      doing 64 multiply-adds and 8 multiplies (x times its weight) a
      position, the positions of each stage of 32 rounded up to 4;
    - acs and state_pass: 3 operations a weight, an exp and a multiply-add
      a state element and chunk;
    - chunk_scan: per (b, chunk, h, row tile t), after the first chunk the
      inter-chunk 64·64·N multiply-adds and the 64 x 64 scaling; per
      column tile the decay (4 operations a score) and 64·64·64
      multiply-adds, of which the diagonal tile issues only the positions
      up to each thread's last row (min(64, 4·ty + 36) for the rows 4·ty …
      4·ty + 3 and 4·ty + 32 … 4·ty + 35)."""
    nc, nt = s // q, -(-q // tile)
    pairs = nt * (nt + 1) // 2
    cb = b * nc * pairs * tile * tile * 2 * n
    steps = sum(-(-min(32, q - k0) // 4) * 4 for k0 in range(0, q, 32))
    state = b * nc * h * -(-n // 128) * 128 * (2 * 64 + 8) * steps
    acs_and_pass = b * nc * h * 3 * q + b * h * n * p * nc * 3
    diag = 8 * sum(min(tile, 4 * ty + 36) for ty in range(8)) * 2 * 64   # 8 threads a row group, 64 FMAs a step
    decay = 4 * tile * tile
    per_row_tile = [(decay + 2 * tile ** 3) * t + decay + diag for t in range(nt)]
    inter = b * (nc - 1) * h * nt * (2 * tile * tile * n + tile * tile)
    scan = b * nc * h * sum(per_row_tile) + inter
    return cb + state + acs_and_pass + scan


def ssd_phase_us(fn, *, n: int = 3) -> dict:
    """Device µs per call of each of B6's five launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(B6_PHASES, 0.0)
    for e in device_events(prof):
        m = re.search(r"ssd_scan_(\w+?)_kernel", e.name)
        if m and m.group(1) in us:
            us[m.group(1)] += e.time_range.elapsed_us() / n
    return us


def check_ssd_kernel(torch, rows) -> None:
    """B6 against its plain version on the card, y and the final state,
    element by element within SSD_ATOL + SSD_RTOL·|ref|, and its device
    time by launch.  No PyTorch call computes the SSD scan, so there is no
    library time."""
    from repro_torch.kernels.ssd_scan.kernel import smem_bytes, ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_ref

    for shape in B6_SHAPES:
        b, s, h, p, n, chunk, a_log, dt_kind = shape
        x, dt, bm, cm, a = ssd_inputs(torch, b, s, h, p, n, a_log, dt_kind, seed=b * s + h + p + n)
        q = min(chunk, s)
        y, hs = ssd_scan(x, dt, bm, cm, a, chunk=chunk)
        ry, rh = ssd_ref(x, dt, bm, cm, a, chunk=chunk)
        torch.cuda.synchronize()
        worst, errs = 0.0, []
        for out, ref in ((y, ry), (hs, rh)):
            diff = (out - ref).abs()
            worst = max(worst, float((diff / (SSD_ATOL + SSD_RTOL * ref.abs())).max()))
            errs.append((float(diff.max()), float(ref.abs().max())))
        if not worst <= 1.0 or not (torch.isfinite(y).all() and torch.isfinite(hs).all()):
            fail(f"ssd_scan != plain at {shape}: max |diff| (y, state) {errs}, "
                 f"largest |diff| / limit {worst}")
        underflow = float((torch.exp((dt * a).reshape(b, s // q, q, h).sum(dim=2)) == 0).float().mean())
        if a_log is not None and a_log > 2 and underflow < 1.0:
            fail(f"ssd_scan strong-decay shape: exp(acs) of a whole chunk underflows in only {underflow}")
        if dt_kind == "weak" and underflow > 0.0:
            fail(f"ssd_scan weak-decay shape: exp(acs) of a whole chunk underflows in {underflow}")
        del y, hs, ry, rh
        nbytes, ops = ssd_work(b, s, h, p, n, q)
        own = ssd_kernel_ops(b, s, h, p, n, q)
        big = ops > 1e10
        row = timed_row(lambda: ssd_scan(x, dt, bm, cm, a, chunk=chunk),
                        lambda: ssd_ref(x, dt, bm, cm, a, chunk=chunk),
                        n=3 if big else 20, inner=2 if big else 10, reps=3 if big else 5,
                        shape=[b, s, h, p, n, q], a_log=a_log, dt=dt_kind, bytes=nbytes, ops=ops,
                        max_abs_err=errs[0][0], max_abs_ref=errs[0][1], state_max_abs_err=errs[1][0],
                        state_max_abs_ref=errs[1][1], diff_over_limit=worst, chunk_underflow=underflow,
                        kernel_ops=own, smem_bytes=smem_bytes())
        row["phases_us"] = ssd_phase_us(lambda: ssd_scan(x, dt, bm, cm, a, chunk=chunk))
        rows[("ssd_scan", *shape)] = row
        print(f"  ssd_scan (B,S,H,P,N,Q)=({b},{s},{h},{p},{n},{q}), a_log {a_log}, dt {dt_kind}: "
              f"max |diff| y {errs[0][0]:.3g} (max |ref| {errs[0][1]:.4g}), state {errs[1][0]:.3g} "
              f"(max |ref| {errs[1][1]:.4g}), largest |diff| / limit {worst:.3g} (limit {SSD_ATOL:g} + "
              f"{SSD_RTOL:g}·|ref|); whole-chunk decay underflows in {100 * underflow:.0f}% of chunks; "
              f"{ops:.4g} operations needed, {own:.4g} issued by B6 ({own / row['ms'] / 1e9:.1f} TFLOP/s, "
              f"at most {row['smem_bytes']} bytes of dynamic shared memory a block); " + describe(row))
        print("    by launch, device us: " + ", ".join(f"{k} {v:.1f}" for k, v in row["phases_us"].items()))
        if row["ms"] > row["plain_ms"]:
            fail(f"ssd_scan at {shape}: {row['ms'] * 1e3:.1f} us, slower than its plain version's "
                 f"{row['plain_ms'] * 1e3:.1f} us (both by {row['source']})")
        del x, dt, bm, cm, a
        torch.cuda.empty_cache()


def device_share(prof, range_name: str, kernel_key: str | None) -> dict:
    """Inside the host span of the ``range_name`` range: the device's busy
    time and idle share, the busy time of kernels whose name holds
    ``kernel_key`` (none when None) and of the cuBLAS products (names
    holding "gemm", "gemv" or "nvjet"), and the runtime calls that launch or wait."""
    from torch.autograd import DeviceType

    span = [e for e in prof.events() if e.name == range_name and e.device_type == DeviceType.CPU][0]
    lo, hi = span.time_range.start, span.time_range.end
    busy = key = gemm = 0.0
    for e in device_events(prof):
        overlap = max(0, min(e.time_range.end, hi) - max(e.time_range.start, lo))
        busy += overlap
        if kernel_key is not None and kernel_key in e.name:
            key += overlap
        elif "gemm" in e.name or "gemv" in e.name or "nvjet" in e.name:
            gemm += overlap
    inside = [e for e in prof.events() if e.device_type == DeviceType.CPU
              and lo <= e.time_range.start and e.time_range.end <= hi]
    calls = {name: sum(e.name == name for e in inside)
             for name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaStreamSynchronize",
                          "cudaMemcpyAsync")}
    return {"span_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3, "idle": 1 - busy / (hi - lo),
            "kernel_ms": key / 1e3, "kernel_share": key / busy if busy else 0.0,
            "gemm_ms": gemm / 1e3, "calls": calls}


def check_prefill_body(label: str, cell: dict, by_body: dict, launches: int) -> None:
    """The prefill's ``launches`` of B4 all ran the cell's ``prefill_body``
    and no other body ran (nothing to check where the cell names none)."""
    if cell["prefill_body"] is None:
        return
    want = {body: launches if body == cell["prefill_body"] else 0 for body in by_body}
    if by_body != want:
        fail(f"{label}: B4 launches by body {by_body}, expected {want}")


def serve_config(cell: dict, *, reduced: bool):
    """The cell's model config: full width (cut to ``layers`` where the
    cell gives it), or reduced (``reduced_layers`` deep where given, at
    ``reduced_head_dim`` where given)."""
    import dataclasses

    from repro_torch.configs import ARCHS, scale_down

    cfg = ARCHS[cell["arch"]]
    if not reduced:
        return dataclasses.replace(cfg, num_layers=cell["layers"]) if cell.get("layers") else cfg
    cfg = scale_down(cfg, layers=cell.get("reduced_layers") or 2)
    if cell["reduced_head_dim"] is not None:
        cfg = dataclasses.replace(cfg, head_dim=cell["reduced_head_dim"])
    return cfg


def layer_kinds(cfg) -> tuple[int, int, int]:
    """(attention layers, Mamba-2 layers, MoE layers) of ``cfg``."""
    attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    return attn, cfg.num_layers - attn, moe


def expected_launches(cfg, tokens: int) -> dict:
    """A serve's launches: B4 once an attention layer, an encoder layer and
    a cross-attention layer and B6 once a Mamba-2 layer in the prefill, B5
    once an attention layer and a cross-attention layer a decoded token."""
    attn, ssm, _ = layer_kinds(cfg)
    cross = cfg.num_layers if cfg.cross_attention else 0
    want = {"flash_attention": attn + cfg.encoder_layers + cross, "flash_decode": (attn + cross) * tokens,
            "ssd_scan": ssm}
    return {k: v for k, v in want.items() if v}


def expected_shapes(cfg, b: int, prompt: int, frames: int, tokens: int) -> tuple[dict, dict]:
    """A float32 serve's launches by shape: B4's (B, S, T, H, KV, d, dtype,
    causal) in the prefill (the decoder's self-attention over the prompt's
    rows, the encoder over the frames, the cross-attention from the prompt
    to the frames) and B5's (B, H, KV, d, T, dtype) over all decoded tokens
    (the self caches of prompt + tokens + 1, the cross caches of
    ``encoder_len``)."""
    attn, _, _ = layer_kinds(cfg)
    cross = cfg.num_layers if cfg.cross_attention else 0
    if not (attn or cfg.encoder_layers or cross):      # no attention: no heads to read
        return {}, {}
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b4 = {(b, prompt, prompt, h, kv, d, "float32", True): attn,
          (b, frames, frames, h, kv, d, "float32", False): cfg.encoder_layers,
          (b, prompt, frames, h, kv, d, "float32", False): cross}
    b5 = {(b, h, kv, d, prompt + tokens + 1, "float32"): attn * tokens,
          (b, h, kv, d, cfg.encoder_len, "float32"): cross * tokens}
    return {k: v for k, v in b4.items() if v}, {k: v for k, v in b5.items() if v}


def shape_launches(metrics: dict, kernel: str, shape: tuple) -> int:
    """The launches of ``kernel`` at a kernel-phase row's ``shape`` in a
    serve's run (``metrics["launches_by_shape"]``; B5's key leaves out the
    cache lengths)."""
    key = list(shape[:8] if kernel == "flash_attention" else shape[:6])
    return sum(e["launches"] for e in metrics["launches_by_shape"][kernel] if e["shape"] == key)


def serve_batch(torch, cfg, b: int, prompt: int, device, frames: int | None = None, seed: int = 1) -> dict:
    """The launcher's batch (``make_prompt``) with a vlm's patches and an
    audio model's frames ([b, ``frames`` or ``prompt``, d_model]) drawn from
    a normal seeded by ``seed``."""
    from repro_torch.launch import serve as launcher

    batch = launcher.make_prompt(cfg, b, prompt, device, seed=seed)
    g = torch.Generator().manual_seed(seed + 100)
    if "patches" in batch:
        batch["patches"] = torch.randn(tuple(batch["patches"].shape), generator=g).to(device)
    if "frames" in batch:
        batch["frames"] = torch.randn((b, frames or prompt, cfg.d_model), generator=g).to(device)
    return batch


def forced_batch(torch, cfg, fed, frames: int) -> dict:
    """The forward's batch that a decode over the ``fed`` tokens equals:
    a vlm's with no patch (the decode never sees them), an audio model's
    over zero frames (what the zeroed cross caches hold, ROADMAP C14)."""
    batch = {"tokens": fed}
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros((fed.shape[0], 0, cfg.patch_dim), device=fed.device)
    if cfg.encoder_layers:
        batch["frames"] = torch.zeros((fed.shape[0], frames, cfg.d_model), device=fed.device)
    return batch


def serve_gemm_flops(params, cfg, b: int, rows: int, frames: int) -> float:
    """The products of a prefill of ``b`` sequences of ``rows`` decoder
    rows: each weight matrix times the rows it multiplies (the decoder's
    ``rows``, the encoder's and the cross K/V's ``frames``, the patch
    projector's ``num_patches``), the last position's unembedding, the
    experts at top_k a token as ``moe_flops`` counts them."""
    from repro_torch.models.moe import moe_flops

    total = 2.0 * b * cfg.d_model * cfg.vocab
    for name, p in params.named_parameters():
        if p.dim() < 2 or name.startswith("embed.") or ".moe.w_" in name:
            continue
        if name.startswith("enc_") or ".cross.wk" in name or ".cross.wv" in name:
            n = frames
        elif name.startswith("patch_proj."):
            n = cfg.num_patches
        else:
            n = rows
        total += 2.0 * b * n * p.numel()
    moe_layers = layer_kinds(cfg)[2]
    if moe_layers:
        total += moe_layers * moe_flops(b * rows, cfg.d_model, cfg.moe, cfg.mlp)
    return total


def drop_free(cfg):
    """The same model with capacity factor E/k: every expert has a slot
    for each token of a call, so no token is dropped."""
    import dataclasses

    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def moe_drop_summary(steps: list) -> dict:
    """Per step (the prefill, then each decode step), the least and the
    largest dropped fraction over the MoE layers, and the aux losses'
    range."""
    import torch

    out = []
    for stats in steps:
        d = torch.stack([s.dropped_fraction for s in stats]).cpu()
        a = torch.stack([s.aux_loss for s in stats]).cpu()
        out.append(dict(dropped_min=float(d.min()), dropped_max=float(d.max()),
                        dropped_mean=float(d.mean()), layers_dropping=int((d > 0).sum()),
                        aux_min=float(a.min()), aux_max=float(a.max())))
    return {"prefill": out[0], "decode": out[1:]}


def moe_split(torch, params, cfg, tokens, layers: int, n: int) -> dict:
    """Device ms of one MoE layer's four steps on ``tokens`` (int[B, S]),
    each timed alone by the profile and by CUDA events: the first MoE
    layer's own input (the embedded tokens through its ``norm2``), one
    group; router = the float32 router product and ``route`` (softmax,
    top-k, capacity ranks, slot owners).  Times ``layers`` give the
    step's MoE time."""
    from repro_torch.models import moe
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.transformer import embed_tokens

    i = next(i for i in range(cfg.num_layers) if cfg.is_moe_layer(i))
    pl = params[f"layer_{i}"]
    h = apply_norm(cfg.norm, pl["norm2"], embed_tokens(params, tokens, cfg))
    h = h.reshape(1, -1, cfg.d_model)
    p, m, t = pl["moe"], cfg.moe, h.shape[1]
    c = moe.capacity(t, m)
    logits = moe.router_logits(p, h, m)
    r = moe.route(logits, m, c)
    xe = moe.dispatch(h, r, m, c)
    ye = moe.expert_ffn(p, xe, cfg.mlp)
    def step_ms(fn):
        # the profile's device time (the events' where it kept no device activity) and CUDA events
        # around the calls: a profile that lost activities reads below the events
        events = median_ms(fn, inner=n, reps=3)
        return device_ms(fn, n=n) or events, events

    timed = dict(router_logits=step_ms(lambda: moe.router_logits(p, h, m)),
                 route=step_ms(lambda: moe.route(logits, m, c)),
                 dispatch=step_ms(lambda: moe.dispatch(h, r, m, c)),
                 experts=step_ms(lambda: moe.expert_ffn(p, xe, cfg.mlp)),
                 combine=step_ms(lambda: moe.combine(ye, r, t)))
    ms, events = ({"router": timed["router_logits"][i] + timed["route"][i],
                   **{k: timed[k][i] for k in ("dispatch", "experts", "combine")}} for i in (0, 1))
    mats = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    padded = 2.0 * m.num_experts * c * cfg.d_model * m.d_ff * mats
    active = moe.moe_flops(t, cfg.d_model, m, cfg.mlp)
    return dict(tokens=t, capacity=c, layer_ms=ms, step_ms={k: v * layers for k, v in ms.items()},
                step_events_ms={k: v * layers for k, v in events.items()},
                expert_flops=padded, active_flops=active, padding_share=1 - active / padded,
                expert_tflops=padded / ms["experts"] / 1e9)


@contextlib.contextmanager
def layer_digests(out: dict):
    """While active, a short SHA-256 of each B6 output (``mamba2.ssd_scan``'s
    y, one a Mamba-2 layer of a prefill or forward) and of each MoE
    routing (``moe.route``'s expert ids and slot owners, one an MoE layer
    and a call), appended to ``out[out["phase"]]`` in call order.  Each
    digest reads its tensor to the host, so it is kept out of timed
    runs."""
    from repro_torch.models import mamba2, moe

    def digest(*tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:12]

    scan, route = mamba2.ssd_scan, moe.route

    def scan_hook(*args, **kwargs):
        y, state = scan(*args, **kwargs)
        out.setdefault(out.get("phase", "?") + ".b6", []).append(digest(y))
        return y, state

    def route_hook(*args, **kwargs):
        r = route(*args, **kwargs)
        out.setdefault(out.get("phase", "?") + ".route", []).append(digest(r.top_e, r.src))
        return r

    mamba2.ssd_scan, moe.route = scan_hook, route_hook
    try:
        yield out
    finally:
        mamba2.ssd_scan, moe.route = scan, route


def describe_digests(digests: dict) -> str:
    """B6's digests one a layer, and the routings of a phase folded into
    one digest (their count beside it)."""
    parts = []
    for key, vals in digests.items():
        if key == "phase" or not vals:
            continue
        if key.endswith(".b6"):
            parts.append(f"{key} {vals}")
        else:
            parts.append(f"{key} {hashlib.sha256(''.join(vals).encode()).hexdigest()[:12]} (x{len(vals)})")
    return "; ".join(parts) or "none"


def teacher_forcing(torch, cfg, run, params, res, n: int, frames: int, digests: dict | None = None) -> dict:
    """Decode step t fed token t at position t against the full forward over
    the fed tokens at t (an MoE model: both on its drop-free copy, which
    must drop nothing): ``ok`` when max |diff| <= 1e-3 x max |logits| of the
    forward and the argmax agrees everywhere.  ``digests["phase"]`` is set
    to "tf_decode" and then "forward" for :func:`layer_digests`."""
    from repro_torch.launch import serve as launcher
    from repro_torch.models.transformer import forward_lm, init_decode_cache

    digests = {} if digests is None else digests
    n_moe = layer_kinds(cfg)[2]
    b = res.tokens.shape[0]
    fed = res.tokens[:, :n]
    tf_cfg, tf_step = cfg, torch.stack(res.step_logits, dim=1)
    tf_stats = []
    if n_moe:
        digests["phase"] = "tf_decode"
        tf_cfg = drop_free(cfg)
        tf_decode = launcher.build_decode_step(tf_cfg, run)
        cache = init_decode_cache(tf_cfg, b, n + 1, torch.float32, res.tokens.device)
        steps = []
        for t in range(n):
            _, lg, cache = tf_decode(params, fed[:, t:t + 1].contiguous(), cache, moe_stats=tf_stats)
            steps.append(lg)
        tf_step = torch.stack(steps, dim=1)
        del cache, steps
    digests["phase"] = "forward"
    full_stats = [] if n_moe else None
    full = forward_lm(params, forced_batch(torch, cfg, fed, frames), tf_cfg, run, mode="prefill",
                      moe_stats=full_stats)
    if n_moe and max(float(s.dropped_fraction) for s in tf_stats + full_stats) != 0.0:
        fail(f"serve {cfg.name}: the drop-free copy dropped tokens")
    diff = float((full - tf_step).abs().max())
    scale = float(full.abs().max())
    agree = float((full.argmax(-1) == tf_step.argmax(-1)).float().mean())
    return dict(diff=diff, scale=scale, agree=agree, ok=diff <= 1e-3 * scale and agree == 1.0, cfg=tf_cfg,
                forward_max=scale, decode_max=float(tf_step.abs().max()))


def poison_free_memory(torch, byte: int) -> int:
    """Fills the card's free memory, less 1 GiB, with ``byte`` (0xff: every
    float32 read from it is NaN) and hands it back to CUDA, so that the
    next allocations read it if they read before they write.  Returns the
    bytes filled."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    n = max(free - (1 << 30), 0)
    if n:
        block = torch.empty(n, dtype=torch.uint8, device="cuda")
        block.fill_(byte)
        torch.cuda.synchronize()
        del block
    torch.cuda.empty_cache()
    return n


def c16_loop(torch, reps: int) -> int:
    """ROADMAP C16: jamba-1.5-large-398b at the hybrid serve cell (full width,
    2 of 72 layers, batch 1, prompt 2,048, 8 greedy tokens, seed 0), built
    once, then ``reps`` times prefill -> decode -> teacher forcing, each
    repetition after the free memory was poisoned (0xff and 0x3f bytes in
    turn).  A line a repetition: max |logits| of the forward and of the
    decode, a digest of each layer's B6 output and of the MoE routings of
    each phase, and the verdict.  Returns the number of failed
    repetitions."""
    from repro_torch.launch import serve as launcher
    from repro_torch.models.transformer import init_params

    cell = SERVE_CELLS["hybrid"]
    b, prompt, n = cell["batch"], cell["prompt"], cell["tokens"]
    cuda = torch.device("cuda")
    run = launcher.RUN
    cfg = serve_config(cell, reduced=False)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=run.dtype(), device=cuda)
    torch.cuda.synchronize()
    print(f"  {cell['arch']} cut to {cfg.num_layers} layers, made on the card in {time.perf_counter() - t0:.1f} s; "
          f"{reps} repetitions of prefill [{b}x{prompt}] -> {n} decode steps -> teacher forcing")
    launcher.serve(params, cfg, run, serve_batch(torch, cfg, b, 128, cuda, 128), 2)
    seen, failed = {}, 0
    for i in range(reps):
        byte = (0xFF, 0x3F)[i % 2]
        filled = poison_free_memory(torch, byte)
        batch = serve_batch(torch, cfg, b, prompt, cuda)
        digests = {"phase": "prefill+decode"}
        t0 = time.perf_counter()
        with layer_digests(digests):
            res = launcher.serve(params, cfg, run, batch, n, keep_logits=True, moe_stats=[])
            tf = teacher_forcing(torch, cfg, run, params, res, n, prompt, digests)
        text = describe_digests(digests)
        for key, vals in digests.items():
            if key != "phase":
                seen.setdefault(key, set()).add(tuple(vals))
        failed += not tf["ok"]
        print(f"  c16 rep {i + 1}/{reps} (free {filled / 1e9:.1f} GB poisoned with 0x{byte:02x}; "
              f"{time.perf_counter() - t0:.1f} s): max |logits| forward {tf['forward_max']:.6g}, decode "
              f"{tf['decode_max']:.6g}; max |decode - forward| {tf['diff']:.4g} = {tf['diff'] / tf['scale']:.3g} x; "
              f"argmax agreement {tf['agree']:.4f}; {text}: {'pass' if tf['ok'] else 'FAIL'}", flush=True)
        del res, tf, batch
    stable = {key: len(v) for key, v in seen.items()}
    print(f"  c16: {reps - failed} of {reps} repetitions passed; distinct digests per phase over the "
          f"repetitions {stable}")
    del params
    torch.cuda.empty_cache()
    return failed


def serve_path(torch, family: str) -> tuple[dict, dict]:
    """The full-width LM serving path of ``SERVE_CELLS[family]`` through the
    launcher's functions: prefill (B4 once an attention, encoder and
    cross-attention layer, B6 once a Mamba-2 layer), greedy decode (B5 once
    an attention and a cross-attention layer a token), a teacher-forcing
    check of every decode step against the full forward over the fed tokens
    (for an MoE model, both on its drop-free copy: the real capacity of a
    decode step's few tokens drops some; a vlm's forward with no patch, an
    audio model's over zero frames: ``forced_batch``), the MoE layers'
    dropped fractions, a profile of one prefill and one decode step with
    the MoE's steps timed apart, and, where the cell asks, the stacked
    prefill on the same weights against the unrolled one.  Frees the
    weights before it returns."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import RunConfig
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_decode.kernel import flash_decode
    from repro_torch.launch import serve as launcher
    from repro_torch.models import mamba2
    from repro_torch.models.moe import capacity
    from repro_torch.models.stacked import stack_params
    from repro_torch.models.transformer import init_params

    cell = SERVE_CELLS[family]
    arch, b, prompt, n = cell["arch"], cell["batch"], cell["prompt"], cell["tokens"]
    frames = cell.get("frames") or prompt
    pre_fn, pre_kernel, pre_label = cell["prefill"]
    cuda = torch.device("cuda")
    run = launcher.RUN
    cfg = serve_config(cell, reduced=False)
    n_attn, n_ssm, n_moe = layer_kinds(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=run.dtype(), device=cuda)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    expert_params = sum(p.numel() for name, p in params.named_parameters()
                        if ".moe.w_" in name)
    widths = []
    if n_attn:
        widths.append(f"heads {cfg.num_heads}/{cfg.num_kv_heads} of {cfg.resolved_head_dim}")
    if n_ssm:
        d_inner, nheads, state = mamba2.mamba_dims(cfg.d_model, cfg.ssm)
        widths.append(f"{nheads} SSM heads of {cfg.ssm.head_dim}, state {state}, chunk {cfg.ssm.chunk_len}")
    widths.append(f"d_ff {cfg.d_ff}")
    if n_moe:
        widths.append(f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} of width {cfg.moe.d_ff} on "
                      f"{n_moe} layers, capacity factor {cfg.moe.capacity_factor}")
    if cfg.family == "vlm":
        widths.append(f"{cfg.num_patches} patches of {cfg.patch_dim} before {prompt - cfg.num_patches} tokens")
    if cfg.encoder_layers:
        widths.append(f"an encoder of {cfg.encoder_layers} layers over {frames} frames, cross-attention in "
                      f"every decoder layer (cross caches of {cfg.encoder_len})")
    print(f"  {arch}: {cfg.num_layers} layers ({n_attn} attention, {n_ssm} Mamba-2, {n_moe} MoE), "
          f"d_model {cfg.d_model}, {', '.join(widths)}, vocab {cfg.vocab}: "
          f"{n_params:,} parameters ({n_params * 4 / 1e9:.2f} GB float32), made on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    # warm the card's lazily loaded kernels (cuBLAS' heuristics) outside the timed run
    launcher.serve(params, cfg, run, serve_batch(torch, cfg, b, cfg.num_patches + 128, cuda, 128), 2)
    batch = serve_batch(torch, cfg, b, prompt, cuda, frames)

    stats = [] if n_moe else None
    reset_launches()
    res = launcher.serve(params, cfg, run, batch, n, keep_logits=True, moe_stats=stats)
    launches = read_launches()
    by_body = dict(flash_attention.launches_by_body)
    by_shape = dict(flash_attention.launches_by_shape), dict(flash_decode.launches_by_shape)
    peak = torch.cuda.max_memory_allocated()

    step = torch.stack(res.step_logits, dim=1)                       # [B, n, V]
    if (res.prefill_logits.shape != (b, cfg.vocab) or step.shape != (b, n, cfg.vocab)
            or res.tokens.shape != (b, n + 1)):
        fail(f"serve {arch}: shapes {tuple(res.prefill_logits.shape)}, {tuple(step.shape)}, "
             f"{tuple(res.tokens.shape)}")
    if not (bool(torch.isfinite(res.prefill_logits).all()) and bool(torch.isfinite(step).all())):
        fail(f"serve {arch}: non-finite logits")
    if not (bool((res.tokens >= 0).all()) and bool((res.tokens < cfg.vocab).all())):
        fail(f"serve {arch}: token out of the vocabulary")
    expect = expected_launches(cfg, n)
    if {k: v for k, v in launches.items() if v} != expect:
        fail(f"serve {arch}: launches {launches}, expected {expect}")
    b4_prefill = expect.get("flash_attention", 0)
    check_prefill_body(f"serve {arch}", cell, by_body, b4_prefill)
    if by_shape != expected_shapes(cfg, b, prompt, frames, n):
        fail(f"serve {arch}: B4 and B5 launches by shape {by_shape}, expected "
             f"{expected_shapes(cfg, b, prompt, frames, n)}")
    drops = None
    if n_moe:
        drops = moe_drop_summary(stats)
        if len(stats) != n + 1 or any(len(s) != n_moe for s in stats):
            fail(f"serve {arch}: MoE stats of {[len(s) for s in stats]} layers a step, expected {n_moe}")
        pre_d, dec = drops["prefill"], drops["decode"]
        print(f"  MoE dropped fraction, prefill: min {pre_d['dropped_min']:.4g}, max {pre_d['dropped_max']:.4g} "
              f"over {n_moe} layers (aux loss {pre_d['aux_min']:.4f}..{pre_d['aux_max']:.4f})")
        print(f"  MoE dropped fraction, decode steps 0..{n - 1} (capacity {capacity(b, cfg.moe)} slots an "
              f"expert for {b} tokens): min over layers "
              f"{[round(d['dropped_min'], 4) for d in dec]}; max {[round(d['dropped_max'], 4) for d in dec]}; "
              f"layers dropping a step {[d['layers_dropping'] for d in dec]}")

    # teacher forcing: decode step t fed token t at position t == the full
    # forward over the fed tokens at t (an MoE model: both on its drop-free copy)
    digests = {}
    with layer_digests(digests):
        tf = teacher_forcing(torch, cfg, run, params, res, n, frames, digests)
    diff, scale, agree, tf_cfg = tf["diff"], tf["scale"], tf["agree"], tf["cfg"]
    if not tf["ok"]:
        fail(f"serve {arch}: decode != teacher forcing: max |diff| {diff} (limit 1e-3 x max |logits| "
             f"{scale}), argmax agreement {agree}; max |logits| of the forward {tf['forward_max']:.6g}, of "
             f"the decode {tf['decode_max']:.6g}; digests {describe_digests(digests)}")
    del step, tf
    prefill_tok_s = b * prompt / res.prefill_s
    decode_tok_s = b * n / res.decode_s
    per = ", ".join(f"{k} {v // n} per token" if k == "flash_decode" else f"{k} {v} per prefill"
                    for k, v in launches.items() if v)
    print(f"  prefill [{b}x{prompt}] {res.prefill_s * 1e3:.1f} ms = {prefill_tok_s:.1f} tokens/s; "
          f"decode {n} tokens/seq in {res.decode_s * 1e3:.1f} ms = {res.decode_s * 1e3 / n:.2f} ms/step "
          f"= {decode_tok_s:.1f} tokens/s; max_memory_allocated {peak / 1e9:.2f} GB; launches "
          f"{launches} ({per}; layers {cfg.num_layers})"
          + ("" if cell["prefill_body"] is None else f"; B4 by body {by_body}"))
    print(f"  teacher forcing over {n} steps{' (the drop-free copy, capacity factor ' + str(tf_cfg.moe.capacity_factor) + ')' if n_moe else ''}: "
          f"max |decode - forward| {diff:.4g} = "
          f"{diff / scale:.3g} x max |logits| {scale:.4g} (limit 1e-3); argmax agreement {agree:.4f} "
          f"(required 1)")

    stacked = None
    if cell.get("stacked"):
        prefill = launcher.build_prefill_step(cfg, run)
        want = prefill(params, batch)
        sparams = stack_params(params, cfg)
        before = flash_attention.launches
        got = launcher.build_prefill_step(cfg, RunConfig(param_dtype="float32", stacked=True))(sparams, batch)
        ran = flash_attention.launches - before
        sdiff, sscale = float((got - want).abs().max()), float(want.abs().max())
        stacked = dict(bit_equal=bool(torch.equal(got, want)), max_abs_diff=sdiff, max_abs_logit=sscale,
                       b4_launches=ran)
        if not sdiff <= 1e-5 * sscale or ran != b4_prefill:
            fail(f"serve {arch}: stacked prefill != unrolled: max |diff| {sdiff} (limit 1e-5 x {sscale}), "
                 f"B4 launches {ran} of {b4_prefill}")
        print(f"  stacked prefill ({cfg.num_layers} groups of 1 layer, weights restacked on the card) == "
              f"unrolled: {'bit-equal' if stacked['bit_equal'] else f'max |diff| {sdiff:.3g}'} "
              f"(limit 1e-5 x max |logits| {sscale:.4g}); B4 {ran} launches")
        del sparams, got, want

    prefill = launcher.build_prefill_step(cfg, run)
    decode = launcher.build_decode_step(cfg, run)
    tok = res.tokens[:, -1:].contiguous()
    dec_kernel = cell["decode"]
    # a capture now and then keeps no device activity in one of its spans
    # (CAPTURE_PAD_S); the step is then profiled again, at most three times
    for attempt in range(3):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with prof:
            time.sleep(CAPTURE_PAD_S)
            with record_function("serve.prefill"):
                prefill(params, batch)
                torch.cuda.synchronize()
            with record_function("serve.decode_step"):
                decode(params, tok, res.cache)                       # position n of the cache
                torch.cuda.synchronize()
            time.sleep(CAPTURE_PAD_S)
        pre = device_share(prof, "serve.prefill", pre_kernel)
        dec = device_share(prof, "serve.decode_step", None if dec_kernel is None else dec_kernel[1])
        if pre["busy_ms"] > 0 and dec["busy_ms"] > 0:
            break
        print(f"  profile {attempt + 1} kept no device activity in a span (prefill busy {pre['busy_ms']} ms, "
              f"decode step {dec['busy_ms']} ms): taken again")
    else:
        fail(f"serve {arch}: three profiles kept no device activity in a span")
    gemm_flops = serve_gemm_flops(params, cfg, b, prompt, frames)
    # the weights a decode step reads: all but the encoder's and the patch projector's
    decode_bytes = 4 * sum(p.numel() for name, p in params.named_parameters()
                           if not name.startswith(("enc_", "patch_proj.")))
    print(f"profile: prefill span {pre['span_ms']:.1f} ms, device busy {pre['busy_ms']:.1f} ms "
          f"(idle {100 * pre['idle']:.1f}%); cuBLAS products {pre['gemm_ms']:.1f} ms = "
          f"{100 * pre['gemm_ms'] / pre['busy_ms']:.1f}% ({gemm_flops:.4g} flops"
          + (", experts by moe_flops" if n_moe else "") + ", "
          f"{gemm_flops / pre['gemm_ms'] / 1e9:.1f} TFLOP/s); {pre_label} {pre['kernel_ms']:.1f} ms = "
          f"{100 * pre['kernel_share']:.1f}% of the device time; the rest elementwise "
          f"{pre['busy_ms'] - pre['gemm_ms'] - pre['kernel_ms']:.1f} ms")
    if n_ssm:
        mflops = n_ssm * mamba2.mamba_flops(b * prompt, cfg.d_model, cfg.ssm)
        print(f"  mamba_flops (the reference's count, projections + SSD): {mflops:.4g} for the "
              f"prefill's {n_ssm} Mamba-2 layers, {mflops / pre['busy_ms'] / 1e9:.1f} TFLOP/s of device "
              f"busy time")
    dec_kernel_text = ("no kernel" if dec_kernel is None else
                       f"{dec_kernel[2]} {dec['kernel_ms'] * 1e3:.1f} us = "
                       f"{100 * dec['kernel_share']:.2f}% of the device time")
    print(f"profile: decode step (position {n}) span {dec['span_ms']:.2f} ms, device busy "
          f"{dec['busy_ms']:.2f} ms (idle {100 * dec['idle']:.1f}%); cuBLAS products "
          f"{dec['gemm_ms']:.2f} ms = {100 * dec['gemm_ms'] / dec['busy_ms']:.1f}% (weights "
          f"{decode_bytes / dec['gemm_ms'] / 1e9:.3f} TB/s while they run); {dec_kernel_text}")
    print(f"  runtime calls: prefill {pre['calls']}, decode step {dec['calls']}")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=10))
    split = None
    if n_moe:
        split = {"prefill": moe_split(torch, params, cfg, batch["tokens"], n_moe, n=5),
                 "decode": moe_split(torch, params, cfg, tok, n_moe, n=20)}
        for name, sp, busy in (("prefill", split["prefill"], pre["busy_ms"]),
                               ("decode step", split["decode"], dec["busy_ms"])):
            total = sum(sp["step_ms"].values())
            print(f"  MoE split, {name} ({sp['tokens']} tokens a layer, capacity {sp['capacity']}, x {n_moe} "
                  f"layers, each step timed alone): "
                  + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f}%; events {sp['step_events_ms'][k]:.3f})"
                              for k, v in sp["step_ms"].items())
                  + f"; together {total:.3f} ms = {100 * total / busy:.1f}% of the {name}'s device busy "
                  f"{busy:.3f} ms; expert products {sp['expert_flops']:.4g} flops a layer as run "
                  f"({sp['expert_tflops']:.1f} TFLOP/s), {sp['active_flops']:.4g} by moe_flops: capacity "
                  f"padding {100 * sp['padding_share']:.1f}% of the expert flops")
    metrics = dict(arch=arch, layers=cfg.num_layers, params=n_params, batch=b, prompt=prompt, tokens=n,
                   frames=frames if cfg.encoder_layers else None, stacked=stacked,
                   prefill_ms=res.prefill_s * 1e3, prefill_tok_s=prefill_tok_s,
                   decode_ms_per_step=res.decode_s * 1e3 / n, decode_tok_s=decode_tok_s,
                   max_memory_allocated=peak, b4_by_body=by_body,
                   launches_by_shape={name: [dict(shape=list(k), launches=v) for k, v in counts.items()]
                                      for name, counts in zip(("flash_attention", "flash_decode"), by_shape)},
                   teacher_forcing_max_diff=diff,
                   teacher_forcing_rel=diff / scale, argmax_agreement=agree,
                   prefill_profile=pre, decode_profile=dec, gemm_flops=gemm_flops)
    if n_moe:
        metrics.update(moe_dropped=drops, moe_split=split, expert_params=expert_params)
    del params, res, prof
    torch.cuda.empty_cache()
    return launches, metrics


def reduced_serve(torch, family: str) -> None:
    """The reduced LM of ``SERVE_CELLS[family]`` served on the card equals
    the same on the CPU: the same tokens, logits and decode caches (the
    cross caches too) within 1e-4 (weights made on the CPU and copied; an
    MoE at its real capacity; a vlm's patches and an audio model's frames
    from a seeded normal)."""
    from repro_torch import convert
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.launch import serve as launcher
    from repro_torch.models.transformer import init_params

    cell = SERVE_CELLS[family]
    arch = cell["arch"]
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    cfg = serve_config(cell, reduced=True)
    n_attn, n_ssm, n_moe = layer_kinds(cfg)
    p_cpu = init_params(cfg, seed=0, device=cpu)
    p_gpu = convert.params_from_numpy(convert.params_to_numpy(p_cpu), cfg, device=cuda)
    prompt = serve_batch(torch, cfg, 2, cell["reduced_prompt"], cpu)
    reset_launches()
    gpu = launcher.serve(p_gpu, cfg, launcher.RUN, {k: v.to(cuda) for k, v in prompt.items()}, 8,
                         keep_logits=True)
    launches = {k: v for k, v in read_launches().items() if v}
    by_body = dict(flash_attention.launches_by_body)
    check_prefill_body(f"reduced serve {arch}", cell, by_body, expected_launches(cfg, 8).get("flash_attention", 0))
    if launches != expected_launches(cfg, 8):
        fail(f"reduced serve {arch}: launches {launches}, expected {expected_launches(cfg, 8)}")
    ref = launcher.serve(p_cpu, cfg, launcher.RUN, prompt, 8, keep_logits=True)
    pairs = [("prefill", gpu.prefill_logits, ref.prefill_logits)]
    pairs += [(f"step {i}", a, b) for i, (a, b) in enumerate(zip(gpu.step_logits, ref.step_logits))]
    for i, (a, b) in enumerate(zip(gpu.cache.layers, ref.cache.layers)):
        pairs += [(f"cache {i}.{f}", x, y) for f, x, y in zip(a._fields, a, b)]
    for i, (a, b) in enumerate(zip(gpu.cache.cross, ref.cache.cross)):
        if a is not None:
            pairs += [(f"cross {i}.{f}", x, y) for f, x, y in zip(a._fields, a, b)]
    worst = max(float((a.cpu() - b).abs().max()) for _, a, b in pairs)
    if not torch.equal(gpu.tokens.cpu(), ref.tokens) or not worst <= 1e-4:
        fail(f"reduced serve {arch}: card != CPU (tokens equal: "
             f"{torch.equal(gpu.tokens.cpu(), ref.tokens)}, max |diff| {worst})")
    fields = sorted({f for layer in gpu.cache.layers for f in layer._fields})
    kinds = f"{n_attn} attention, {n_ssm} Mamba-2, {n_moe} MoE at capacity factor {cfg.moe.capacity_factor}, " \
        if n_moe else ""
    print(f"  reduced {arch} ({cfg.num_layers} layers, {kinds}d_model {cfg.d_model}, head dim "
          f"{cfg.resolved_head_dim}, prompt "
          f"{cell['reduced_prompt']}): card == CPU, tokens {gpu.tokens[0].tolist()}, logits and caches "
          f"({'/'.join(fields)}) within {worst:.3g} (limit 1e-4); launches {launches}"
          + ("" if cell["prefill_body"] is None else f"; B4 by body {by_body}"))


def detect_inputs(torch, cfg, repo, frame_ids, tokens: int, device) -> dict:
    """The detector's batch: each frame's ``frame_embedding`` as
    ``num_patches`` patches of ``patch_dim`` (a padded slot's frame -1 as
    frame 0, as the reference example does), then ``tokens`` tokens of 1."""
    from repro_torch.sim import frame_embedding

    patches = torch.stack([frame_embedding(repo, max(int(f), 0), dim=cfg.patch_dim, patches=cfg.num_patches)
                           for f in frame_ids]).to(device)
    return {"tokens": torch.ones((len(frame_ids), tokens), dtype=torch.int32, device=device), "patches": patches}


def head_checks(torch, label: str, out, frames: int, c: dict) -> dict:
    """The detector's outputs: shapes, finite, scores and boxes in [0, 1],
    unit features within 1e-5."""
    shapes = {"boxes": (frames, c["max_dets"], 4), "scores": (frames, c["max_dets"]),
              "cls_logits": (frames, c["max_dets"], c["num_classes"]),
              "feats": (frames, c["max_dets"], c["feat_dim"])}
    got = {f: tuple(getattr(out, f).shape) for f in shapes}
    if got != shapes:
        fail(f"{label}: output shapes {got}, expected {shapes}")
    if not all(bool(torch.isfinite(x).all()) for x in out):
        fail(f"{label}: non-finite detections")
    lo = min(float(out.scores.min()), float(out.boxes.min()))
    hi = max(float(out.scores.max()), float(out.boxes.max()))
    norm_err = float((torch.linalg.vector_norm(out.feats, dim=-1) - 1).abs().max())
    if not (0.0 <= lo and hi <= 1.0) or not norm_err <= 1e-5:
        fail(f"{label}: scores and boxes in [{lo}, {hi}], | |feats| - 1 | up to {norm_err} (limit 1e-5)")
    return dict(scores_boxes_range=[lo, hi], feat_norm_err=norm_err)


def detect_path(torch) -> tuple[dict, dict]:
    """The detector step (``build_detect_step``) on phi-3-vision at full
    width and depth over one cohort of ``DETECT["frames"]`` bdd(1.0)
    frames (a seeded chunk each, a seeded frame in it) batched by
    ``RequestBatcher``: B4 once a layer a call on "wgmma_f32", the head's
    ranges, the 50-frame call equal within 1e-4 to a call on its first
    ``alone`` frames alone, the device time a frame (profiled); then the
    reduced model's step on the card against the CPU within 1e-4."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import convert
    from repro_torch.configs import ARCHS, scale_down
    from repro_torch.configs.exsample_paper import bdd
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.launch import serve as launcher
    from repro_torch.models.detection import init_head
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.batcher import RequestBatcher
    from repro_torch.serve.serve_step import build_detect_step
    from repro_torch.sim import generate

    c = DETECT
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cfg, run = ARCHS[c["arch"]], launcher.RUN
    widths = {k: c[k] for k in ("max_dets", "num_classes", "feat_dim")}
    repo, chunks = generate(bdd(scale=1.0).repo, device=cuda)
    g = torch.Generator().manual_seed(c["seed"])
    chunk_ids = torch.randperm(chunks.num_chunks, generator=g)[:c["frames"]]
    start, length = chunks.start.cpu()[chunk_ids], chunks.length.cpu()[chunk_ids]
    frame_ids = start + torch.randint(0, 2**30, (c["frames"],), generator=g) % length
    batcher = RequestBatcher(batch_size=c["frames"])
    batcher.submit(frame_ids.tolist(), chunk_ids.tolist(), cohort=0)
    batch = batcher.next_batch()
    if not batch.valid.all() or batcher.occupancy != 1.0:
        fail(f"detect: the cohort's batch is not full ({batch.valid.sum()} of {c['frames']})")
    inputs = detect_inputs(torch, cfg, repo, batch.frame_ids, c["tokens"], cuda)
    s = inputs["tokens"].shape[1] + cfg.num_patches

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, dtype=run.dtype(), device=cuda)
    head = init_head(cfg.d_model, **widths, seed=1, device=cuda)
    detect = build_detect_step(cfg, run, **widths)
    alone = {k: v[:c["alone"]] for k, v in inputs.items()}
    detect(params, head, alone)                                    # warm cuBLAS outside the timed calls
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = detect(params, head, inputs)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items() if v}
    by_body = dict(flash_attention.launches_by_body)
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": cfg.num_layers}
    if launches != want:
        fail(f"detect: launches {launches}, expected {want}")
    check_prefill_body("detect", SERVE_CELLS["vlm"], by_body, cfg.num_layers)
    ranges = head_checks(torch, "detect", out, c["frames"], c)
    few = detect(params, head, alone)
    diff = max(float((a[:c["alone"]] - b).abs().max()) for a, b in zip(out, few))
    if not diff <= 1e-4:
        fail(f"detect: the {c['frames']}-frame call != its first {c['alone']} frames alone: max |diff| {diff}")

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        time.sleep(CAPTURE_PAD_S)
        with record_function("serve.detect"):
            detect(params, head, inputs)
            torch.cuda.synchronize()
        time.sleep(CAPTURE_PAD_S)
    share = device_share(prof, "serve.detect", "flash_attention")
    layer_params = sum(p.numel() for name, p in params.named_parameters() if name.startswith("layer_"))
    attn_ops = cfg.num_layers * 4 * cfg.resolved_head_dim * visible_pairs(s, s, True) * c["frames"] * cfg.num_heads
    flops = (2.0 * c["frames"] * (s * layer_params + cfg.num_patches * cfg.patch_dim * cfg.d_model)
             + 2.0 * c["frames"] * sum(p.numel() for p in head.parameters()) + attn_ops)
    ms_frame = call_s * 1e3 / c["frames"]
    print(f"  detector: {cfg.name} full width and depth ({sum(p.numel() for p in params.parameters()):,} "
          f"parameters), head max_dets {c['max_dets']}, num_classes {c['num_classes']}, feat_dim {c['feat_dim']}; "
          f"one cohort of {c['frames']} bdd(1.0) frames (chunks {chunk_ids[:4].tolist()}..., batch occupancy "
          f"{batcher.occupancy:.2f}), S = {s} ({cfg.num_patches} patches + {c['tokens']} tokens)")
    print(f"  detector call: {call_s * 1e3:.1f} ms = {ms_frame:.2f} ms a frame; {flops:.4g} flops "
          f"({flops / call_s / 1e12:.1f} TFLOP/s); launches {launches}, B4 by body {by_body}; "
          f"max_memory_allocated {peak / 1e9:.2f} GB; scores and boxes in [{ranges['scores_boxes_range'][0]:.4g}, "
          f"{ranges['scores_boxes_range'][1]:.4g}], | |feats| - 1 | <= {ranges['feat_norm_err']:.3g}; "
          f"first {c['alone']} frames alone: max |diff| {diff:.3g} (limit 1e-4)")
    print(f"profile: detector call span {share['span_ms']:.1f} ms, device busy {share['busy_ms']:.1f} ms "
          f"(idle {100 * share['idle']:.1f}%); cuBLAS products {share['gemm_ms']:.1f} ms = "
          f"{100 * share['gemm_ms'] / share['busy_ms']:.1f}%; B4 {share['kernel_ms']:.1f} ms = "
          f"{100 * share['kernel_share']:.1f}%; the rest {share['busy_ms'] - share['gemm_ms'] - share['kernel_ms']:.1f} ms")
    metrics = dict(arch=cfg.name, frames=c["frames"], seq=s, call_ms=call_s * 1e3, ms_per_frame=ms_frame,
                   flops=flops, tflops=flops / call_s / 1e12, max_memory_allocated=peak, b4_by_body=by_body,
                   alone_max_diff=diff, profile=share, **ranges)
    del params, head, out, few, prof, inputs
    torch.cuda.empty_cache()

    # the reduced model's step: card == CPU
    rcfg = scale_down(cfg)
    p_cpu = init_params(rcfg, seed=0, device=cpu)
    h_cpu = init_head(rcfg.d_model, **widths, seed=1, device=cpu)
    p_gpu = convert.params_from_numpy(convert.params_to_numpy(p_cpu), rcfg, device=cuda)
    h_gpu = convert.head_from_numpy(convert.params_to_numpy(h_cpu), d_model=rcfg.d_model, **widths, device=cuda)
    r_inputs = detect_inputs(torch, rcfg, repo, batch.frame_ids[:10], 16 - rcfg.num_patches, cpu)
    r_detect = build_detect_step(rcfg, run, **widths)
    before = flash_attention.launches
    gpu = r_detect(p_gpu, h_gpu, {k: v.to(cuda) for k, v in r_inputs.items()})
    ran = flash_attention.launches - before
    ref = r_detect(p_cpu, h_cpu, r_inputs)
    worst = max(float((a.cpu() - b).abs().max()) for a, b in zip(gpu, ref))
    if not worst <= 1e-4 or ran != rcfg.num_layers:
        fail(f"reduced detect: card != CPU: max |diff| {worst} (limit 1e-4), B4 launches {ran}")
    head_checks(torch, "reduced detect", gpu, 10, c)
    print(f"  reduced detector ({rcfg.num_layers} layers, d_model {rcfg.d_model}, {rcfg.num_patches} patches + "
          f"{16 - rcfg.num_patches} tokens, 10 frames): card == CPU within {worst:.3g} (limit 1e-4); B4 {ran}")
    metrics["reduced_max_diff"] = worst
    return launches, metrics


def bf16_prefill_path(torch) -> tuple[dict, dict]:
    """The dense prefill in bfloat16 through the launcher's prefill step:
    ``BF16_PREFILL``'s arch at full width and depth, one long prompt,
    so that each layer's attention is B4's "wgmma" body at B4_BF16.
    Checks the logits (shape, finite) and that each layer launched that
    body once and nothing else ran; profiles the prefill.  Returns the
    body's launches (as "flash_attention_wgmma") and the metrics."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import RunConfig
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.launch import serve as launcher
    from repro_torch.models.transformer import init_params

    cell = BF16_PREFILL
    cuda = torch.device("cuda")
    run = RunConfig(param_dtype="bfloat16")
    cfg = launcher.model_config(cell["arch"], reduced=False, device=cuda)
    b, prompt = cell["batch"], cell["prompt"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, dtype=run.dtype(), device=cuda)
    n_params = sum(p.numel() for p in params.parameters())
    prefill = launcher.build_prefill_step(cfg, run)
    prefill(params, launcher.make_prompt(cfg, b, 128, cuda))          # warm cuBLAS' bf16 kernels
    batch = launcher.make_prompt(cfg, b, prompt, cuda)
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items() if v}
    by_body = dict(flash_attention.launches_by_body)
    peak = torch.cuda.max_memory_allocated()
    if logits.shape != (b, cfg.vocab) or logits.dtype != torch.bfloat16 or not bool(torch.isfinite(logits).all()):
        fail(f"bf16 prefill: logits {tuple(logits.shape)} {logits.dtype}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    if (launches != {"flash_attention": cfg.num_layers}
            or by_body != {"simt": 0, "wgmma": cfg.num_layers, "wgmma_f32": 0}):
        fail(f"bf16 prefill: launches {launches}, by body {by_body}; expected {cfg.num_layers} of 'wgmma'")
    tok_s = b * prompt / secs
    print(f"  {cfg.num_layers} layers, {n_params:,} parameters ({n_params * 2 / 1e9:.2f} GB bf16); prefill [{b}x{prompt}] "
          f"{secs * 1e3:.1f} ms = {tok_s:.1f} tokens/s; launches {launches}, B4 by body {by_body}; "
          f"max_memory_allocated {peak / 1e9:.2f} GB; logits finite, max |logit| "
          f"{float(logits.float().abs().max()):.4g}")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        with record_function("serve.prefill"):
            prefill(params, batch)
            torch.cuda.synchronize()
    pre = device_share(prof, "serve.prefill", "flash_attention_wgmma")
    print(f"profile: bf16 prefill span {pre['span_ms']:.1f} ms, device busy {pre['busy_ms']:.1f} ms "
          f"(idle {100 * pre['idle']:.1f}%); cuBLAS products {pre['gemm_ms']:.1f} ms = "
          f"{100 * pre['gemm_ms'] / pre['busy_ms']:.1f}%; B4 wgmma {pre['kernel_ms']:.1f} ms = "
          f"{100 * pre['kernel_share']:.1f}% ({pre['kernel_ms'] / cfg.num_layers:.3f} ms a layer); the rest "
          f"{pre['busy_ms'] - pre['gemm_ms'] - pre['kernel_ms']:.1f} ms")
    metrics = dict(arch=cell["arch"], layers=cfg.num_layers, params=n_params, batch=b, prompt=prompt,
                   prefill_ms=secs * 1e3, prefill_tok_s=tok_s, max_memory_allocated=peak,
                   by_body=by_body, prefill_profile=pre)
    del params, logits, prof
    torch.cuda.empty_cache()
    return {"flash_attention_wgmma": by_body["wgmma"]}, metrics


def reduced_bf16_prefill(torch) -> None:
    """The reduced dense LM's bfloat16 prefill (head dim 16: B4's "wgmma"
    body) on the card against the same on the CPU (B4's plain version):
    logits within 2e-2 x max |logits|, the bf16 tolerance of the layer
    tests, since the two round each bf16 product and sum at other places."""
    from repro_torch.configs import RunConfig
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.launch import serve as launcher
    from repro_torch.models.transformer import init_params

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    run = RunConfig(param_dtype="bfloat16")
    cfg = launcher.model_config(BF16_PREFILL["arch"], reduced=True, device=cuda)
    params = init_params(cfg, seed=0, dtype=run.dtype(), device=cpu)
    prompt = launcher.make_prompt(cfg, 2, BF16_PREFILL["reduced_prompt"], cpu)
    prefill = launcher.build_prefill_step(cfg, run)
    ref = prefill(params, prompt).float()
    before = flash_attention.launches_by_body["wgmma"]
    gpu = prefill(params.to(cuda), {"tokens": prompt["tokens"].to(cuda)}).float().cpu()
    ran = flash_attention.launches_by_body["wgmma"] - before
    diff, scale = float((gpu - ref).abs().max()), float(ref.abs().max())
    if ran != cfg.num_layers or not diff <= 2e-2 * scale:
        fail(f"reduced bf16 prefill: card != CPU (wgmma launches {ran} of {cfg.num_layers}, max |diff| "
             f"{diff}, limit 2e-2 x {scale})")
    print(f"  reduced {BF16_PREFILL['arch']} (head dim {cfg.resolved_head_dim}, {cfg.num_layers} layers), "
          f"bf16 prefill, card ('wgmma' x {ran}) == CPU: max |diff| {diff:.4g} = {diff / scale:.3g} x max "
          f"|logits| {scale:.4g} (limit 2e-2)")


# ------------------------------------------------------------- training

def check_bwd_build(info: dict) -> None:
    """B4's backward as built: ptxas reports each of its kernels at each
    instantiation (its D pass, the "simt" dK/dV and dQ kernels at BT = 16,
    the "wgmma_f32" ones at each width bucket the library reports for d up
    to 128) without spills, serializes none of its wgmmas, and the
    library's SASS holds TF32 HGMMA instructions (where cuobjdump is there
    to say)."""
    from repro_torch.kernels.flash_attention.kernel import bwd_tiles

    widths = tuple(sorted({bwd_tiles(d)["width"] for d in range(8, 129, 8)}))
    kernels = {"flash_attention_bwd_delta": (None,), "flash_attention_bwd_dkdv": (16,),
               "flash_attention_bwd_dq": (16,), "flash_attention_bwd_dkdv_tf32": widths,
               "flash_attention_bwd_dq_tf32": widths}
    entries = [e for e in ptxas_entries(info["log"]) if "flash_attention_bwd" in e["name"]]
    seen = set()
    for e in entries:
        inst = re.search(r"\d(flash_attention_bwd_(?:delta|dkdv_tf32|dq_tf32|dkdv|dq))(?:ILi(\d+)E)?", e["name"])
        if inst is None:
            fail(f"ptxas reported an unknown kernel of B4's backward: {e['name']}")
        label = (inst.group(1), None if inst.group(2) is None else int(inst.group(2)))
        seen.add(label)
        print(f"  B4 backward {label[0]}{'' if label[1] is None else f'<{label[1]}>'}: {e['registers']} registers, "
              f"spill stores {e['spill_stores']} B, spill loads {e['spill_loads']} B")
        if e["spill_stores"] or e["spill_loads"] or e["registers"] is None:
            fail(f"B4's backward spills or went unreported: {e}")
    want = {(name, w) for name, ws in kernels.items() for w in ws}
    if seen != want or len(entries) != len(want):
        fail(f"ptxas reported B4's backward kernels {sorted(seen, key=str)} ({len(entries)} entries), expected "
             f"{sorted(want, key=str)}")
    serialized = [line for line in info["log"].splitlines() if "serialized" in line and "flash_attention_bwd" in line]
    if serialized:
        fail(f"ptxas serializes B4's backward's wgmmas: {serialized}")
    ops = sass_opcodes(info["path"])
    if ops is None:
        print("  B4 backward library: TF32 HGMMA not checked (no cuobjdump)")
        return
    hgmma = {op: n for op, n in ops.items() if op.startswith("HGMMA") and "TF32" in op.split(".")}
    if not hgmma:
        fail(f"B4's backward library holds no TF32 HGMMA instruction (HGMMA: "
             f"{[op for op in ops if op.startswith('HGMMA')]})")
    print(f"  B4 backward library: {sum(hgmma.values())} TF32 HGMMA instructions {hgmma}")


def bwd_issued_ops(b: int, s: int, t: int, h: int, d: int, causal: bool) -> int:
    """TF32 operations the "wgmma_f32" backward issues: over the tiles it
    walks (masked pairs of the diagonal tiles included; the tiling as the
    library reports it, ``bwd_tiles``), 3 products for each float32 one of
    S^T, dP^T, dV, dK (the dK/dV kernel) and S, dP, dQ (the dQ kernel),
    each 2·D a pair at the width bucket D."""
    from repro_torch.kernels.flash_attention.kernel import bwd_tiles

    tiles = bwd_tiles(d)
    width, kb, qt, qr, kt = (tiles[k] for k in ("width", "keys", "q_tile", "q_rows", "k_tile"))
    nq = -(-s // qt)
    kv_pairs = sum(kb * qt * (nq - (min(k0 // qt, nq) if causal else 0)) for k0 in range(0, t, kb))
    n_k = -(-t // kt)
    q_pairs = sum(qr * kt * (min(n_k, (q0 + qr - 1) // kt + 1) if causal else n_k) for q0 in range(0, s, qr))
    return 3 * 2 * width * b * h * (4 * kv_pairs + 3 * q_pairs)


def check_attention_bwd(torch, rows) -> None:
    """B4's backward (``flash_attention_bwd``, three launches a call, from
    the forward's output and lse2) against its plain version
    (``attention_bwd_ref``) on the card at ``BWD_SHAPES``: each of dQ, dK
    and dV within ``BWD_RTOL``·max |ref|, on the body ``select_bwd_body``,
    and a second call the same bits.  Timed beside the plain version and
    SDPA's backward kernels (the backward of ``scaled_dot_product_attention``
    on K/V repeated to H heads, its graph kept: never used by the port);
    the bound is the larger of the bytes of q, k, v, o, dO, lse in and dQ,
    dK, dV out, and the 10·d operations a live pair that are needed, at the
    rate of the body's arithmetic: 3 TF32 products each at the tensor
    cores' TF32 rate for "wgmma_f32" (as the forward's rows count it), the
    float32 rate for "simt".  Beside it: the float32-FMA bound, and what
    the body issues ("wgmma_f32": ``bwd_issued_ops`` TF32 operations, 3 ×
    14·d a live pair and the diagonal tiles' masked pairs; "simt": 14·d a
    live pair as float32 FMAs)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd, select_bwd_body
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    for b, s, t, h, kv, d, causal in BWD_SHAPES:
        label = (b, s, t, h, kv, d, causal)
        g = torch.Generator(device="cuda").manual_seed(b * s + t + h + d)
        q, do = (torch.randn((b, s, h, d), generator=g, device="cuda") for _ in range(2))
        k, v = (torch.randn((b, t, kv, d), generator=g, device="cuda") for _ in range(2))
        lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
        o = flash_attention(q, k, v, causal=causal, lse=lse)
        body = select_bwd_body(d)
        before = dict(flash_attention_bwd.launches_by_body)
        got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
        again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
        want = attention_bwd_ref(q, k, v, o, do, causal=causal)
        torch.cuda.synchronize()
        ran = {n: c - before[n] for n, c in flash_attention_bwd.launches_by_body.items() if c != before[n]}
        if ran != {body: 2}:
            fail(f"flash_attention_bwd at {label} ran bodies {ran}, expected {body}")
        rel = [float((x - y).abs().max()) / float(y.abs().max()) for x, y in zip(got, want)]
        err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        if not all(math.isfinite(r) and r <= BWD_RTOL for r in rel):
            fail(f"flash_attention_bwd != plain at {label}: max |diff| / max |ref| of "
                 f"dq, dk, dv {rel} (limit {BWD_RTOL})")
        if not all(bits_equal(x, y) for x, y in zip(got, again)):
            fail(f"flash_attention_bwd at {label}: two calls on the same inputs differ")
        del got, again, want
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kt, vt = (x.repeat_interleave(h // kv, dim=1) for x in (kt, vt))
        qt, kt, vt = (x.requires_grad_(True) for x in (qt, kt, vt))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()
        backend, names = sdpa_backend(lambda: sdpa_out.backward(dot, retain_graph=True))
        pairs = visible_pairs(s, t, causal) * b * h
        big = pairs * d > 1e10
        needed = 10 * d * pairs
        if body == "wgmma_f32":            # 3 TF32 products for each float32 one, as the forward's rows count
            ops, ops_per_s = 3 * needed, TF32_OPS_PER_S
            issued, issued_rate = bwd_issued_ops(b, s, t, h, d, causal), TF32_OPS_PER_S
        else:
            ops, ops_per_s = needed, F32_OPS_PER_S
            issued, issued_rate = 14 * d * pairs, F32_OPS_PER_S
        nbytes = 4 * 2 * (q.numel() + k.numel() + v.numel()) + 8 * q.numel() + 4 * lse.numel()
        row = timed_row(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=causal),
                        lambda: attention_bwd_ref(q, k, v, o, do, causal=causal),
                        library=lambda: sdpa_out.backward(dot, retain_graph=True),
                        n=3 if big else 10, inner=2 if big else 5, reps=3, ops_per_s=ops_per_s,
                        shape=[b, s, t, h, kv, d], causal=causal, bytes=nbytes, ops=ops, needed_ops=needed,
                        fma_bound_ms=max(nbytes / HBM_BYTES_PER_S, needed / F32_OPS_PER_S) * 1e3,
                        issued_ops=issued, issued_ms=issued / issued_rate * 1e3,
                        max_abs_err=err, rel_err=rel, sdpa_backend=backend, body=body)
        rows[("flash_attention_bwd", b, s, t, h, kv, d, causal)] = row
        kind = "TF32" if body == "wgmma_f32" else "float32 FMA"
        print(f"  flash_attention_bwd (B,S,T,H,KV,d)=({b},{s},{t},{h},{kv},{d}) {'causal' if causal else 'full'} "
              f"[{body}]: max |diff| / max |ref| dq {rel[0]:.3g}, dk {rel[1]:.3g}, dv {rel[2]:.3g} (limit {BWD_RTOL}); "
              f"two calls bit-equal; " + describe(row) + f"; float32-FMA bound {row['fma_bound_ms'] * 1e3:.1f} us; "
              f"{issued:.4g} {kind} operations issued ({issued / pairs / d:.1f}·d a live pair; "
              f"{row['issued_ms'] * 1e3:.1f} us at {issued_rate / 1e12:g} TFLOP/s, not a bound), "
              f"{issued / row['ms'] / 1e9:.1f} TFLOP/s issued; SDPA "
              f"backward {backend} ({', '.join(n[:50] for n in names[:3])})")
        del q, k, v, o, do, lse, qt, kt, vt, sdpa_out, dot
        torch.cuda.empty_cache()


def train_config(reduced_arch: str | None = None):
    """The train cell's config (``TRAIN``: full width, cut in depth) or a
    reduced arch's (``scale_down``'s) and their RunConfig."""
    import dataclasses

    from repro_torch.configs import ARCHS, RunConfig, scale_down

    if reduced_arch is not None:
        return scale_down(ARCHS[reduced_arch]), RunConfig(param_dtype="float32", remat=True, microbatches=2,
                                                          learning_rate=1e-2)
    cfg = dataclasses.replace(ARCHS[TRAIN["arch"]], num_layers=TRAIN["layers"])
    return cfg, RunConfig(param_dtype="float32", remat=False, microbatches=TRAIN["microbatches"],
                          learning_rate=TRAIN["lr"])


def train_path(torch) -> tuple[dict, dict]:
    """qwen2.5-32b at full width cut to ``TRAIN["layers"]`` layers, float32:
    ``TRAIN["steps"]`` AdamW steps of ``TRAIN["microbatches"]`` microbatches
    on one fixed batch (``DeterministicTokenPipeline.batch_at(0)``), the
    loss falling; B4's forward and backward launched once a layer and a
    microbatch, at the cell's shape; every leaf's gradient finite and the
    attention projections' nonzero; one step profiled (idle share, cuBLAS,
    B4's forward and backward); then ``TRAIN["steps_8bit"]`` steps with the
    8-bit moments.  Returns (launches of the steps, metrics)."""
    import statistics as st

    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.data.pipeline import DeterministicTokenPipeline, TrainBatchSpec
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import state_bytes
    from repro_torch.train.train_step import build_train_step, init_train_state, microbatch_grad

    cuda = torch.device("cuda")
    cfg, run = train_config()
    b, seq, k = TRAIN["batch"], TRAIN["seq"], TRAIN["microbatches"]
    tokens = b * seq
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, torch.float32, cuda)
    n_params = sum(p.numel() for p in params.parameters())
    gemm_flops = 6.0 * tokens * sum(p.numel() for p in params.parameters() if p.dim() == 2)
    state = init_train_state(params, run)
    batch = DeterministicTokenPipeline(TrainBatchSpec(b, seq, cfg.vocab), seed=0, device=cuda).batch_at(0)
    step = build_train_step(cfg, run)
    torch.cuda.synchronize()
    print(f"  {TRAIN['arch']} cut to {cfg.num_layers} of 64 layers: {n_params:,} parameters "
          f"({4 * n_params / 1e9:.2f} GB float32), moments {state_bytes(state.opt) / 1e9:.2f} GB; set-up "
          f"{time.perf_counter() - t0:.1f} s; {k} microbatches of {b // k} x {seq} tokens a step")
    reset_launches()
    losses, step_s = [], []
    for i in range(TRAIN["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        print(f"    step {i}: loss {losses[-1]:.4f}, grad norm {float(m['grad_norm']):.4f}, lr {m['lr']:.3g}; "
              f"{step_s[-1] * 1e3:.1f} ms")
    launches = read_launches()
    fwd_shapes = dict(flash_attention.launches_by_shape)
    bwd_shapes = dict(flash_attention_bwd.launches_by_shape)
    peak = torch.cuda.max_memory_allocated()
    shape = (b // k, seq, seq, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, "float32", True)
    want = {shape: cfg.num_layers * k * TRAIN["steps"]}
    if (fwd_shapes != want or bwd_shapes != want or flash_attention.launches_by_body["wgmma_f32"] != want[shape]
            or flash_attention_bwd.launches_by_body["wgmma_f32"] != want[shape]):
        fail(f"train: B4 forward launches {fwd_shapes} ({flash_attention.launches_by_body}), backward "
             f"{bwd_shapes} ({flash_attention_bwd.launches_by_body}); expected {want} each, on \"wgmma_f32\"")
    if any(v for name, v in launches.items() if name not in ("flash_attention", "flash_attention_bwd")):
        fail(f"train: launches {launches}: only B4 and its backward may run")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0] and min(losses[1:]) < losses[0]):
        fail(f"train: the loss did not fall over {TRAIN['steps']} steps: {losses}")
    bad = [n for n, p in state.params.named_parameters() if not bool(torch.isfinite(p).all())]
    if bad:
        fail(f"train: non-finite parameters {bad}")

    # every leaf's gradient on one microbatch: finite, the attention projections' nonzero
    mb = {key: x[: b // k] for key, x in batch.items()}
    _, grads = microbatch_grad(state.params, mb, cfg, run, moe_groups=1)
    bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())]
    zero = [n for n, g in grads.items() if n.split(".")[-1] in ("wq", "wk", "wv", "bq", "bk", "bv")
            and not float(g.abs().max()) > 0]
    n_attn = sum(n.split(".")[-1] in ("wq", "wk", "wv", "bq", "bk", "bv") for n in grads)
    if bad or zero or n_attn != 6 * cfg.num_layers:
        fail(f"train: gradients non-finite {bad}, attention projections zero {zero} ({n_attn} of them)")
    print(f"  gradients: {len(grads)} leaves finite; the {n_attn} attention projections' (wq, wk, wv, bq, bk, bv) "
          f"nonzero, max |g| {min(float(grads[n].abs().max()) for n in grads if n.split('.')[-1] in ('wq', 'bq')):.3g}"
          f" (least of wq, bq)")
    del grads

    for attempt in range(3):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with prof:
            time.sleep(CAPTURE_PAD_S)
            with record_function("train.step"):
                state, m = step(state, batch)
                torch.cuda.synchronize()
            time.sleep(CAPTURE_PAD_S)
        bwd = device_share(prof, "train.step", "flash_attention_bwd")
        both = device_share(prof, "train.step", "flash_attention")
        if bwd["busy_ms"] > 0:
            break
        print(f"  profile {attempt + 1} kept no device activity: taken again")
    else:
        fail("train: three profiles kept no device activity")
    fwd_ms = both["kernel_ms"] - bwd["kernel_ms"]
    step_ms = st.median(step_s[1:]) * 1e3
    print(f"  {TRAIN['steps']} steps: losses {[round(x, 4) for x in losses]}; a step {step_ms:.1f} ms (median of "
          f"steps 1..{TRAIN['steps'] - 1}; step 0 {step_s[0] * 1e3:.1f}) = {tokens / step_ms * 1e3:.1f} tokens/s; "
          f"peak {peak / 1e9:.2f} GB; B4 forward and backward {want[shape] // TRAIN['steps']} a step each at {shape}")
    print(f"profile: a train step span {bwd['span_ms']:.1f} ms, device busy {bwd['busy_ms']:.1f} ms (idle "
          f"{100 * bwd['idle']:.1f}%); cuBLAS products {bwd['gemm_ms']:.1f} ms = "
          f"{100 * bwd['gemm_ms'] / bwd['busy_ms']:.1f}% ({gemm_flops:.4g} flops, "
          f"{gemm_flops / bwd['gemm_ms'] / 1e9:.1f} TFLOP/s); B4's backward {bwd['kernel_ms']:.1f} ms = "
          f"{100 * bwd['kernel_share']:.1f}%, its forward {fwd_ms:.1f} ms = {100 * fwd_ms / bwd['busy_ms']:.1f}%; "
          f"the rest {bwd['busy_ms'] - bwd['gemm_ms'] - bwd['kernel_ms'] - fwd_ms:.1f} ms")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=10))
    del state, params, prof, m
    torch.cuda.empty_cache()

    # the 8-bit moments: fresh weights, TRAIN["steps_8bit"] steps
    import dataclasses

    run8 = dataclasses.replace(run, adam_8bit=True)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(init_params(cfg, 0, torch.float32, cuda), run8)
    step8 = build_train_step(cfg, run8)
    losses8, s8 = [], []
    for _ in range(TRAIN["steps_8bit"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step8(state, batch)
        losses8.append(float(m["loss"]))
        torch.cuda.synchronize()
        s8.append(time.perf_counter() - t0)
    peak8, bytes8 = torch.cuda.max_memory_allocated(), state_bytes(state.opt)
    if not (all(math.isfinite(x) for x in losses8) and losses8[-1] < losses8[0]):
        fail(f"train 8-bit: the loss did not fall: {losses8}")
    if not abs(losses8[0] - losses[0]) <= 1e-5 * abs(losses[0]):
        fail(f"train 8-bit: step 0's loss {losses8[0]} != the float32 run's {losses[0]} (same weights and batch)")
    print(f"  8-bit moments: losses {[round(x, 4) for x in losses8]}, steps {[round(x * 1e3, 1) for x in s8]} ms, "
          f"moments {bytes8 / 1e9:.2f} GB, peak {peak8 / 1e9:.2f} GB")
    del state
    torch.cuda.empty_cache()
    metrics = dict(arch=TRAIN["arch"], layers=cfg.num_layers, params=n_params, batch=b, seq=seq, microbatches=k,
                   losses=losses, step_ms=step_ms, first_step_ms=step_s[0] * 1e3, tokens_per_s=tokens / step_ms * 1e3,
                   max_memory_allocated=peak, profile=bwd, b4_fwd_ms=fwd_ms, gemm_flops=gemm_flops,
                   b4_launches_a_step=want[shape] // TRAIN["steps"], losses_8bit=losses8,
                   step_ms_8bit=[x * 1e3 for x in s8], moments_bytes_8bit=bytes8, max_memory_allocated_8bit=peak8)
    return launches, metrics


def reduced_train(torch) -> dict:
    """The reduced dense, moe, vlm and audio models (``TRAIN_REDUCED``) on
    the card against the same on the CPU (weights made on the CPU and
    copied): a microbatch's gradients, each leaf within 1e-4·max |cpu| +
    1e-6, and 2 steps of 2 microbatches with remat, the losses within 1e-4
    relative (not the parameters: Adam's first steps move a weight whose
    gradient is rounding noise by ±lr, its sign the noise's); the
    ssm and hybrid families raise NotImplementedError on the card (B6 has
    no backward there yet, ROADMAP A13.6b)."""
    import copy

    from repro_torch.models.transformer import init_params
    from repro_torch.train.train_step import build_train_step, init_train_state, microbatch_grad

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    out = {}
    for arch in TRAIN_REDUCED:
        cfg, run = train_config(arch)
        g = torch.Generator().manual_seed(5)
        n = 32 - (cfg.num_patches if cfg.family == "vlm" else 0)
        batch = {"tokens": torch.randint(0, cfg.vocab, (4, n), generator=g),
                 "labels": torch.randint(0, cfg.vocab, (4, n), generator=g)}
        if cfg.family == "vlm":
            batch["patches"] = torch.randn((4, cfg.num_patches, cfg.patch_dim), generator=g)
        if cfg.encoder_layers:
            batch["frames"] = torch.randn((4, 16, cfg.d_model), generator=g)
        weights = init_params(cfg, 0, torch.float32, cpu)
        res = {}
        for dev in (cuda, cpu):
            on_dev = {key: x.to(dev) for key, x in batch.items()}
            _, grads = microbatch_grad(copy.deepcopy(weights).to(dev), {key: x[:2] for key, x in on_dev.items()},
                                       cfg, run, moe_groups=1)
            state = init_train_state(copy.deepcopy(weights).to(dev), run)
            step = build_train_step(cfg, run)
            losses = []
            for _ in range(2):
                state, m = step(state, on_dev)
                losses.append(float(m["loss"]))
            res[dev.type] = (losses, {n_: g_.cpu() for n_, g_ in grads.items()})
        rel = max(abs(a - b_) / abs(b_) for a, b_ in zip(res["cuda"][0], res["cpu"][0]))
        worst = max(float((res["cuda"][1][n_] - g_).abs().max()) / (1e-4 * float(g_.abs().max()) + 1e-6)
                    for n_, g_ in res["cpu"][1].items())
        if not (rel <= 1e-4 and worst <= 1.0):
            fail(f"reduced train {arch}: card != CPU: losses {res['cuda'][0]} vs {res['cpu'][0]}, largest gradient "
                 f"|diff| / limit {worst}")
        out[arch] = dict(losses_card=res["cuda"][0], losses_cpu=res["cpu"][0], loss_rel=rel, grad_diff_over_limit=worst)
        print(f"  reduced {arch} ({cfg.family}): the gradients of a microbatch card == CPU (largest |diff| / "
              f"(1e-4·max |g| + 1e-6) {worst:.3g}); 2 steps of 2 microbatches with remat: losses "
              f"{[round(x, 5) for x in res['cuda'][0]]} (rel {rel:.2g})")
    for arch in TRAIN_RAISES:
        cfg, run = train_config(arch)
        params = init_params(cfg, 0, torch.float32, cuda)
        tokens = torch.zeros((1, 64), dtype=torch.int64, device=cuda)
        try:
            microbatch_grad(params, {"tokens": tokens, "labels": tokens}, cfg, run, moe_groups=1)
        except NotImplementedError as exc:
            print(f"  reduced {arch} ({cfg.family}) on the card raises NotImplementedError: {exc}")
        else:
            fail(f"reduced train {arch}: a gradient through B6 on the card did not raise")
    return out


def launcher_path(torch) -> dict:
    """``repro_torch.launch.train`` on the card (its default device), the
    reduced config: ``LAUNCH_ARGV`` uninterrupted, then the same stopped
    after step 6 (its checkpoint: step 5) and run again over that
    directory: it resumes at step 6, and its loss lines equal the
    uninterrupted run's."""
    import contextlib as cl
    import io

    from repro_torch.launch import train as launcher

    root = ROOT / "build" / "train_launcher"
    shutil.rmtree(root, ignore_errors=True)

    def run(argv, name):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with cl.redirect_stdout(buf):
            launcher.main([*argv, "--ckpt-dir", str(root / name)])
        return buf.getvalue(), time.perf_counter() - t0

    line = re.compile(r"step\s+(\d+) loss=([0-9.]+)")
    full, full_s = run(LAUNCH_ARGV, "full")
    cut = list(LAUNCH_ARGV)
    cut[cut.index("--steps") + 1] = "7"
    run(cut, "resumed")
    resumed, resumed_s = run(LAUNCH_ARGV, "resumed")
    want = {int(m.group(1)): m.group(2) for m in line.finditer(full)}
    got = {int(m.group(1)): m.group(2) for m in line.finditer(resumed)}
    ckpts = sorted(os.listdir(root / "full"))
    shutil.rmtree(root, ignore_errors=True)
    if "resumed from step 6" not in resumed or got != {s: x for s, x in want.items() if s >= 6} or not want:
        fail(f"train launcher: the resumed run's lines {got} != the uninterrupted run's {want}:\n{resumed}")
    if ckpts != ["step_10", "step_5"]:
        fail(f"train launcher: checkpoints {ckpts}, expected step_5 and step_10")
    print(f"  launcher {' '.join(LAUNCH_ARGV)} on the card: {full.strip().splitlines()[-1]} ({full_s:.1f} s); "
          f"checkpoints {ckpts}; resumed from step 6 of a run stopped at 7: lines {got} == the uninterrupted run's "
          f"({resumed_s:.1f} s)")
    return dict(losses={s: float(x) for s, x in want.items()}, seconds=full_s)


def main() -> int:
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch

    if sys.argv[1:2] == ["--mesh-cpu"]:
        return mesh_cpu_cell(sys.argv[2])
    if sys.argv[1:2] == ["--multi-cpu"]:
        return multi_cpu_cell(sys.argv[2])
    if sys.argv[1:2] == ["--scan-cpu"]:
        return scan_cpu_cells()

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: FAIL: no repro_torch package under {SRC}", file=sys.stderr)
        return 2
    from repro_torch.configs import ARCHS
    from repro_torch.configs.exsample_paper import bdd, dashcam
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device: {kind}; nvidia-smi: {smi}")
    if sys.argv[1:2] == ["--loop-c16"]:
        phase(f"ROADMAP C16: jamba's serve cell, {sys.argv[2]} repetitions of prefill, decode and teacher forcing:")
        build.build(("ssd_scan",))
        return 1 if c16_loop(torch, int(sys.argv[2])) else 0

    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} kernels in parallel")
    for name, info in built.items():
        print(f"  {name}: {info['seconds']:.1f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "warning" in line.lower():
                print(f"    {line.strip()}")
    check_b1_build(built["thompson_choose"])
    check_b3_build(built["iou_matrix"])
    check_b4_build(built["flash_attention"])
    check_b5_build(built["flash_decode"])
    check_b6_build(built["ssd_scan"])
    check_bwd_build(built["flash_attention_bwd"])

    phase("kernels vs plain versions on the card:")
    rows = check_kernels(torch)
    phase("attention kernels vs plain versions on the card, beside SDPA:")
    check_attention_kernels(torch, rows)
    phase("B4's backward vs its plain version on the card, beside SDPA's backward:")
    check_attention_bwd(torch, rows)
    phase("SSD chunk scan (B6) vs its plain version on the card:")
    check_ssd_kernel(torch, rows)

    # warm the card's lazily loaded PyTorch kernels outside the timed runs
    run_search(torch, dashcam(scale=1.0), dict(MAIN_PLAN, max_steps=100), torch.device("cuda"))
    phase("main path: scan search, full size, card vs CPU:")
    scan_launches, scan_metrics = {}, {}
    for name, setup in (("dashcam(scale=1.0)", dashcam(scale=1.0)), ("bdd(scale=1.0)", bdd(scale=1.0))):
        launches, scan_metrics[name] = main_path(torch, name, setup)
        for k, v in launches.items():
            scan_launches[k] = scan_launches.get(k, 0) + v

    phase("rounds a read of the exit test (K), the bdd scan on the card:")
    rounds_per_sync_sweep(torch, "bdd(scale=1.0)", bdd(scale=1.0))

    host, host_s, _ = run_search(torch, dashcam(scale=1.0), HOST_CHECK_PLAN, torch.device("cuda"), "host")
    scan, scan_s, _ = run_search(torch, dashcam(scale=1.0), HOST_CHECK_PLAN, torch.device("cuda"), "scan")
    diffs = [d for d in same_search(host, scan) if d != "stats"]
    if diffs or host.stats.frames_sampled != scan.stats.frames_sampled:
        fail(f"host kind != scan kind on the card: {diffs}")
    print(f"  host == scan on the card ({host.steps[0]} frames, {host.results[0]} results; "
          f"host {host_s:.2f} s, scan {scan_s:.2f} s)")

    profile_plan = dict(MAIN_PLAN, max_steps=500)
    profile_path(torch, "bdd scan", lambda around: run_search(
        torch, bdd(scale=1.0), profile_plan, torch.device("cuda"), around=around)[:2], MAIN_PLAN["cohorts"])

    phase("multi path: Q-axis multi-query search, full width, card vs CPU:")
    multi_launches, multi_metrics, multi_ref = multi_path(torch, "bdd(scale=1.0) multi", bdd(scale=1.0))
    per_query_contract(torch, "dashcam(scale=1.0) multi", dashcam(scale=1.0))
    multi_profile = dict(MULTI_PLAN, max_steps=500)
    oracle_multi_profile = profile_path(torch, "bdd multi Q=8", lambda around: run_multi(
        torch, bdd(scale=1.0), multi_profile, torch.device("cuda"), around=around)[:2],
        MULTI_PLAN["cohorts"])
    phase("cosine matcher path: dashcam scan and multi with feat_thresh set, card vs CPU:")
    cosine_launches = cosine_path(torch, "dashcam(scale=1.0)", dashcam(scale=1.0))

    phase("noisy detector: the bdd scan and multi paths, its draws inside the captured round, card vs CPU:")
    noisy_scan_launches, noisy_scan = main_path(torch, "bdd(scale=1.0) noisy", bdd(scale=1.0), detector="noisy")
    # one replay each: a replayed noisy round is ~10^5 device activities, too many to parse for every replay
    replays = {det: one_replay_profile(torch, lambda det=det: run_search(
        torch, bdd(scale=1.0), profile_plan, torch.device("cuda"), detector=det)) for det in ("noisy", "oracle")}
    noisy_vs_oracle("bdd scan", dict(noisy_scan, **replays["noisy"]), dict(scan_metrics["bdd(scale=1.0)"], **replays["oracle"]),
                    ("frames", "results", "frames_per_s", "capture_ms", "activities_a_round", "replay_ms", "replay_idle"))
    noisy_multi_launches, noisy_multi, _ = multi_path(torch, "bdd(scale=1.0) noisy multi", bdd(scale=1.0),
                                                      detector="noisy")
    noisy_multi_profile = profile_path(torch, "bdd noisy multi Q=8", lambda around: run_multi(
        torch, bdd(scale=1.0), multi_profile, torch.device("cuda"), around=around, detector="noisy")[:2],
        MULTI_PLAN["cohorts"], warm=False)
    noisy_vs_oracle("bdd multi", dict(noisy_multi, **noisy_multi_profile), dict(multi_metrics, **oracle_multi_profile),
                    ("frames", "results", "frames_per_s", "amortization", "invocations", "cache_hits", "capture_ms",
                     "activities_a_round", "idle"))
    phase(f"baselines: random+ and greedy, bdd(scale=1.0), class 0, limit {BASELINE_LIMIT}, "
          f"{BASELINE_STEPS} frames, card vs CPU:")
    baseline_launches = baselines_path(torch, "bdd(scale=1.0)", bdd(scale=1.0),
                                       scan_metrics["bdd(scale=1.0)"]["frames"])
    phase("bench multiquery: the full workload on the card against the pinned CPU counts:")
    multiquery_bench_path(torch)

    phase("repository index on the bdd(1.0) multi path: the cold run == no index, the warm run 0 detector "
          "calls from one captured graph; a warm-started scan, card vs CPU:")
    index_metrics = index_path(torch, "bdd(scale=1.0) multi", bdd(scale=1.0), multi_ref)
    phase(f"async_multi, bdd(scale=1.0), Q = {len(MULTI_CLASSES)}, W = {ASYNC_WORKERS}, method pallas: each "
          "query == the card's multi run:")
    async_multi_launches, async_multi_metrics = async_multi_path(torch, "bdd(scale=1.0) async_multi",
                                                                 bdd(scale=1.0), multi_ref, multi_metrics)
    del multi_ref
    phase(f"async, bdd(scale=1.0), class 0, W = {ASYNC_WORKERS}: the merge invariants; a synchronous drive, "
          "card vs CPU:")
    async_launches, async_metrics = async_path(torch, "bdd(scale=1.0) async", bdd(scale=1.0))
    phase("bench async_compose --quick on the card (gate 2x):")
    async_compose_bench_path(torch)
    phase(f"mesh, bdd(scale=1.0) on {MESH_SHARDS} shards of the card, {MESH_COHORTS} cohorts: the sharded kind at "
          f"sync_every 1 and 4, the composed kind (Q = {len(MULTI_CLASSES)}, cache -1), each card == CPU; bench "
          "plan_compose full against the pinned counts; the elastic CLI killing worker 7 of 8, replayed:")
    mesh_launches, mesh_metrics = mesh_path(torch)
    phase(f"service, bdd(scale=1.0): {len(MULTI_CLASSES)} tenants in two waves of {SERVICE_WAVE} on one live driver, "
          f"W = {ASYNC_WORKERS}, method exact; then the HTTP front:")
    service_launches, service_metrics = service_path(torch, "bdd(scale=1.0) service", bdd(scale=1.0))
    service_http_path(torch)

    serve_launches, serve_metrics = {}, {}
    for family, cell in SERVE_CELLS.items():
        depth = ("full depth" if not cell.get("layers") else
                 f"num_layers cut {ARCHS[cell['arch']].num_layers} -> {cell['layers']} (the whole model does "
                 f"not fit one card)")
        phase(f"serve path ({family}): {cell['arch']}, full width, {depth}, float32, batch {cell['batch']}, "
              f"prompt {cell['prompt']}, {cell['tokens']} greedy tokens; reduced check at "
              f"{cell.get('reduced_layers') or 2} layers:")
        serve_launches[family], serve_metrics[family] = serve_path(torch, family)
        reduced_serve(torch, family)
    phase(f"detector step: {DETECT['arch']} at full width and depth, one cohort of {DETECT['frames']} bdd(1.0) "
          f"frames of {ARCHS[DETECT['arch']].num_patches} patches + {DETECT['tokens']} tokens; reduced card vs CPU:")
    detect_launches, detect_metrics = detect_path(torch)
    phase(f"bf16 prefill path: {BF16_PREFILL['arch']}, full width and depth, bfloat16, batch {BF16_PREFILL['batch']}, prompt {BF16_PREFILL['prompt']}:")
    bf16_launches, bf16_metrics = bf16_prefill_path(torch)
    reduced_bf16_prefill(torch)
    phase(f"train path: {TRAIN['arch']} at full width, {TRAIN['layers']} of 64 layers, float32, {TRAIN['steps']} "
          f"AdamW steps of {TRAIN['microbatches']} microbatches x {TRAIN['seq']} tokens on a fixed batch, lr "
          f"{TRAIN['lr']}; then {TRAIN['steps_8bit']} steps with the 8-bit moments:")
    train_launches, train_metrics = train_path(torch)
    phase("reduced training, card vs CPU (dense, moe, vlm, audio); ssm and hybrid raise on the card:")
    train_metrics["reduced"] = reduced_train(torch)
    phase("the train launcher on the card (reduced config), with a checkpoint and a resume:")
    train_metrics["launcher"] = launcher_path(torch)

    summary = []
    b4_src, b4_tpu = "src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:91"
    b5_src, b5_tpu = "src/repro_torch/csrc/flash_decode.cu", "src/repro/kernels/flash_decode/kernel.py:71"
    for kname, key, src, replaces, launches in (
        ("thompson_round", ("thompson_round", 50, 1000, "sampler"), "src/repro_torch/csrc/thompson_choose.cu",
         "src/repro/kernels/thompson/kernel.py:73", scan_launches["thompson_round"]),
        ("thompson_round_batched", ("thompson_round_batched", 8, 50, 1000, "sampler"),
         "src/repro_torch/csrc/thompson_choose.cu", "src/repro/kernels/thompson/kernel.py:114",
         multi_launches["thompson_round_batched"]),
        ("thompson_choose", ("thompson_choose", 50, 1000), "src/repro_torch/csrc/thompson_choose.cu",
         "src/repro/kernels/thompson/kernel.py:73", scan_launches["thompson_choose"]),
        ("thompson_choose_batched", ("thompson_choose_batched", 8, 50, 1000),
         "src/repro_torch/csrc/thompson_choose.cu", "src/repro/kernels/thompson/kernel.py:114",
         multi_launches["thompson_choose_batched"]),
        ("match_update", ("match_update", 16, 8192), "src/repro_torch/csrc/iou_matrix.cu",
         "src/repro/kernels/iou_match/kernel.py:37", scan_launches["match_update"]),
        ("match_update_batched", ("match_update_batched", 8, 16, 8192), "src/repro_torch/csrc/iou_matrix.cu",
         "src/repro/kernels/iou_match/kernel.py:37", multi_launches["match_update_batched"]),
        ("iou_matrix", ("iou_matrix", 16, 8192), "src/repro_torch/csrc/iou_matrix.cu",
         "src/repro/kernels/iou_match/kernel.py:37", cosine_launches["scan"]["iou_matrix"]),
        ("iou_matrix_batched", ("iou_matrix_batched", 8, 16, 8192), "src/repro_torch/csrc/iou_matrix.cu",
         "src/repro/kernels/iou_match/kernel.py:37", cosine_launches["multi"]["iou_matrix_batched"]),
        ("flash_attention", ("flash_attention", *B4_SERVE), b4_src, b4_tpu,
         serve_launches["dense"]["flash_attention"]),
        ("flash_attention_d256", ("flash_attention", *B4_GEMMA), b4_src, b4_tpu,
         serve_launches["gemma"]["flash_attention"]),
        ("flash_attention_wgmma", ("flash_attention", *B4_BF16), b4_src, b4_tpu,
         bf16_launches["flash_attention_wgmma"]),
        ("flash_decode", ("flash_decode", *B5_SERVE), b5_src, b5_tpu,
         serve_launches["dense"]["flash_decode"]),
        ("flash_decode_d256", ("flash_decode", *B5_GEMMA), b5_src, b5_tpu,
         serve_launches["gemma"]["flash_decode"]),
        ("ssd_scan", ("ssd_scan", *B6_SHAPES[0]),
         "src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan/kernel.py:77",
         serve_launches["ssm"]["ssd_scan"]),
        ("flash_attention_d64", ("flash_attention", *B4_MOE), b4_src, b4_tpu,
         serve_launches["moe"]["flash_attention"]),
        ("flash_decode_d64", ("flash_decode", *B5_MOE), b5_src, b5_tpu,
         serve_launches["moe"]["flash_decode"]),
        ("ssd_scan_hybrid", ("ssd_scan", *B6_HYBRID),
         "src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan/kernel.py:77",
         serve_launches["hybrid"]["ssd_scan"]),
        ("flash_attention_vlm", ("flash_attention", *B4_VLM), b4_src, b4_tpu,
         serve_launches["vlm"]["flash_attention"]),
        ("flash_attention_detect", ("flash_attention", *B4_DETECT), b4_src, b4_tpu,
         detect_launches["flash_attention"]),
        # whisper's prefill: the encoder, the decoder's self-attention and the cross-attention, each
        # row with the launches of its own shape
        ("flash_attention_full_d64", ("flash_attention", *B4_AUDIO), b4_src, b4_tpu,
         shape_launches(serve_metrics["audio"], "flash_attention", B4_AUDIO)),
        ("flash_attention_audio_self", ("flash_attention", *B4_AUDIO_SELF), b4_src, b4_tpu,
         shape_launches(serve_metrics["audio"], "flash_attention", B4_AUDIO_SELF)),
        ("flash_attention_cross", ("flash_attention", *B4_CROSS), b4_src, b4_tpu,
         shape_launches(serve_metrics["audio"], "flash_attention", B4_CROSS)),
        ("flash_decode_vlm", ("flash_decode", *B5_VLM), b5_src, b5_tpu,
         serve_launches["vlm"]["flash_decode"]),
        # whisper's decode: over the self caches and over the cross caches
        ("flash_decode_audio_self", ("flash_decode", *B5_AUDIO_SELF), b5_src, b5_tpu,
         shape_launches(serve_metrics["audio"], "flash_decode", B5_AUDIO_SELF)),
        ("flash_decode_cross", ("flash_decode", *B5_CROSS), b5_src, b5_tpu,
         shape_launches(serve_metrics["audio"], "flash_decode", B5_CROSS)),
        # B4's backward replaces no TPU kernel: it computes what jax.grad of the reference's
        # plain-jnp blocked_attention gives its train step
        ("flash_attention_bwd", ("flash_attention_bwd", *BWD_TRAIN), "src/repro_torch/csrc/flash_attention_bwd.cu",
         "src/repro/models/attention.py:76", train_launches["flash_attention_bwd"]),
    ):
        row = rows[key]
        summary.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=launches, max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"], shape=row["shape"],
            call_ms=row["call_ms"], plain_call_ms=row["plain_call_ms"],
        ))
        summary[-1].update({k: row[k] for k in ("body", "dtype", "needed_ops", "fma_bound_ms", "splits",
                                                 "kernels_a_call", "old_ms", "old_call_ms", "state",
                                                 "library_gqa_ms", "library_repeat_ms",
                                                 "sdpa_backend", "sdpa_repeat_backend", "issued_ops",
                                                 "rel_err") if k in row})
    phase("done; the summary lines follow")
    print(f"kernels_a_call: {CAPTURES['captures']} profiler captures, the fewest leading fills one kept "
          f"{CAPTURES['fewest_fills_kept']} of {SPARES}, {CAPTURES['retakes']} retakes")
    print(json.dumps({"index": {k: v for k, v in index_metrics.items() if k != "launches"},
                      "async_multi": async_multi_metrics, "async": async_metrics, "service": service_metrics,
                      "mesh": mesh_metrics}))
    print(json.dumps({"serve": serve_metrics["dense"], "serve_gemma": serve_metrics["gemma"],
                      "serve_ssm": serve_metrics["ssm"], "serve_moe": serve_metrics["moe"],
                      "serve_hybrid": serve_metrics["hybrid"], "serve_vlm": serve_metrics["vlm"],
                      "serve_audio": serve_metrics["audio"], "detect": detect_metrics, "prefill_bf16": bf16_metrics,
                      "train": train_metrics}))
    print(json.dumps({"launches": {"scan": scan_launches, "multi": multi_launches,
                                   "cosine_scan": cosine_launches["scan"],
                                   "cosine_multi": cosine_launches["multi"],
                                   "noisy_scan": noisy_scan_launches, "noisy_multi": noisy_multi_launches,
                                   "randomplus": baseline_launches["randomplus"],
                                   "greedy": baseline_launches["greedy"],
                                   "index_warm_multi": index_metrics["launches"],
                                   "async_multi": async_multi_launches, "async": async_launches,
                                   "service": service_launches,
                                   "sharded": mesh_launches["sharded1"], "sharded_sync4": mesh_launches["sharded4"],
                                   "multi_sharded": mesh_launches["multi_sharded"],
                                   "plan_compose": mesh_launches["plan_compose"],
                                   "elastic": mesh_launches["elastic"],
                                   "serve": serve_launches["dense"], "serve_gemma": serve_launches["gemma"],
                                   "serve_ssm": serve_launches["ssm"], "serve_moe": serve_launches["moe"],
                                   "serve_hybrid": serve_launches["hybrid"], "serve_vlm": serve_launches["vlm"],
                                   "serve_audio": serve_launches["audio"], "detect": detect_launches,
                                   "prefill_bf16": bf16_launches, "train": train_launches}}))
    print(f"{smi}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
