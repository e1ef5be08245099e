"""The mesh's collectives, its sharded Thompson choice, and the merge of
per-worker deltas (paper §3.7.1).

Counterpart of ``repro.core.distributed``.  The reference runs its mesh
single-controller: one process, ``shard_map`` over S devices.  The port
keeps that design without ``shard_map``: the S shards of a
:class:`~repro_torch.launch.mesh.DataMesh` are slots in one process's
lists, each with its own device, and a collective is a plain function
over the per-shard list, its result placed on each shard's device
(``all_gather``, ``psum``, ``all_to_all``).  A driver runs its shards one
after another; within a round a shard reads only its own state and the
replicated values, and every cross-shard read is a collective after all S
shards have run, so the order changes nothing.

The sharded Thompson choice: each shard draws Wilson–Hilferty scores for
its M/S chunks under ``fold_in(key, shard_id)`` (all S keys from one
``split``) and keeps its per-cohort
winner (``shard_winners``: the fused round, kernel B1 or B2, on the card;
its plain version on the CPU); the winners are gathered and the global
argmax taken (``local_cohort_winners{,_batched}``).  The kernel marks an
exhausted chunk −1e30 and a row with no live chunk −1 (ROADMAP C2); the
reference's shard body marks −inf and reads a dead row's local winner as
0.  ``shard_winners`` maps the kernel's marks back before the gather, so
a dead cohort reads as dead and picks chunk ``shard_id · M/S``, as the
reference's does.  ``shard_winners_ref`` is the reference's shard body
itself, the plain version the kernel path is held to.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng
from repro_torch.core.state import SamplerState


# ---------------------------------------------------------------------------
# Collectives over per-shard lists
# ---------------------------------------------------------------------------


def replicate(x: torch.Tensor, mesh) -> list[torch.Tensor]:
    """``x`` on every shard's device (one copy a device; shards that share
    a device share the tensor, which no caller writes in place)."""
    copies: dict = {}
    return [copies.setdefault(d, x.to(d)) for d in mesh.devices]


def all_gather(xs: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """``jax.lax.all_gather``: every shard's value stacked on a new leading
    ``[S]`` axis, on each shard's device."""
    return replicate(torch.stack([x.to(mesh.device) for x in xs]), mesh)


def psum(xs: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """``jax.lax.psum``: the sum over shards, in shard order, on each
    shard's device.  The drivers sum counts, exact in any order."""
    acc = xs[0].to(mesh.device)
    for x in xs[1:]:
        acc = acc + x.to(mesh.device)
    return replicate(acc, mesh)


def all_to_all(xs: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """``jax.lax.all_to_all(x, axis, 0, 0)``: ``xs[s]`` has a leading
    ``[S]`` axis whose row h goes to shard h; shard s receives
    ``[xs[0][s], …, xs[S-1][s]]`` stacked in source order."""
    return [torch.stack([x[s].to(d) for x in xs]) for s, d in enumerate(mesh.devices)]


# ---------------------------------------------------------------------------
# Sharded statistics
# ---------------------------------------------------------------------------


def pad_chunks(state: SamplerState, multiple: int) -> SamplerState:
    """Pad the chunk axis (the last: ``[M]`` or ``[Q, M]``) to a multiple
    of ``multiple`` with exhausted dummy chunks: n1 = 0, n = 1, frames = 0,
    so ``n ≥ frames`` and they are never chosen."""
    m = state.n1.shape[-1]
    pad = (-m) % multiple
    if pad == 0:
        return state

    def f(x: torch.Tensor, fill) -> torch.Tensor:
        return torch.cat([x, torch.full(x.shape[:-1] + (pad,), fill, dtype=x.dtype, device=x.device)], dim=-1)

    return dataclasses.replace(state, n1=f(state.n1, 0), n=f(state.n, 1), frames=f(state.frames, 0))


def shard_sampler_state(state: SamplerState, mesh) -> list[SamplerState]:
    """Shard s's slice ``[s·M/S, (s+1)·M/S)`` of the chunk axis, on its
    device (M must divide by S: ``pad_chunks`` first)."""
    m, s_n = state.n1.shape[-1], mesh.size
    if m % s_n:
        raise ValueError(f"{m} chunks do not divide over {s_n} shards: call pad_chunks() first")
    lm = m // s_n
    return [dataclasses.replace(state, **{f: getattr(state, f)[..., s * lm:(s + 1) * lm].contiguous().to(d)
                                          for f in ("n1", "n", "frames")})
            for s, d in enumerate(mesh.devices)]


# ---------------------------------------------------------------------------
# The sharded Thompson choice
# ---------------------------------------------------------------------------


def shard_keys(key: torch.Tensor, num_shards: int) -> torch.Tensor:
    """``fold_in(key, s)`` for every shard s, as ``key[..., S, 2]``: one
    ``split``, which is ``fold_in`` over the counters 0..S-1."""
    return prng.split(key, num_shards)


def shard_winners(key: torch.Tensor, view: SamplerState, shard_id: int, cohorts: int):
    """Shard ``shard_id``'s half of the choice: the fused round (one launch
    of B1 for a key int64[2] and ``[M/S]`` statistics, of B2 for keys
    int64[Q, 2] and ``[Q, M/S]``) under ``key``, the shard's
    ``fold_in(key, shard_id)`` (:func:`shard_keys`), its marks mapped back
    to the reference's.  Returns (global chunk id i32[..., C], score
    f32[..., C], −inf where no local chunk is live, the winner's sample
    count f32[..., C])."""
    from repro_torch.kernels.thompson.ops import choose_round, choose_round_batched

    choose = choose_round_batched if key.dim() == 2 else choose_round
    idx, val = choose(key, view, cohorts)
    dead = idx < 0
    local_best = torch.where(dead, torch.zeros_like(idx), idx)
    score = torch.where(dead, torch.full_like(val, -torch.inf), val)
    return _shard_triple(view, shard_id, local_best, score)


def shard_winners_ref(key: torch.Tensor, view: SamplerState, shard_id: int, cohorts: int):
    """The reference's shard body, op by op: Wilson–Hilferty scores on
    ``prng.normal(key, (C, M/S))`` (``key`` the shard's folded key), −inf
    where exhausted, the first argmax.  The plain version of
    :func:`shard_winners`."""
    from repro_torch.core.thompson import draw_scores_wilson_hilferty

    scores = draw_scores_wilson_hilferty(key, view, cohorts=cohorts)
    local_best = torch.argmax(scores, dim=-1).int()
    score = torch.gather(scores, -1, local_best.long()[..., None])[..., 0]
    return _shard_triple(view, shard_id, local_best, score)


def _shard_triple(view: SamplerState, shard_id: int, local_best: torch.Tensor, score: torch.Tensor):
    lm = view.n.shape[-1]
    gidx = (local_best + shard_id * lm).int()
    return gidx, score, torch.gather(view.n, -1, local_best.long())


def combine_winners(triples: list, mesh):
    """The gather half: every shard's (id, score, n) winners gathered and
    the global first argmax over shards taken.  Returns the replicated
    (i32[..., C] chunk ids, f32[..., C] scores, −inf iff every chunk
    everywhere is exhausted, f32[..., C] the owner's sample count: the
    random+ rank base), on ``mesh.device``."""
    ids, scores, ns = (torch.stack([t[i].to(mesh.device) for t in triples]) for i in range(3))
    win = torch.argmax(scores, dim=0, keepdim=True)
    pick = lambda a: torch.gather(a, 0, win)[0]
    return pick(ids).int(), pick(scores), pick(ns)


def local_cohort_winners(key: torch.Tensor, views: list[SamplerState], mesh, *, cohorts: int, plain: bool = False):
    """The globally consistent Thompson choice over sharded statistics:
    ``views[s]`` is shard s's ``[M/S]`` view.  Returns replicated (chunk
    ids i32[C], scores f32[C], rank bases f32[C]) on ``mesh.device``.
    ``plain`` takes :func:`shard_winners_ref` instead of the fused round."""
    body = shard_winners_ref if plain else shard_winners
    ks = shard_keys(key, mesh.size)
    return combine_winners([body(ks[..., s, :].to(v.n.device), v, s, cohorts) for s, v in enumerate(views)], mesh)


def local_cohort_winners_batched(keys: torch.Tensor, views: list[SamplerState], mesh, *, cohorts: int,
                                 plain: bool = False):
    """Leading-[Q] :func:`local_cohort_winners`: keys int64[Q, 2], views
    ``[Q, M/S]``; row q equals ``local_cohort_winners(keys[q], …)`` on
    query q's views.  Returns replicated (i32[Q, C], f32[Q, C], f32[Q, C])."""
    return local_cohort_winners(keys, views, mesh, cohorts=cohorts, plain=plain)


def distributed_choose(key: torch.Tensor, state: SamplerState, *, mesh, cohorts: int) -> torch.Tensor:
    """The standalone sharded choice: ``state`` (M divisible by S) split
    over the mesh, then :func:`local_cohort_winners`.  Returns the
    replicated i32[cohorts] global chunk ids."""
    ids, _, _ = local_cohort_winners(key, shard_sampler_state(state, mesh), mesh, cohorts=cohorts)
    return ids


# ---------------------------------------------------------------------------
# Merges
# ---------------------------------------------------------------------------


def merge_deltas(state: SamplerState, delta_n1: torch.Tensor, delta_n: torch.Tensor) -> SamplerState:
    """``state`` plus per-worker delta statistics: ``delta_*`` are stacked
    ``[W, M]`` updates or a single ``[M]`` delta, summed over the worker
    axis.  The updates are additive, so the merge is exact in any
    interleaving."""
    d1 = torch.atleast_2d(delta_n1).sum(dim=0)
    dn = torch.atleast_2d(delta_n).sum(dim=0)
    return dataclasses.replace(state, n1=state.n1 + d1, n=state.n + dn)


def straggler_robust_rounds(worker_latencies, sync_every: int, round_time: float) -> torch.Tensor:
    """The analytic straggler model: a barrier every round costs the
    slowest worker, the commutative merge the mean plus the sync cost
    spread over ``sync_every`` rounds.  Returns f32[2] (barrier, async)
    seconds a round."""
    lat = torch.as_tensor(worker_latencies, dtype=torch.float32)
    return torch.stack([lat.max(), lat.mean() + round_time / max(sync_every, 1)])
