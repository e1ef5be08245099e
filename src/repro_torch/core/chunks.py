"""Chunk partitioning and within-chunk random+ order (paper §3.5, §3.7.2).

Counterpart of ``repro.core.chunks``.  ``build_chunks`` and
``global_randomplus_order`` are numpy and copied as they are, so both
packages build the same ``ChunkIndex`` from the same seed.  random+ is the
bit-reversal permutation of frame offsets, cycle-walked onto
non-power-of-two lengths and rotated per chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve

_M32 = 0xFFFFFFFF


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def bit_reverse(i: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Reverse the low ``bits`` bits of i, with uint32 semantics (the words
    are held in int64).  Returns int64 holding the int32 result."""
    i = torch.as_tensor(i).long() & _M32
    i = ((i & 0x55555555) << 1) | ((i >> 1) & 0x55555555)
    i = ((i & 0x33333333) << 2) | ((i >> 2) & 0x33333333)
    i = ((i & 0x0F0F0F0F) << 4) | ((i >> 4) & 0x0F0F0F0F)
    i = ((i & 0x00FF00FF) << 8) | ((i >> 8) & 0x00FF00FF)
    i = ((i << 16) & _M32) | (i >> 16)
    bits = torch.as_tensor(bits, device=i.device).long() & _M32
    # a uint32 shift by 32 or more gives 0 in XLA; clamp so torch never
    # shifts by a negative amount, then mask those lanes
    shift = torch.clamp(32 - bits, 0, 31)
    out = torch.where((bits > 0) & (bits <= 32), i >> shift, torch.zeros_like(i))
    out = torch.where(bits > 32, torch.zeros_like(out), out)
    # astype(int32) wraps values at or above 2**31
    return torch.where(out >= 2**31, out - 2**32, out)


@dataclasses.dataclass(frozen=True)
class ChunkIndex:
    """Static geometry of the chunked repository (M chunks), int32 tensors."""

    video_id: torch.Tensor
    start: torch.Tensor
    length: torch.Tensor
    pow2: torch.Tensor
    bits: torch.Tensor
    rotation: torch.Tensor

    @property
    def num_chunks(self) -> int:
        return self.video_id.shape[0]

    @property
    def total_frames(self) -> int:
        return int(self.start[-1]) + int(self.length[-1])

    def to(self, device) -> "ChunkIndex":
        return ChunkIndex(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


def build_chunks(
    video_lengths: Sequence[int],
    *,
    chunk_frames: int,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> ChunkIndex:
    """Split each video into ceil(len/chunk_frames) chunks (§3.5)."""
    vids, starts, lengths = [], [], []
    base = 0
    for v, flen in enumerate(video_lengths):
        off = 0
        while off < flen:
            clen = min(chunk_frames, flen - off)
            vids.append(v)
            starts.append(base + off)
            lengths.append(clen)
            off += clen
        base += flen
    lengths_np = np.asarray(lengths, np.int32)
    pow2 = np.asarray([_next_pow2(l) for l in lengths], np.int32)
    bits = np.asarray([int(p).bit_length() - 1 for p in pow2], np.int32)
    rng = np.random.default_rng(seed)
    rotation = rng.integers(0, np.maximum(lengths_np, 1), dtype=np.int64).astype(np.int32)

    device = resolve(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(device)

    return ChunkIndex(
        video_id=t(vids), start=t(starts), length=t(lengths_np),
        pow2=t(pow2), bits=t(bits), rotation=t(rotation),
    )


def randomplus_offset(index: ChunkIndex, chunk, k) -> torch.Tensor:
    """Frame offset within the chunk of its k-th random+ sample.

    ``bit_reverse(k mod pow2)`` enumerates [0, pow2) in stratified order; a
    candidate past the chunk's length is walked back to ``k mod pow2``
    (bit reversal is an involution, so one step suffices), then rotated.
    """
    # torch.take, not t[chunk]: indexing with a 0-dim CUDA tensor reads
    # the index back to the host (a sync per frame)
    chunk = torch.as_tensor(chunk, device=index.length.device).long()
    length = torch.take(index.length, chunk).long()
    pow2 = torch.clamp_min(torch.take(index.pow2, chunk).long(), 1)
    bits = torch.take(index.bits, chunk)
    rot = torch.take(index.rotation, chunk).long()
    k = torch.as_tensor(k, device=length.device).long()
    raw = torch.remainder(k, pow2)   # k ≥ 0 and pow2 > 0: int32 % agrees
    cand = bit_reverse(raw, bits)
    offset = torch.where(cand < length, cand, raw)
    return torch.remainder(offset + rot, torch.clamp_min(length, 1))


def randomplus_frame(index: ChunkIndex, chunk, k) -> torch.Tensor:
    """Global frame id of the k-th random+ sample from ``chunk`` (int64)."""
    chunk = torch.as_tensor(chunk, device=index.start.device).long()
    return torch.take(index.start, chunk).long() + randomplus_offset(index, chunk, k)


def global_randomplus_order(total_frames: int, *, seed: int = 0) -> np.ndarray:
    """random+ over the whole dataset: a bit-reversal permutation of
    [0, total) with a random rotation (host-side numpy)."""
    pow2 = _next_pow2(total_frames)
    bits = int(pow2).bit_length() - 1
    idx = np.arange(pow2, dtype=np.uint64)
    rev = np.zeros(pow2, dtype=np.uint64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    rev = rev[rev < total_frames].astype(np.int64)
    rng = np.random.default_rng(seed)
    rot = int(rng.integers(0, max(total_frames, 1)))
    return ((rev + rot) % total_frames).astype(np.int64)
