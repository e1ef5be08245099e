"""The matcher merge of repro_torch (``core.matcher``: ``merge_matcher``,
``merge_stats``, ``merge_matcher_checked``, ``eviction_mask`` and
``ResultLog``) against ``repro.core.matcher``, on the CPU.

States are made with numpy from a seed: a snapshot ring, then workers
that each insert entries at the snapshot's cursor (wrapping) and bump
the seen-counts of some live entries, as ``match_and_update`` would.
Every ``MatcherState`` field and every ``MergeStats`` field must equal
the reference's exactly (tolerance 0): the sequential case, two
overlapping workers merged in turn, a cursor that wraps, a worker that
inserted the capacity or more (overflow), the eviction mask at window
sizes from 0 past the capacity, the host log's spills, and Q rings with
a leading [Q] against each ring alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import matcher as jm
from repro_torch.convert import matcher_from_numpy, to_numpy
from repro_torch.core import matcher as tm

FIELDS = ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted")
F = 8


def _snapshot(rng, cap: int, live: int, cursor: int, total: int, *, filled: bool = False) -> dict:
    """A ring with ``live`` entries at random slots, or (``filled``) in the
    slots before the cursor, as a ring that never wrapped holds them."""
    occupied = np.zeros(cap, bool)
    occupied[(cursor - 1 - np.arange(live)) % cap if filled else rng.choice(cap, size=live, replace=False)] = True
    return dict(
        boxes=np.where(occupied[:, None], rng.random((cap, 4)), 0).astype(np.float32),
        feats=np.where(occupied[:, None], rng.normal(size=(cap, F)), 0).astype(np.float32),
        video=np.where(occupied, rng.integers(0, 3, cap), -1).astype(np.int32),
        frame=np.where(occupied, rng.integers(0, 50_000, cap), -(10**9)).astype(np.int32),
        chunk=np.where(occupied, rng.integers(0, 20, cap), -1).astype(np.int32),
        times_seen=np.where(occupied, rng.integers(1, 4, cap), 0).astype(np.int32),
        cursor=np.int32(cursor), total_inserted=np.int32(total),
    )


def _advance(rng, s: dict, inserts: int, bumps: int) -> dict:
    """A worker's ring after ``inserts`` insertions and ``bumps`` seen-count
    bumps of live entries."""
    s = {k: np.array(v) for k, v in s.items()}
    cap = s["boxes"].shape[0]
    live = np.flatnonzero(s["times_seen"] > 0)
    if len(live) and bumps:
        s["times_seen"][rng.choice(live, size=min(bumps, len(live)), replace=False)] += 1
    for i in range(inserts):
        slot = (int(s["cursor"]) + i) % cap
        s["boxes"][slot] = rng.random(4)
        s["feats"][slot] = rng.normal(size=F)
        s["video"][slot] = rng.integers(0, 3)
        s["frame"][slot] = rng.integers(0, 50_000)
        s["chunk"][slot] = rng.integers(0, 20)
        s["times_seen"][slot] = 1
    s["cursor"] = np.int32((int(s["cursor"]) + inserts) % cap)
    s["total_inserted"] = np.int32(int(s["total_inserted"]) + inserts)
    return s


def _j(d):
    return jm.MatcherState(**{k: jnp.asarray(v) for k, v in d.items()})


def _t(d):
    return matcher_from_numpy(d, device="cpu")


def _assert_state_equal(t: tm.MatcherState, j) -> None:
    got = to_numpy(t)
    for f in FIELDS:
        want = np.asarray(getattr(j, f))
        assert got[f].dtype == want.dtype, f
        np.testing.assert_array_equal(got[f], want, err_msg=f)


def _merge_both(dst: dict, src: dict, snap: dict):
    jd, js = jm.merge_matcher_checked(_j(dst), _j(src), _j(snap))
    td, ts = tm.merge_matcher_checked(_t(dst), _t(src), _t(snap))
    _assert_state_equal(td, jd)
    for f in jm.MergeStats._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
    _assert_state_equal(tm.merge_matcher(_t(dst), _t(src), _t(snap)), jm.merge_matcher(_j(dst), _j(src), _j(snap)))
    return to_numpy(td), js


@pytest.mark.parametrize("seed", range(4))
def test_sequential_merge_equals_the_worker(seed):
    rng = np.random.default_rng(seed)
    snap = _snapshot(rng, 64, live=20, cursor=20, total=20, filled=True)
    src = _advance(rng, snap, inserts=7, bumps=5)
    merged, stats = _merge_both(snap, src, snap)
    for f in FIELDS:                           # exact in the sequential case
        np.testing.assert_array_equal(merged[f], src[f], err_msg=f)
    assert int(stats.inserted) == 7 and not bool(stats.overflow) and int(stats.clobbered) == 0


@pytest.mark.parametrize("seed", range(4))
def test_two_overlapping_workers(seed):
    rng = np.random.default_rng(10 + seed)
    snap = _snapshot(rng, 64, live=40, cursor=40, total=300)
    w1 = _advance(rng, snap, inserts=5, bumps=6)
    w2 = _advance(rng, snap, inserts=9, bumps=6)
    dst, s1 = _merge_both(snap, w1, snap)
    dst, s2 = _merge_both(dst, w2, snap)
    assert int(dst["total_inserted"]) == 300 + 5 + 9
    assert int(dst["cursor"]) == (40 + 14) % 64
    assert int(s1.clobbered) + int(s2.clobbered) > 0


@pytest.mark.parametrize("cursor,inserts", [(13, 7), (15, 1), (0, 15), (9, 16), (9, 19), (4, 40)])
def test_cursor_wraps_and_overflow(cursor, inserts):
    """Both cursors wrap modulo 16; 16 or more insertions overflow."""
    rng = np.random.default_rng(cursor * 100 + inserts)
    snap = _snapshot(rng, 16, live=10, cursor=cursor, total=1000 + cursor)
    dst = _advance(rng, snap, inserts=3, bumps=2)
    src = _advance(rng, snap, inserts=inserts, bumps=4)
    _, stats = _merge_both(dst, src, snap)
    assert int(stats.inserted) == inserts and bool(stats.overflow) == (inserts >= 16)


@pytest.mark.parametrize("n_new", [0, 1, 5, 15, 16, 17, 40])
@pytest.mark.parametrize("cursor", [0, 11])
def test_eviction_mask(n_new, cursor):
    rng = np.random.default_rng(n_new + cursor)
    d = _snapshot(rng, 16, live=12, cursor=cursor, total=cursor)
    got = tm.eviction_mask(_t(d), n_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.eviction_mask(_j(d), n_new)))
    np.testing.assert_array_equal(tm.eviction_mask(_t(d), torch.tensor(n_new, dtype=torch.int32)).numpy(),
                                  got.numpy())


def test_result_log_spills_like_the_reference():
    rng = np.random.default_rng(3)
    jl, tl = jm.ResultLog(), tm.ResultLog()
    assert {k: v.shape for k, v in tl.as_arrays().items()} == {k: v.shape for k, v in jl.as_arrays().items()}
    for n_new in (0, 4, 9):
        d = _snapshot(rng, 16, live=12, cursor=int(rng.integers(16)), total=0)
        assert tl.spill(_t(d), tm.eviction_mask(_t(d), n_new)) == jl.spill(_j(d), jm.eviction_mask(_j(d), n_new))
    assert len(tl) == len(jl) > 0
    got, want = tl.as_arrays(), jl.as_arrays()
    for f in want:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_q_rings_merge_each_ring_alone():
    rng = np.random.default_rng(7)
    snaps = [_snapshot(rng, 16, live=8, cursor=c, total=c) for c in (3, 14, 0)]
    dsts = [_advance(rng, s, inserts=2, bumps=2) for s in snaps]
    srcs = [_advance(rng, s, inserts=k, bumps=3) for s, k in zip(snaps, (4, 6, 17))]

    def stack(ds):
        return {k: np.stack([d[k] for d in ds]) for k in ds[0]}

    merged, stats = tm.merge_matcher_checked(_t(stack(dsts)), _t(stack(srcs)), _t(stack(snaps)))
    mask = tm.eviction_mask(_t(stack(dsts)), torch.tensor([1, 5, 30], dtype=torch.int32))
    for q in range(3):
        one, one_stats = tm.merge_matcher_checked(_t(dsts[q]), _t(srcs[q]), _t(snaps[q]))
        for f in FIELDS:
            assert torch.equal(getattr(merged, f)[q], getattr(one, f)), (q, f)
        for f in tm.MergeStats._fields:
            assert torch.equal(getattr(stats, f)[q], getattr(one_stats, f)), (q, f)
        assert torch.equal(mask[q], tm.eviction_mask(_t(dsts[q]), (1, 5, 30)[q]))
    assert merged.capacity == 16 and merged.boxes.is_contiguous()
