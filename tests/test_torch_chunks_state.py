"""Parity of repro_torch's chunk index, random+ order and sampler state
with the JAX reference.  Everything here is integer or integer-valued, so
every comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chunks as jchunks
from repro.core import state as jstate
from repro_torch.core import chunks as tchunks
from repro_torch.core.matcher import broadcast_leading
from repro_torch.core import state as tstate

LENGTHS = [
    ([100, 37, 1, 64, 1000], 64),      # ragged videos, non-power-of-two tails
    ([54_000, 81_000, 3_600], 54_000),  # dashcam-like
    ([1200] * 9, 1200),                 # bdd-like: one chunk per clip
    ([5, 3, 2, 7, 1], 3),
]


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("lengths,chunk_frames", LENGTHS)
@pytest.mark.parametrize("seed", [0, 7])
def test_build_chunks_identical(lengths, chunk_frames, seed):
    j = jchunks.build_chunks(lengths, chunk_frames=chunk_frames, seed=seed)
    t = tchunks.build_chunks(lengths, chunk_frames=chunk_frames, seed=seed, device="cpu")
    for f in ("video_id", "start", "length", "pow2", "bits", "rotation"):
        np.testing.assert_array_equal(_np(getattr(t, f)), np.asarray(getattr(j, f)), err_msg=f)
    assert t.num_chunks == j.num_chunks and t.total_frames == j.total_frames


@pytest.mark.parametrize("lengths,chunk_frames", [LENGTHS[0], LENGTHS[3], ([3000, 777], 1000)])
def test_randomplus_frames_identical(lengths, chunk_frames):
    j = jchunks.build_chunks(lengths, chunk_frames=chunk_frames, seed=3)
    t = tchunks.build_chunks(lengths, chunk_frames=chunk_frames, seed=3, device="cpu")
    m = j.num_chunks
    kmax = int(np.asarray(j.pow2).max()) + 5      # past exhaustion too
    chunk = np.repeat(np.arange(m, dtype=np.int32), kmax)
    k = np.tile(np.arange(kmax, dtype=np.int32), m)
    ref = np.asarray(jax.jit(jchunks.randomplus_frame)(j, jnp.asarray(chunk), jnp.asarray(k)))
    got = tchunks.randomplus_frame(t, torch.from_numpy(chunk), torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, ref)
    # the first `length` ranks of a chunk visit every frame exactly once
    length = np.asarray(j.length)
    for c in range(m):
        frames = got[c * kmax: c * kmax + length[c]]
        assert len(set(frames.tolist())) == length[c]


def test_bit_reverse_32bit_boundaries():
    vals = np.array([0, 1, 2, 3, 0x55555555, 0x0F0F0F0F, 2**31 - 1, -(2**31), -1, -2,
                     0x12345678, 0x7FFF0000, 1 << 16, (1 << 16) - 1], dtype=np.int64)
    bits = np.arange(-1, 34, dtype=np.int64)
    i = np.repeat(vals, bits.size)
    b = np.tile(bits, vals.size)
    i32 = i.astype(np.int32)                 # the reference takes int32 words
    ref = np.asarray(jax.jit(jchunks.bit_reverse)(jnp.asarray(i32), jnp.asarray(b.astype(np.int32))))
    got = tchunks.bit_reverse(torch.from_numpy(i32.astype(np.int64)), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_global_randomplus_order_identical():
    for total in (1, 7, 1000, 4097):
        np.testing.assert_array_equal(
            tchunks.global_randomplus_order(total, seed=2),
            jchunks.global_randomplus_order(total, seed=2))


def test_apply_update_colliding_indices():
    rng = np.random.default_rng(0)
    frames = rng.integers(1, 40, 12).astype(np.int32)
    js, ts = jstate.init_state(frames), tstate.init_state(frames, device="cpu")
    for _ in range(20):
        idx = rng.integers(0, 12, 9).astype(np.int32)        # collisions certain
        d0 = rng.integers(0, 4, 9).astype(np.float32)
        d1 = rng.integers(0, 3, 9).astype(np.float32)
        js = jstate.apply_update(js, jnp.asarray(idx), jnp.asarray(d0), jnp.asarray(d1))
        ts = tstate.apply_update(ts, torch.from_numpy(idx), torch.from_numpy(d0), torch.from_numpy(d1))
        home = rng.integers(0, 12, 5).astype(np.int32)
        cnt = rng.integers(0, 2, 5).astype(np.float32)
        js = jstate.apply_cross_chunk_decrement(js, jnp.asarray(home), jnp.asarray(cnt))
        ts = tstate.apply_cross_chunk_decrement(ts, torch.from_numpy(home), torch.from_numpy(cnt))
    np.testing.assert_array_equal(ts.n1.numpy(), np.asarray(js.n1))
    np.testing.assert_array_equal(ts.n.numpy(), np.asarray(js.n))
    np.testing.assert_array_equal(ts.exhausted().numpy(), np.asarray(js.exhausted()))
    np.testing.assert_array_equal(tstate.point_estimate(ts).numpy(), np.asarray(jstate.point_estimate(js)))


def test_apply_update_scalar_form():
    js = jstate.apply_update(jstate.init_state([5, 5, 5]), jnp.int32(1), 3, 1)
    ts = tstate.apply_update(tstate.init_state([5, 5, 5], device="cpu"), torch.tensor(1), 3, 1)
    np.testing.assert_array_equal(ts.n1.numpy(), np.asarray(js.n1))
    np.testing.assert_array_equal(ts.n.numpy(), np.asarray(js.n))


def test_batched_updates_equal_the_reference_vmap():
    """[Q, M] statistics: one chunk per query scatters at q·M + j, gated by
    ``samples`` (0 for a finished query), as the reference's vmapped fold
    does; no query's delta lands in another's row."""
    rng = np.random.default_rng(1)
    q_n, m, r = 4, 12, 6
    frames = rng.integers(1, 40, m).astype(np.int32)
    js = jax.tree.map(lambda x: jnp.broadcast_to(x, (q_n,) + x.shape), jstate.init_state(frames))
    ts = broadcast_leading(tstate.init_state(frames, device="cpu"), q_n)

    def jstep(s, idx, d0, d1, act, home, cnt):
        s = jstate.apply_update(s, idx, d0, d1, samples=act)
        return jstate.apply_cross_chunk_decrement(s, home, cnt)

    for _ in range(15):
        idx = rng.integers(0, m, q_n).astype(np.int32)
        idx[:2] = idx[0]                                        # two queries, one chunk
        d0 = rng.integers(0, 4, q_n).astype(np.int32)
        d1 = rng.integers(0, 3, q_n).astype(np.int32)
        act = (rng.random(q_n) < 0.8).astype(np.float32)
        home = rng.integers(0, m, (q_n, r)).astype(np.int32)
        cnt = rng.integers(0, 2, (q_n, r)).astype(np.float32)
        js = jax.vmap(jstep)(js, *(jnp.asarray(x) for x in (idx, d0, d1, act, home, cnt)))
        ts = tstate.apply_update(ts, torch.from_numpy(idx), torch.from_numpy(d0), torch.from_numpy(d1),
                                 samples=torch.from_numpy(act))
        ts = tstate.apply_cross_chunk_decrement(ts, torch.from_numpy(home), torch.from_numpy(cnt))
    np.testing.assert_array_equal(ts.n1.numpy(), np.asarray(js.n1))
    np.testing.assert_array_equal(ts.n.numpy(), np.asarray(js.n))
    np.testing.assert_array_equal(ts.exhausted().numpy(), np.asarray(js.exhausted()))
    assert ts.num_chunks == m
