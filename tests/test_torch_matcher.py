"""Parity of repro_torch's matcher with the jitted JAX ``match_and_update``.

Every output is integer or a copy of an input box, so the comparisons are
exact: ring contents, ``times_seen``, ``cursor``, ``total_inserted``, d₀,
d₁, ``cross_chunk`` and ``cross_home`` after every frame of long
sequences.  The frames come from the oracle detector on a small
repository, revisited often (so results are re-seen, also from other
chunks), with a ring small enough to wrap.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import matcher as jm
from repro.sim import oracle as joracle
from repro.sim import repository as jrepo
from repro_torch.core import matcher as tm
from repro_torch.sim import oracle as toracle
from repro_torch.sim import repository as trepo

SPEC = dict(video_lengths=[400, 300], num_instances=60, num_classes=2,
            duration_mu=4.5, duration_sigma=0.8, locality=1.0, chunk_frames=100)
FIELDS = ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted")


def _run(capacity, frames, *, feat_thresh=-1.0, time_gate=900, seed=0):
    jr, jc = jrepo.generate(jrepo.RepoSpec(**SPEC, seed=seed))
    tr, tc = trepo.generate(trepo.RepoSpec(**SPEC, seed=seed), device="cpu")
    js = jm.init_matcher(max_results=capacity, feat_thresh=feat_thresh, time_gate=time_gate)
    ts = tm.init_matcher(max_results=capacity, feat_thresh=feat_thresh, time_gate=time_gate,
                         device="cpu")
    step = jax.jit(jm.match_and_update)
    detect = jax.jit(lambda f: joracle.oracle_detect(jr, f, query_class=None))
    vof = np.asarray(jr.video_of_frame)
    chunk_of = np.searchsorted(np.asarray(jc.start), np.arange(jr.total_frames), side="right") - 1
    crossings = 0
    for f in frames:
        v, c = int(vof[f]), int(chunk_of[f])
        d = detect(jnp.int32(f))
        out = step(js, d.boxes, d.feats, d.valid, jnp.int32(v), jnp.int32(f), jnp.int32(c))
        td = toracle.oracle_detect(tr, torch.tensor(f), query_class=None)
        got = tm.match_and_update(ts, td.boxes, td.feats, td.valid, torch.tensor(v),
                                  torch.tensor(f), torch.tensor(c))
        for name in ("d0", "d1", "cross_chunk", "cross_home", "is_new"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(out, name)),
                                          err_msg=f"frame {f}: {name}")
        crossings += int(got.cross_chunk)
        js, ts = out.new_state, got.new_state
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                          err_msg=f"frame {f}: {name}")
    return js, ts, crossings


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    # a random walk revisits neighbourhoods, so results are seen again
    return np.clip(np.cumsum(rng.integers(-40, 60, n)), 0, 699).astype(int)


def test_long_sequence_with_ring_wrap():
    js, ts, _ = _run(capacity=24, frames=_frames(250, 1))
    assert int(js.total_inserted) > 2 * 24          # the ring wrapped, twice
    assert int(np.asarray(js.times_seen).max()) >= 2


def test_long_sequence_large_ring_cross_chunk():
    js, ts, crossings = _run(capacity=512, frames=_frames(250, 2), time_gate=300)
    assert int(np.asarray(js.times_seen).max()) >= 3
    assert crossings > 0                              # §3.4 cross-chunk path taken


def test_feature_cosine_path():
    """feat_thresh > -1 adds the appearance re-identification path."""
    _run(capacity=64, frames=_frames(150, 3), feat_thresh=0.9)


def test_ties_go_to_the_first_entry():
    """Two ring entries with the same box: a detection matching both bumps
    the first."""
    box = np.array([[0.1, 0.1, 0.3, 0.3]], np.float32)
    boxes = np.concatenate([box, box, np.zeros((2, 4), np.float32)])
    feats = np.zeros((4, 8), np.float32)
    valid = np.array([True, True, False, False])
    js = jm.init_matcher(max_results=8)
    ts = tm.init_matcher(max_results=8, device="cpu")
    for frame, vld in ((10, valid), (11, np.array([True, False, False, False]))):
        out = jax.jit(jm.match_and_update)(js, jnp.asarray(boxes), jnp.asarray(feats), jnp.asarray(vld),
                                           jnp.int32(0), jnp.int32(frame), jnp.int32(0))
        got = tm.match_and_update(ts, torch.from_numpy(boxes), torch.from_numpy(feats),
                                  torch.from_numpy(vld), torch.tensor(0), torch.tensor(frame),
                                  torch.tensor(0))
        js, ts = out.new_state, got.new_state
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    assert ts.times_seen[:2].tolist() == [2, 1]
    assert int(got.d1) == 1


def test_num_results_and_init():
    a, b = jm.init_matcher(max_results=16, feat_dim=4), tm.init_matcher(max_results=16, feat_dim=4, device="cpu")
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, torch.Tensor):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))
            assert y.numpy().dtype == np.asarray(x).dtype, f.name
        else:
            assert x == y
    assert int(tm.num_results(b)) == int(jm.num_results(a)) == 0
