"""The fused matcher step (kernel B3's ``match_update``) as plain PyTorch,
against the jitted JAX ``match_and_update`` on the CPU.

``match_update_ref`` is the port's op-by-op step; ``match_update_split_ref``
runs the kernel's decomposition: the ring split into ``blocks`` contiguous
ranges, each range's first maximum (IoU, slot) a detection, the partials
combined in rank order with ties to the lower slot, and each range deriving
the insert order itself and writing its own slots.  Both must equal JAX
exactly on every output (d0, d1, cross_chunk, cross_home, is_new and the
eight ring fields), at 1, 2, 3 and 8 blocks, on the adversarial states of
``tests/_match_states.py``: ties across block boundaries, an IoU exactly at
the threshold, |Δframe| at and one past the gate, another video, an empty
slot, invalid detections, 1 -> 2 transitions from another chunk, several
detections on one entry, and a full ring that wraps over a slot bumped in
the same frame; R = 1 and R < 8 blocks; batched, with an inactive query,
compared query by query.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _match_states import FIELDS, batch_case, frame_case
from repro.core import matcher as jm
from repro_torch.core import matcher as tm
from repro_torch.kernels.iou_match import kernel as t_kernel
from repro_torch.kernels.iou_match import ops as t_ops
from repro_torch.kernels.iou_match.ref import match_update_ref, match_update_split_ref

OUTPUTS = ("d0", "d1", "cross_chunk", "cross_home", "is_new")
BLOCKS = (1, 2, 3, 8)
_step = jax.jit(jm.match_and_update)


def _jax(case, iou_thresh=0.5):
    ring = case["ring"]
    state = jm.MatcherState(**{k: jnp.asarray(ring[k]) for k in FIELDS}, iou_thresh=iou_thresh,
                            time_gate=case["time_gate"])
    det = case["det"]
    out = _step(state, jnp.asarray(det["boxes"]), jnp.asarray(det["feats"]), jnp.asarray(det["valid"]),
                *(jnp.int32(v) for v in case["ids"]))
    return out


def _port_state(ring, time_gate, iou_thresh=0.5):
    return tm.MatcherState(**{k: torch.from_numpy(np.asarray(ring[k])) for k in FIELDS},
                           iou_thresh=iou_thresh, time_gate=time_gate)


def _port(fn, case, iou_thresh=0.5, **kw):
    det = case["det"]
    return fn(_port_state(case["ring"], case["time_gate"], iou_thresh),
              torch.from_numpy(det["boxes"]), torch.from_numpy(det["feats"]), torch.from_numpy(det["valid"]),
              *(torch.as_tensor(v) for v in case["ids"]), **kw)


def _assert_equal(got, want, where=""):
    """Every output and ring field equal, values and dtypes."""
    for name in OUTPUTS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(g, w, err_msg=f"{where}{name}")
        assert g.dtype == w.dtype, (where, name, g.dtype, w.dtype)
    for name in FIELDS:
        g, w = getattr(got.new_state, name).numpy(), np.asarray(getattr(want.new_state, name))
        np.testing.assert_array_equal(g, w, err_msg=f"{where}new_state.{name}")
        assert g.dtype == w.dtype, (where, name, g.dtype, w.dtype)


def _versions():
    return [("plain", match_update_ref, {})] + [
        (f"split{k}", match_update_split_ref, dict(blocks=k)) for k in BLOCKS]


# (D, R): the main path's 16 detections; a ragged 13 over a ring that is not
# a multiple of any block count; 1 x 1; the kernel's most detections; R = 1
# with more new detections than slots (the last one a slot wins); R < 8
SHAPES = [(16, 256), (13, 250), (1, 1), (64, 200), (3, 1), (16, 5), (0, 8)]


@pytest.mark.parametrize("d,r", SHAPES)
@pytest.mark.parametrize("version", [v[0] for v in _versions()])
def test_step_equals_jax(d, r, version):
    fn, kw = {name: (f, k) for name, f, k in _versions()}[version]
    for seed in range(3):
        case = frame_case(seed * 101 + d + r, d, r)
        _assert_equal(_port(fn, case, **kw), _jax(case), f"seed {seed}: ")


@pytest.mark.parametrize("q,d,r", [(8, 16, 256), (3, 13, 250), (2, 1, 1), (4, 64, 9)])
@pytest.mark.parametrize("version", [v[0] for v in _versions()])
def test_batched_step_equals_jax_query_by_query(q, d, r, version):
    fn, kw = {name: (f, k) for name, f, k in _versions()}[version]
    case = batch_case(q * 1000 + d + r, q, d, r)
    got = _port(fn, case, **kw)
    for i, one in enumerate(case["cases"]):
        sliced = got._replace(**{n: getattr(got, n)[i] for n in OUTPUTS}, new_state=dataclasses.replace(
            got.new_state, **{n: getattr(got.new_state, n)[i] for n in FIELDS}))
        _assert_equal(sliced, _jax(one), f"query {i}: ")
    assert not got.is_new[-1].any() and int(got.d0[-1]) == 0 and int(got.d1[-1]) == 0   # the inactive query


def test_the_states_reach_every_rule():
    """The (16, 256) state exercises what it is built for, in JAX's own
    result: ties go to the lower slot at every boundary, a 1 -> 2 from
    another chunk, 1 -> 3, the threshold met exactly, the gate's edges,
    another video, an empty slot, an invalid detection, and the wrap
    overwriting a slot bumped in the same frame."""
    case = frame_case(7, 16, 256)
    out = _jax(case)
    seen0, seen1 = case["ring"]["times_seen"], np.asarray(out.new_state.times_seen)
    is_new, roles = np.asarray(out.is_new), case["roles"]
    assert len(roles["tie"]) == 3
    for (lo_slot, hi_slot), (i,) in roles["tie"]:
        assert not is_new[i] and seen1[hi_slot] == seen0[hi_slot] and lo_slot != 0
    ((s,), _), = roles["cross"]
    assert int(out.cross_chunk) >= 1 and int(np.asarray(out.cross_home)[s]) == 6
    ((s,), _), = roles["double"]
    assert seen1[s] == 3
    for role, new in (("thresh", False), ("gate_in", False), ("gate_out", True), ("video", True),
                      ("empty", True)):
        (_, (i,)), = roles[role]
        assert is_new[i] == new, role
    (_, (i,)), = roles["invalid"]
    assert not is_new[i]
    assert int(out.d0) >= 3 and int(case["ring"]["cursor"]) == 254
    (_, (i,)), = roles["wrap"]
    assert not is_new[i] and seen1[0] == 1                    # bumped to 2, then overwritten
    np.testing.assert_array_equal(np.asarray(out.new_state.boxes)[0],
                                  case["det"]["boxes"][np.flatnonzero(is_new)[2]])


@pytest.mark.parametrize("iou_thresh,matched", [
    (0.5, True),
    (0.5 + 1e-12, True),                                        # rounds to 0.5 in float32
    (float(np.nextafter(np.float32(0.5), np.float32(1))), False),
])
@pytest.mark.parametrize("version", [v[0] for v in _versions()])
def test_the_threshold_is_compared_in_float32(iou_thresh, matched, version):
    fn, kw = {name: (f, k) for name, f, k in _versions()}[version]
    case = frame_case(11, 16, 256)
    want = _jax(case, iou_thresh)
    got = _port(fn, case, iou_thresh, **kw)
    _assert_equal(got, want)
    (_, (i,)), = case["roles"]["thresh"]
    assert bool(got.is_new[i]) is not matched


@pytest.mark.parametrize("blocks", BLOCKS)
def test_a_sequence_of_frames_through_a_small_ring(blocks):
    """Frames chained through a ring of 24 (it wraps several times): the
    split equals JAX after every frame."""
    rng = np.random.default_rng(blocks)
    case = frame_case(blocks, 16, 24)
    js = jm.MatcherState(**{k: jnp.asarray(case["ring"][k]) for k in FIELDS}, time_gate=case["time_gate"])
    ts = _port_state(case["ring"], case["time_gate"])
    pool = frame_case(99, 40, 24)["det"]
    for step in range(30):
        pick = rng.choice(40, 16, replace=False)
        det = {k: v[pick] for k, v in pool.items()}
        ids = (3, 5000 + int(rng.integers(-5, 6)), int(rng.integers(5, 9)))
        want = _step(js, jnp.asarray(det["boxes"]), jnp.asarray(det["feats"]), jnp.asarray(det["valid"]),
                     *(jnp.int32(v) for v in ids))
        got = match_update_split_ref(ts, torch.from_numpy(det["boxes"]), torch.from_numpy(det["feats"]),
                                     torch.from_numpy(det["valid"]), *(torch.tensor(v) for v in ids),
                                     blocks=blocks)
        _assert_equal(got, want, f"frame {step}: ")
        js, ts = want.new_state, got.new_state


@settings(deadline=None, max_examples=25)
@given(seed=st.integers(0, 2**31 - 1), blocks=st.sampled_from(BLOCKS))
def test_split_equals_jax_on_random_states(seed, blocks):
    case = frame_case(seed, 16, 64)
    _assert_equal(_port(match_update_split_ref, case, blocks=blocks), _jax(case))


def test_dispatch_on_the_cpu_takes_the_plain_step():
    case = frame_case(3, 16, 256)
    _assert_equal(_port(t_ops.match_update, case), _jax(case))
    _assert_equal(_port(tm.match_and_update, case), _jax(case))
    q = batch_case(5, 3, 16, 64)
    _assert_equal(_port(t_ops.match_update, q), _port(match_update_ref, q))


def test_the_cosine_path_keeps_its_op_by_op_step():
    """feat_thresh > -1: ``match_and_update`` runs ``match_update_ref`` with
    the cosine, as JAX does."""
    case = frame_case(4, 16, 64)
    ring = case["ring"]
    ring["feats"][:] = np.abs(ring["feats"])
    case["det"]["feats"][:] = np.abs(case["det"]["feats"])
    det = case["det"]
    js = jm.MatcherState(**{k: jnp.asarray(ring[k]) for k in FIELDS}, time_gate=case["time_gate"],
                         feat_thresh=0.9)
    want = jax.jit(jm.match_and_update)(js, jnp.asarray(det["boxes"]), jnp.asarray(det["feats"]),
                                        jnp.asarray(det["valid"]), *(jnp.int32(v) for v in case["ids"]))
    ts = dataclasses.replace(_port_state(ring, case["time_gate"]), feat_thresh=0.9)
    got = tm.match_and_update(ts, torch.from_numpy(det["boxes"]), torch.from_numpy(det["feats"]),
                              torch.from_numpy(det["valid"]), *(torch.as_tensor(v) for v in case["ids"]))
    _assert_equal(got, want)
    assert int(got.d0) < int(_jax(case).d0)                    # the cosine matched more


def test_the_kernel_refuses_what_it_cannot_run():
    """Checked before any launch, so no card is needed: CPU tensors, and
    the cosine path, which the fused step does not compute."""
    case = frame_case(1, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        _port(t_kernel.match_update, case)
    state = dataclasses.replace(_port_state(case["ring"], 900), feat_thresh=0.5)
    with pytest.raises(ValueError, match="feat_thresh"):
        t_kernel.match_update(state, *(torch.from_numpy(case["det"][k]) for k in ("boxes", "feats", "valid")),
                              0, 0, 0)
