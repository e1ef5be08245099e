"""Parity of repro_torch's simulated repository and oracle detector with
the JAX reference.  ``generate`` is the same numpy program, so its arrays
are identical; the oracle's box track ``box + t·drift`` is one fused
multiply-add in the jitted reference and in the port, so detections are
identical bit for bit on every frame."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import exsample_paper as jcfg
from repro.sim import oracle as joracle
from repro.sim import repository as jrepo
from repro_torch.configs import exsample_paper as tcfg
from repro_torch.sim import oracle as toracle
from repro_torch.sim import repository as trepo

SPEC = dict(video_lengths=[300, 500, 200], num_instances=80, num_classes=3,
            duration_mu=4.0, duration_sigma=1.2, locality=2.0, chunk_frames=250)


def _pair(seed):
    j = jrepo.generate(jrepo.RepoSpec(**SPEC, seed=seed))
    t = trepo.generate(trepo.RepoSpec(**SPEC, seed=seed), device="cpu")
    return j, t


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_generate_identical(seed):
    (jr, jc), (tr, tc) = _pair(seed)
    for f in dataclasses.fields(jr):
        a, b = getattr(jr, f.name), getattr(tr, f.name)
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f.name)
            assert b.numpy().dtype == np.asarray(a).dtype, f.name
        else:
            assert a == b, f.name
    for f in dataclasses.fields(jc):
        np.testing.assert_array_equal(getattr(tc, f.name).numpy(), np.asarray(getattr(jc, f.name)))


@pytest.mark.parametrize("make", ["dashcam", "bdd"])
def test_paper_configs_identical(make):
    j = getattr(jcfg, make)(seed=3, scale=0.05)
    t = getattr(tcfg, make)(seed=3, scale=0.05)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("query_class", [0, 2, None])
def test_oracle_detect_every_frame(query_class):
    (jr, jc), (tr, tc) = _pair(5)
    frames = np.arange(jr.total_frames, dtype=np.int32)
    det = jax.jit(jax.vmap(lambda f: joracle.oracle_detect(jr, f, query_class=query_class)))
    ref = det(jnp.asarray(frames))
    # the per-frame jitted reference agrees with the batched one
    one = jax.jit(lambda f: joracle.oracle_detect(jr, f, query_class=query_class))
    for f in (0, 777, jr.total_frames - 1):
        np.testing.assert_array_equal(np.asarray(one(jnp.int32(f)).boxes), np.asarray(ref.boxes[f]))
    for f in frames:
        got = toracle.oracle_detect(tr, torch.tensor(int(f)), query_class=query_class)
        for name in ("boxes", "feats", "valid", "inst_id"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(ref, name)[f]),
                err_msg=f"frame {f} {name}")


def test_sampling_cost_matches_reference():
    from repro.sim import costmodel as jcost
    from repro_torch.sim import costmodel as tcost

    for frames, workers in ((0, 1), (450, 1), (5000, 4)):
        j = jcost.sampling_cost(frames, jcost.CostRates(workers=workers))
        t = tcost.sampling_cost(frames, tcost.CostRates(workers=workers))
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    # the port's default peak is the H100's, the reference's a TPU's: compare on one input
    assert tcost.CostRates.from_backbone(1e12, peak_flops=989e12) == tcost.CostRates(**dataclasses.asdict(
        jcost.CostRates.from_backbone(1e12, peak_flops=989e12)))


@pytest.mark.parametrize("query_class", [1, None])
def test_oracle_detect_on_a_batch_of_frames(query_class):
    """The multi-query detector protocol: a batch of frames [B] gives
    detections with a leading [B], each row the single frame's."""
    (jr, _), (tr, _) = _pair(5)
    frames = np.array([0, 3, 3, 250, 777, jr.total_frames - 1], np.int64)
    ref = jax.jit(jax.vmap(lambda f: joracle.oracle_detect(jr, f, query_class=query_class)))(
        jnp.asarray(frames, jnp.int32))
    got = toracle.oracle_detect(tr, torch.from_numpy(frames), query_class=query_class)
    for name in ("boxes", "feats", "valid", "inst_id"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
        one = getattr(toracle.oracle_detect(tr, torch.tensor(777), query_class=query_class), name)
        assert torch.equal(getattr(got, name)[4], one)


def test_class_select_and_filter_class_match_reference():
    (jr, _), (tr, _) = _pair(2)
    frames = np.arange(0, jr.total_frames, 7, dtype=np.int64)[:12]
    classes = [0, 2, 1, 0]
    jdets = jax.vmap(lambda f: joracle.oracle_detect(jr, f, query_class=None))(jnp.asarray(frames[:4], jnp.int32))
    tdets = toracle.oracle_detect(tr, torch.from_numpy(frames[:4]), query_class=None)
    jsel = joracle.class_select(jr, classes)
    want = jax.vmap(jsel)(jnp.arange(4, dtype=jnp.int32), jdets)
    got = toracle.class_select(tr, classes)(torch.arange(4, dtype=torch.int32), tdets)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for cls in (0, 1, 2):
        one = toracle.filter_class(tr, toracle.oracle_detect(tr, torch.from_numpy(frames), query_class=None), cls)
        per = toracle.oracle_detect(tr, torch.from_numpy(frames), query_class=cls)
        for f in range(len(frames)):
            jref = joracle.filter_class(jr, joracle.oracle_detect(jr, jnp.int32(frames[f]), query_class=None), cls)
            np.testing.assert_array_equal(one.valid[f].numpy(), np.asarray(jref.valid))
        # the valid detections of a filtered detect-all pass are the class's own
        assert torch.equal(one.valid.sum(-1), per.valid.sum(-1))
