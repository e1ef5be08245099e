"""The noisy detector of repro_torch against the JAX package, on the CPU.

Held against the reference, with the same numpy-made keys and frames:

  * ``prng.bernoulli`` against ``jax.random.bernoulli``, bit for bit, for
    one key and for a batch of keys;
  * ``sim.noisy_detect`` against ``repro.sim.oracle.noisy_detect`` for 256
    keys at bdd and dashcam(0.05), class 0 and class-agnostic: ``valid``,
    ``inst_id``, ``boxes`` and ``feats`` all bit-equal (tolerance 0), in
    both call forms (one key [2] with a 0-dim frame; keys [B, 2] with
    frames [B], against the reference ``jax.vmap``ped).  Bit-equality
    needs XLA's choices mirrored: the jitter's √2·jitter folded into one
    float32 constant and contracted into an FMA, and the features' norm
    summed by halves;
  * ``frame_embedding`` within 1e-5 absolute (sin and a small matmul whose
    order is the library's);
  * the searches with the noisy detector: ``host`` and ``scan`` at cohorts
    1 and 8 and ``multi`` at Q = 4 (class-agnostic noisy detector with
    ``class_select``) exactly: steps, results, traces, stats and the final
    sampler, ring and key;
  * the CLI's ``--detector noisy --baseline`` lines against the
    reference CLI's.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import exsample_paper as jcfg
from repro.sim import generate as j_generate
from repro.sim import oracle as joracle
from repro_torch import core as tcore
from repro_torch.configs import exsample_paper as tcfg
from repro_torch.core import prng
from repro_torch.sim import generate as t_generate
from repro_torch.sim import oracle as toracle

CPU = "cpu"
KEYS = 256
MATCHER_FIELDS = ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted")
QUERY_CLASS = 7          # dashcam(0.02)'s densest class
RING = 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's plain paths are many small elementwise passes (the key
    stream op by op): one intra-op thread runs them faster than eight, and
    the suite's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _repos(make: str, scale: float):
    return (j_generate(getattr(jcfg, make)(scale=scale).repo),
            t_generate(getattr(tcfg, make)(scale=scale).repo, device=CPU))


def _keys_frames(n: int, total_frames: int, seed: int):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    frames = rng.integers(0, total_frames, n).astype(np.int32)
    return keys, frames


def _tkeys(keys: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(keys.astype(np.int64))


# ---- bernoulli --------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.0, 0.05, 0.1, 0.5, 0.999, 1.0])
def test_bernoulli_matches_jax_bit_for_bit(p):
    keys, _ = _keys_frames(64, 1, seed=11)
    want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, p, (37, 3)))(jnp.asarray(keys)))
    got = prng.bernoulli(_tkeys(keys), p, (37, 3))
    assert got.dtype == torch.bool and tuple(got.shape) == (64, 37, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # row b of the batched call is the call on key b
    np.testing.assert_array_equal(prng.bernoulli(_tkeys(keys[5]), p, (37, 3)).numpy(), want[5])


# ---- noisy_detect -----------------------------------------------------------------

@pytest.mark.parametrize("query_class", [0, None])
@pytest.mark.parametrize("make", ["bdd", "dashcam"])
def test_noisy_detect_bit_equal_both_forms(make, query_class):
    (jr, _), (tr, _) = _repos(make, 0.05)
    keys, frames = _keys_frames(KEYS, jr.total_frames, seed=3)
    ref = jax.jit(jax.vmap(lambda k, f: joracle.noisy_detect(k, jr, f, query_class=query_class)))(
        jnp.asarray(keys), jnp.asarray(frames))
    got = toracle.noisy_detect(_tkeys(keys), tr, torch.from_numpy(frames.astype(np.int64)),
                               query_class=query_class)
    for name in ("valid", "inst_id", "boxes", "feats"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    inst = np.asarray(ref.inst_id)
    # every kind of slot occurs: real detections, false positives, empty slots
    assert (inst >= 0).any() and (inst == -2).any() and (inst == -1).any()
    one = jax.jit(lambda k, f: joracle.noisy_detect(k, jr, f, query_class=query_class))
    for i in range(KEYS):
        t1 = toracle.noisy_detect(_tkeys(keys[i]), tr, torch.tensor(int(frames[i])), query_class=query_class)
        j1 = one(jnp.asarray(keys[i]), jnp.int32(frames[i]))
        for name in ("valid", "inst_id", "boxes", "feats"):
            np.testing.assert_array_equal(getattr(t1, name).numpy(), np.asarray(getattr(j1, name)),
                                          err_msg=f"key {i} {name}")


def test_noisy_detect_rates_and_fp_shape():
    """Misses drop about miss_rate of the visible instances, and false
    positives are unit features in boxes of the reference's ranges."""
    (_, _), (tr, _) = _repos("dashcam", 0.05)
    keys, frames = _keys_frames(KEYS, tr.total_frames, seed=5)
    f = torch.from_numpy(frames.astype(np.int64))
    noisy = toracle.noisy_detect(_tkeys(keys), tr, f, query_class=None, miss_rate=0.3)
    clean = toracle.oracle_detect(tr, f, query_class=None)
    real = (noisy.inst_id >= 0).sum().item() / max(clean.valid.sum().item(), 1)
    assert 0.6 < real < 0.8
    fp = noisy.inst_id == -2
    norms = torch.linalg.vector_norm(noisy.feats[fp], dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)
    b = noisy.boxes[fp]
    assert bool(((b[:, :2] >= 0) & (b[:, :2] < 0.8)).all())
    wh = b[:, 2:] - b[:, :2]
    assert bool(((wh > 0.04) & (wh < 0.21)).all())


@pytest.mark.parametrize("patches", [0, 3])
def test_frame_embedding_within_tolerance(patches):
    (jr, _), (tr, _) = _repos("dashcam", 0.05)
    for frame in (0, 777, jr.total_frames - 1):
        want = np.asarray(joracle.frame_embedding(jr, jnp.int32(frame), dim=32, patches=patches))
        got = toracle.frame_embedding(tr, torch.tensor(frame), dim=32, patches=patches).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---- the searches with the noisy detector -------------------------------------------

def _assert_same_carry(tc, jc):
    for f in ("n1", "n", "frames"):
        np.testing.assert_array_equal(getattr(tc.sampler, f).numpy(), np.asarray(getattr(jc.sampler, f)), err_msg=f)
    for f in MATCHER_FIELDS:
        np.testing.assert_array_equal(getattr(tc.matcher, f).numpy(), np.asarray(getattr(jc.matcher, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tc.key.numpy().astype(np.uint32), np.asarray(jc.key))


@pytest.mark.parametrize("cohorts", [1, 8])
@pytest.mark.parametrize("kind", ["scan", "host"])
def test_noisy_search_matches_reference_exactly(kind, cohorts):
    (jr, jc), (tr, tc) = _repos("dashcam", 0.02)
    plan = dict(result_limit=40, max_steps=240 if cohorts == 1 else 480, cohorts=cohorts, method="pallas",
                trace_every=24, execution=dict(strategy=kind))
    jres = jcore.SearchPlan.from_dict(plan).run(
        jcore.init_carry(jcore.init_state(jc.length), jcore.init_matcher(max_results=RING),
                         jax.random.PRNGKey(3)),
        jc, detector=lambda k, f: joracle.noisy_detect(k, jr, f, query_class=QUERY_CLASS))
    tres = tcore.SearchPlan.from_dict(plan).run(
        tcore.init_carry(tcore.init_state(tc.length, device=CPU), tcore.init_matcher(max_results=RING, device=CPU),
                         prng.PRNGKey(3, device=CPU)),
        tc, detector=lambda k, f: toracle.noisy_detect(k, tr, f, query_class=QUERY_CLASS))
    assert tres.kind == jres.kind == kind
    assert (tres.steps, tres.results, tres.traces) == (jres.steps, jres.results, jres.traces)
    assert dataclasses.asdict(tres.stats) == dataclasses.asdict(jres.stats)
    _assert_same_carry(tres.carry, jres.carry)
    assert jres.results[0] > 0 and len(jres.trace) >= 2
    # false positives are results of a single-query noisy run
    assert int(np.sum(np.asarray(jres.carry.matcher.times_seen) > 0)) > 0


def test_noisy_multi_matches_reference_exactly():
    (jr, jc), (tr, tc) = _repos("dashcam", 0.02)
    classes = (7, 7, 3, 5)
    plan = dict(queries=4, result_limit=10, max_steps=400, cohorts=8, method="pallas", trace_every=32,
                execution=dict(queries_axis=True, cache=-1))
    jkeys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), q) for q in range(4)])
    tkeys = torch.stack([prng.fold_in(prng.PRNGKey(0, device=CPU), q) for q in range(4)])
    jres = jcore.SearchPlan.from_dict(plan).run(
        jcore.init_carry_multi(jcore.init_state(jc.length), jcore.init_matcher(max_results=RING), jkeys),
        jc, detector=lambda k, f: joracle.noisy_detect(k, jr, f, query_class=None),
        select=joracle.class_select(jr, classes))
    tres = tcore.SearchPlan.from_dict(plan).run(
        tcore.init_carry_multi(tcore.init_state(tc.length, device=CPU),
                               tcore.init_matcher(max_results=RING, device=CPU), tkeys),
        tc, detector=lambda k, f: toracle.noisy_detect(k, tr, f, query_class=None),
        select=toracle.class_select(tr, classes))
    assert tres.kind == jres.kind == "multi"
    assert (tres.steps, tres.results, tres.traces) == (jres.steps, jres.results, jres.traces)
    assert dataclasses.asdict(tres.stats) == dataclasses.asdict(jres.stats)
    _assert_same_carry(tres.carry, jres.carry)
    assert jres.stats.cache_hits > 0 and min(jres.results) > 0


# ---- the CLI ----------------------------------------------------------------------

def _counts(out: str) -> list[list[str]]:
    """The numbers of the result lines, wall-clock parts left out."""
    import re

    lines = [line.split(" / est.")[0] for line in out.splitlines() if line.startswith(("ExSample[", "random+:"))]
    return [re.findall(r"[\d,.]+x?", line) for line in lines]


def test_cli_noisy_baseline_matches_reference(capsys, monkeypatch):
    """``--detector noisy --baseline``: the ExSample and random+ lines hold
    the reference CLI's results, frames and savings."""
    from repro.launch import search as jsearch
    from repro_torch.launch import search as tsearch

    args = ["--scale", "0.02", "--query-class", str(QUERY_CLASS), "--detector", "noisy", "--baseline",
            "--plan", '{"result_limit": 20, "max_steps": 600, "cohorts": 8, "method": "pallas"}']
    tsearch.main(["--device", "cpu", *args])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["search", *args])
    jsearch.main()
    ref = capsys.readouterr().out
    assert "random+:" in port and "savings" in port
    assert _counts(port) == _counts(ref) and len(_counts(port)) == 2
