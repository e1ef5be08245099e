"""State carried from the JAX package into repro_torch (and back) through
``repro_torch.convert``: a search paused in JAX resumes in the port on
exactly the reference's trajectory."""
import dataclasses

import jax
import numpy as np
import torch

from repro import core as jcore
from repro.configs.exsample_paper import dashcam as j_dashcam
from repro.sim import generate as j_generate
from repro.sim.oracle import oracle_detect as j_detect
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch.sim import oracle_detect as t_detect


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _carry_dict(carry) -> dict:
    return {"sampler": _np(carry.sampler), "matcher": _np(carry.matcher),
            "key": np.asarray(carry.key), "step": np.asarray(carry.step),
            "results": np.asarray(carry.results)}


def test_jax_state_resumes_in_the_port():
    jrepo, jchunks = j_generate(j_dashcam(scale=0.02).repo)
    det = lambda k, f: j_detect(jrepo, f, query_class=7)
    carry = jcore.init_carry(jcore.init_state(jchunks.length), jcore.init_matcher(max_results=128),
                             jax.random.PRNGKey(9))
    first = jcore.SearchPlan(result_limit=4, max_steps=96, cohorts=8, method="pallas").run(
        carry, jchunks, detector=det)
    second = dict(result_limit=9, max_steps=400, cohorts=8, method="pallas", trace_every=32)
    ref = jcore.SearchPlan.from_dict(second).run(first.carry, jchunks, detector=det)

    trepo = convert.repository_from_numpy(_np(jrepo), device="cpu")
    tchunks = convert.chunks_from_numpy(_np(jchunks), device="cpu")
    tcarry = convert.carry_from_numpy(_carry_dict(first.carry), device="cpu")
    got = tcore.SearchPlan.from_dict(second).run(
        tcarry, tchunks, detector=lambda k, f: t_detect(trepo, f, query_class=7))
    assert got.steps == ref.steps and got.results == ref.results and got.trace == ref.trace

    back = convert.to_numpy(got.carry)
    want = _carry_dict(ref.carry)
    for part in ("sampler", "matcher"):
        for name, value in want[part].items():
            assert np.array_equal(np.asarray(back[part][name]), value), (part, name)
    assert back["key"].dtype == np.uint32 and np.array_equal(back["key"], want["key"])
    assert int(back["step"]) == int(want["step"]) and int(back["results"]) == int(want["results"])


def test_repository_and_chunks_round_trip():
    jrepo, jchunks = j_generate(j_dashcam(scale=0.02).repo)
    trepo = convert.repository_from_numpy(_np(jrepo), device="cpu")
    tchunks = convert.chunks_from_numpy(_np(jchunks), device="cpu")
    for name, value in _np(jrepo).items():
        assert np.array_equal(np.asarray(convert.to_numpy(trepo)[name]), value), name
    for name, value in _np(jchunks).items():
        assert np.array_equal(convert.to_numpy(tchunks)[name], value), name
    assert convert.to_numpy(tchunks)["start"].dtype == np.int32


def _cache_dict(cache) -> dict:
    return {"tag": np.asarray(cache.tag), "store": {f: np.asarray(v) for f, v in cache.store._asdict().items()}}


def test_jax_multi_carry_and_cache_resume_one_round_in_the_port():
    """A multi-query carry and its DetectionCache, paused in JAX, resume in
    the port: one more round in each package gives the same carry, cache,
    detector calls and cache hits; and both convert back to the
    reference's numpy form."""
    from repro.core import exsample as jex
    from repro_torch.core import exsample as tex
    from repro_torch.sim import class_select as t_class_select

    from repro.sim.oracle import class_select as j_class_select

    jrepo, jchunks = j_generate(j_dashcam(scale=0.02).repo)
    classes = [7, 3, 7]
    keys = jax.numpy.stack([jax.random.fold_in(jax.random.PRNGKey(2), q) for q in range(3)])
    jcarry = jcore.init_carry_multi(jcore.init_state(jchunks.length), jcore.init_matcher(max_results=128), keys)
    jdet = lambda k, f: j_detect(jrepo, f, query_class=None)
    jsel = j_class_select(jrepo, classes)
    mid, _, ms = jex._multi_search(jcarry, jchunks, detector=jdet, select=jsel, result_limits=[30, 2, 30],
                                   max_steps=64, cohorts=8, method="pallas", cache_frames=jchunks.total_frames)
    jcache = ms["final_cache"]
    active = (mid.results < jax.numpy.asarray([30, 2, 30])) & (mid.step < 10_000)
    assert np.asarray(active).tolist() == [True, False, True]
    want, wcache, wcalls, whits, _ = jex._multi_round(mid, jcache, jchunks, active, detector=jdet, select=jsel,
                                                      cohorts=8, method="pallas")

    trepo = convert.repository_from_numpy(_np(jrepo), device="cpu")
    tchunks = convert.chunks_from_numpy(_np(jchunks), device="cpu")
    tcarry = convert.carry_from_numpy(_carry_dict(mid), device="cpu")
    tcache = convert.cache_from_numpy(_cache_dict(jcache), device="cpu")
    assert tcarry.key.shape == (3, 2) and tcache.capacity == jchunks.total_frames
    got, gcache, gcalls, ghits, _ = tex._multi_round(
        tcarry, tcache, tchunks, torch.from_numpy(np.array(active)),
        detector=lambda k, f: t_detect(trepo, f, query_class=None), select=t_class_select(trepo, classes),
        cohorts=8, method="pallas")
    assert (int(gcalls), int(ghits)) == (int(wcalls), int(whits)) and int(whits) > 0

    back, ref = convert.to_numpy(got), _carry_dict(want)
    for part in ("sampler", "matcher"):
        for name, value in ref[part].items():
            assert np.array_equal(np.asarray(back[part][name]), value), (part, name)
    for name in ("key", "step", "results"):
        assert back[name].dtype == np.asarray(ref[name]).dtype and np.array_equal(back[name], ref[name]), name
    cback, cref = convert.to_numpy(gcache), _cache_dict(wcache)
    assert np.array_equal(cback["tag"], cref["tag"])
    for name, value in cref["store"].items():
        assert np.array_equal(cback["store"][name], value), name
