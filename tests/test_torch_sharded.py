"""The sharded kind (``sharded``, DESIGN.md §8) of repro_torch against the
JAX package, on the CPU.

Each case of ``tests/_mesh_cases.py::SHARDED`` runs one query through
``SearchPlan.run`` in both packages: S = 1 against JAX in this process,
S = 2 and 8 against the file's JAX child with 8 forced host devices.
sync_every 1 and 4, cohorts S and 2S, M = 16 and M = 15 (which divides by
no S > 1), and a 70-frame world that every search exhausts (dead cohorts,
dead shards).  The port must equal the reference bit for bit: steps,
results, the trace, every ``SearchStats`` field (merges, ring high water,
overflow), the sampler, the ring and the key.
"""
import numpy as np
import pytest
import torch

import _mesh_cases as mc
from _mesh_cases import one_intra_op_thread  # noqa: F401
from repro_torch.core import PlanError, SearchPlan, init_carry, init_matcher, init_state, prng
from repro_torch.core.exsample import _sharded_search
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.sim import RepoSpec, generate, oracle_detect


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return mc.reference(["sharded"], tmp_path_factory.mktemp("sharded"))


@pytest.mark.parametrize("case", list(mc.SHARDED))
def test_sharded_equals_jax(request, case):
    got = mc.run("torch", "sharded", case)
    if mc.mesh_size("sharded", case) > 1:
        want = request.getfixturevalue("ref")[("sharded", case)]
    else:
        want = mc.run("jax", "sharded", case)
    mc.assert_same(got, want)
    # the reference's invariants after the final sync
    assert int(got["step"]) == int(got["n"].sum())
    assert int((got["ring.times_seen"] > 0).sum()) == int(got["results"])
    assert tuple(got["trace0"][-1]) == (int(got["step"]), int(got["results"]))


def _world(name="b"):
    repo, chunks = generate(RepoSpec(**mc.WORLDS[name]), device="cpu")
    return chunks, (lambda k, f: oracle_detect(repo, f, query_class=0))


def _carry(chunks):
    return init_carry(init_state(chunks.length, device="cpu"), init_matcher(max_results=mc.RING, device="cpu"),
                      prng.PRNGKey(0, device="cpu"))


def test_padding_is_trimmed_and_the_run_stops_at_a_sync_boundary():
    """M = 15 over 4 shards is padded to 16 and trimmed back; the search
    stops at the first sync boundary past the limit (the reference's
    overshoot of at most one window)."""
    chunks, det = _world()
    out, trace, stats = _sharded_search(_carry(chunks), chunks, mesh=make_data_mesh(4, device="cpu"), detector=det,
                                        result_limit=45, max_steps=400, cohorts=8, sync_every=2)
    assert out.sampler.num_chunks == chunks.num_chunks == 15
    assert int(out.step) % 16 == 0 and int(out.results) >= 45
    assert stats["merges"] == len(trace) == int(out.step) // 16
    assert len(trace) >= 2 and trace[-2][1] < 45


def test_sharded_rejects_bad_geometry():
    chunks, det = _world()
    mesh = make_data_mesh(2, device="cpu")
    for cohorts, sync in ((3, 1), (1, 1), (0, 1), (2, 0)):
        with pytest.raises(ValueError, match="cohorts|sync_every"):
            _sharded_search(_carry(chunks), chunks, mesh=mesh, detector=det, result_limit=1, max_steps=8,
                            cohorts=cohorts, sync_every=sync)
    plan = SearchPlan.from_dict(dict(result_limit=5, max_steps=50, cohorts=4, execution=dict(shards=4)))
    with pytest.raises(PlanError, match="shards"):
        plan.run(_carry(chunks), chunks, detector=det, mesh=mesh)


def test_the_mesh_kind_runs_on_the_carry_device_by_default():
    chunks, det = _world()
    res = SearchPlan.from_dict(dict(result_limit=10, max_steps=64, cohorts=4, execution=dict(shards=2))).run(
        _carry(chunks), chunks, detector=det)
    assert res.kind == "sharded" and res.carry.sampler.n1.device == torch.device("cpu")
    same = SearchPlan.from_dict(dict(result_limit=10, max_steps=64, cohorts=4, execution=dict(shards=2))).run(
        _carry(chunks), chunks, detector=det, mesh=make_data_mesh(2, device="cpu"))
    assert res.traces == same.traces and np.array_equal(res.carry.sampler.n.numpy(), same.carry.sampler.n.numpy())
