"""The port's data mesh, its collectives and its sharded Thompson choice,
held to the JAX package on the CPU.

``DataMesh`` and ``make_data_mesh``; ``all_gather``, ``psum`` and
``all_to_all`` against ``jax.lax``'s under ``shard_map`` at S = 8;
``pad_chunks`` and ``shard_sampler_state``; and ``local_cohort_winners``
(single and batched, through the fused round's wrapper and through the
plain shard body) against the reference's at S = 1 in this process and at
S = 2 and 8 in the file's JAX child (``tests/_mesh_cases.py``), on
statistics with an exhausted shard and with every chunk exhausted.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import _mesh_cases as mc
from _mesh_cases import one_intra_op_thread  # noqa: F401
from repro.core import distributed as jdist
from repro.core.state import SamplerState as JState
from repro_torch.core import distributed as tdist
from repro_torch.core.state import SamplerState as TState
from repro_torch.launch.mesh import DataMesh, describe, make_data_mesh

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return mc.reference(["winners", "collectives"], tmp_path_factory.mktemp("mesh"))


# ---- the mesh ---------------------------------------------------------------


def test_make_data_mesh_on_the_cpu():
    mesh = make_data_mesh(4, device="cpu")
    assert isinstance(mesh, DataMesh)
    assert mesh.size == 4 and mesh.shape == {"data": 4} and mesh.axis == "data"
    assert mesh.devices == (CPU,) * 4 and mesh.device == CPU
    assert "mesh(4,)" in describe(mesh)
    with pytest.raises(ValueError, match="num_shards"):
        make_data_mesh(0, device="cpu")


def test_make_data_mesh_defaults_to_the_card():
    """No device: the shards go on the card; without one this raises and
    never falls back to the CPU."""
    if torch.cuda.is_available():
        mesh = make_data_mesh(2)
        assert all(d.type == "cuda" for d in mesh.devices)
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            make_data_mesh(2)


# ---- collectives -------------------------------------------------------------


@pytest.mark.parametrize("name", ["all_gather", "psum", "all_to_all"])
def test_collectives_equal_jax_at_8_shards(ref, name):
    got = mc.run("torch", "collectives")
    mc.assert_same(got, ref[("collectives", "")], [name])


def test_collectives_place_each_result_on_its_shard():
    mesh = make_data_mesh(3, device="cpu")
    # shard s's row h holds 10·s + h: all_to_all sends it to shard h
    xs = [10 * s + torch.arange(3, dtype=torch.int32) for s in range(3)]
    for out in (tdist.all_gather(xs, mesh), tdist.psum(xs, mesh), tdist.all_to_all(xs, mesh)):
        assert len(out) == 3 and all(o.device == CPU for o in out)
    assert tdist.psum(xs, mesh)[2].tolist() == [30, 33, 36]
    assert tdist.all_gather(xs, mesh)[0][:, 1].tolist() == [1, 11, 21]
    assert [o.tolist() for o in tdist.all_to_all(xs, mesh)] == [[0, 10, 20], [1, 11, 21], [2, 12, 22]]


# ---- padded and sharded statistics ---------------------------------------------


def _states(n1, n, frames):
    return (JState(n1=jnp.asarray(n1), n=jnp.asarray(n), frames=jnp.asarray(frames)),
            TState(n1=torch.as_tensor(n1), n=torch.as_tensor(n), frames=torch.as_tensor(frames)))


@settings(max_examples=25, deadline=None)
@given(m=st.integers(1, 20), s=st.integers(1, 8), q=st.sampled_from([0, 1, 3]), seed=st.integers(0, 2**16))
def test_pad_chunks_equals_jax(m, s, q, seed):
    rng = np.random.default_rng(seed)
    lead = (q,) if q else ()
    frames = rng.integers(0, 30, lead + (m,)).astype(np.int32)
    n = rng.integers(0, 30, lead + (m,)).astype(np.float32)
    n1 = rng.integers(-2, 5, lead + (m,)).astype(np.float32)
    js, ts = _states(n1, n, frames)
    jp, tp = jdist.pad_chunks(js, s), tdist.pad_chunks(ts, s)
    for f in ("n1", "n", "frames"):
        assert np.array_equal(np.asarray(getattr(jp, f)), getattr(tp, f).numpy()), f
    assert tp.n1.shape[-1] % s == 0


def test_shard_sampler_state_slices_the_chunk_axis():
    mesh = make_data_mesh(4, device="cpu")
    st_ = TState(n1=torch.arange(8.0)[None].repeat(2, 1), n=torch.zeros(2, 8), frames=torch.ones(2, 8, dtype=torch.int32))
    shards = tdist.shard_sampler_state(st_, mesh)
    assert [s.n1[0].tolist() for s in shards] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert all(s.n1.is_contiguous() and s.frames.dtype == torch.int32 for s in shards)
    with pytest.raises(ValueError, match="pad_chunks"):
        tdist.shard_sampler_state(dataclasses.replace(st_, n1=st_.n1[:, :7], n=st_.n[:, :7],
                                                      frames=st_.frames[:, :7]), mesh)


# ---- the sharded choice ------------------------------------------------------


@pytest.mark.parametrize("case", list(mc.WINNERS))
def test_local_cohort_winners_equal_jax(request, case):
    """The fused round's wrapper (its plain version on the CPU) and the
    reference's shard body op by op both give JAX's winners, scores and
    rank bases bit for bit, with shard 0 all exhausted (at S = 1, the
    first half of the chunks) and, in the "dead" cases, every chunk
    everywhere (−inf scores, chunk 0)."""
    got = mc.run("torch", "winners", case)
    if mc.mesh_size("winners", case) > 1:
        want = request.getfixturevalue("ref")[("winners", case)]
    else:
        want = mc.run("jax", "winners", case)
    mc.assert_same(got, want)
    mc.assert_same({k: got["plain." + k] for k in ("ids", "scores", "ns")}, want, ["ids", "scores", "ns"])
    if case.endswith("dead"):
        assert np.isneginf(got["scores"]).all() and (got["ids"] == 0).all()
    else:
        dead = mc.WINNERS[case][0] // max(mc.mesh_size("winners", case), 2)
        assert np.isfinite(got["scores"]).all() and (got["ids"] >= dead).all()


def test_shard_winners_maps_the_kernel_marks_back():
    """A shard with no live chunk: the fused round's −1 / −1e30 become the
    reference's local winner 0 and score −inf, so its global id is
    ``shard_id · M/S``."""
    view = TState(n1=torch.zeros(5), n=torch.full((5,), 3.0), frames=torch.full((5,), 3, dtype=torch.int32))
    key = torch.tensor([0, 7])
    ids, scores, ns = tdist.shard_winners(key, view, 2, 3)
    assert ids.tolist() == [10, 10, 10] and np.isneginf(scores.numpy()).all() and ns.tolist() == [3.0] * 3
    assert [t.tolist() for t in tdist.shard_winners_ref(key, view, 2, 3)] == [t.tolist() for t in (ids, scores, ns)]


def test_straggler_robust_rounds_equals_jax():
    lat = np.asarray([0.1, 0.4, 0.25, 1.3], np.float32)
    for sync in (0, 1, 4):
        want = np.asarray(jdist.straggler_robust_rounds(jnp.asarray(lat), sync, 0.2))
        got = tdist.straggler_robust_rounds(lat, sync, 0.2).numpy()
        assert np.array_equal(got, want), (sync, got, want)


# ---- the frame stores (A12's last module) ----------------------------------------


@pytest.fixture(scope="module")
def stores():
    from repro.data.framestore import SimFrameStore as JStore
    from repro.sim import RepoSpec as JSpec
    from repro.sim import generate as j_generate
    from repro_torch.data import SimFrameStore
    from repro_torch.sim import RepoSpec, generate

    spec = dict(video_lengths=[50], num_instances=5, chunk_frames=10, seed=3)
    return (JStore(repo=j_generate(JSpec(**spec))[0], embed_dim=8),
            SimFrameStore(repo=generate(RepoSpec(**spec), device="cpu")[0], embed_dim=8))


@pytest.mark.parametrize("num_hosts", [1, 4, 7])
def test_frame_stores_equal_jax(stores, num_hosts):
    """50 frames over 4 hosts: the last stripe is short; ids past the end
    are no host's; payloads within 1e-5 (``frame_embedding``'s sin), masks,
    owners and decode costs exactly."""
    from repro.data.framestore import ShardedFrameStore as JSharded
    from repro_torch.data import ShardedFrameStore

    js, ts = stores
    ids = np.asarray([0, 12, 13, 25, 26, 38, 39, 49, 50, 62], np.int32)
    np.testing.assert_allclose(ts.fetch(torch.as_tensor(ids)).numpy(), np.asarray(js.fetch(jnp.asarray(ids))),
                               rtol=0, atol=1e-5)
    assert np.array_equal(ts.decode_cost(torch.as_tensor(ids)).numpy(), np.asarray(js.decode_cost(jnp.asarray(ids))))
    owners = np.zeros(ids.shape, int)
    for h in range(num_hosts):
        j, t = JSharded(inner=js, host_id=h, num_hosts=num_hosts), ShardedFrameStore(inner=ts, host_id=h,
                                                                                      num_hosts=num_hosts)
        (jp, jm), (tp, tm) = j.fetch(jnp.asarray(ids)), t.fetch(torch.as_tensor(ids))
        assert np.array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
        assert (tp.numpy()[~tm.numpy()] == 0).all()
        assert np.array_equal(t.local_mask(torch.as_tensor(ids)).numpy(), np.asarray(j.local_mask(jnp.asarray(ids))))
        assert np.array_equal(t.owner_of(torch.as_tensor(ids)).numpy(), np.asarray(j.owner_of(jnp.asarray(ids))))
        assert np.array_equal(t.decode_cost(torch.as_tensor(ids)).numpy(),
                              np.asarray(j.decode_cost(jnp.asarray(ids))))
        owners += tm.numpy()
    assert (owners[ids < 50] == 1).all() and (owners[ids >= 50] == 0).all()
