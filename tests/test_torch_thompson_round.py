"""The fused Thompson round (the kernel ``thompson_round``: the key stream's
normals, the Wilson–Hilferty draw and the first-max argmax in one launch)
as plain PyTorch, against the JAX package on the CPU.

The reference's round is ``jax.random.normal(key, (C, M))`` followed by the
Pallas kernel B1 (``thompson_choose``; batched: ``vmap`` of the normal over
Q keys, then B2), here run with ``interpret=True``.  The port's plain
version, ``thompson_round_ref``, must choose the same index on every row,
exactly, and the same value, bit for bit; the values must also be
bit-equal to the port's own composition (``prng.normal`` then
``thompson_ref``).  Both hold with no tolerance because the port's normals
and Wilson–Hilferty draws take their square roots correctly rounded
(``numerics.sqrt32``; PyTorch's CPU ``sqrt`` is not, and with it the
winning normal of a row of a (50, 10000) round came out 2 ulp off JAX's).

``thompson_round_split_ref`` is the kernel's decomposition: each row's
chunks in S contiguous pieces, each piece's first maximum, combined with
the larger value winning and ties to the lower index.  At S = 1, 2, 3 and
8 it must equal the unsplit version exactly, on states built so that whole
rows draw exactly 0 (a fresh chunk's draw is 0 about half the time) and
the tie falls across a split.  The kernel folds ``gamma_params`` into the
launch; its float32 arithmetic, modelled in numpy, must give the same
(α, β, exhausted) bits as ``gamma_params``.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.state import SamplerState as JState
from repro.core.thompson import choose_chunks as j_choose_chunks
from repro.core.thompson import choose_chunks_batched as j_choose_chunks_batched
from repro.core.thompson import gamma_params as j_gamma_params
from repro.kernels.thompson.kernel import thompson_choose as j_thompson_choose
from repro.kernels.thompson.kernel import thompson_choose_batched as j_thompson_choose_batched
from repro_torch.core import prng
from repro_torch.core import thompson as tthompson
from repro_torch.core.state import SamplerState as TState
from repro_torch.kernels.thompson import kernel as t_kernel
from repro_torch.kernels.thompson import ops as t_ops
from repro_torch.kernels.thompson.ref import thompson_ref, thompson_round_ref, thompson_round_split_ref

SPLITS = (1, 2, 3, 8)
CU = Path(t_kernel.__file__).resolve().parents[2] / "csrc" / "thompson_choose.cu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain normal is ~100 small elementwise passes: one intra-op
    thread runs it ~3x faster than eight, and the suite's workers share
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stats(rng, q, m, kind):
    """(n1, n, frames) of ``q`` queries over ``m`` chunks.  ``sampler``: a
    search under way, ~20% of chunks exhausted; ``fresh``: all zero, chunk
    0 exhausted, so whole rows draw 0 and the first live index is 1."""
    if kind == "sampler":
        n1 = rng.integers(0, 30, (q, m)).astype(np.float32)
        n = rng.integers(0, 400, (q, m)).astype(np.float32)
        frames = np.where(rng.random((q, m)) < 0.2, n, n + rng.integers(1, 500, (q, m))).astype(np.int32)
    else:
        n1 = np.zeros((q, m), np.float32)
        n = np.zeros((q, m), np.float32)
        frames = np.full((q, m), 100, np.int32)
        frames[:, 0] = 0 if m > 1 else 100
    return n1, n, frames


def _keys(seeds):
    return np.stack([np.asarray(jax.random.PRNGKey(s)) for s in seeds]).astype(np.uint32)


def _tstate(n1, n, frames, **kw):
    return TState(n1=torch.from_numpy(n1), n=torch.from_numpy(n), frames=torch.from_numpy(frames), **kw)


def _jstate(n1, n, frames, **kw):
    return JState(n1=jnp.asarray(n1), n=jnp.asarray(n), frames=jnp.asarray(frames), **kw)


def _jax_round(keys, n1, n, frames, c, batched):
    """JAX's round: gamma_params with the exhaustion sentinel, the normals,
    then the Pallas kernel in interpret mode.  Returns (idx, val, z)."""
    js = _jstate(n1, n, frames)
    alpha, beta = j_gamma_params(js)
    alpha = jnp.where(js.exhausted(), -1.0, alpha)
    m = n1.shape[-1]
    if batched:
        z = jax.vmap(lambda k: jax.random.normal(k, (c, m)))(jnp.asarray(keys))
        idx, val = j_thompson_choose_batched(alpha, beta, z, interpret=True)
    else:
        z = jax.random.normal(jnp.asarray(keys), (c, m))
        idx, val = j_thompson_choose(alpha, beta, z, interpret=True)
    return np.asarray(idx), np.asarray(val), np.asarray(z)


def _port_composition(key, n1, n, frames, c):
    """prng.normal then thompson_ref, written out."""
    alpha = torch.clamp_min(torch.from_numpy(n1) + 0.1, 0.05)
    alpha = torch.where(torch.from_numpy(n) >= torch.from_numpy(frames).float(), torch.full_like(alpha, -1.0),
                        alpha)
    z = prng.normal(key, (c, n1.shape[-1]))
    return thompson_ref(alpha, torch.from_numpy(n) + 1.0, z) + (z,)


def _assert_matches_jax(ti, tv, tz, ji, jv, jz):
    """Indices, values and the normals themselves bit-equal to JAX's; an
    all-exhausted row is (-1, -1e30)."""
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
    np.testing.assert_array_equal(tz.view(np.int32), jz.view(np.int32))
    dead = ti < 0
    np.testing.assert_array_equal(tv[dead], np.full(int(dead.sum()), -1e30, np.float32))


@pytest.mark.parametrize("kind", ["sampler", "fresh"])
@pytest.mark.parametrize("c,m", [(50, 22), (50, 1000), (7, 1025), (1, 1)])
def test_round_plain_matches_jax(c, m, kind):
    rng = np.random.default_rng(c * 7919 + m)
    n1, n, frames = (x[0] for x in _stats(rng, 1, m, kind))
    key = _keys([c + m])[0]
    ji, jv, jz = _jax_round(key, n1, n, frames, c, batched=False)
    tkey = torch.from_numpy(key.astype(np.int64))
    ti, tv = thompson_round_ref(tkey, _tstate(n1, n, frames), c)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32 and ti.shape == (c,)
    pi, pv, pz = _port_composition(tkey, n1, n, frames, c)
    assert torch.equal(ti, pi) and torch.equal(tv.view(torch.int32), pv.view(torch.int32))
    _assert_matches_jax(ti.numpy(), tv.numpy(), pz.numpy(), ji, jv, jz)


@pytest.mark.parametrize("kind", ["sampler", "fresh"])
@pytest.mark.parametrize("q,c,m", [(8, 50, 22), (3, 7, 1025), (8, 50, 1000)])
def test_round_batched_plain_matches_jax(q, c, m, kind):
    """Q keys at once, the last query with every chunk exhausted: its rows
    give (-1, -1e30), as the Pallas kernel's do (ROADMAP C2)."""
    rng = np.random.default_rng(q * 131 + c * 7 + m)
    n1, n, frames = _stats(rng, q, m, kind)
    n[-1] = frames[-1]
    keys = _keys(range(100, 100 + q))
    ji, jv, jz = _jax_round(keys, n1, n, frames, c, batched=True)
    tkeys = torch.from_numpy(keys.astype(np.int64))
    state = _tstate(n1, n, frames)
    ti, tv = thompson_round_ref(tkeys, state, c)
    assert ti.shape == (q, c)
    assert ti[-1].tolist() == [-1] * c
    alpha, beta, tz = tthompson._kernel_inputs(tkeys, state, c)
    pi, pv = thompson_ref(alpha, beta, tz)
    assert torch.equal(ti, pi) and torch.equal(tv.view(torch.int32), pv.view(torch.int32))
    _assert_matches_jax(ti.numpy(), tv.numpy(), tz.numpy(), ji, jv, jz)
    for i in range(q):
        si, sv = thompson_round_ref(tkeys[i], _tstate(n1[i], n[i], frames[i]), c)
        assert torch.equal(ti[i], si) and torch.equal(tv[i].view(torch.int32), sv.view(torch.int32)), i


@pytest.mark.parametrize("m", [1, 2, 3, 5, 22])
def test_fresh_rows_that_draw_zero_take_the_first_live_index(m):
    """At a fresh state (α = 0.1) a draw is exactly 0 unless z > 0.105;
    with few chunks whole rows draw 0 and must return the first live
    index, 1 here (chunk 0 is exhausted), with the value 0.  With α₀ =
    1e-3 every draw is 0."""
    c = 50
    n1, n, frames = (x[0] for x in _stats(np.random.default_rng(m), 1, m, "fresh"))
    first = 1 if m > 1 else 0
    for alpha0, seed in ((0.1, 3), (1e-3, 4)):
        key = _keys([seed])[0]
        ti, tv = thompson_round_ref(torch.from_numpy(key.astype(np.int64)),
                                    _tstate(n1, n, frames, alpha0=alpha0), c)
        zero = tv == 0.0
        assert bool((ti[zero] == first).all())
        if alpha0 == 1e-3:
            assert bool(zero.all())
        elif m <= 5:
            assert bool(zero.any())
        js = _jstate(n1, n, frames, alpha0=alpha0)
        alpha, beta = j_gamma_params(js)
        alpha = jnp.where(js.exhausted(), -1.0, alpha)
        ji, _ = j_thompson_choose(alpha, beta, jax.random.normal(jnp.asarray(key), (c, m)), interpret=True)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _tie_state(rng, q, m, exhausted_prefix):
    """A fresh state whose first ``exhausted_prefix`` chunks are exhausted,
    so all-zero rows tie at the first live chunk, which can sit on either
    side of a split; α₀ = 1e-3 makes every draw 0 on some queries."""
    n1, n, frames = _stats(rng, q, m, "fresh")
    frames[:, :exhausted_prefix] = 0
    return n1, n, frames


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("q,c,m,prefix", [(1, 50, 22, 8), (1, 50, 22, 7), (3, 7, 1025, 129), (1, 50, 3, 1),
                                          (2, 50, 1000, 334), (2, 5, 9, 3), (1, 1, 1, 0)])
def test_split_equals_unsplit(q, c, m, prefix, splits):
    rng = np.random.default_rng(q + c + m + prefix)
    keys = torch.from_numpy(_keys(range(q)).astype(np.int64))
    for alpha0 in (0.1, 1e-3):
        for n1, n, frames in (_tie_state(rng, q, m, prefix), _stats(rng, q, m, "sampler")):
            state = _tstate(n1, n, frames, alpha0=alpha0)
            want = thompson_round_ref(keys, state, c)
            got = thompson_round_split_ref(keys, state, c, splits)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), m=st.integers(1, 300), c=st.integers(1, 9), splits=st.sampled_from(SPLITS),
       prefix=st.integers(0, 40), alpha0=st.sampled_from([0.1, 0.5, 1e-3]))
def test_split_equals_unsplit_property(seed, m, c, splits, prefix, alpha0):
    rng = np.random.default_rng(seed)
    n1, n, frames = _tie_state(rng, 2, m, min(prefix, m))
    live = rng.random((2, m)) < 0.5
    n1 = np.where(live, rng.integers(0, 5, (2, m)), 0).astype(np.float32)
    state = _tstate(n1, n, frames, alpha0=alpha0)
    keys = torch.from_numpy(_keys([seed % 1000, seed % 997]).astype(np.int64))
    want = thompson_round_ref(keys, state, c)
    got = thompson_round_split_ref(keys, state, c, splits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


def _kernel_gamma(n1, n, frames, alpha0, beta0):
    """The kernel's float32 arithmetic for (α, β, exhausted): α₀, α₀/2 and
    β₀ rounded to float32 on the host, one float32 add each, the clamp, and
    the frames converted to float32 for the comparison."""
    a0, floor, b0 = (np.float32(v) for v in t_kernel._scalars(alpha0, beta0))
    alpha = n1 + a0
    alpha = np.where(alpha < floor, floor, alpha)
    return alpha, n + b0, n >= frames.astype(np.float32)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), alpha0=st.floats(1e-6, 10.0), beta0=st.floats(1e-3, 100.0))
def test_fused_gamma_params_match_the_state(seed, alpha0, beta0):
    rng = np.random.default_rng(seed)
    m = 500
    n1 = np.concatenate([rng.integers(-3, 3000, m), rng.random(m) * 7 - 2]).astype(np.float32)
    n = np.concatenate([rng.integers(0, 3000, m), rng.random(m) * 50]).astype(np.float32)
    frames = rng.integers(0, 3000, 2 * m).astype(np.int32)
    state = _tstate(n1, n, frames, alpha0=alpha0, beta0=beta0)
    alpha, beta = tthompson.gamma_params(state)
    k_alpha, k_beta, k_ex = _kernel_gamma(n1, n, frames, alpha0, beta0)
    np.testing.assert_array_equal(alpha.numpy().view(np.int32), k_alpha.view(np.int32))
    np.testing.assert_array_equal(beta.numpy().view(np.int32), k_beta.view(np.int32))
    np.testing.assert_array_equal(state.exhausted().numpy(), k_ex)


def _cu_constants():
    """Name -> float32 values of the constants the fused kernel declares."""
    src = CU.read_text()
    out = {}
    for name, body in re.findall(r"constexpr float (k\w+) = ([^;]+);", src):
        out[name] = [float.fromhex(body.strip().rstrip("f"))] if "0x" in body else None
    for name, body in re.findall(r"__constant__ float (k\w+)\[\d+\] = \{([^}]*)\}", src):
        out[name] = [float.fromhex(v.strip().rstrip("f")) for v in body.split(",")]
    return out


def test_kernel_constants_are_the_key_streams():
    """Every constant of the kernel's normal is the float32 the plain
    version uses (``prng._f32`` of the same source constant)."""
    f = prng._f32
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    want = {
        "kUniformLo": [lo], "kUniformSpan": [f(np.float32(1.0) - np.float32(lo))],
        "kSqrt2": [f(np.sqrt(2.0))], "kMinNormal": [f(1.17549435e-38)], "kSqrtHalf": [f(prng._SQRTHF)],
        "kLogQ1": [f(prng._LOG_Q1)], "kLogQ2": [f(prng._LOG_Q2)], "kLog1pSmall": [f(0.41421356237309504880)],
        "kLogP": [f(v) for v in prng._LOG_P], "kLog1pNum": [f(v) for v in prng._LOG1P_NUM],
        "kLog1pDen": [f(v) for v in prng._LOG1P_DEN], "kErfinvLt5": [f(v) for v in prng._ERFINV_LT5],
        "kErfinvGe5": [f(v) for v in prng._ERFINV_GE5],
    }
    got = _cu_constants()
    for name, values in want.items():
        assert got.get(name) == values, name


@pytest.mark.parametrize("rows,m,splits", [(50, 1000, 3), (400, 1000, 1), (50, 22, 1), (24, 22, 1),
                                           (7, 1025, 8), (1, 1, 1), (3, 300, 5), (150, 50_000, 1)])
def test_round_splits_fill_the_card(rows, m, splits):
    """On a card of 132 SMs: enough blocks to cover the SMs, at most 8 (a
    cluster), at least 64 chunks a block."""
    assert t_kernel.round_splits(rows, m, 132) == splits


@pytest.mark.parametrize("method", ["pallas", "wilson_hilferty"])
@pytest.mark.parametrize("cohorts", [1, 50])
def test_choose_chunks_match_jax(method, cohorts):
    """The drivers' entry points on a sampler state: ``"pallas"`` (the fused
    round) chooses what JAX's ``"pallas"`` and ``"wilson_hilferty"`` do."""
    rng = np.random.default_rng(cohorts)
    n1, n, frames = _stats(rng, 4, 300, "sampler")
    keys = _keys([1, 2, 3, 4])
    got = tthompson.choose_chunks(torch.from_numpy(keys[0].astype(np.int64)), _tstate(n1[0], n[0], frames[0]),
                                  cohorts=cohorts, method=method)
    want = j_choose_chunks(jnp.asarray(keys[0]), _jstate(n1[0], n[0], frames[0]), cohorts=cohorts, method=method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tthompson.choose_chunks_batched(torch.from_numpy(keys.astype(np.int64)), _tstate(n1, n, frames),
                                          cohorts=cohorts, method=method)
    want = j_choose_chunks_batched(jnp.asarray(keys), _jstate(n1, n, frames), cohorts=cohorts, method=method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_dispatch_runs_the_plain_round_and_launches_nothing():
    t_kernel.thompson_round.launches = 0
    t_kernel.thompson_round_batched.launches = 0
    n1, n, frames = _stats(np.random.default_rng(5), 3, 40, "sampler")
    keys = torch.from_numpy(_keys([7, 8, 9]).astype(np.int64))
    got = t_ops.choose_round(keys[0], _tstate(n1[0], n[0], frames[0]), 6)
    want = thompson_round_ref(keys[0], _tstate(n1[0], n[0], frames[0]), 6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # a key row of a [Q, 3, 2] split, as the multi driver passes it: strided
    split = prng.split(keys, 3)[:, 1]
    got = t_ops.choose_round_batched(split, _tstate(n1, n, frames), 6)
    want = thompson_round_ref(split.contiguous(), _tstate(n1, n, frames), 6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert t_kernel.thompson_round.launches == 0 and t_kernel.thompson_round_batched.launches == 0


def test_round_wrappers_refuse_cpu_tensors():
    """The launch wrappers never fall back: a CPU state is an error, before
    any launch."""
    n1, n, frames = _stats(np.random.default_rng(6), 2, 10, "sampler")
    keys = torch.from_numpy(_keys([1, 2]).astype(np.int64))
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.thompson_round(keys[0], _tstate(n1[0], n[0], frames[0]), 4)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.thompson_round_batched(keys, _tstate(n1, n, frames), 4)
    assert t_kernel.thompson_round.launches == 0 and t_kernel.thompson_round_batched.launches == 0
