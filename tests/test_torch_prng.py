"""Parity of repro_torch's key stream with jax.random (threefry2x32,
partitionable mode).

Integer outputs (keys, split, fold_in, raw bits), uniforms and normals
must be bit-exact.  Normals go through XLA's float32 ErfInv and XLA CPU's
log1p, which the port rebuilds with the same fused multiply-adds, and
ErfInv's w ≥ 5 branch (|z| > 2.9) through a square root: the port takes it
with ``numerics.sqrt32``, since PyTorch's CPU ``sqrt`` is not correctly
rounded (with it, 1.3e-5 of 4M draws came out 1-2 ulp off).  Over 4M
draws (20 keys × 200×1000) every normal now equals the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng


def _tk(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_jax_runs_threefry_partitionable():
    # the port reproduces the partitionable key stream only
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 7919, 2**31 - 1, -1, -12345])
def test_prngkey(seed):
    np.testing.assert_array_equal(_u32(prng.PRNGKey(seed, device="cpu")), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [0, 3, 99])
@pytest.mark.parametrize("num", [1, 2, 3, 8, 50])
def test_split(seed, num):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(prng.split(_tk(key), num)), np.asarray(jax.random.split(key, num)))


@pytest.mark.parametrize("data", [0, 1, 12345, 2**31 - 1, 2**32 - 1])
def test_fold_in(data):
    key = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(
        _u32(prng.fold_in(_tk(key), data)),
        np.asarray(jax.random.fold_in(key, np.uint32(data))))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (50, 22), (50, 1001), (2, 3, 4)])
@pytest.mark.parametrize("seed", [0, 5])
def test_random_bits(shape, seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        _u32(prng.random_bits(_tk(key), shape)), np.asarray(jax.random.bits(key, shape)))


@pytest.mark.parametrize("shape", [(50, 22), (7, 1025), (1000,)])
def test_uniform_bit_exact(shape):
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jax.jit(lambda k: jax.random.uniform(k, shape))(key))
        got = prng.uniform(_tk(key), shape).numpy()
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_normal_within_stated_ulp_bound():
    """The stated bound is 0 ulp: every normal equals the reference's."""
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jax.jit(lambda k: jax.random.normal(k, (64, 1001)))(key))
        got = prng.normal(_tk(key), (64, 1001)).numpy()
        ulp = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
        assert ulp.max() == 0, f"seed {seed}: {int((ulp > 0).sum())} normals differ, by up to {ulp.max()} ulp"


def test_driver_key_sequence():
    """The drivers' exact use: split(carry.key, 3), then normal(k_choice,
    (cohorts, M)) and split(k_det, cohorts)."""
    key = jax.random.PRNGKey(2024)
    tkey = _tk(key)
    for _ in range(5):
        key, k_choice, k_det = jax.random.split(key, 3)
        t3 = prng.split(tkey, 3)
        tkey, tc, td = t3[0], t3[1], t3[2]
        np.testing.assert_array_equal(_u32(tkey), np.asarray(key))
        np.testing.assert_array_equal(_u32(prng.split(td, 8)), np.asarray(jax.random.split(k_det, 8)))
        ref = np.asarray(jax.jit(lambda k: jax.random.normal(k, (8, 22)))(k_choice))
        got = prng.normal(tc, (8, 22)).numpy()
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_log1p_matches_xla_cpu():
    """XLA CPU's own float32 log1p (both of its branches) is rebuilt bit for bit."""
    x = np.random.default_rng(0).uniform(-0.9999, 3.0, 200_000).astype(np.float32)
    ref = np.asarray(jax.jit(jnp.log1p)(x))
    got = prng._xla_log1p_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_batched_keys_equal_their_rows_and_jax_vmap():
    """A leading [Q] key axis: row q equals the single-key call bit for bit,
    and the whole equals ``jax.vmap`` of the reference."""
    jkeys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(0), q) for q in range(5)])
    tkeys = torch.stack([prng.fold_in(prng.PRNGKey(0, device="cpu"), q) for q in range(5)])
    np.testing.assert_array_equal(_u32(tkeys), np.asarray(jkeys))
    np.testing.assert_array_equal(_u32(prng.split(tkeys, 3)), np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(jkeys)))
    np.testing.assert_array_equal(_u32(prng.fold_in(tkeys, 9)),
                                  np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 9))(jkeys)))
    np.testing.assert_array_equal(_u32(prng.random_bits(tkeys, (3, 7))),
                                  np.asarray(jax.vmap(lambda k: jax.random.bits(k, (3, 7)))(jkeys)))
    z = prng.normal(tkeys, (50, 22))
    assert z.shape == (5, 50, 22)
    ref = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.normal(k, (50, 22))))(jkeys))
    np.testing.assert_array_equal(z.numpy().view(np.int32), ref.view(np.int32))
    for q in range(5):
        assert torch.equal(prng.split(tkeys, 3)[q], prng.split(tkeys[q], 3))
        assert torch.equal(prng.fold_in(tkeys, 9)[q], prng.fold_in(tkeys[q], 9))
        assert torch.equal(z[q].view(torch.int32), prng.normal(tkeys[q], (50, 22)).view(torch.int32))
