"""Kernel B5's decomposition of flash decode, in plain PyTorch
(``decode_split_ref``), against the JAX package on the CPU.

B5 splits each sequence's live range [0, live) into ``splits`` shares,
keeps a float32 (m, l, acc) per head and share, and combines the shares
exactly: out = Σ_i exp(m_i − M)·acc_i / max(Σ_i exp(m_i − M)·l_i, 1e-30).
``decode_split_ref`` is that decomposition; here it is held to the
reference's Pallas kernel in interpret mode (with ``block_kv`` the share's
length where T allows) and to its oracle, on the same inputs made with
numpy from a seed, at the reference's kernel-test tolerances: 2e-5 in
float32 and 2e-2 in bfloat16 (both sides do float32 math; they sum in
other orders).

Covered: one share of the whole cache, 3 (a ragged last share), 4 and 8;
cache_len full, partial, 0, negative and mixed; shares with no work (more
shares than live positions); groups of 1, 5 and 48 query heads a KV head.
Also the wrapper's rule for the number of shares and its head groups,
which need no card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.kernel import flash_decode as j_flash_decode
from repro.kernels.flash_decode.ref import decode_ref as j_decode_ref
from repro_torch.kernels.flash_decode import kernel as t_fd_kernel
from repro_torch.kernels.flash_decode.ref import decode_ref, decode_split_ref, split_ranges

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, H, KV, d, T): a group of 1 (gemma-7b's MHA), 5 (qwen2.5-32b's 40
# over 8) and 48 (granite-20b's MQA) query heads a KV head
SHAPES = {1: (4, 4, 4, 16, 96), 5: (4, 10, 2, 32, 120), 48: (2, 48, 1, 16, 64)}


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(a: np.ndarray, dtype: str):
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _cache_len(kind, b, t):
    return {"full": [t] * b, "partial": [t // 3 + 1] * b, "zero": [0] * b, "negative": [-7] * b,
            "mixed": ([0, 1, t, t // 2 + 3] * b)[:b]}[kind]


def _inputs(seed, g, dtype):
    b, h, kv, d, t = SHAPES[g]
    return (_pair(_normal(seed, b, h, d), dtype), _pair(_normal(seed + 1, b, t, kv, d), dtype),
            _pair(_normal(seed + 2, b, t, kv, d), dtype))


def _close(port: torch.Tensor, ref, tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)


def _check(splits, g, lens, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(10 * g + splits, g, dtype)
    t = tk.shape[1]
    cl = np.asarray(_cache_len(lens, tq.shape[0], t), np.int32)
    out = decode_split_ref(tq, tk, tv, torch.from_numpy(cl), splits)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    block = t // splits if t % splits == 0 else t
    kernel = j_flash_decode(jq, jk, jv, jnp.asarray(cl), block_kv=block, interpret=True)
    _close(out, kernel.astype(jnp.float32), TOL[dtype])
    _close(out, j_decode_ref(jq, jk, jv, jnp.asarray(cl)).astype(jnp.float32), TOL[dtype])


@pytest.mark.parametrize("lens", ["full", "partial", "zero", "negative", "mixed"])
@pytest.mark.parametrize("g", [1, 5, 48])
@pytest.mark.parametrize("splits", [1, 3, 4, 8])
def test_split_decode_matches_the_reference_kernel_and_oracle(splits, g, lens):
    _check(splits, g, lens, "float32")


@pytest.mark.parametrize("lens", ["full", "partial", "zero", "negative", "mixed"])
@pytest.mark.parametrize("g", [1, 5, 48])
@pytest.mark.parametrize("splits", [3, 8])
def test_split_decode_in_bfloat16_matches_the_reference_kernel_and_oracle(splits, g, lens):
    _check(splits, g, lens, "bfloat16")


@pytest.mark.parametrize("t,lens,splits,want", [
    (100, [10], 4, [(0, 3), (3, 6), (6, 9), (9, 10)]),          # a ragged last share
    (100, [2], 4, [(0, 1), (1, 2), (2, 2), (2, 2)]),            # shares with no work
    (100, [0], 3, [(0, 34), (34, 68), (68, 100)]),              # empty cache: all of T
    (100, [-3], 1, [(0, 100)]),
    (100, [250], 2, [(0, 50), (50, 100)]),                      # a length past T reads T
    (64, [64], 8, [(8 * i, 8 * i + 8) for i in range(8)]),
])
def test_split_ranges_follow_the_live_length(t, lens, splits, want):
    got = split_ranges(torch.tensor(lens, dtype=torch.int32), t, splits)
    assert [(int(lo[0]), int(hi[0])) for lo, hi in got] == want


@pytest.mark.parametrize("splits", [1, 2, 5, 8])
def test_positions_past_the_cache_length_add_nothing(splits):
    """Shares wholly past cache_len do no work: changing K and V there, to
    values that would swamp the softmax, leaves the output as it was."""
    b, h, kv, d, t = 3, 6, 2, 16, 80
    q, k, v = (torch.from_numpy(_normal(s, *shape)) for s, shape in
               ((1, (b, h, d)), (2, (b, t, kv, d)), (3, (b, t, kv, d))))
    cl = torch.tensor([1, 5, 33], dtype=torch.int32)
    out = decode_split_ref(q, k, v, cl, splits)
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(cl.tolist()):
        k2[i, n:] = 1e4
        v2[i, n:] = -1e4
    torch.testing.assert_close(decode_split_ref(q, k2, v2, cl, splits), out, rtol=0, atol=0)
    torch.testing.assert_close(out, decode_ref(q, k, v, cl), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_an_empty_cache_is_the_mean_of_v_for_every_split_count(splits):
    b, h, kv, d, t = 2, 4, 2, 16, 37
    q, k, v = (torch.from_numpy(_normal(s, *shape)) for s, shape in
               ((4, (b, h, d)), (5, (b, t, kv, d)), (6, (b, t, kv, d))))
    out = decode_split_ref(q, k, v, torch.tensor([0, -1], dtype=torch.int32), splits)
    torch.testing.assert_close(out, v.mean(dim=1).repeat_interleave(h // kv, dim=1), rtol=2e-6, atol=2e-6)


def test_shares_far_below_the_maximum_carry_no_weight():
    """A share whose scores sit far below another's: exp(m_i − M)
    underflows to 0 and the combine equals the one-pass softmax."""
    b, h, kv, d, t = 1, 2, 1, 8, 64
    q = torch.ones(b, h, d)
    k = torch.zeros(b, t, kv, d)
    k[0, :32] = -200.0                                   # the first share's scores: -565.7
    v = torch.from_numpy(_normal(7, b, t, kv, d))
    cl = torch.tensor([t], dtype=torch.int32)
    out = decode_split_ref(q, k, v, cl, 2)
    torch.testing.assert_close(out, decode_ref(q, k, v, cl), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out[0, 0], v[0, 32:, 0].mean(dim=0), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,t,h,kv,want", [
    (4, 2113, 40, 10, 2),      # phi3-medium's serve decode: half the SMs, one wave
    (4, 2113, 16, 16, 2),      # gemma-7b's
    (8, 32768, 40, 10, 8),     # a long cache: one split a 1,024 positions, at most 8
    (4, 8192, 48, 1, 8),       # granite-20b's MQA: 12 groups of 4 heads
    (1, 4096, 48, 1, 6),       # 12 units: half the SMs
    (4, 8192, 40, 8, 8),       # qwen2.5-32b's group of 5: 2 head groups
    (2, 40, 4, 4, 2),          # a short cache: no split shorter than a tile
    (1, 1, 4, 4, 1),
    (256, 2113, 40, 8, 2),     # a wide batch fills the card alone
])
def test_split_count_rule(b, t, h, kv, want):
    assert t_fd_kernel.decode_splits(b, t, h, kv, 132) == want


@pytest.mark.parametrize("g,groups", [(1, 1), (4, 1), (5, 2), (8, 2), (48, 12)])
def test_groups_wider_than_four_heads_take_several_blocks(g, groups):
    assert t_fd_kernel.head_groups(g) == groups
