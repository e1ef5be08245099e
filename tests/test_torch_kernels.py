"""The port's kernel packages against the JAX reference kernels.

On the CPU the dispatchers run the plain PyTorch versions; these are held
to the reference's ``ref.py`` and to its Pallas kernel run with
``interpret=True``:

* Thompson choice (B1, and B2 over Q queries): indices exact and values
  bit-equal (the Wilson–Hilferty transform has no fused multiply-add
  site).
* IoU matrix (B3): bit-equal to the jitted ``pairwise_iou`` and to the
  interpreted Pallas kernel at the matcher's shapes (both fuse area_b's
  multiply into the add, and so does the port); within 3 ulp at small or
  ragged shapes, where XLA's own evaluation changes with the shape.  The
  batched entry equals the 2-D one on every slice.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.matcher import pairwise_iou as j_pairwise_iou
from repro.kernels.iou_match.kernel import iou_matrix as j_iou_matrix
from repro.kernels.thompson.kernel import thompson_choose as j_thompson_choose
from repro.kernels.thompson.kernel import thompson_choose_batched as j_thompson_choose_batched
from repro.kernels.thompson.ref import thompson_ref as j_thompson_ref
from repro_torch.kernels.iou_match import kernel as t_iou_kernel
from repro_torch.kernels.iou_match import ops as t_iou_ops
from repro_torch.kernels.iou_match.ref import iou_ref
from repro_torch.kernels.thompson import kernel as t_th_kernel
from repro_torch.kernels.thompson import ops as t_th_ops
from repro_torch.kernels.thompson.ref import thompson_ref


def _tricky(m, c, seed, block):
    """Sampler-like (α, β, z) with exhausted sentinels and exact ties that
    straddle Pallas block edges."""
    rng = np.random.default_rng(seed)
    n1 = rng.integers(0, 20, m).astype(np.float32)
    n = rng.integers(0, 300, m).astype(np.float32)
    alpha = np.maximum(n1 + np.float32(0.1), np.float32(0.05))
    beta = n + np.float32(1.0)
    z = rng.standard_normal((c, m)).astype(np.float32)
    alpha[rng.random(m) < 0.25] = -1.0
    # dominant tied pair across a block edge: the lower index must win
    hi = min(block, m - 1)
    lo = hi - 1
    for j in (lo, hi):
        alpha[j], beta[j] = 500.0, 1.0
    z[:, hi] = z[:, lo]
    return alpha, beta, z


@pytest.mark.parametrize("m,c,block", [(130, 4, 64), (64, 3, 64), (300, 5, 128), (1025, 7, 1024), (22, 50, 1024)])
def test_thompson_plain_matches_reference(m, c, block):
    alpha, beta, z = _tricky(m, c, seed=m + c, block=block)
    kidx, kval = j_thompson_choose(jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(z),
                                   block_m=block, interpret=True)
    ridx, rval = jax.jit(j_thompson_ref)(alpha, beta, z)
    tidx, tval = thompson_ref(torch.from_numpy(alpha), torch.from_numpy(beta), torch.from_numpy(z))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(kidx))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(tval.numpy().view(np.int32), np.asarray(kval).view(np.int32))
    np.testing.assert_array_equal(tval.numpy().view(np.int32), np.asarray(rval).view(np.int32))
    assert set(tidx.numpy().tolist()) <= set(np.flatnonzero(alpha > 0).tolist())


def test_thompson_all_exhausted_row_follows_the_kernel():
    """Reference inconsistency: on an all-exhausted row the Pallas kernel
    returns index -1 (its strict '>' never beats the -1e30 start) while
    thompson_ref returns 0 (argmax of an all-equal row).  The port follows
    the kernel.  The drivers never reach this row: their exit test runs
    first."""
    alpha = np.full(40, -1.0, np.float32)
    beta = np.ones(40, np.float32)
    z = np.random.default_rng(0).standard_normal((3, 40)).astype(np.float32)
    kidx, kval = j_thompson_choose(jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(z),
                                   block_m=16, interpret=True)
    ridx, _ = j_thompson_ref(alpha, beta, z)
    assert np.asarray(kidx).tolist() == [-1, -1, -1]
    assert np.asarray(ridx).tolist() == [0, 0, 0]
    tidx, tval = thompson_ref(torch.from_numpy(alpha), torch.from_numpy(beta), torch.from_numpy(z))
    assert tidx.tolist() == [-1, -1, -1]
    np.testing.assert_array_equal(tval.numpy(), np.asarray(kval))


def _batched(q_n, c, m, block, seed):
    """Q queries of ``_tricky`` statistics; the last query is all exhausted."""
    rows = [_tricky(m, c, seed + q, block) for q in range(q_n)]
    alpha = np.stack([r[0] for r in rows])
    beta = np.stack([r[1] for r in rows])
    z = np.stack([r[2] for r in rows])
    alpha[-1] = -1.0
    return alpha, beta, z


@pytest.mark.parametrize("q_n,c,m,block", [(3, 4, 130, 64), (2, 3, 64, 64), (4, 5, 300, 128),
                                           (3, 7, 1025, 1024), (8, 50, 22, 1024), (3, 7, 1025, 256)])
def test_thompson_batched_plain_matches_the_kernel(q_n, c, m, block):
    """B2's plain version against the Pallas kernel in interpret mode, at
    ragged M and several block widths, with an all-exhausted query whose
    rows give (-1, -1e30) as the kernel does (the reference's CPU path,
    ``vmap(thompson_ref)``, gives 0 there: ROADMAP C2)."""
    alpha, beta, z = _batched(q_n, c, m, block, seed=q_n * 100 + m)
    kidx, kval = j_thompson_choose_batched(jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(z),
                                           block_m=block, interpret=True)
    tidx, tval = thompson_ref(torch.from_numpy(alpha), torch.from_numpy(beta), torch.from_numpy(z))
    assert tidx.shape == (q_n, c) and tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(kidx))
    np.testing.assert_array_equal(tval.numpy().view(np.int32), np.asarray(kval).view(np.int32))
    assert tidx[-1].tolist() == [-1] * c
    for q in range(q_n):
        ridx, rval = thompson_ref(*(torch.from_numpy(x[q]) for x in (alpha, beta, z)))
        assert torch.equal(tidx[q], ridx) and torch.equal(tval[q].view(torch.int32), rval.view(torch.int32))


@pytest.mark.parametrize("q_n,d,r", [(8, 16, 8192), (3, 13, 1000), (2, 5, 7), (1, 16, 512)])
def test_iou_batched_plain_equals_the_2d_plain_per_slice(q_n, d, r):
    rng = np.random.default_rng(q_n * 7 + d + r)
    a = np.stack([_boxes(rng, d) for _ in range(q_n)])
    b = np.stack([_boxes(rng, r) for _ in range(q_n)])
    k = min(d, r)
    b[:, :k] = a[:, :k] + rng.normal(0, 0.01, (q_n, k, 4)).astype(np.float32)
    got = iou_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (q_n, d, r)
    for q in range(q_n):
        want = iou_ref(torch.from_numpy(a[q]), torch.from_numpy(b[q]))
        assert torch.equal(got[q].view(torch.int32), want.view(torch.int32))
    assert torch.equal(t_iou_ops.iou(torch.from_numpy(a), torch.from_numpy(b)), got)


def _boxes(rng, k, zero_area=0.15):
    xy = rng.uniform(0.05, 0.75, (k, 2))
    wh = rng.uniform(0.05, 0.2, (k, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    flat = rng.random(k) < zero_area
    b[flat, 2] = b[flat, 0]                     # zero width
    b[rng.random(k) < zero_area, :] = 0.0       # empty ring slots
    return b


def _iou_case(d, r):
    rng = np.random.default_rng(d * 1000 + r)
    a, b = _boxes(rng, d), _boxes(rng, r)
    k = min(d, r)
    b[:k] = a[:k] + rng.normal(0, 0.01, (k, 4)).astype(np.float32)   # real overlaps
    ref = np.asarray(jax.jit(j_pairwise_iou)(a, b))
    interp = np.asarray(j_iou_matrix(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = iou_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    return got, ref, interp


@pytest.mark.parametrize("d,r", [(16, 8192), (13, 1000), (1, 8192), (7, 128), (16, 1024)])
def test_iou_plain_bit_equal_at_matcher_shapes(d, r):
    """At the matcher's ring widths (R a multiple of 8, R >= 128; the CLI
    runs R = 8192) XLA fuses area_b's product into the add in every
    column, as the port does: bit-equal."""
    got, ref, interp = _iou_case(d, r)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), interp.view(np.int32))


@pytest.mark.parametrize("d,r", [(5, 7), (37, 211), (129, 513), (200, 9), (64, 15), (16, 64), (1, 1)])
def test_iou_plain_within_3_ulp_at_ragged_shapes(d, r):
    """At small or ragged R XLA's CPU code changes with the shape (a scalar
    epilogue for the last R mod 8 columns, other vector widths below 128
    columns) and with it which multiply it fuses, so no single float32
    program matches it at every shape.  Measured on these inputs: at most
    3 ulp, on at most 26 of the D·R entries."""
    got, ref, interp = _iou_case(d, r)
    np.testing.assert_array_max_ulp(got, ref, maxulp=3)
    np.testing.assert_array_max_ulp(got, interp, maxulp=3)
    assert int((got != ref).sum()) <= 26


def test_dispatch_on_cpu_runs_plain_versions_and_launches_nothing():
    counted = (t_th_kernel.thompson_choose, t_th_kernel.thompson_choose_batched,
               t_iou_kernel.iou_matrix, t_iou_kernel.iou_matrix_batched)
    for fn in counted:
        fn.launches = 0
    alpha, beta, z = (torch.from_numpy(x) for x in _tricky(50, 4, 1, 16))
    idx, val = t_th_ops.choose(alpha, beta, z)
    ridx, rval = thompson_ref(alpha, beta, z)
    assert torch.equal(idx, ridx) and torch.equal(val, rval)
    alpha, beta, z = (torch.from_numpy(x) for x in _batched(3, 4, 50, 16, seed=1))
    idx, val = t_th_ops.choose_batched(alpha, beta, z)
    ridx, rval = thompson_ref(alpha, beta, z)
    assert torch.equal(idx, ridx) and torch.equal(val, rval)
    a = torch.rand(4, 4)
    assert torch.equal(t_iou_ops.iou(a, a), iou_ref(a, a))
    assert torch.equal(t_iou_ops.iou(a[None], a[None]), iou_ref(a[None], a[None]))
    assert [fn.launches for fn in counted] == [0, 0, 0, 0]


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launch wrappers never fall back: a non-CUDA tensor is an error."""
    with pytest.raises(ValueError, match="CUDA"):
        t_th_kernel.thompson_choose(torch.ones(3), torch.ones(3), torch.ones(2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        t_iou_kernel.iou_matrix(torch.ones(2, 4), torch.ones(3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        t_th_kernel.thompson_choose_batched(torch.ones(2, 3), torch.ones(2, 3), torch.ones(2, 2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        t_iou_kernel.iou_matrix_batched(torch.ones(2, 2, 4), torch.ones(2, 3, 4))
    assert t_th_kernel.thompson_choose.launches == 0
    assert t_th_kernel.thompson_choose_batched.launches == 0
