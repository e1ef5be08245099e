"""Kernel B6's plain version (``repro_torch.kernels.ssd_scan``) against the
JAX package's SSD chunk scan, on the CPU.

Same inputs, made with numpy from a seed, through both packages: the
Pallas kernel ``ssd_scan_kernel`` in interpret mode and its oracle
``ssd_ref`` (the kernel's ``[BH, S, .]`` layout, which the port reads as
B = BH, H = 1 with a decay per row), and the model's
``repro.models.mamba2.ssd_scan`` (the model's layout, and the final state,
which the Pallas kernel drops).  ``ssd_chunked_ref``, the same function in
kernel B6's five phases, is held to both.  Tolerance 2e-4, the reference's own for
its kernel against its oracle (``tests/test_kernels.py``): both sides are
float32 and sum in other orders; the port sums the chunk's cumulative
log-decay in float64 (see ``ref.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro.kernels.ssd_scan.ref import ssd_ref as j_ssd_ref
from repro.models import mamba2 as jm
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.kernel import ssd_scan as ssd_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_ref
from repro_torch.models import mamba2 as tm

TOL = 2e-4


def _kernel_inputs(seed, bh, s, p, n, *, a_log_mean=0.0, a_log_scale=0.3):
    """x [BH,S,P], dt [BH,S] after softplus, B/C [BH,S,N], a [BH] < 0, as
    ``tests/test_kernels.py::test_ssd_scan_sweep`` draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, s, p)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(rng.standard_normal((bh, s)).astype(np.float32)))
    bm = (0.3 * rng.standard_normal((bh, s, n))).astype(np.float32)
    cm = (0.3 * rng.standard_normal((bh, s, n))).astype(np.float32)
    a = (-np.exp(a_log_mean + a_log_scale * rng.standard_normal(bh))).astype(np.float32)
    return x, dt, bm, cm, a


def _model_inputs(seed, b, s, h, p, n):
    """x [B,S,H,P], dt [B,S,H], B/C [B,S,N] as column slices of one
    [B,S,2N] array (as the model splits its bc projection), a_log [H]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(rng.standard_normal((b, s, h)).astype(np.float32)))
    bc = (0.3 * rng.standard_normal((b, s, 2 * n))).astype(np.float32)
    a_log = (0.3 * rng.standard_normal(h)).astype(np.float32)
    return x, dt, bc, a_log


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _as_rows(x, dt, bm, cm, a):
    """The Pallas kernel's [BH, S, .] inputs in the port's layout: B = BH
    rows of one head each, a [BH, 1] a decay per row."""
    return x[:, :, None], dt[:, :, None], bm, cm, a[:, None]


def _rows_ref(x, dt, bm, cm, a, *, chunk):
    """The plain version on [BH, S, .] inputs → (y [BH,S,P], state [BH,P,N])."""
    y, hs = ssd_ref(*_as_rows(x, dt, bm, cm, a), chunk=chunk)
    return y[:, :, 0], hs[:, 0]


def _against_the_kernel_and_its_oracle(inputs, chunk):
    y, _ = _rows_ref(*_t(*inputs), chunk=chunk)
    kernel = np.asarray(ssd_scan_kernel(*_j(*inputs), chunk=chunk, interpret=True))
    oracle = np.asarray(j_ssd_ref(*_j(*inputs), chunk=chunk))
    assert y.shape == kernel.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), kernel, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y.numpy(), oracle, rtol=TOL, atol=TOL)
    return y


# the reference's sweep (tests/test_kernels.py): shapes (BH, S, P, N), chunks 16 and 32
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("shape", [(2, 64, 8, 16), (3, 128, 16, 32)])
def test_plain_matches_the_pallas_kernel_and_its_oracle(chunk, shape):
    _against_the_kernel_and_its_oracle(_kernel_inputs(sum(shape) + chunk, *shape), chunk)


@pytest.mark.parametrize("chunk", [64, 256])
def test_one_chunk(chunk):
    """S == Q (chunk 64), and a chunk longer than S, cut to S as
    min(chunk, S) does: the state never carries."""
    _against_the_kernel_and_its_oracle(_kernel_inputs(5, 2, 64, 8, 16), chunk)


def test_strong_decay_underflows_as_the_reference():
    """a ≈ -8: exp(acs) underflows to 0 inside every chunk, and the
    exp(acs_t - acs_s) of distant pairs too."""
    inputs = _kernel_inputs(6, 3, 128, 16, 32, a_log_mean=np.log(8.0), a_log_scale=0.05)
    x, dt, _, _, a = inputs
    acs = np.cumsum((dt * a[:, None]).reshape(3, 4, 32), axis=-1)
    assert (np.exp(acs[:, :, -1]) == 0.0).all()            # the whole-chunk decay underflows
    y = _against_the_kernel_and_its_oracle(inputs, 32)
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("chunk", [16, 64])
def test_model_layout_and_final_state_match_the_reference(chunk):
    """The model's layout (B/C shared by the heads, read as column slices)
    through ``repro_torch.models.mamba2.ssd_scan``: y and the final state
    against ``repro.models.mamba2.ssd_scan``, over four chunks and one."""
    b, s, h, p, n = 2, 64, 3, 8, 16
    x, dt, bc, a_log = _model_inputs(7, b, s, h, p, n)
    tx, tdt, tbc, ta = _t(x, dt, bc, a_log)
    bm, cm = tbc[..., :n], tbc[..., n:]
    assert not bm.is_contiguous()
    y, hs = tm.ssd_scan(tx, tdt, bm, cm, ta, chunk=chunk)
    jy, jh = jm.ssd_scan(*_j(x, dt, bc[..., :n], bc[..., n:], a_log), chunk=chunk)
    assert y.shape == (b, s, h, p) and hs.shape == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jh), rtol=TOL, atol=TOL)


def test_kernel_layout_final_state_matches_the_reference():
    """The ``[BH, .]`` rows' final state: each row against the model's
    ``ssd_scan`` run on it alone (B = 1, H = 1, a_log = log(-a))."""
    x, dt, bm, cm, a = _kernel_inputs(9, 3, 128, 16, 32)
    _, hs = _rows_ref(*_t(x, dt, bm, cm, a), chunk=32)
    assert hs.shape == (3, 16, 32)
    for i in range(3):
        _, jh = jm.ssd_scan(jnp.asarray(x[i][None, :, None]), jnp.asarray(dt[i][None, :, None]),
                            jnp.asarray(bm[i][None]), jnp.asarray(cm[i][None]),
                            jnp.log(-jnp.asarray(a[i:i + 1])), chunk=32)
        np.testing.assert_allclose(hs[i].numpy(), np.asarray(jh)[0, 0], rtol=TOL, atol=TOL)


def test_the_two_layouts_agree():
    """The model's layout equals the Pallas kernel's rows with B/C repeated
    per head and a per row: one function, two ways of reading it."""
    b, s, h, p, n = 2, 64, 3, 8, 16
    x, dt, bc, a_log = _t(*_model_inputs(10, b, s, h, p, n))
    a = -torch.exp(a_log)
    y, hs = ssd_ref(x, dt, bc[..., :n], bc[..., n:], a, chunk=32)
    rows = lambda t: t.transpose(1, 2).reshape(b * h, s, *t.shape[3:])            # noqa: E731
    per_head = lambda t: t[:, None].expand(b, h, s, n).reshape(b * h, s, n)       # noqa: E731
    yk, hk = _rows_ref(rows(x), rows(dt), per_head(bc[..., :n]), per_head(bc[..., n:]),
                       a.repeat(b), chunk=32)
    torch.testing.assert_close(rows(y), yk, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(hs.reshape(b * h, p, n), hk, rtol=1e-6, atol=1e-6)


def _sequential(x, dt, bm, cm, a):
    """h_t = exp(dt_t a) h_{t-1} + dt_t x_t ⊗ B_t from h = 0; y_t = h_t C_t
    (model layout, float64): the recurrence the chunked scan computes."""
    b, s, h, p = x.shape
    hs = np.zeros((b, h, p, bm.shape[-1]))
    ys = np.zeros((b, s, h, p))
    for t in range(s):
        decay = np.exp(dt[:, t] * a[None, :])
        hs = decay[..., None, None] * hs + np.einsum("bh,bn,bhp->bhpn", dt[:, t], bm[:, t], x[:, t])
        ys[:, t] = np.einsum("bn,bhpn->bhp", cm[:, t], hs)
    return ys, hs


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 2), st.sampled_from([4, 8, 16]), st.integers(1, 3), st.integers(1, 3),
       st.sampled_from([4, 8]), st.sampled_from([4, 8]), st.integers(0, 2**16))
def test_plain_equals_the_sequential_recurrence(b, q, nc, h, p, n, seed):
    """Any chunk length gives the token-by-token recurrence, state included."""
    s = q * nc
    x, dt, bc, a_log = _model_inputs(seed, b, s, h, p, n)
    a = -np.exp(a_log)
    y, hs = ssd_ref(*_t(x, dt, bc[..., :n], bc[..., n:], a), chunk=q)
    ys, hseq = _sequential(x, dt, bc[..., :n], bc[..., n:], a)
    np.testing.assert_allclose(y.numpy(), ys, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hs.numpy(), hseq, rtol=TOL, atol=TOL)


def test_float32_chunks_lose_precision_as_the_decay_sum_grows():
    """Why decode and prefill differ more for mamba2 than for attention: in
    float32 the chunked form rounds acs, the decay summed over the chunk,
    whose ulp grows with the chunk (|acs| ≈ 2,200 at the end of a chunk of
    1,024 with the model's a = -e), while the step-by-step recurrence of
    decode never forms it.  Against the float64 recurrence, relative to
    max |y|: the float32 recurrence and a chunk of 16 stay near one ulp, a
    chunk of 1,024 is an order of magnitude further off, and still within
    1e-4."""
    b, s, h, p, n = 1, 1024, 2, 16, 32
    x, dt, bc, _ = _model_inputs(13, b, s, h, p, n)
    a = np.full(h, -np.e, np.float32)
    exact, _ = _sequential(*(v.astype(np.float64) for v in (x, dt, bc[..., :n], bc[..., n:], a)))
    scale = np.abs(exact).max()

    def err(y):
        return np.abs(np.asarray(y, np.float64) - exact).max() / scale

    hs, rec = np.zeros((b, h, p, n), np.float32), np.zeros((b, s, h, p), np.float32)
    for t in range(s):                                  # the float32 recurrence, as decode runs it
        hs = (np.exp(dt[:, t] * a[None])[..., None, None] * hs
              + np.einsum("bh,bn,bhp->bhpn", dt[:, t], bc[:, t, :n], x[:, t]))
        rec[:, t] = np.einsum("bn,bhpn->bhp", bc[:, t, n:], hs)
    chunked = {q: err(ssd_ref(*_t(x, dt, bc[..., :n], bc[..., n:], a), chunk=q)[0].numpy())
               for q in (16, 1024)}
    assert err(rec) < chunked[1024] / 10 and chunked[16] < chunked[1024] / 10
    assert chunked[1024] < 1e-4


def test_a_chunk_that_does_not_divide_the_sequence_raises():
    x, dt, bc, a_log = _t(*_model_inputs(11, 2, 48, 2, 8, 16))
    bm, cm, a = bc[..., :16], bc[..., 16:], -torch.exp(a_log)
    with pytest.raises(ValueError, match="not a multiple of the chunk 32"):
        ssd_ref(x, dt, bm, cm, a, chunk=32)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.ssd(x, dt, bm, cm, a, chunk=32)


def test_ops_dispatch_on_the_device():
    """A CPU tensor takes the plain version; the kernel's wrapper refuses a
    CPU tensor rather than fall back; another device is an error."""
    x, dt, bc, a_log = _t(*_model_inputs(12, 2, 64, 2, 8, 16))
    inputs = (x, dt, bc[..., :16], bc[..., 16:], -torch.exp(a_log))
    y, hs = ops.ssd(*inputs, chunk=16)
    ry, rh = ssd_ref(*inputs, chunk=16)
    assert torch.equal(y, ry) and torch.equal(hs, rh)
    before = ssd_kernel.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ssd_kernel(*inputs, chunk=16)
    assert ssd_kernel.launches == before
    with pytest.raises(ValueError, match="no SSD scan for device meta"):
        ops.ssd(*[t.to("meta") for t in inputs], chunk=16)


# ---- ssd_chunked_ref: B6's decomposition (chunks at once, then the state's carry)

def _weak_inputs(seed, b, s, h, p, n):
    """dt log-uniform in [1e-3, 0.1] (Mamba-2's dt init) and a = -1: no
    decay underflows, so every pair and every chunk's state carries
    weight.  a_log [H] = 0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.exp(np.log(1e-3) + np.log(100.0) * rng.random((b, s, h))).astype(np.float32)
    bc = (0.3 * rng.standard_normal((b, s, 2 * n))).astype(np.float32)
    return x, dt, bc, np.zeros(h, np.float32)


def _against_the_plain_version_and_the_reference(x, dt, bc, a_log, chunk):
    """ssd_chunked_ref's y and final state against ssd_ref and against
    ``repro.models.mamba2.ssd_scan`` on the same inputs."""
    n = bc.shape[-1] // 2
    tx, tdt, tbc, ta = _t(x, dt, bc, a_log)
    inputs = (tx, tdt, tbc[..., :n], tbc[..., n:], -torch.exp(ta))
    y, hs = ssd_chunked_ref(*inputs, chunk=chunk)
    ry, rh = ssd_ref(*inputs, chunk=chunk)
    jy, jh = jm.ssd_scan(*_j(x, dt, bc[..., :n], bc[..., n:], a_log), chunk=chunk)
    assert y.shape == x.shape and hs.shape == rh.shape and y.dtype == hs.dtype == torch.float32
    for ours, plain, ref in ((y, ry, jy), (hs, rh, jh)):
        assert torch.isfinite(ours).all()
        np.testing.assert_allclose(ours.numpy(), plain.numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    return y, hs


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 3, 8, 16, 16),        # the file's widths, four chunks
    (2, 64, 3, 8, 16, 64),        # one chunk
    (1, 200, 2, 8, 16, 100),      # a chunk that is not a multiple of the kernel's 64-row tile
    (2, 96, 2, 8, 16, 32),        # a chunk below one tile
    (1, 128, 2, 16, 32, 256),     # a chunk longer than S, cut to S
])
def test_chunked_plain_matches_the_plain_version_and_the_reference(b, s, h, p, n, chunk):
    _against_the_plain_version_and_the_reference(*_model_inputs(b * s + chunk, b, s, h, p, n), chunk)


@pytest.mark.parametrize("decay", ["strong", "weak"])
def test_chunked_plain_at_strong_and_weak_decay(decay):
    """a = -8 (exp of a whole chunk's decay underflows to 0, and so does
    the pairwise decay of distant positions), or the weak decay (nothing
    underflows: a term dropped for its small decay would show)."""
    b, s, h, p, n, q = 2, 256, 2, 8, 16, 64
    if decay == "strong":
        x, dt, bc, _ = _model_inputs(21, b, s, h, p, n)
        a_log = np.full(h, np.log(8.0), np.float32)
    else:
        x, dt, bc, a_log = _weak_inputs(22, b, s, h, p, n)
    whole = np.exp((dt * -np.exp(a_log)).reshape(b, s // q, q, h).sum(axis=2))
    assert (whole == 0).all() if decay == "strong" else (whole > 0).all()
    y, _ = _against_the_plain_version_and_the_reference(x, dt, bc, a_log, q)
    assert float(y.abs().max()) > 0.1


@pytest.mark.parametrize("chunk", [8, 12, 48])
def test_chunked_plain_final_state_equals_the_sequential_recurrence(chunk):
    """The carry of phase 4 gives the token-by-token recurrence's state and
    output, over several chunks (12 and 48 do not divide a 64-row tile)."""
    b, s, h, p, n = 2, 96, 2, 4, 8
    x, dt, bc, a_log = _weak_inputs(chunk, b, s, h, p, n)
    a = -np.exp(a_log)
    y, hs = ssd_chunked_ref(*_t(x, dt, bc[..., :n], bc[..., n:], a), chunk=chunk)
    ys, hseq = _sequential(x, dt, bc[..., :n], bc[..., n:], a)
    np.testing.assert_allclose(y.numpy(), ys, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hs.numpy(), hseq, rtol=TOL, atol=TOL)


def test_unfactored_decay_stays_finite_where_the_factored_one_overflows():
    """At a = -8 acs falls by hundreds inside a chunk of 64, so exp(-acs_s)
    overflows float32 and exp(acs_t)·exp(-acs_s) gives inf and NaN, where
    exp(acs_t - acs_s), formed pair by pair as B6 and ssd_chunked_ref do,
    stays in [0, 1]."""
    b, s, h, p, n, q = 1, 64, 2, 8, 16, 64
    x, dt, bc, _ = _model_inputs(23, b, s, h, p, n)
    a = np.full(h, -8.0, np.float32)
    acs = torch.cumsum(torch.from_numpy(dt * a), dim=1, dtype=torch.float64).float()[0]   # [Q,H]
    assert float(acs.min()) < -89.0                       # exp(89) overflows float32
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))[..., None]
    factored = torch.exp(acs)[:, None] * torch.exp(-acs)[None, :]
    assert not torch.isfinite(factored[tri.expand_as(factored)]).all()
    pairwise = torch.exp(acs[:, None] - acs[None, :])[tri.expand(q, q, h)]
    assert torch.isfinite(pairwise).all() and float(pairwise.max()) <= 1.0
    inputs = _t(x, dt, bc[..., :n], bc[..., n:], a)
    y, hs = ssd_chunked_ref(*inputs, chunk=q)
    ry, rh = ssd_ref(*inputs, chunk=q)
    assert torch.isfinite(y).all() and torch.isfinite(hs).all()
    torch.testing.assert_close(y, ry, rtol=TOL, atol=TOL)
    torch.testing.assert_close(hs, rh, rtol=TOL, atol=TOL)
