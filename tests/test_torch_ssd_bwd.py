"""The SSD chunk scan's backward (``repro_torch.kernels.ssd_scan``) against
autograd and against the JAX package's gradient, on the CPU.

``ref.ssd_bwd_ref`` is the plain version the card's kernel
(``csrc/ssd_scan_bwd.cu``) is held to, and ``ops.ssd``'s autograd
function runs it on the CPU.  Held:
* to PyTorch autograd of ``ssd_ref`` on float64 inputs (both keep
  float64), within 1e-5·max |ref| + 1e-6 for each of dx, ddt, dB, dC, da:
  the algebra;
* in float32, to that float64 gradient within 1e-4·max |ref| + 1e-6 (the
  card's gate for the kernel against the plain version).  Float32 autograd
  of ``ssd_ref`` would not hold it: at a = -8 over one chunk of 32 its da
  reads 2.7e-4 of max |da| from float64, because it sums and subtracts in
  float32 two terms that cancel exactly (the pairs' diagonal and the last
  position's state weight, exp(0)), and every position's d(log-decay)
  carries that rounding; the plain backward leaves both out (1.2e-5);
* through the port's ``models.mamba2.ssd_scan`` (a = -exp(a_log)), to
  ``jax.vjp`` of ``repro.models.mamba2.ssd_scan`` on the same numpy inputs
  and cotangents, gradients with respect to x, dt, B, C and a_log, within
  1e-4·max |ref| + 1e-6 (JAX sums acs in float32, C7).
The cases: strong decay (softplus dt, a ≈ -e), weak decay (dt log-uniform
in [1e-3, 0.1], a ≈ -1), a = -8 (exp(acs) underflows); one chunk and
several; with and without a final state's cotangent; B and C always the
column slices of one [B, S, 2N] array, as the model splits them.  Also:
the autograd function under ``torch.utils.checkpoint``, and no incoming
states kept when no gradient is needed.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models import mamba2 as jm
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref, ssd_ref
from repro_torch.models import mamba2 as tm

torch.set_num_threads(1)

NAMES = ("dx", "ddt", "dB", "dC", "da")
DECAYS = {"strong": 1.0, "weak": 0.0, "a=-8": math.log(8.0)}
# (B, S, H, P, N, chunk): one chunk; several chunks
SHAPES = [(2, 32, 3, 8, 16, 32), (2, 96, 3, 8, 16, 32)]


def _inputs(seed, b, s, h, p, n, decay):
    """x [B,S,H,P], dt [B,S,H], bc [B,S,2N] (B and C are its column
    slices), a_log [H], dy [B,S,H,P], dh [B,H,P,N], as numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    if decay == "weak":
        dt = np.exp(np.log(1e-3) + np.log(100.0) * rng.random((b, s, h))).astype(np.float32)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    bc = (0.3 * rng.standard_normal((b, s, 2 * n))).astype(np.float32)
    a_log = (DECAYS[decay] + 0.3 * rng.standard_normal(h)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dh = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, bc, a_log, dy, dh


def _assert_close(got, want, tol, label):
    for name, g, w in zip(NAMES, got, want):
        g, w = (t.detach().double() if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t)).double()
                for t in (g, w))
        err, lim = float((g - w).abs().max()), tol * float(w.abs().max()) + 1e-6
        assert err <= lim, (label, name, err, lim)


def _autograd(x, dt, bc, a, dy, dh, chunk):
    """Autograd of ``ssd_ref`` (dtype as given): (dx, ddt, dB, dC, da)."""
    n = bc.shape[-1] // 2
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, bc, a)]
    y, hs = ssd_ref(leaves[0], leaves[1], leaves[2][..., :n], leaves[2][..., n:], leaves[3], chunk=chunk)
    loss = (y * dy).sum() + (0 if dh is None else (hs * dh).sum())
    gx, gdt, gbc, ga = torch.autograd.grad(loss, leaves)
    return gx, gdt, gbc[..., :n], gbc[..., n:], ga


def _plain(x, dt, bc, a, dy, dh, chunk):
    n = bc.shape[-1] // 2
    bm, cm = bc[..., :n], bc[..., n:]
    _, _, h_in = ssd_ref(x, dt, bm, cm, a, chunk=chunk, states=True)
    return ssd_bwd_ref(x, dt, bm, cm, a, dy, dh, h_in, chunk=chunk)


@pytest.mark.parametrize("final", [True, False])
@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_equals_autograd(shape, decay, final):
    """float64: the algebra, within 1e-5; float32: within 1e-4 of float64."""
    x, dt, bc, a_log, dy, dh = _inputs(sum(shape) + len(decay), *shape[:5], decay)
    chunk = shape[5]
    t64 = [torch.from_numpy(v).double() for v in (x, dt, bc, a_log, dy, dh)]
    a64 = -torch.exp(t64[3])
    want = _autograd(t64[0], t64[1], t64[2], a64, t64[4], t64[5] if final else None, chunk)
    got64 = _plain(t64[0], t64[1], t64[2], a64, t64[4], t64[5] if final else None, chunk)
    _assert_close(got64, want, 1e-5, "float64")
    t32 = [torch.from_numpy(v) for v in (x, dt, bc, a_log, dy, dh)]
    got32 = _plain(t32[0], t32[1], t32[2], -torch.exp(t32[3]), t32[4], t32[5] if final else None, chunk)
    _assert_close(got32, want, 1e-4, "float32")


def test_the_masked_pairs_stay_finite_where_the_forward_overflows_them():
    """a = -8 over a chunk of 64: acs_t - acs_s for s > t reaches +700, so
    exp of it is inf; the backward never forms it, and every gradient is
    finite."""
    x, dt, bc, a_log, dy, dh = _inputs(5, 1, 64, 2, 8, 16, "a=-8")
    a = -torch.exp(torch.from_numpy(a_log))
    dtt = torch.from_numpy(dt)
    acs = torch.cumsum(dtt * a, dim=1)
    assert float((acs[:, 0] - acs[:, -1]).max()) > 89.0          # exp(-acs_s) would overflow float32
    got = _plain(torch.from_numpy(x), dtt, torch.from_numpy(bc), a, torch.from_numpy(dy), torch.from_numpy(dh), 64)
    assert all(bool(torch.isfinite(g).all()) for g in got)


@functools.lru_cache(maxsize=None)
def _jax_vjp(shape):
    """jit of jax.vjp of the reference's ssd_scan, one compile a shape."""
    chunk = shape[5]

    def f(x, dt, bc, a_log, dy, dh):
        n = bc.shape[-1] // 2
        fn = lambda x_, dt_, bc_, al_: jm.ssd_scan(x_, dt_, bc_[..., :n], bc_[..., n:], al_, chunk=chunk)
        _, pull = jax.vjp(fn, x, dt, bc, a_log)
        return pull((dy, dh))

    return jax.jit(f)


@pytest.mark.parametrize("final", [True, False])
@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("shape", SHAPES)
def test_model_gradient_matches_jax(shape, decay, final):
    """The port's model-level ``ssd_scan`` (through ``ops.ssd``'s autograd
    function) against ``jax.vjp`` of the reference's, a_log's gradient
    chained through a = -exp(a_log) on both sides."""
    x, dt, bc, a_log, dy, dh = _inputs(3 * sum(shape) + len(decay), *shape[:5], decay)
    if not final:
        dh = np.zeros_like(dh)
    gx, gdt, gbc, ga = _jax_vjp(shape)(*(jnp.asarray(v) for v in (x, dt, bc, a_log, dy, dh)))
    n = shape[4]
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (x, dt, bc, a_log)]
    y, hs = tm.ssd_scan(leaves[0], leaves[1], leaves[2][..., :n], leaves[2][..., n:], leaves[3], chunk=shape[5])
    outs, cots = ([y, hs], [torch.from_numpy(dy), torch.from_numpy(dh)]) if final else ([y], [torch.from_numpy(dy)])
    got = torch.autograd.grad(outs, leaves, cots)
    got = (got[0], got[1], got[2][..., :n], got[2][..., n:], got[3])
    want = tuple(np.asarray(g) for g in (gx, gdt, gbc[..., :n], gbc[..., n:], ga))
    _assert_close(got, want, 1e-4, "jax")


def test_the_autograd_function_under_checkpoint_and_bit_equal_forward():
    """``torch.utils.checkpoint`` (non-reentrant, as the model's remat) reruns
    the forward in the backward: the same gradients bit for bit; the
    forward's y and final state are ``ssd_ref``'s bit for bit."""
    x, dt, bc, a_log, dy, dh = (torch.from_numpy(v) for v in _inputs(9, 2, 96, 3, 8, 16, "strong"))
    a = -torch.exp(a_log)

    def run(remat):
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, bc, a)]
        fn = lambda x_, dt_, bc_, a_: ops.ssd(x_, dt_, bc_[..., :16], bc_[..., 16:], a_, chunk=32)
        y, hs = checkpoint(fn, *leaves, use_reentrant=False) if remat else fn(*leaves)
        return (y, hs), torch.autograd.grad((y * dy).sum() + (hs * dh).sum(), leaves)

    (y, hs), plain = run(False)
    _, remat = run(True)
    ry, rh = ssd_ref(x, dt, bc[..., :16], bc[..., 16:], a, chunk=32)
    assert torch.equal(y.detach(), ry) and torch.equal(hs.detach(), rh)
    assert all(torch.equal(p, r) for p, r in zip(plain, remat))


def test_no_incoming_states_are_kept_without_a_gradient(monkeypatch):
    """Under ``no_grad``, or with no input requiring a gradient, the forward
    asks ``ssd_ref`` for no incoming states and records no graph; with a
    gradient it keeps them (the card's path allocates the kernel's h_in
    buffer under the same condition)."""
    asked = []
    real = ops.ssd_ref
    monkeypatch.setattr(ops, "ssd_ref", lambda *a, **k: asked.append(k.get("states", False)) or real(*a, **k))
    x, dt, bc, a_log, _, _ = (torch.from_numpy(v) for v in _inputs(4, 1, 64, 2, 8, 16, "weak"))
    args = (x, dt, bc[..., :16], bc[..., 16:], -torch.exp(a_log))
    y0, _ = ops.ssd(*args, chunk=32)
    leaves = [t.clone().requires_grad_(True) for t in args]
    with torch.no_grad():
        y1, _ = ops.ssd(*leaves, chunk=32)
    y2, _ = ops.ssd(*leaves, chunk=32)
    assert asked == [False, False, True]
    assert y0.grad_fn is None and y1.grad_fn is None and y2.grad_fn is not None
    assert torch.equal(y0, y1) and torch.equal(y0, y2.detach())


def test_the_kernels_wrapper_refuses_a_cpu_tensor():
    """``ssd_scan_bwd`` launches the card's kernel or raises: a CPU tensor
    is refused (the CPU's backward is ``ssd_bwd_ref``), nothing counted."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd

    x, dt, bc, a_log, dy, dh = (torch.from_numpy(v) for v in _inputs(6, 1, 64, 2, 8, 16, "strong"))
    h_in = torch.zeros((1, 2, 2, 16, 8))
    before = ssd_scan_bwd.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ssd_scan_bwd(x, dt, bc[..., :16], bc[..., 16:], -torch.exp(a_log), dy, dh, h_in, chunk=32)
    assert ssd_scan_bwd.launches == before


def test_the_shared_header_rebuilds_the_forward_and_the_backward(tmp_path, monkeypatch):
    """B6's forward and backward share ``csrc/ssd_scan.cuh``: an edit to it
    changes both libraries' names and no other, so neither is loaded stale."""
    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in build.CSRC.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    assert [p.name for p in build.sources_of("ssd_scan_bwd")] == ["ssd_scan_bwd.cu", "ssd_scan.cuh"]
    before = {name: build.library_path(name) for name in build.SOURCES}
    header = csrc / "ssd_scan.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    changed = {name for name in build.SOURCES if build.library_path(name) != before[name]}
    assert changed == {"ssd_scan", "ssd_scan_bwd"}
