"""The gradient of the port's attention against torch autograd and JAX, on
the CPU.

``attention_bwd_ref`` (the plain version of ``csrc/flash_attention_bwd.cu``,
written out) is held to torch's autograd of ``attention_ref`` and to
``jax.vjp`` of the reference's ``repeat_kv`` + ``blocked_attention``, on the
same numpy-seeded inputs, within 1e-5 + 1e-5·|ref| per element: all three
compute in float32 and sum in other orders.  The cases cover causal and
full attention, S == T and S != T (the top-left causal rule of B4 and of
``blocked_attention`` at ``q_offset`` 0), a ragged T, GQA groups of 1, 4
and 5, and head widths 64, 96, 128 and 256.  ``ops.attention`` is the
autograd function the model calls: its CPU backward is the plain one.
The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  What the CPU can hold of its "wgmma_f32" body is held
here: its tiled decomposition (dK/dV over blocks of 64 keys and query
tiles of 32 rows, dQ over key tiles of 32, P rebuilt from the forward's
base-2 lse) with every product as three TF32 ones, emulated in float32
against the card check's gate; ``attention_lse_ref``, the lse's plain
version; and the build's hash over the headers a source includes.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import blocked_attention, repeat_kv
from repro_torch.kernels import build, counted_wrappers
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, select_bwd_body
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_lse_ref, attention_ref
from test_torch_attention import _tf32_product

torch.set_num_threads(1)

ATOL = RTOL = 1e-5

# (B, S, T, H, KV, d, causal)
CASES = [
    (2, 32, 32, 4, 4, 64, True),      # G = 1
    (2, 32, 32, 4, 4, 64, False),
    (1, 24, 40, 8, 2, 64, True),      # S != T, G = 4
    (1, 40, 24, 8, 2, 64, True),      # S > T: late rows see every key
    (2, 16, 37, 10, 2, 96, False),    # ragged T, G = 5 (whisper's cross-attention: S != T, full)
    (1, 33, 33, 10, 2, 128, True),    # ragged, G = 5 (qwen2.5-32b's group)
    (1, 20, 20, 4, 1, 256, True),     # d = 256, G = 4 (MQA-like)
    (2, 18, 18, 2, 2, 256, False),    # d = 256, G = 1
]


def _inputs(seed, b, s, t, h, kv, d):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, do


def _close(got: torch.Tensor, want, name):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}_S{}_T{}_H{}_KV{}_d{}_{}".format(
    *c[:6], "causal" if c[6] else "full"))
def test_bwd_ref_matches_autograd_and_jax(case):
    b, s, t, h, kv, d, causal = case
    q, k, v, do = _inputs(sum(case[:6]), b, s, t, h, kv, d)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = attention_ref(tq, tk, tv, causal=causal)
    o.backward(torch.from_numpy(do))
    dq, dk, dv = attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), o.detach(), torch.from_numpy(do),
                                   causal=causal)
    for name, got, want in (("dq", dq, tq.grad), ("dk", dk, tk.grad), ("dv", dv, tv.grad)):
        _close(got, want.numpy(), f"{name} vs autograd")

    def j_attn(q, k, v):
        return blocked_attention(q, repeat_kv(k, h), repeat_kv(v, h), causal=causal, block_q=s, block_kv=t)

    o_j, vjp = jax.vjp(j_attn, *(jnp.asarray(x) for x in (q, k, v)))
    _close(o.detach(), o_j, "o vs JAX")
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), vjp(jnp.asarray(do))):
        _close(got, want, f"{name} vs JAX")


@pytest.mark.parametrize("causal", [True, False])
def test_ops_attention_backward_is_the_plain_one_on_the_cpu(causal):
    q, k, v, do = _inputs(7, 2, 12, 12, 6, 3, 64)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = ops.attention(tq, tk, tv, causal=causal)
    assert o.grad_fn is not None
    o.backward(torch.from_numpy(do))
    want = attention_bwd_ref(*(torch.from_numpy(x) for x in (q, k, v)), o.detach(), torch.from_numpy(do),
                             causal=causal)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.equal(got, w)
    with torch.no_grad():                      # serving: no graph, the same output
        assert torch.equal(ops.attention(tq, tk, tv, causal=causal), o.detach())


def test_the_backward_kernel_is_counted_and_takes_only_the_card():
    assert counted_wrappers()["flash_attention_bwd"] is flash_attention_bwd
    assert flash_attention_bwd.launches_by_body == {"wgmma_f32": 0, "simt": 0}
    assert [select_bwd_body(d) for d in (8, 64, 128, 136, 256)] == ["wgmma_f32"] * 3 + ["simt"] * 2
    x, lse = torch.zeros((1, 4, 2, 64)), torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(x, x, x, x, x, lse)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(*(torch.zeros((1, 4, 2, 12)),) * 5, lse)


LOG2E = 1.4426950408889634
# chip_smoke.py's card gate: each of dQ, dK, dV within BWD_RTOL·max |ref|
BWD_RTOL = 1e-4
PRODUCTS = ("s", "dp", "dv", "dk", "dq")
# (B, S, T, H, KV, d, causal): S != T throughout, ragged to the tiles
TF32_CASES = [
    (1, 96, 160, 4, 2, 64, True),
    (1, 160, 96, 4, 2, 64, False),
    (1, 128, 200, 4, 1, 128, True),
    (1, 200, 128, 2, 2, 128, False),
    (1, 96, 64, 2, 1, 256, True),
    (1, 64, 96, 2, 2, 256, False),
]


def _live(rows, cols, s: int, t: int, causal: bool) -> torch.Tensor:
    ok = (rows[:, None] < s) & (cols[None, :] < t)
    return ok & (rows[:, None] >= cols[None, :]) if causal else ok


def _forward_lse2(q, k, *, causal: bool, tile: int = 32) -> torch.Tensor:
    """The rows' lse in base 2 as B4's "wgmma_f32" body forms it: S as three
    TF32 products over key tiles of ``tile``, an online maximum m and sum l
    of 2^(s·scale·log2(e) − m), lse2 = m + log2(l); [B, H, S]."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    qf = q.permute(0, 2, 1, 3)
    kf = k.repeat_interleave(h // kv, dim=2).permute(0, 2, 1, 3)
    c = LOG2E / math.sqrt(d)
    m, l = torch.full((b, h, s), -1e30), torch.zeros(b, h, s)
    rows = torch.arange(s)
    for k0 in range(0, t, tile):
        cols = torch.arange(k0, min(k0 + tile, t))
        sc = _tf32_product(qf, kf[:, :, k0:k0 + tile].transpose(-1, -2), 3) * c
        sc = torch.where(_live(rows, cols, s, t, causal), sc, torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        l = l * torch.exp2(m - m_new) + torch.exp2(sc - m_new[..., None]).sum(dim=-1)
        m = m_new
    return m + torch.log2(l.clamp_min(1e-30))


def _tiled_bwd_tf32(q, k, v, o, do, lse2, *, causal: bool, passes: dict):
    """The "wgmma_f32" backward's arithmetic on the CPU, each product as
    ``passes[name]`` TF32 products (1 or 3): the dK/dV kernel's blocks of 64
    keys walking query tiles of 32 rows (causal: from the tile of row k0),
    S^T = K·Q^T ("s") and dP^T = V·dO^T ("dp"), P^T = 2^(S^T·scale·log2(e) −
    lse2) where live, dS^T = P^T(dP^T − D), dV += P^T·dO ("dv"), dK += dS^T·Q
    ("dk"); the dQ kernel's blocks of 128 rows walking key tiles of 32, S and
    dP again and dQ += dS·K ("dq").  The G query heads of a KV head are
    summed after the walk (the kernel sums them in its walk: float32 order
    only)."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf, dof = q.permute(0, 2, 1, 3), do.permute(0, 2, 1, 3)
    kf, vf = (x.repeat_interleave(g, dim=2).permute(0, 2, 1, 3) for x in (k, v))
    scale = 1.0 / math.sqrt(d)
    c = scale * LOG2E
    delta = (do * o).sum(dim=-1).permute(0, 2, 1)
    zero = torch.tensor(0.0)

    def product(a, bm, name):
        return _tf32_product(a, bm, passes[name])

    dk, dv = torch.zeros(b, h, t, d), torch.zeros(b, h, t, d)
    for k0 in range(0, t, 64):
        kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
        cols = torch.arange(k0, min(k0 + 64, t))
        for q0 in range((k0 // 32) * 32 if causal else 0, s, 32):
            rows = torch.arange(q0, min(q0 + 32, s))
            qt, dot = qf[:, :, q0:q0 + 32], dof[:, :, q0:q0 + 32]
            st, dpt = product(kt, qt.transpose(-1, -2), "s"), product(vt, dot.transpose(-1, -2), "dp")
            pt = torch.where(_live(rows, cols, s, t, causal).T,
                             torch.exp2(st * c - lse2[:, :, None, q0:q0 + 32]), zero)
            dst = pt * (dpt - delta[:, :, None, q0:q0 + 32])
            dv[:, :, k0:k0 + 64] += product(pt, dot, "dv")
            dk[:, :, k0:k0 + 64] += product(dst, qt, "dk")
    dq = torch.zeros(b, h, s, d)
    for q0 in range(0, s, 128):
        rows = torch.arange(q0, min(q0 + 128, s))
        qt, dot = qf[:, :, q0:q0 + 128], dof[:, :, q0:q0 + 128]
        for k0 in range(0, min(t, q0 + 128) if causal else t, 32):
            cols = torch.arange(k0, min(k0 + 32, t))
            sc = product(qt, kf[:, :, k0:k0 + 32].transpose(-1, -2), "s")
            dp = product(dot, vf[:, :, k0:k0 + 32].transpose(-1, -2), "dp")
            p = torch.where(_live(rows, cols, s, t, causal), torch.exp2(sc * c - lse2[:, :, q0:q0 + 128, None]), zero)
            dq[:, :, q0:q0 + 128] += product(p * (dp - delta[:, :, q0:q0 + 128, None]), kf[:, :, k0:k0 + 32], "dq")
    dq = (dq * scale).permute(0, 2, 1, 3)
    dk = (dk * scale).reshape(b, kv, g, t, d).sum(dim=2).permute(0, 2, 1, 3)
    dv = dv.reshape(b, kv, g, t, d).sum(dim=2).permute(0, 2, 1, 3)
    return dq, dk, dv


def _tf32_case(case):
    b, s, t, h, kv, d, causal = case
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(sum(case[:6]), b, s, t, h, kv, d))
    o = attention_ref(q, k, v, causal=causal)
    ref = attention_bwd_ref(q, k, v, o, do, causal=causal)
    lse2 = _forward_lse2(q, k, causal=causal)

    def worst(passes):
        got = _tiled_bwd_tf32(q, k, v, o, do, lse2, causal=causal, passes=passes)
        return [float((x - y).abs().max()) / (BWD_RTOL * float(y.abs().max())) for x, y in zip(got, ref)]
    return worst


@pytest.mark.parametrize("case", TF32_CASES, ids=lambda c: "B{}_S{}_T{}_H{}_KV{}_d{}_{}".format(
    *c[:6], "causal" if c[6] else "full"))
def test_three_tf32_passes_hold_the_backward_card_gate_where_one_breaks_it(case):
    """chip_smoke.py holds each of B4's backward's dQ, dK, dV within 1e-4 of
    max |ref| of the plain version.  Three TF32 products for every product of
    the tiled backward, P rebuilt from the forward's lse2, stay within 0.1 of
    that gate; one for every product breaks it for each gradient."""
    worst = _tf32_case(case)
    assert max(worst(dict.fromkeys(PRODUCTS, 3))) <= 0.1
    assert min(worst(dict.fromkeys(PRODUCTS, 1))) > 1.0


@pytest.mark.parametrize("one", PRODUCTS)
def test_no_product_of_the_backward_holds_the_gate_with_one_tf32_pass(one):
    """With one product (S, dP, dV, dK or dQ) cut to a single TF32 pass and
    the rest at three, a gradient that product feeds breaks the gate: the
    kernel keeps three on all five."""
    feeds = {"s": (0, 1, 2), "dp": (0, 1), "dv": (2,), "dk": (1,), "dq": (0,)}[one]
    worst = _tf32_case((1, 128, 200, 4, 1, 128, True))(dict(dict.fromkeys(PRODUCTS, 3), **{one: 1}))
    assert all(worst[i] > 1.0 for i in feeds)
    assert all(worst[i] <= 0.1 for i in set(range(3)) - set(feeds))


@pytest.mark.parametrize("case", [(2, 24, 40, 4, 2, 64, True), (1, 40, 24, 4, 2, 64, True),
                                  (2, 24, 40, 4, 2, 64, False), (1, 33, 33, 10, 2, 128, True)],
                         ids=lambda c: "S{}_T{}_{}".format(c[1], c[2], "causal" if c[6] else "full"))
def test_lse_ref_rebuilds_the_softmax_and_the_forward_s_base_2_form_matches_it(case):
    """exp(scores·scale − lse)·V is ``attention_ref``; the emulated
    "wgmma_f32" forward's lse2 is lse·log2(e)."""
    b, s, t, h, kv, d, causal = case
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(sum(case[:6]), b, s, t, h, kv, d))
    lse = attention_lse_ref(q, k, causal=causal)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    kr, vr = (x.repeat_interleave(h // kv, dim=2) for x in (k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kr) / math.sqrt(d)
    if causal:
        scores = torch.where(torch.arange(s)[:, None] >= torch.arange(t)[None, :], scores, torch.tensor(-1e30))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(scores - lse[..., None]), vr)
    torch.testing.assert_close(out, attention_ref(q, k, v, causal=causal), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(_forward_lse2(q, k, causal=causal) / LOG2E, lse, rtol=1e-5, atol=1e-5)


def test_the_library_name_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    """An edited header under csrc/ changes the library's name of every
    source that includes it, and of no other, so no stale build is loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in build.CSRC.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    assert [p.name for p in build.sources_of("flash_attention_bwd")] == ["flash_attention_bwd.cu", "tf32_wgmma.cuh"]
    before = {name: build.library_path(name) for name in build.SOURCES}
    header = csrc / "tf32_wgmma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    changed = {name for name in build.SOURCES if before[name] != after[name]}
    assert changed == {"flash_attention", "flash_attention_bwd"}
