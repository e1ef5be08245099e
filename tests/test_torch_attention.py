"""The port's attention kernels (B4 flash attention, B5 flash decode)
against the JAX package, on the CPU.

The dispatchers run the plain PyTorch versions on a CPU tensor; these are
held to the reference's Pallas kernels run with ``interpret=True`` and to
their oracles (``attention_ref``, ``decode_ref``), on the same inputs made
with numpy from a seed.  Tolerances are the reference's own kernel tests':
2e-5 in float32 and 2e-2 in bfloat16 (both sides do float32 math; they
sum in other orders).

Two behaviours of the reference are pinned here:
* causal attention at S != T follows the Pallas kernel (top-left: row i
  sees column j iff i >= j), not ``attention_ref``, which aligns the
  diagonal bottom-right (ROADMAP C4);
* flash decode with ``cache_len = 0`` gives the mean of V over all T
  positions, as both the Pallas kernel and ``decode_ref`` do.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.  What the CPU can hold of B4's bodies is
held here: which body a (dtype, d) takes and the numerical
designs of the tensor-core bodies, emulated in float32 against the card
check's gates: "wgmma" carries P as two bfloat16 halves, "wgmma_f32" forms
each float32 product as three TF32 ones, over tiles of 32 keys.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.kernels.flash_decode.kernel import flash_decode as j_flash_decode
from repro.kernels.flash_decode.ref import decode_ref as j_decode_ref
from repro.models import attention as j_attn
from repro_torch.configs import ARCHS
from repro_torch.kernels.flash_attention import kernel as t_fa_kernel
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref as t_attention_ref
from repro_torch.kernels.flash_decode import kernel as t_fd_kernel
from repro_torch.kernels.flash_decode import ops as t_fd_ops
from repro_torch.models import attention as t_attn

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype`` (both
    round the float32 draws to nearest even for bfloat16)."""
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _close(port: torch.Tensor, ref, tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)


def _qkv(seed, b, s, t, h, kv, d, dtype):
    q = _pair(_normal(seed, b, s, h, d), dtype)
    k = _pair(_normal(seed + 1, b, t, kv, d), dtype)
    v = _pair(_normal(seed + 2, b, t, kv, d), dtype)
    return q, k, v


# ---------------------------------------------------------------- B4
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [
    (1, 64, 2, 2, 16),     # MHA-like
    (2, 128, 4, 2, 32),    # GQA 2:1
    (1, 96, 6, 1, 16),     # MQA, non-pow2 seq (divisible by 32)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_the_reference_kernel_and_oracle(causal, shape, dtype):
    b, s, h, kv, d = shape
    (jq, tq), (jk, tk), (jv, tv) = _qkv(sum(shape), b, s, s, h, kv, d, dtype)
    out = t_fa_ops.attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    kernel = j_flash_attention(jq, jk, jv, causal=causal, block_q=32, block_kv=32, interpret=True)
    _close(out, kernel.astype(jnp.float32), TOL[dtype])
    _close(out, j_attention_ref(jq, jk, jv, causal=causal).astype(jnp.float32), TOL[dtype])


@pytest.mark.parametrize("s,t", [(32, 64), (64, 32)])
def test_attention_plain_follows_the_kernel_when_s_differs_from_t(s, t):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(7, 2, s, t, 4, 2, 16, "float32")
    out = t_fa_ops.attention(tq, tk, tv, causal=True)
    kernel = j_flash_attention(jq, jk, jv, causal=True, block_q=32, block_kv=32, interpret=True)
    _close(out, kernel, TOL["float32"])
    # the reference's oracle aligns the diagonal bottom-right, the kernel top-left
    oracle = np.asarray(j_attention_ref(jq, jk, jv, causal=True))
    assert np.abs(out.numpy() - oracle).max() > 0.1


@pytest.mark.parametrize("causal", [True, False])
def test_attention_plain_at_a_ragged_length(causal):
    """S = T = 50, no multiple of any tile: the reference kernel runs it as
    one 50-row block, its oracle directly."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(11, 2, 50, 50, 4, 2, 16, "float32")
    out = t_fa_ops.attention(tq, tk, tv, causal=causal)
    _close(out, j_flash_attention(jq, jk, jv, causal=causal, interpret=True), TOL["float32"])
    _close(out, j_attention_ref(jq, jk, jv, causal=causal), TOL["float32"])


# ---------------------------------------------------------------- B5
def _cache_len(kind, b, t):
    return {"full": [t] * b, "partial": [t // 3 + 1] * b, "zero": [0] * b,
            "mixed": ([0, 1, t, t // 2 + 3] * b)[:b]}[kind]


@pytest.mark.parametrize("shape", [(2, 8, 2, 64, 256), (1, 4, 4, 32, 128), (4, 6, 3, 16, 100)])
@pytest.mark.parametrize("lens", ["full", "partial", "zero", "mixed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_the_reference_kernel_and_oracle(shape, lens, dtype):
    b, h, kv, d, t = shape
    jq, tq = _pair(_normal(1, b, h, d), dtype)
    jk, tk = _pair(_normal(2, b, t, kv, d), dtype)
    jv, tv = _pair(_normal(3, b, t, kv, d), dtype)
    cl = np.asarray(_cache_len(lens, b, t), np.int32)
    out = t_fd_ops.decode(tq, tk, tv, torch.from_numpy(cl))
    assert out.dtype == tq.dtype and out.shape == tq.shape
    block = t // 4 if t % 4 == 0 else t          # T = 100 runs as one block in the reference
    kernel = j_flash_decode(jq, jk, jv, jnp.asarray(cl), block_kv=block, interpret=True)
    _close(out, kernel.astype(jnp.float32), TOL[dtype])
    _close(out, j_decode_ref(jq, jk, jv, jnp.asarray(cl)).astype(jnp.float32), TOL[dtype])


def test_decode_with_an_empty_cache_is_the_mean_of_v():
    b, h, kv, d, t = 2, 4, 2, 16, 37
    tq = torch.from_numpy(_normal(4, b, h, d))
    tk, tv = torch.from_numpy(_normal(5, b, t, kv, d)), torch.from_numpy(_normal(6, b, t, kv, d))
    out = t_fd_ops.decode(tq, tk, tv, torch.zeros(b, dtype=torch.int32))
    mean = tv.mean(dim=1).repeat_interleave(h // kv, dim=1)
    torch.testing.assert_close(out, mean, rtol=2e-6, atol=2e-6)


# ------------------------------------------------------- the model's entry points
def test_blocked_attention_on_unrepeated_kv_matches_the_reference():
    """The reference's model repeats K/V before its jnp blocked attention;
    the port passes them un-repeated to B4, which maps heads by index."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(9, 2, 32, 32, 6, 2, 16, "float32")
    out = t_attn.blocked_attention(tq, tk, tv, causal=True)
    ref = j_attn.blocked_attention(jq, j_attn.repeat_kv(jk, 6), j_attn.repeat_kv(jv, 6),
                                   causal=True, block_q=16, block_kv=16)
    _close(out, ref, TOL["float32"])


def test_decode_attention_matches_the_reference():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(10, 3, 1, 40, 8, 2, 16, "float32")
    cl = np.asarray([5, 40, 1], np.int32)
    out = t_attn.decode_attention(tq, tk, tv, cache_len=torch.from_numpy(cl))
    assert out.shape == (3, 1, 8, 16)
    _close(out, j_attn.decode_attention(jq, jk, jv, cache_len=jnp.asarray(cl)), TOL["float32"])


def test_options_off_the_path_raise():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="q_offset"):
        t_attn.blocked_attention(q, q, q, q_offset=2)
    with pytest.raises(NotImplementedError, match="probs_bf16"):
        t_attn.blocked_attention(q, q, q, probs_bf16=True)


def test_kernel_wrappers_refuse_what_they_cannot_run():
    """An unsupported head dim or dtype is an error, never a fallback; the
    wrappers take CUDA tensors only (the CPU runs the plain versions)."""
    for d in (12, 4, 264):
        q = torch.zeros(1, 4, 2, d)
        with pytest.raises(ValueError, match="head dim"):
            t_fa_kernel.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="head dim"):
            t_fd_kernel.flash_decode(q[:, 0], q, q, torch.ones(1, dtype=torch.int32))
    q16 = torch.zeros(1, 4, 2, 16, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t_fa_kernel.flash_attention(q16, q16, q16)
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        t_fa_kernel.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        t_fd_kernel.flash_decode(q[:, 0], q, q, torch.ones(1, dtype=torch.int32))
    before = (t_fa_kernel.flash_attention.launches, t_fd_kernel.flash_decode.launches)
    t_fa_ops.attention(q, q, q)
    t_fd_ops.decode(q[:, 0], q, q, torch.ones(1, dtype=torch.int32))
    assert (t_fa_kernel.flash_attention.launches, t_fd_kernel.flash_decode.launches) == before


# ------------------------------------------------------- B4's three bodies
@pytest.mark.parametrize("dtype,d,body", [
    (torch.bfloat16, 128, "wgmma"),     # phi3-medium, granite-20b, qwen2.5-32b, dbrx
    (torch.bfloat16, 96, "wgmma"),      # phi3-vision
    (torch.bfloat16, 64, "wgmma"),      # whisper-base, granite-moe
    (torch.bfloat16, 16, "wgmma"),
    (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 48, "wgmma"),
    (torch.bfloat16, 80, "wgmma"),
    (torch.bfloat16, 112, "wgmma"),
    (torch.bfloat16, 40, "simt"),       # a multiple of 8 only
    (torch.bfloat16, 136, "simt"),
    (torch.bfloat16, 256, "simt"),      # gemma-7b
    (torch.float32, 128, "wgmma_f32"),  # the float32 serve path's prefill (phi3-medium)
    (torch.float32, 64, "wgmma_f32"),
    (torch.float32, 96, "wgmma_f32"),
    (torch.float32, 16, "wgmma_f32"),   # the reduced dense model
    (torch.float32, 40, "wgmma_f32"),   # a multiple of 8 is enough: k-steps of 8
    (torch.float32, 8, "wgmma_f32"),
    (torch.float32, 136, "wgmma_f32"),  # above 128: one instantiation, D = 256, d at run time
    (torch.float32, 256, "wgmma_f32"),  # gemma-7b, the launcher's default arch
])
def test_body_selection_table(dtype, d, body):
    assert t_fa_kernel.select_body(dtype, d) == body


def test_every_registered_head_width_takes_the_tensor_cores_in_bfloat16_but_gemma():
    """In bfloat16 gemma-7b's d = 256 stays on "simt"; in float32 (the
    launcher's dtype) every registered width, gemma's included, takes the
    tensor cores."""
    widths = {name: cfg.resolved_head_dim for name, cfg in ARCHS.items() if cfg.num_heads}
    simt = {name for name, d in widths.items() if t_fa_kernel.select_body(torch.bfloat16, d) == "simt"}
    assert simt == {"gemma-7b"}
    f32 = {name: t_fa_kernel.select_body(torch.float32, d) for name, d in widths.items()}
    assert set(f32.values()) == {"wgmma_f32"}
    assert f32["gemma-7b"] == "wgmma_f32" and widths["gemma-7b"] == 256


def _tiled_attention(q, k, v, *, pv, qk=torch.matmul, tile: int = 64):
    """A tensor-core body's arithmetic in float32 on the CPU: K/V tiles of
    ``tile`` keys, an online softmax in float32 (the top-left causal rule;
    l sums the float32 p), S = qk(Q, Kᵀ) and P·V = pv(P, V); the output is
    rounded once to q's dtype."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(h // kv, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(h // kv, dim=2).permute(0, 2, 1, 3)
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros(b, h, s, 1)
    o = torch.zeros(b, h, s, d)
    rows = torch.arange(s)[:, None]
    for k0 in range(0, t, tile):
        scores = qk(qf, kf[:, :, k0:k0 + tile].transpose(-1, -2)) / math.sqrt(d)
        cols = torch.arange(k0, min(k0 + tile, t))[None, :]
        scores = torch.where(rows >= cols, scores, torch.tensor(-1e30))
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + pv(p, vf[:, :, k0:k0 + tile])
        m = m_new
    return (o / l.clamp_min(1e-30)).permute(0, 2, 1, 3).to(q.dtype)


def _bf16_p_product(split_p: bool):
    """P·V as the "wgmma" body forms it (bf16 × bf16 products summed in
    float32): P = exp(s − m) rounded to bfloat16 once (``split_p=False``)
    or carried as P_hi + P_lo, two bfloat16 halves."""
    def pv(p, v):
        p_hi = p.bfloat16().float()
        out = p_hi @ v
        return out + (p - p_hi).bfloat16().float() @ v if split_p else out
    return pv


def test_split_p_holds_the_card_gate_where_a_bf16_p_breaks_it():
    """The card check holds bfloat16 B4 to its plain version within 1e-4 +
    8e-3·|ref|, capped at 2e-2 (``chip_smoke.py``'s ATTN gate).  The TPU
    kernel keeps P in float32; a P rounded to bfloat16 alone moves the
    early causal rows (few keys, large outputs) by ~2^-9 of their size and
    breaks the gate several times over, while P_hi + P_lo stays within
    it.  Causal, GQA 2:1, d = 128, 4 tiles of 64 keys."""
    b, s, h, kv, d = 1, 256, 4, 2, 128
    q = torch.from_numpy(_normal(21, b, s, h, d)).bfloat16()
    k = torch.from_numpy(_normal(22, b, s, kv, d)).bfloat16()
    v = torch.from_numpy(_normal(23, b, s, kv, d)).bfloat16()
    ref = t_attention_ref(q, k, v, causal=True).float()
    limit = (1e-4 + 8e-3 * ref.abs()).clamp(max=2e-2)

    def worst(out):
        return float(((out.float() - ref).abs() / limit).max())

    assert worst(_tiled_attention(q, k, v, pv=_bf16_p_product(True))) <= 1.0
    assert worst(_tiled_attention(q, k, v, pv=_bf16_p_product(False))) > 2.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: the low 13
    bits to nearest, ties away from zero.  Adding half the dropped unit to
    the bit pattern and clearing the bits rounds the magnitude so, for
    either sign."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(a, b, passes: int):
    """a @ b as the "wgmma_f32" body forms it: one TF32 product (passes=1),
    or three, a_hi·b_hi + a_hi·b_lo + a_lo·b_hi with x_lo = tf32(x − x_hi);
    each product of two TF32 values is exact in float32, and the sums are
    float32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = a_hi @ b_hi
    if passes == 3:
        out = out + a_hi @ _tf32(b - b_hi) + _tf32(a - a_hi) @ b_hi
    return out


def _tiled_attention_tf32(q, k, v, passes: int, tile: int = 32):
    """The "wgmma_f32" body's arithmetic on the CPU: K/V tiles of ``tile``
    keys (the body's 32 at every width: above d = 128 its V tiles are
    halves of that, which changes only the order of P·V's sums), each of
    Q·Kᵀ and P·V as ``passes`` TF32 products."""
    def product(a, b):
        return _tf32_product(a, b, passes)
    return _tiled_attention(q, k, v, qk=product, pv=product, tile=tile)


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    one = 1.0 + 2.0 ** -10                        # TF32's spacing at 1 is 2^-10
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -11 - 2.0 ** -23,
                      1.0 + 3 * 2.0 ** -11, 3.0, -0.0])
    want = torch.tensor([one, -one, 1.0, 1.0 + 2 * 2.0 ** -10, 3.0, -0.0])
    assert torch.equal(_tf32(x).view(torch.int32), want.view(torch.int32))
    r = torch.from_numpy(_normal(24, 4096))
    assert ((_tf32(r).view(torch.int32) & 0x1FFF) == 0).all()
    assert float(((_tf32(r) - r) / r).abs().max()) <= 2.0 ** -11
    lo = _tf32(r - _tf32(r))                      # x_hi + x_lo carries x to ~2^-22
    assert float(((_tf32(r) + lo - r) / r).abs().max()) <= 2.0 ** -21


@pytest.mark.parametrize("shape", [
    (1, 256, 8, 2, 128),       # phi3-medium's heads: d = 128, GQA 4:1, 8 tiles of 32 keys
    (2, 160, 4, 4, 16),        # the reduced dense model's heads (the reduced serve check)
    (1, 256, 4, 4, 256),       # gemma-7b's heads: d = 256, H = KV, 8 tiles of 32 keys
])
def test_three_tf32_passes_hold_the_float32_card_gate_where_one_breaks_it(shape):
    """The card check holds float32 B4 to its plain version within 1e-4
    (``chip_smoke.py``'s ATTN gate, ``ATTN_RTOL["float32"] = 0``).  One
    TF32 product keeps ~11 bits of each operand and moves the output by
    several times that limit; three (x = x_hi + x_lo, the x_lo·y_lo term
    dropped) stay far within it, causal, over several key tiles of the
    body's size."""
    b, s, h, kv, d = shape
    q = torch.from_numpy(_normal(31, b, s, h, d))
    k = torch.from_numpy(_normal(32, b, s, kv, d))
    v = torch.from_numpy(_normal(33, b, s, kv, d))
    ref = t_attention_ref(q, k, v, causal=True)

    def worst(out):
        return float((out - ref).abs().max()) / 1e-4

    assert worst(_tiled_attention_tf32(q, k, v, passes=3)) <= 0.1
    assert worst(_tiled_attention_tf32(q, k, v, passes=1)) > 2.0
