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
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import blocked_attention, repeat_kv
from repro_torch.kernels import counted_wrappers
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

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
    assert flash_attention_bwd.launches_by_body == {"simt": 0}
    x = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(x, x, x, x, x)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(*(torch.zeros((1, 4, 2, 12)),) * 5)
