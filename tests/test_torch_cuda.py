"""repro_torch's CUDA kernels against their plain PyTorch versions, on
the card.  These tests import no JAX, so they run on a machine with a card
and PyTorch alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card they skip (the kernels have no CPU mode).
"""
import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from _match_states import FIELDS as RING_FIELDS
from _match_states import batch_case, frame_case
from repro_torch.core.matcher import MatcherState, match_and_update
from repro_torch.kernels._launch import bind
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd, select_bwd_body
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_lse_ref, attention_ref
from repro_torch.kernels.flash_decode.kernel import decode_splits, flash_decode
from repro_torch.kernels.flash_decode.ref import decode_ref
from repro_torch.kernels.iou_match.kernel import iou_matrix, iou_matrix_batched, match_update, match_update_batched
from repro_torch.kernels.iou_match.ref import iou_ref, match_update_ref, match_update_split_ref
from repro_torch.kernels.ssd_scan.kernel import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.core import prng
from repro_torch.core.state import SamplerState
from repro_torch.kernels.thompson.kernel import (round_splits, thompson_choose, thompson_choose_batched,
                                                 thompson_round, thompson_round_batched)
from repro_torch.kernels.thompson.ref import thompson_ref, thompson_round_ref, thompson_round_split_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("c,m", [(50, 22), (50, 1000), (7, 1025), (1, 1)])
def test_thompson_kernel_equals_plain(card, c, m):
    g = torch.Generator().manual_seed(c * 1000 + m)
    alpha = torch.rand(m, generator=g) * 20 + 0.05
    alpha[torch.rand(m, generator=g) < 0.3] = -1.0
    beta = torch.rand(m, generator=g) * 300 + 1
    z = torch.randn(c, m, generator=g)
    alpha, beta, z = alpha.to(card), beta.to(card), z.to(card)
    before = thompson_choose.launches
    ki, kv = thompson_choose(alpha, beta, z)
    ri, rv = thompson_ref(alpha, beta, z)
    assert thompson_choose.launches == before + 1
    assert torch.equal(ki, ri) and torch.equal(_bits(kv), _bits(rv))


def test_thompson_kernel_all_exhausted(card):
    alpha = torch.full((300,), -1.0, device=card)
    ki, kv = thompson_choose(alpha, torch.ones(300, device=card), torch.randn(4, 300, device=card))
    assert ki.tolist() == [-1] * 4
    assert torch.equal(kv, torch.full((4,), -1e30, dtype=torch.float32, device=card))


@pytest.mark.parametrize("q,c,m", [(8, 50, 22), (8, 50, 1000), (3, 7, 1025), (1, 1, 1)])
def test_thompson_batched_kernel_equals_plain(card, q, c, m):
    g = torch.Generator().manual_seed(q * 100000 + c * 1000 + m)
    alpha = torch.rand(q, m, generator=g) * 20 + 0.05
    alpha[torch.rand(q, m, generator=g) < 0.3] = -1.0
    alpha[-1] = -1.0                                  # one query with every chunk exhausted
    beta = torch.rand(q, m, generator=g) * 300 + 1
    z = torch.randn(q, c, m, generator=g)
    alpha, beta, z = alpha.to(card), beta.to(card), z.to(card)
    before = thompson_choose_batched.launches
    ki, kv = thompson_choose_batched(alpha, beta, z)
    ri, rv = thompson_ref(alpha, beta, z)
    assert thompson_choose_batched.launches == before + 1
    assert torch.equal(ki, ri) and torch.equal(_bits(kv), _bits(rv))
    assert ki[-1].tolist() == [-1] * c
    for i in range(q):
        bi, bv = thompson_choose(alpha[i].contiguous(), beta[i].contiguous(), z[i].contiguous())
        assert torch.equal(ki[i], bi) and torch.equal(_bits(kv[i]), _bits(bv))


def _round_state(q, m, kind, seed, card, alpha0=0.1):
    """Sampler statistics of ``q`` queries (None: one, no leading axis) over
    ``m`` chunks: ``sampler`` a search under way with ~20% of chunks
    exhausted, ``fresh`` all zero with chunk 0 exhausted (whole rows draw
    exactly 0 at few chunks; every row at alpha0 = 1e-3)."""
    rng = np.random.default_rng(seed)
    lead = (1 if q is None else q, m)
    if kind == "sampler":
        n1 = rng.integers(0, 30, lead).astype(np.float32)
        n = rng.integers(0, 400, lead).astype(np.float32)
        frames = np.where(rng.random(lead) < 0.2, n, n + rng.integers(1, 500, lead)).astype(np.int32)
    else:
        n1, n = np.zeros(lead, np.float32), np.zeros(lead, np.float32)
        frames = np.full(lead, 100, np.int32)
        frames[:, 0] = 0 if m > 1 else 100
    if q is None:
        n1, n, frames = n1[0], n[0], frames[0]
    return SamplerState(n1=torch.from_numpy(n1).to(card), n=torch.from_numpy(n).to(card),
                        frames=torch.from_numpy(frames).to(card), alpha0=alpha0)


def _round_keys(q, seed, card):
    key = prng.PRNGKey(seed, device=card)
    return key if q is None else torch.stack([prng.fold_in(key, i) for i in range(q)])


def _same_round(got, want):
    return torch.equal(got[0].cpu(), want[0].cpu()) and torch.equal(_bits(got[1]).cpu(), _bits(want[1]).cpu())


@pytest.mark.parametrize("kind", ["sampler", "fresh"])
@pytest.mark.parametrize("c,m", [(50, 22), (50, 1000), (7, 1025), (1, 1), (50, 10000)])
def test_thompson_round_equals_plain(card, c, m, kind):
    """The fused round against its plain version on the card and on the
    CPU, bit for bit on idx and val."""
    state = _round_state(None, m, kind, c * 1000 + m, card)
    key = _round_keys(None, c + m, card)
    before = thompson_round.launches
    got = thompson_round(key, state, c)
    assert thompson_round.launches == before + 1
    assert _same_round(got, thompson_round_ref(key, state, c))
    assert _same_round(got, thompson_round_ref(key.cpu(), state.to("cpu"), c))


@pytest.mark.parametrize("q,c,m", [(8, 50, 22), (8, 50, 1000), (3, 7, 1025), (3, 50, 22), (1, 1, 1)])
def test_thompson_round_batched_equals_plain_and_the_single_round(card, q, c, m):
    """Q queries in one launch, the last with every chunk exhausted (rows
    (-1, -1e30)); row q equals the single round on key q."""
    state = _round_state(q, m, "sampler", q * 100000 + c * 1000 + m, card)
    state.n[-1] = state.frames[-1].float()
    keys = prng.split(_round_keys(None, q + c, card), 3 * q).reshape(q, 3, 2)[:, 1]   # strided rows
    before = thompson_round_batched.launches
    got = thompson_round_batched(keys, state, c)
    assert thompson_round_batched.launches == before + 1
    assert _same_round(got, thompson_round_ref(keys.contiguous(), state, c))
    assert got[0][-1].tolist() == [-1] * c
    assert torch.equal(got[1][-1], torch.full((c,), -1e30, dtype=torch.float32, device=card))
    for i in range(q):
        row = dataclasses.replace(state, n1=state.n1[i], n=state.n[i], frames=state.frames[i])
        single = thompson_round(keys[i].contiguous(), row, c)
        assert torch.equal(got[0][i], single[0]) and torch.equal(_bits(got[1][i]), _bits(single[1])), i


# (Q or None, C, M) of the fused round's split cases and the S that
# ``round_splits`` gives each on a card of 132 SMs (the H100 SXM's): 1, 2,
# 3, 5 and 8 blocks a row, each reached through the shape alone
ROUND_SPLIT_CASES = [(None, 150, 1000, 1), (None, 50, 22, 1), (None, 100, 1000, 2), (None, 50, 1000, 3),
                     (None, 7, 1025, 8), (None, 17, 512, 8), (8, 50, 1000, 1), (2, 25, 1000, 3), (2, 3, 300, 5)]


def _chosen_splits(card, q, c, m, s132):
    """``round_splits`` on this card; on 132 SMs it must be ``s132``."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    chosen = round_splits(c * (q or 1), m, sms)
    assert sms != 132 or chosen == s132, (q, c, m, chosen)
    return chosen


@pytest.mark.parametrize("c,m,s132", [(50, 1, 1), (50, 3, 1), (50, 5, 1), (50, 1000, 3), (150, 1000, 1),
                                      (100, 1000, 2), (7, 1025, 8)])
def test_thompson_round_rows_that_draw_zero(card, c, m, s132):
    """Rows whose every live draw is exactly 0 return the first live index
    (1: chunk 0 is exhausted) at every split the shapes reach (1, 2, 3
    and 8 blocks a row on 132 SMs), as the plain version."""
    _chosen_splits(card, None, c, m, s132)
    for alpha0 in (0.1, 1e-3):
        state = _round_state(None, m, "fresh", m, card, alpha0=alpha0)
        key = _round_keys(None, m + 7, card)
        want = thompson_round_ref(key, state, c)
        assert _same_round(thompson_round(key, state, c), want), alpha0
        zero = want[1] == 0.0
        assert bool((want[0][zero] == (1 if m > 1 else 0)).all())
        if alpha0 == 1e-3:
            assert bool(zero.all())


@pytest.mark.parametrize("q,c,m,s132", ROUND_SPLIT_CASES)
def test_thompson_round_equals_the_split_reference(card, q, c, m, s132):
    """At the grid ``round_splits`` chooses on this card, the kernel equals
    ``thompson_round_split_ref`` of the same S (and so the unsplit plain
    version)."""
    state = _round_state(q, m, "sampler", 17 * m + c, card)
    keys = _round_keys(q, m + c, card)
    chosen = _chosen_splits(card, q, c, m, s132)
    fn = thompson_round if q is None else thompson_round_batched
    got = fn(keys, state, c)
    assert _same_round(got, thompson_round_split_ref(keys, state, c, chosen))
    assert _same_round(got, thompson_round_ref(keys, state, c))


def test_thompson_round_replays_from_a_cuda_graph(card):
    """The key and the statistics are read on the card: a captured round,
    replayed after the key and the state change in place, gives each new
    key's choice (single and batched)."""
    state = _round_state(None, 1000, "sampler", 1, card)
    key = _round_keys(None, 1, card).clone()
    states = _round_state(8, 1000, "sampler", 2, card)
    keys = _round_keys(8, 2, card).clone()
    thompson_round(key, state, 50)
    thompson_round_batched(keys, states, 50)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = thompson_round(key, state, 50)
        out_b = thompson_round_batched(keys, states, 50)
    for seed in (3, 4, 5):
        key.copy_(_round_keys(None, seed, card))
        keys.copy_(_round_keys(8, seed, card))
        new, new_b = _round_state(None, 1000, "sampler", seed, card), _round_state(8, 1000, "sampler", seed, card)
        for s, t in ((state, new), (states, new_b)):
            s.n1.copy_(t.n1)
            s.n.copy_(t.n)
            s.frames.copy_(t.frames)
        graph.replay()
        torch.cuda.synchronize()
        assert _same_round(out, thompson_round_ref(key, state, 50))
        assert _same_round(out_b, thompson_round_ref(keys, states, 50))


def test_thompson_round_refuses_what_it_cannot_run(card):
    """CPU tensors, statistics of another shape or type and a key of
    another shape raise before any launch."""
    state = _round_state(None, 100, "sampler", 9, card)
    key = _round_keys(None, 9, card)
    before = (thompson_round.launches, thompson_round_batched.launches)
    with pytest.raises(ValueError, match="CUDA"):
        thompson_round(key.cpu(), state.to("cpu"), 4)
    with pytest.raises(ValueError, match="keys"):
        thompson_round(key.cpu(), state, 4)
    with pytest.raises(ValueError, match="state"):
        thompson_round(key, dataclasses.replace(state, frames=state.frames.long()), 4)
    with pytest.raises(ValueError, match="state"):
        thompson_round(key, dataclasses.replace(state, n=state.n[:50]), 4)
    with pytest.raises(ValueError, match="keys"):
        thompson_round(torch.stack([key, key]), state, 4)
    states = _round_state(3, 100, "sampler", 9, card)
    with pytest.raises(ValueError, match="keys"):
        thompson_round_batched(_round_keys(2, 9, card), states, 4)
    assert (thompson_round.launches, thompson_round_batched.launches) == before


def _boxes(g, card, *shape):
    xy = torch.rand(*shape, 2, generator=g) * 0.7
    b = torch.cat([xy, xy + torch.rand(*shape, 2, generator=g) * 0.2], -1)
    b[torch.rand(*shape, generator=g) < 0.2] = 0.0
    return b.to(card)


@pytest.mark.parametrize("d,r", [(16, 8192), (13, 1000), (1, 1), (40, 77)])
def test_iou_kernel_equals_plain(card, d, r):
    g = torch.Generator().manual_seed(d * 1000 + r)
    a, b = _boxes(g, card, d), _boxes(g, card, r)
    assert torch.equal(_bits(iou_matrix(a, b)), _bits(iou_ref(a, b)))


@pytest.mark.parametrize("q,d,r", [(8, 16, 8192), (3, 13, 1000), (2, 1, 1), (4, 40, 77)])
def test_iou_batched_kernel_equals_plain_and_the_2d_kernel(card, q, d, r):
    g = torch.Generator().manual_seed(q * 100000 + d * 1000 + r)
    a, b = _boxes(g, card, q, d), _boxes(g, card, q, r)
    before = iou_matrix_batched.launches
    out = iou_matrix_batched(a, b)
    assert iou_matrix_batched.launches == before + 1
    assert torch.equal(_bits(out), _bits(iou_ref(a, b)))
    for i in range(q):
        assert torch.equal(_bits(out[i]), _bits(iou_matrix(a[i].contiguous(), b[i].contiguous())))


# the fused matcher step: its outputs and the new ring's fields
MATCH_OUTPUTS = ("d0", "d1", "cross_chunk", "cross_home", "is_new")


def _ring(case, device, **kw):
    return MatcherState(**{k: torch.from_numpy(np.asarray(case["ring"][k])).to(device) for k in RING_FIELDS},
                        time_gate=case["time_gate"], **kw)


def _frame(case, device, *, query_stride=False):
    """The detections and ids of ``case`` on ``device``: ids as the scan
    path has them (video and chunk int32, frame int64); with
    ``query_stride``, the detections as a cohort slot's view of a [Q, 2, D]
    batch (rows contiguous, queries strided), as the multi path has them."""
    det = {k: torch.from_numpy(case["det"][k]).to(device) for k in ("boxes", "feats", "valid")}
    if query_stride:
        det = {k: torch.stack([torch.zeros_like(v), v], 1)[:, 1] for k, v in det.items()}
    vid, fid, cid = (torch.as_tensor(v, dtype=t, device=device)
                     for v, t in zip(case["ids"], (torch.int32, torch.int64, torch.int32)))
    return det["boxes"], det["feats"], det["valid"], vid, fid, cid


def _assert_same_step(got, want):
    """Every output and ring field equal, bit for bit, dtypes included."""
    for name in MATCH_OUTPUTS:
        a, b = getattr(got, name).cpu(), getattr(want, name).cpu()
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for name in RING_FIELDS:
        a, b = getattr(got.new_state, name).cpu(), getattr(want.new_state, name).cpu()
        assert a.dtype == b.dtype, name
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b), name


def _check_step(card, case, kernel, *, query_stride=False):
    """``kernel`` on the card against the kernel's decomposition on the CPU
    (8 blocks) always, and against the plain step on the card where no
    slot takes two inserts (the plain step's scatter then has no repeated
    index, whose winner a CUDA scatter leaves open)."""
    state, args = _ring(case, card), _frame(case, card, query_stride=query_stride)
    got = kernel(state, *args)
    _assert_same_step(got, match_update_split_ref(_ring(case, "cpu"), *(a.cpu() for a in args), blocks=8))
    if int(got.d0.max()) <= state.capacity:
        _assert_same_step(got, match_update_ref(state, *args))
    return got


@pytest.mark.parametrize("d,r", [(16, 8192), (13, 1000), (1, 1), (64, 200), (3, 1), (16, 5), (0, 8)])
def test_match_update_kernel_equals_plain(card, d, r):
    for seed in range(3):
        before = match_update.launches
        _check_step(card, frame_case(seed * 101 + d + r, d, r), match_update)
        assert match_update.launches == before + 1


@pytest.mark.parametrize("q,d,r", [(8, 16, 8192), (3, 13, 1000), (2, 1, 1), (4, 64, 9)])
def test_match_update_batched_equals_plain_and_the_2d_kernel(card, q, d, r):
    case = batch_case(q * 1000 + d + r, q, d, r)
    before = match_update_batched.launches
    got = _check_step(card, case, match_update_batched, query_stride=True)
    assert match_update_batched.launches == before + 1
    assert not bool(got.is_new[-1].any()) and int(got.d0[-1]) == 0        # the inactive query
    for i, one in enumerate(case["cases"]):
        solo = match_update(_ring(one, card), *_frame(one, card))
        sliced = got._replace(**{n: getattr(got, n)[i] for n in MATCH_OUTPUTS}, new_state=dataclasses.replace(
            got.new_state, **{n: getattr(got.new_state, n)[i] for n in RING_FIELDS}))
        _assert_same_step(sliced, solo)


def test_match_update_twice_in_a_row_keeps_each_result(card):
    """Two calls, the second on the first's new ring: neither result is
    overwritten, and the first's input ring is left as it was."""
    first, second = frame_case(21, 16, 8192), frame_case(22, 16, 8192)
    state = _ring(first, card)
    kept = {n: getattr(state, n).clone() for n in RING_FIELDS}
    a = match_update(state, *_frame(first, card))
    a_copy = {n: getattr(a.new_state, n).clone() for n in RING_FIELDS}
    b = match_update(a.new_state, *_frame(second, card))
    _assert_same_step(a, match_update_ref(state, *_frame(first, card)))
    _assert_same_step(b, match_update_ref(a.new_state, *_frame(second, card)))
    for n in RING_FIELDS:
        assert torch.equal(getattr(state, n), kept[n]) and torch.equal(getattr(a.new_state, n), a_copy[n]), n


def test_match_update_replays_from_a_cuda_graph(card):
    """One launch a call, no host read: a call captured in a CUDA graph,
    replayed after its ring, detections and ids change in place, equals
    the plain step on each."""
    cases = [frame_case(31 + i, 16, 8192) for i in range(3)]
    state, args = _ring(cases[0], card), _frame(cases[0], card)
    match_update(state, *args)                              # builds and loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = match_update(state, *args)
    for case in cases:
        for name in RING_FIELDS:
            getattr(state, name).copy_(getattr(_ring(case, card), name))
        for t, v in zip(args, _frame(case, card)):
            t.copy_(v)
        graph.replay()
        torch.cuda.synchronize()
        _assert_same_step(out, match_update_ref(state, *args))


def test_match_update_refuses_what_it_cannot_run(card):
    """More than 64 detections, a ring that is not int32 and ids of
    another type raise before any launch."""
    case = frame_case(51, 65, 100)
    before = match_update.launches
    with pytest.raises(ValueError, match="at most 64 detections"):
        match_update(_ring(case, card), *_frame(case, card))
    case = frame_case(52, 16, 100)
    state, args = _ring(case, card), _frame(case, card)
    with pytest.raises(ValueError, match="state.frame"):
        match_update(dataclasses.replace(state, frame=state.frame.long()), *args)
    with pytest.raises(ValueError, match="frame_id"):
        match_update(state, *args[:4], args[4].float(), args[5])
    assert match_update.launches == before


def test_the_cosine_path_on_the_card_equals_the_cpu(card):
    """feat_thresh > -1 keeps the op-by-op step, with B3's iou_matrix for
    its IoU, and the fused kernel out of it: the card's result equals the
    CPU's."""
    case = frame_case(41, 16, 8192)
    for k in ("ring", "det"):
        case[k]["feats"][:] = np.abs(case[k]["feats"])
    before = (iou_matrix.launches, match_update.launches)
    got = match_and_update(_ring(case, card, feat_thresh=0.9), *_frame(case, card))
    assert (iou_matrix.launches, match_update.launches) == (before[0] + 1, before[1])
    _assert_same_step(got, match_and_update(_ring(case, "cpu", feat_thresh=0.9), *_frame(case, "cpu")))


# attention kernels, (rtol, atol): both sides compute in float32 and sum in
# other orders; a bfloat16 output rounds once, so the two differ by at most
# one bf16 ulp, 2^-7·|ref|
ATTN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (8e-3, 1e-4)}


@pytest.mark.parametrize("b,s,t,h,kv,d", [
    (2, 64, 64, 4, 2, 16),          # GQA 2:1, one tile
    (1, 100, 100, 8, 2, 128),       # ragged S = T
    (1, 256, 1024, 8, 2, 64),       # S != T: top-left causal rule
    (1, 130, 70, 4, 4, 256),        # gemma's head width, S > T
    (2, 33, 33, 6, 1, 40),          # MQA, d a multiple of 8 only
    (1, 200, 200, 8, 4, 96),        # phi3-vision's head width: N = 96 on the tensor cores
    (1, 1000, 1000, 8, 2, 128),     # 16 K/V tiles of 64, the last one ragged
    (1, 150, 150, 4, 2, 32),        # the tensor cores' other widths: 32 ...
    (1, 97, 130, 4, 1, 48),         # ... 48 (V zero-padded to N = 64), S != T ...
    (2, 300, 300, 4, 4, 80),        # ... 80 (N = 96) ...
    (1, 190, 190, 8, 2, 112),       # ... and 112 (N = 128), the most registers
    (1, 100, 100, 4, 2, 136),       # float32 above 128: d at run time, columns past it zero
    (2, 77, 77, 4, 4, 200),
    (4, 2048, 2048, 16, 16, 256),   # gemma-7b's float32 serve prefill
    (1, 2048, 2048, 16, 16, 256),   # gemma-7b's heads at batch 1 (bfloat16 on "simt")
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_equals_plain(card, b, s, t, h, kv, d, causal, dtype):
    g = torch.Generator().manual_seed(b * 1000 + s + t + d)
    q = torch.randn(b, s, h, d, generator=g).to(card, dtype)
    k = torch.randn(b, t, kv, d, generator=g).to(card, dtype)
    v = torch.randn(b, t, kv, d, generator=g).to(card, dtype)
    body = fa_kernel.select_body(dtype, d)
    key = (b, s, t, h, kv, d, str(dtype).removeprefix("torch."), causal)
    before = (flash_attention.launches, flash_attention.launches_by_body[body],
              flash_attention.launches_by_shape.get(key, 0))
    out = flash_attention(q, k, v, causal=causal)
    assert (flash_attention.launches, flash_attention.launches_by_body[body],
            flash_attention.launches_by_shape[key]) == (before[0] + 1, before[1] + 1, before[2] + 1)
    ref = attention_ref(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=ATTN_TOL[dtype][0], atol=ATTN_TOL[dtype][1])


def test_flash_attention_entry_point_refuses_a_body_it_cannot_take(card):
    """The C side returns cudaErrorInvalidValue (1) for the wgmma body on
    float32, on d = 40 or on d = 256, and for the wgmma_f32 body on
    bfloat16 (at d = 128 and at d = 256), without launching."""
    fn = bind("flash_attention", "flash_attention_fwd", fa_kernel._ARGTYPES)
    stream = torch.cuda.current_stream(card).cuda_stream
    for body, dtype, d in (("wgmma", torch.float32, 128), ("wgmma", torch.bfloat16, 40),
                           ("wgmma", torch.bfloat16, 256), ("wgmma_f32", torch.bfloat16, 128),
                           ("wgmma_f32", torch.bfloat16, 256)):
        q = torch.zeros(1, 64, 2, d, dtype=dtype, device=card)
        out = torch.empty_like(q)
        rc = fn(fa_kernel.BODIES[body], fa_kernel.DTYPES[dtype], q.data_ptr(), q.data_ptr(),
                q.data_ptr(), out.data_ptr(), None, 1, 64, 64, 2, 2, d, *q.stride()[:3], *q.stride()[:3],
                *q.stride()[:3], 1, 1.0 / math.sqrt(d), stream)
        assert rc == 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("b,h,kv,d,t", [
    (2, 8, 2, 64, 256),
    (4, 40, 10, 128, 1000),         # phi3-medium's heads, a ragged last block
    (2, 48, 1, 128, 300),           # granite-20b's MQA group of 48
    (1, 16, 16, 256, 130),          # gemma
    (2, 40, 8, 128, 777),           # qwen2.5-32b's group of 5; T no multiple of a split
    (1, 48, 1, 256, 500),           # 48 heads of 256: twelve blocks a split
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_equals_plain(card, b, h, kv, d, t, dtype):
    g = torch.Generator().manual_seed(b * 1000 + h + t + d)
    q = torch.randn(b, h, d, generator=g).to(card, dtype)
    kc = torch.randn(b, t, kv, d, generator=g).to(card, dtype)
    vc = torch.randn(b, t, kv, d, generator=g).to(card, dtype)
    lens = torch.tensor(([0, 1, t, t // 2 + 3] * b)[:b], dtype=torch.int32, device=card)
    key = (b, h, kv, d, t, str(dtype).removeprefix("torch."))
    before = flash_decode.launches, flash_decode.launches_by_shape.get(key, 0)
    out = flash_decode(q, kc, vc, lens)
    assert (flash_decode.launches, flash_decode.launches_by_shape[key]) == (before[0] + 1, before[1] + 1)
    ref = decode_ref(q, kc, vc, lens)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=ATTN_TOL[dtype][0], atol=ATTN_TOL[dtype][1])
    # cache_len = 0: the mean of V over all T positions, as the reference
    mean = vc[0].float().mean(dim=0).repeat_interleave(h // kv, dim=0)
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(out[0].float(), mean.to(dtype).float(), rtol=rtol, atol=atol)


def _decode_inputs(card, b, h, kv, d, t, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(card, dtype)
                 for shape in ((b, h, d), (b, t, kv, d), (b, t, kv, d)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_the_edges_of_its_splits(card, dtype):
    """cache_len one below, at and one above a whole number of positions a
    split, and of tiles a split: the split of the live range moves a
    position from one block (or tile) to the next."""
    b, h, kv, d, t = 6, 8, 2, 64, 1000
    q, kc, vc = _decode_inputs(card, b, h, kv, d, t, dtype, 7)
    ns = decode_splits(b, t, h, kv, torch.cuda.get_device_properties(card).multi_processor_count)
    assert ns > 1
    for lens in ([ns - 1, ns, ns + 1, 32 * ns - 1, 32 * ns, 32 * ns + 1],
                 [t - 1, t, t + 1, 1, 2, 31]):
        cache_len = torch.tensor(lens, dtype=torch.int32, device=card)
        out = flash_decode(q, kc, vc, cache_len)
        torch.testing.assert_close(out.float(), decode_ref(q, kc, vc, cache_len).float(),
                                   rtol=ATTN_TOL[dtype][0], atol=ATTN_TOL[dtype][1])


def test_flash_decode_twice_in_a_row_keeps_each_result(card):
    b, h, kv, d, t = 4, 40, 10, 128, 2113
    q, kc, vc = _decode_inputs(card, b, h, kv, d, t, torch.float32, 8)
    first = torch.tensor([64] * b, dtype=torch.int32, device=card)
    second = torch.tensor([0, 1, 2113, 999], dtype=torch.int32, device=card)
    before = flash_decode.launches
    a = flash_decode(q, kc, vc, first)
    c = flash_decode(q, kc, vc, second)
    assert flash_decode.launches == before + 2
    rtol, atol = ATTN_TOL[torch.float32]
    torch.testing.assert_close(a, decode_ref(q, kc, vc, first), rtol=rtol, atol=atol)
    torch.testing.assert_close(c, decode_ref(q, kc, vc, second), rtol=rtol, atol=atol)


def test_flash_decode_replays_from_a_cuda_graph(card):
    """One launch a call and no state between calls: a call captured in a
    CUDA graph, replayed after cache_len changes in place, equals the
    plain version at each length."""
    b, h, kv, d, t = 4, 40, 10, 128, 2113
    q, kc, vc = _decode_inputs(card, b, h, kv, d, t, torch.float32, 9)
    cache_len = torch.tensor([64] * b, dtype=torch.int32, device=card)
    flash_decode(q, kc, vc, cache_len)                # builds, and sets the kernel's attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode(q, kc, vc, cache_len)
    rtol, atol = ATTN_TOL[torch.float32]
    for lens in ([64] * b, [1, 2113, 0, 700], [65] * b):
        cache_len.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, decode_ref(q, kc, vc, cache_len), rtol=rtol, atol=atol)


# B6 against its plain version: both float32, summing in other orders; the
# chunk's cumulative log-decay is summed in float64 by both, so only the
# float32 products and sums differ
SSD_TOL = 1e-4


@pytest.mark.parametrize("b,s,h,p,n,chunk,decay", [
    (2, 512, 8, 64, 128, 256, "strong"),     # mamba2's own chunk of 256
    (3, 128, 1, 16, 32, 32, "strong"),       # the reference's kernel test's widths, BH as B
    (1, 200, 4, 32, 64, 100, "strong"),      # chunk not a multiple of the 64-row tile
    (2, 4096, 8, 64, 128, 1024, "weak"),     # serve widths, 4 chunks, nothing underflows
    (1, 8192, 32, 64, 128, 1024, "weak"),    # the batch-1 prefill at serve widths, 8 chunks
    (2, 256, 8, 64, 128, 32, "weak"),        # a chunk below one tile at serve widths
])
def test_ssd_scan_kernel_equals_plain(card, b, s, h, p, n, chunk, decay):
    """dt after softplus of a normal ("strong": exp(acs) underflows within
    ~50 positions at a = -e) or log-uniform in [1e-3, 0.1], Mamba-2's dt
    init, with a near -1 ("weak": every tile pair and every chunk's state
    carries weight, so a tile skipped shows)."""
    g = torch.Generator().manual_seed(b * 1000 + s + h + p + n)
    if decay == "weak":
        dt = torch.exp(math.log(1e-3) + math.log(100.0) * torch.rand(b, s, h, generator=g))
    else:
        dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g))
    x = torch.randn(b, s, h, p, generator=g)
    bc = 0.3 * torch.randn(b, s, 2 * n, generator=g)
    a = -torch.exp(0.3 * torch.randn(h, generator=g))
    if decay == "weak":
        q = min(chunk, s)
        assert (torch.exp((dt * a).reshape(b, s // q, q, h).sum(dim=2)) > 0).all()
    x, dt, bc, a = (t.to(card) for t in (x, dt, bc, a))
    bm, cm = bc[..., :n], bc[..., n:]                  # read in place, as the model's split
    before = ssd_scan.launches
    y, hs = ssd_scan(x, dt, bm, cm, a, chunk=chunk)
    assert ssd_scan.launches == before + 1
    ry, rh = ssd_ref(x, dt, bm, cm, a, chunk=chunk)
    assert y.shape == x.shape and hs.shape == rh.shape == (b, h, p, n)
    torch.testing.assert_close(y, ry, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(hs, rh, rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_scan_refuses_what_it_cannot_run(card):
    x = torch.randn(1, 64, 2, 68, device=card)       # P above 64
    dt = torch.ones(1, 64, 2, device=card)
    bm = torch.randn(1, 64, 16, device=card)
    with pytest.raises(ValueError, match="unsupported"):
        ssd_scan(x, dt, bm, bm, -torch.ones(2, device=card), chunk=32)
    with pytest.raises(ValueError, match="not a multiple"):
        ssd_scan(x[..., :64], dt, bm, bm, -torch.ones(2, device=card), chunk=48)


def test_reduced_mamba2_on_the_card_equals_the_cpu(card):
    """The reduced mamba2-370m served on the card (B6 in the prefill)
    equals the same on the CPU: tokens, logits and every layer's cache
    within 1e-4."""
    from repro_torch import convert
    from repro_torch.launch import serve as launcher
    from repro_torch.models.transformer import init_params

    cfg = launcher.model_config("mamba2-370m", reduced=True, device=card)
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_gpu = convert.params_from_numpy(convert.params_to_numpy(p_cpu), cfg, device=card)
    prompt = launcher.make_prompt(cfg, 2, 64, "cpu")
    before = ssd_scan.launches
    gpu = launcher.serve(p_gpu, cfg, launcher.RUN, {"tokens": prompt["tokens"].to(card)}, 8,
                         keep_logits=True)
    assert ssd_scan.launches == before + cfg.num_layers
    ref = launcher.serve(p_cpu, cfg, launcher.RUN, prompt, 8, keep_logits=True)
    assert torch.equal(gpu.tokens.cpu(), ref.tokens)
    pairs = [(gpu.prefill_logits, ref.prefill_logits)] + list(zip(gpu.step_logits, ref.step_logits))
    for a, b in zip(gpu.cache.layers, ref.cache.layers):
        pairs += [(a.conv, b.conv), (a.ssm, b.ssm)]
    for a, b in pairs:
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


# ---- the resident search loop: one captured round, replayed ------------------

SEARCH_RING = 256
SCAN_PLAN = dict(result_limit=12, max_steps=480, cohorts=8, method="pallas", trace_every=24)
MULTI_CLASSES = (0, 0, 1, 1)
MULTI_PLAN = dict(queries=4, result_limit=[12, 12, 6, 12], max_steps=400, cohorts=4, method="pallas",
                  trace_every=25, execution=dict(queries_axis=True, cache=-1))


def _search(device, plan, *, multi=False, feat_thresh=-1.0, noisy=False):
    """One search of dashcam(0.02) through ``SearchPlan.run`` on ``device``:
    the scan kind with the class-7 detector, or the multi kind with one
    class-agnostic detector and ``class_select``; the oracle, or with
    ``noisy`` the noisy detector."""
    from repro_torch import core as tcore
    from repro_torch.configs.exsample_paper import dashcam
    from repro_torch.sim import class_select, generate, noisy_detect, oracle_detect

    repo, chunks = generate(dashcam(scale=0.02).repo, device=device)
    matcher = tcore.init_matcher(max_results=SEARCH_RING, feat_thresh=feat_thresh, device=device)
    key = prng.PRNGKey(0, device=device)
    query_class = None if multi else 7

    def det(k, f):
        if noisy:
            return noisy_detect(k, repo, f, query_class=query_class)
        return oracle_detect(repo, f, query_class=query_class)

    if not multi:
        carry = tcore.init_carry(tcore.init_state(chunks.length, device=device), matcher, key)
        return tcore.SearchPlan.from_dict(plan).run(carry, chunks, detector=det)
    keys = torch.stack([prng.fold_in(key, q) for q in range(len(MULTI_CLASSES))])
    carry = tcore.init_carry_multi(tcore.init_state(chunks.length, device=device), matcher, keys)
    return tcore.SearchPlan.from_dict(plan).run(carry, chunks, detector=det, select=class_select(repo, MULTI_CLASSES))


def _assert_same_search(got, want):
    assert (got.steps, got.results, got.traces) == (want.steps, want.results, want.traces)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    a, b = got.carry, want.carry
    pairs = [(getattr(a.sampler, f), getattr(b.sampler, f)) for f in ("n1", "n")]
    pairs += [(getattr(a.matcher, f), getattr(b.matcher, f)) for f in RING_FIELDS]
    pairs += [(a.key, b.key), (a.step, b.step), (a.results, b.results)]
    if want.final_cache is not None:
        cap = want.final_cache.capacity
        pairs.append((got.final_cache.tag[:cap], want.final_cache.tag[:cap]))
    for x, y in pairs:
        x, y = x.cpu(), y.cpu()
        assert torch.equal(_bits(x) if x.dtype == torch.float32 else x, _bits(y) if y.dtype == torch.float32 else y)


@pytest.mark.parametrize("feat_thresh", [-1.0, 0.9])
@pytest.mark.parametrize("multi", [False, True])
def test_the_captured_loop_equals_the_cpu(card, multi, feat_thresh):
    """Both kinds, both matcher paths: the rounds after the first are
    replays of one captured graph, and the search equals the CPU's bit for
    bit; each replay launches what the captured round recorded."""
    plan = MULTI_PLAN if multi else SCAN_PLAN
    got = _search(card, plan, multi=multi, feat_thresh=feat_thresh)
    _assert_same_search(got, _search("cpu", plan, multi=multi, feat_thresh=feat_thresh))
    loop, cohorts = got.loop, plan["cohorts"]
    assert loop.captured and loop.eager_rounds == 1 and loop.replays > 0 and loop.capture_s > 0
    assert loop.replays == loop.rounds_per_sync * (loop.syncs - 1)
    choose = "thompson_round_batched" if multi else "thompson_round"
    step = ("iou_matrix" if feat_thresh > -1 else "match_update") + ("_batched" if multi else "")
    assert loop.captured_launches == {choose: 1, step: cohorts}
    live = got.stats.rounds if multi else got.steps[0] // cohorts
    assert live <= loop.eager_rounds + loop.replays <= live + loop.rounds_per_sync


def test_a_second_run_recaptures_and_stays_exact(card):
    """Each ``plan.run`` captures its own round: a second run with another
    result limit (a different exit, the same shapes) is exact too."""
    first_plan = dict(SCAN_PLAN, result_limit=3)
    first = _search(card, first_plan)
    second = _search(card, SCAN_PLAN)
    assert first.loop.captured and second.loop.captured and second.loop.capture_s > 0
    # a round of 8 frames can find more than one result: the exit comes at 3 or more
    assert first.results[0] >= 3 and second.steps[0] > first.steps[0]
    _assert_same_search(first, _search("cpu", first_plan))
    _assert_same_search(second, _search("cpu", SCAN_PLAN))


def test_exact_runs_its_rounds_eagerly_on_the_card(card):
    """``method="exact"`` seeds a host generator from the key every round:
    its rounds run op by op, never captured."""
    got = _search(card, dict(SCAN_PLAN, method="exact"))
    loop = got.loop
    assert not loop.captured and loop.replays == 0 and loop.captured_launches == {}
    assert loop.eager_rounds >= got.steps[0] // SCAN_PLAN["cohorts"] and got.results[0] > 0
    assert got.trace[-1] == (got.steps[0], got.results[0])


def test_a_host_read_in_the_round_fails_the_capture(card, monkeypatch):
    """A value read back to the host inside the round cannot be captured:
    the run raises, with no fallback to op-by-op rounds.  The card is
    usable afterwards."""
    from repro_torch.core import exsample as tex

    process = tex._process_frame

    def reads_the_host(carry, *args):
        int(carry.step)
        return process(carry, *args)

    monkeypatch.setattr(tex, "_process_frame", reads_the_host)
    with pytest.raises(RuntimeError):
        _search(card, SCAN_PLAN)
    monkeypatch.undo()
    torch.cuda.synchronize()
    _assert_same_search(_search(card, SCAN_PLAN), _search("cpu", SCAN_PLAN))


# ---- the noisy detector and the baselines ---------------------------------------

@pytest.mark.parametrize("p", [0.0, 0.05, 0.1, 0.5, 1.0])
def test_bernoulli_on_the_card_equals_the_cpu(card, p):
    keys = torch.from_numpy(np.random.default_rng(1).integers(0, 2**32, (64, 2), dtype=np.uint64).astype(np.int64))
    got = prng.bernoulli(keys.to(card), p, (3000,))
    want = prng.bernoulli(keys, p, (3000,))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(prng.bernoulli(keys[3].to(card), p, (3000,)).cpu(), want[3])


@pytest.mark.parametrize("multi", [False, True])
def test_the_noisy_search_captured_equals_its_eager_run(card, multi, monkeypatch):
    """The noisy detector draws its misses, jitter and false positives from
    the key stream inside the captured round: the replayed search equals
    the same search run op by op on the card, and on the CPU."""
    from repro_torch.core import exsample as tex

    plan = dict(MULTI_PLAN if multi else SCAN_PLAN, result_limit=40 if not multi else [12, 12, 6, 12])
    got = _search(card, plan, multi=multi, noisy=True)
    assert got.loop.captured and got.loop.replays > 0
    choose = "thompson_round_batched" if multi else "thompson_round"
    step = "match_update_batched" if multi else "match_update"
    assert got.loop.captured_launches == {choose: 1, step: plan["cohorts"]}
    monkeypatch.setattr(tex, "_captures", lambda method, device: False)
    eager = _search(card, plan, multi=multi, noisy=True)
    monkeypatch.undo()
    assert not eager.loop.captured and eager.loop.replays == 0
    _assert_same_search(got, eager)
    _assert_same_search(got, _search("cpu", plan, multi=multi, noisy=True))
    assert min(got.results) > 0


@pytest.mark.parametrize("noisy", [False, True])
def test_randomplus_and_greedy_on_the_card_equal_the_cpu(card, noisy):
    """The baselines' host loops: each frame one ``match_update`` launch,
    the (step, results) trace and the final carry as on the CPU."""
    from repro_torch import core as tcore
    from repro_torch.configs.exsample_paper import dashcam
    from repro_torch.core.baselines import FrameSchedule, run_greedy, run_schedule
    from repro_torch.sim import generate, noisy_detect, oracle_detect

    def run(device, policy):
        repo, chunks = generate(dashcam(scale=0.02).repo, device=device)
        carry = tcore.init_carry(tcore.init_state(chunks.length, device=device),
                                 tcore.init_matcher(max_results=SEARCH_RING, device=device), prng.PRNGKey(0, device=device))

        def det(k, f):
            return noisy_detect(k, repo, f, query_class=7) if noisy else oracle_detect(repo, f, query_class=7)

        if policy == "greedy":
            return run_greedy(carry, chunks, detector=det, result_limit=30, max_steps=200, trace_every=8)
        return run_schedule(carry, chunks, FrameSchedule.randomplus(chunks.total_frames, 200), detector=det,
                            result_limit=30, trace_every=8)

    for policy in ("randomplus", "greedy"):
        before = match_update.launches
        got, got_trace = run(card, policy)
        assert match_update.launches - before == int(got.step)
        want, want_trace = run("cpu", policy)
        assert got_trace == want_trace and len(got_trace) >= 2
        pairs = [(getattr(got.sampler, f), getattr(want.sampler, f)) for f in ("n1", "n")]
        pairs += [(getattr(got.matcher, f), getattr(want.matcher, f)) for f in RING_FIELDS]
        pairs += [(got.key, want.key), (got.step, want.step), (got.results, want.results)]
        for x, y in pairs:
            x = x.cpu()
            assert torch.equal(_bits(x) if x.dtype == torch.float32 else x, _bits(y) if y.dtype == torch.float32 else y)


# ---- the repository index and the async runtime ------------------------------


def test_index_warm_and_publish_cache_on_the_card(card, tmp_path):
    """A cache preloaded on the card equals the same preload on the CPU,
    tensor for tensor; a search's final cache on the card publishes the
    same detections as the CPU's, never its scratch row, and the warm
    replay on the card calls the detector on no frame."""
    from repro_torch.index import RepositoryIndex
    from repro_torch.serve.batcher import cache_insert, init_detection_cache

    want = _search("cpu", MULTI_PLAN, multi=True)
    got = _search(card, MULTI_PLAN, multi=True)
    idx_gpu, idx_cpu = RepositoryIndex(), RepositoryIndex()
    assert idx_gpu.publish_cache(got.final_cache) == idx_cpu.publish_cache(want.final_cache) == \
        got.stats.detector_invocations > 0
    assert sorted(idx_gpu._tiers["v0"]) == sorted(idx_cpu._tiers["v0"])
    for f, leaves in idx_cpu._tiers["v0"].items():
        for x, y in zip(idx_gpu._tiers["v0"][f], leaves):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    cap = got.final_cache.capacity
    struct = type(got.final_cache.store)(*(x[0] for x in got.final_cache.store))
    warm_gpu, frames_gpu = idx_gpu.warm(struct, cap)
    warm_cpu, frames_cpu = idx_cpu.warm(type(struct)(*(x.cpu() for x in struct)), cap)
    assert frames_gpu == frames_cpu and warm_gpu.tag.device.type == "cuda"
    assert torch.equal(warm_gpu.tag.cpu(), warm_cpu.tag)
    for x, y in zip(warm_gpu.store, warm_cpu.store):
        assert torch.equal(x.cpu(), y)
    empty, _ = RepositoryIndex().warm(struct, 64)
    cold = init_detection_cache(struct, 64)
    assert torch.equal(empty.tag, cold.tag) and all(torch.equal(x, y) for x, y in zip(empty.store, cold.store))
    # a collision inside one batch: the loser's id lands on the scratch row only
    toy = init_detection_cache(torch.zeros((), device=card), 4)
    frames = torch.tensor([3, 7], device=card)
    cache_insert(toy, frames, frames.float(), torch.tensor([True, True], device=card))
    assert int(toy.tag[4]) == 7
    idx = RepositoryIndex()
    assert idx.publish_cache(toy) == 1 and idx.lookup(7) is None
    # the warm replay on the card, through the plan
    plan = dict(MULTI_PLAN, execution=dict(MULTI_PLAN["execution"], index=dict(path=str(tmp_path))))
    cold_run = _search(card, plan, multi=True)
    warm_run = _search(card, plan, multi=True)
    assert warm_run.stats.detector_invocations == 0
    assert warm_run.stats.index_hits == warm_run.stats.cache_hits > 0
    assert (warm_run.steps, warm_run.results, warm_run.traces) == (want.steps, want.results, want.traces)
    assert cold_run.stats.persisted_detections == want.stats.detector_invocations
    assert warm_run.loop.captured


@pytest.mark.parametrize("workers", [1, 4])
def test_async_multi_on_the_card_equals_multi(card, workers):
    """The slot scheduler with W worker threads, each on its own stream,
    gives every query the trajectory of the card's multi kind."""
    from repro_torch import core as tcore
    from repro_torch.configs.exsample_paper import dashcam
    from repro_torch.core.runtime import AsyncMultiSearchDriver
    from repro_torch.sim import class_select, generate, oracle_detect

    want = _search(card, MULTI_PLAN, multi=True)
    repo, chunks = generate(dashcam(scale=0.02).repo, device=card)
    keys = torch.stack([prng.fold_in(prng.PRNGKey(0, device=card), q) for q in range(len(MULTI_CLASSES))])
    carry = tcore.init_carry_multi(tcore.init_state(chunks.length, device=card),
                                   tcore.init_matcher(max_results=SEARCH_RING, device=card), keys)
    driver = AsyncMultiSearchDriver(
        carry, chunks, lambda k, f: oracle_detect(repo, f, query_class=None), cohorts=MULTI_PLAN["cohorts"],
        num_workers=workers, result_limits=MULTI_PLAN["result_limit"], max_steps=MULTI_PLAN["max_steps"],
        method="pallas", select=class_select(repo, MULTI_CLASSES), cache_frames=chunks.total_frames,
        trace_every=MULTI_PLAN["trace_every"])
    out = driver.run()
    torch.cuda.synchronize()
    assert tuple(out.step.tolist()) == want.steps and tuple(out.results.tolist()) == want.results
    assert driver.traces == want.traces
    a, b = out, want.carry
    pairs = [(getattr(a.sampler, f), getattr(b.sampler, f)) for f in ("n1", "n")]
    pairs += [(getattr(a.matcher, f), getattr(b.matcher, f)) for f in RING_FIELDS]
    pairs += [(a.key, b.key)]
    for x, y in pairs:
        x, y = x.cpu(), y.cpu()
        assert torch.equal(_bits(x) if x.dtype == torch.float32 else x, _bits(y) if y.dtype == torch.float32 else y)
    st = driver.stats
    assert st["merges"] == st["slots"] and st["detector_invocations"] <= int(out.step.sum())
    assert sum(r.rounds for r in driver.rows) == st["lanes_issued"]


def test_async_search_on_the_card_keeps_its_invariants(card):
    """The single-query tier with 4 worker streams: every frame merged once
    (Σ merged frames = step = Σ n), the ring holds every result, and B3's
    fused step ran once a processed frame."""
    from repro_torch import core as tcore
    from repro_torch.configs.exsample_paper import dashcam
    from repro_torch.core.runtime import AsyncSearchDriver
    from repro_torch.sim import generate, oracle_detect

    repo, chunks = generate(dashcam(scale=0.02).repo, device=card)
    carry = tcore.init_carry(tcore.init_state(chunks.length, device=card),
                             tcore.init_matcher(max_results=SEARCH_RING, device=card), prng.PRNGKey(0, device=card))
    driver = AsyncSearchDriver(carry, chunks, lambda k, f: oracle_detect(repo, f, query_class=7), cohort_size=8,
                               num_workers=4, result_limit=20, max_frames=600)
    processed, process = [], driver._process_one

    def counted(wid, cohort):
        res = process(wid, cohort)
        processed.append(res.frames)
        return res

    driver._process_one = counted
    before = match_update.launches
    out = driver.run()
    torch.cuda.synchronize()
    assert int(out.step) == int(out.sampler.n.sum()) == 8 * driver.stats["merges"]
    assert int((out.matcher.times_seen > 0).sum()) == int(out.results)
    assert match_update.launches - before == sum(processed)


def _card_service(card, detector_of, *, workers=4):
    """A small tenant service on the card: dashcam(0.02), cohorts of 8, a
    class-agnostic oracle with ``class_select`` over the classes."""
    from repro_torch import core as tcore
    from repro_torch.configs.exsample_paper import dashcam
    from repro_torch.serve.service import SearchService
    from repro_torch.sim import class_select, generate

    repo, chunks = generate(dashcam(scale=0.02).repo, device=card)
    proto = tcore.init_carry_multi(tcore.init_state(chunks.length, device=card),
                                   tcore.init_matcher(max_results=SEARCH_RING, device=card),
                                   torch.stack([prng.PRNGKey(0, device=card)]))
    num_classes = int(repo.inst_class.max()) + 1
    service = SearchService(proto, chunks, detector_of(repo), select=class_select(repo, list(range(num_classes))),
                            cohorts=8, num_workers=workers, slots_per_batch=2, cache_frames=chunks.total_frames)
    return service, repo, chunks


def test_service_on_the_card_equals_the_solo_scans(card):
    """Three tenants, one admitted after two pool rounds, through the
    background pump and 4 worker streams: each equals its solo scan on the
    card at its debited budget, in each of five services (a read of a row
    not ordered after its merge would show as a difference)."""
    import time

    from repro_torch import core as tcore
    from repro_torch.serve.service import FINISHED
    from repro_torch.sim import filter_class, oracle_detect

    def plan():
        return tcore.SearchPlan(result_limit=12, max_steps=480, cohorts=8,
                                execution=tcore.Execution(queries_axis=True))

    classes = {"a": 0, "b": 7, "late": 3}
    for rep in range(5):
        service, repo, chunks = _card_service(card, lambda r: (lambda k, f: oracle_detect(r, f, query_class=None)))
        service.start(pump=True)
        try:
            service.submit("a", plan(), seed=rep, select_id=classes["a"])
            service.submit("b", plan(), seed=rep + 100, select_id=classes["b"])
            t0 = time.monotonic()
            while service.driver.pool_rounds() < 2 and time.monotonic() - t0 < 60:
                time.sleep(0.002)
            service.submit("late", plan(), seed=rep + 200, select_id=classes["late"])
            service.drain(deadline_s=120.0)
        finally:
            service.stop()
        for tid, cls in classes.items():
            t = service.tenants[tid]
            assert t.state == FINISHED
            row = t.row_obj
            solo = tcore.SearchPlan(result_limit=12, max_steps=row.budget, cohorts=8, method="exact").run(
                tcore.init_carry(tcore.init_state(chunks.length, device=card),
                                 tcore.init_matcher(max_results=SEARCH_RING, device=card), t.key),
                chunks, detector=lambda k, f, c=cls: filter_class(repo, oracle_detect(repo, f, query_class=None), c))
            a, b = row.carry, solo.carry
            pairs = [(getattr(a.sampler, f), getattr(b.sampler, f)) for f in ("n1", "n")]
            pairs += [(getattr(a.matcher, f), getattr(b.matcher, f)) for f in RING_FIELDS]
            pairs += [(a.key, b.key), (a.step, b.step), (a.results, b.results)]
            for x, y in pairs:
                x, y = x.cpu(), y.cpu()
                assert torch.equal(_bits(x) if x.dtype == torch.float32 else x,
                                   _bits(y) if y.dtype == torch.float32 else y), (rep, tid)
            assert int(row.carry.results) == int((row.carry.matcher.times_seen > 0).sum()) + len(row.log)
        assert service.tenants["late"].row_obj.budget < 480
        assert len(service.driver.rows) <= 3 and abs(service.budget.committed_s) < 1e-9


def test_a_raising_detector_stops_the_service_on_the_card(card):
    import threading
    import time

    from repro_torch import core as tcore
    from repro_torch.launch.serve_search import handle_request
    from repro_torch.serve.service import ServiceFailure
    from repro_torch.sim import oracle_detect

    def detector_of(repo):
        def det(key, frame):
            if threading.current_thread() is not threading.main_thread():
                raise RuntimeError("detector failed on a worker")
            return oracle_detect(repo, frame, query_class=None)

        return det

    service, _, _ = _card_service(card, detector_of, workers=2)
    service.start(pump=True)
    try:
        service.submit("a", tcore.SearchPlan(result_limit=12, max_steps=480, cohorts=8,
                                             execution=tcore.Execution(queries_axis=True)), seed=1, select_id=0)
        t0 = time.monotonic()
        with pytest.raises(ServiceFailure, match="detector failed on a worker"):
            service.drain(deadline_s=60.0)
        assert time.monotonic() - t0 < 20 and not service.busy()
        resp = handle_request(service, {"op": "drain"})
        assert resp["ok"] is False and "detector failed on a worker" in resp["error"]
    finally:
        service.stop()


# ---- the mesh: the sharded choice, and the sharded and composed kinds ----------

MESH_SHARDS = 8


@pytest.mark.parametrize("q", [None, 3])
@pytest.mark.parametrize("m,dead", [(24, "shard0"), (1000, "shard0"), (24, "all")])
def test_local_cohort_winners_kernel_equals_plain(card, q, m, dead):
    """The sharded choice through the fused round (one B1 or B2 launch a
    shard, the kernel's −1 / −1e30 marks mapped back) equals the
    reference's shard body op by op on the same card tensors, bit for bit
    on winners, scores and rank bases: with shard 0 all exhausted, and
    with every chunk everywhere exhausted (−inf scores, chunk 0)."""
    from repro_torch.core.distributed import local_cohort_winners, shard_sampler_state
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(MESH_SHARDS)
    state = _round_state(q, m, "sampler", m + (q or 0), card)
    exh = torch.zeros(state.n.shape, dtype=torch.bool, device=card)
    exh[..., : m // MESH_SHARDS] = True
    if dead == "all":
        exh[...] = True
    state = dataclasses.replace(state, n=torch.where(exh, state.frames.float(), state.n))
    views = shard_sampler_state(state, mesh)
    key = _round_keys(q, m, card)
    wrapper = thompson_round if q is None else thompson_round_batched
    before = wrapper.launches
    got = local_cohort_winners(key, views, mesh, cohorts=48)
    assert wrapper.launches == before + MESH_SHARDS
    want = local_cohort_winners(key, views, mesh, cohorts=48, plain=True)
    assert torch.equal(got[0], want[0]) and torch.equal(_bits(got[1]), _bits(want[1])) and torch.equal(got[2], want[2])
    if dead == "all":
        assert bool(torch.isneginf(got[1]).all()) and not bool(got[0].any())
    else:
        assert bool(torch.isfinite(got[1]).all()) and bool((got[0] >= m // MESH_SHARDS).all())


def _mesh_search(device, multi, sync_every):
    """dashcam(0.02) through a mesh kind on 8 shards of ``device``: the
    sharded kind (class 7), or the composed kind over ``MULTI_CLASSES``
    with a repository-sized cache."""
    from repro_torch import core as tcore
    from repro_torch.configs.exsample_paper import dashcam
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.sim import class_select, generate, oracle_detect

    repo, chunks = generate(dashcam(scale=0.02).repo, device=device)
    matcher = tcore.init_matcher(max_results=SEARCH_RING, device=device)
    key = prng.PRNGKey(0, device=device)
    mesh = make_data_mesh(MESH_SHARDS, device=device)
    ex = dict(shards=MESH_SHARDS, sync_every=sync_every)
    if not multi:
        plan = dict(result_limit=40, max_steps=320, cohorts=16, execution=ex)
        carry = tcore.init_carry(tcore.init_state(chunks.length, device=device), matcher, key)
        return tcore.SearchPlan.from_dict(plan).run(
            carry, chunks, detector=lambda k, f: oracle_detect(repo, f, query_class=7), mesh=mesh)
    plan = dict(queries=len(MULTI_CLASSES), result_limit=[12, 12, 6, 12], max_steps=160, cohorts=8,
                execution=dict(ex, queries_axis=True, cache=-1))
    keys = torch.stack([prng.fold_in(key, q) for q in range(len(MULTI_CLASSES))])
    carry = tcore.init_carry_multi(tcore.init_state(chunks.length, device=device), matcher, keys)
    return tcore.SearchPlan.from_dict(plan).run(carry, chunks, detector=lambda k, f: oracle_detect(
        repo, f, query_class=None), select=class_select(repo, MULTI_CLASSES), mesh=mesh)


@pytest.mark.parametrize("sync_every", [1, 4])
@pytest.mark.parametrize("multi", [False, True])
def test_the_mesh_kinds_on_the_card_equal_the_cpu(card, multi, sync_every):
    """The sharded and composed kinds on 8 shards of the card equal the
    same on the CPU bit for bit; one fused Thompson launch a shard a round,
    one fused matcher launch a cohort a round (batched: a shard slot)."""
    from repro_torch.kernels import launch_counts

    before = launch_counts()
    got = _mesh_search(card, multi, sync_every)
    counts = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    _assert_same_search(got, _mesh_search("cpu", multi, sync_every))
    rounds = got.stats.rounds if multi else got.stats.merges * sync_every
    if multi:
        slots = got.plan.cohorts // MESH_SHARDS
        assert counts == {"thompson_round_batched": MESH_SHARDS * rounds,
                          "match_update_batched": MESH_SHARDS * slots * rounds}
    else:
        assert counts == {"thompson_round": MESH_SHARDS * rounds, "match_update": got.plan.cohorts * rounds}


# ---- the MoE and hybrid families and the stacked forward -----------------------

def test_apply_moe_on_the_card_equals_the_cpu(card):
    """The MoE block at reduced width with drops (capacity factor 0.25, 2
    groups): routing exact, output within 1e-5 + 1e-5·|ref|, the dropped
    fraction equal."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    from repro_torch.models.layers import materialize

    cfg = MoEConfig(num_experts=8, top_k=2, d_ff=48, capacity_factor=0.25)
    p = materialize(moe.moe_schema(32, cfg, "swiglu"), 3, torch.float32, "cpu")
    pg = {n: t.to(card) for n, t in p.named_parameters()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 24, 32)).astype(np.float32))
    c = moe.capacity(24, cfg)
    r = moe.route(moe.router_logits(p, x, cfg), cfg, c)
    rg = moe.route(moe.router_logits(pg, x.to(card), cfg), cfg, c)
    for f in ("top_e", "flat_pos", "keep", "src"):
        assert torch.equal(getattr(rg, f).cpu(), getattr(r, f)), f
    out, st = moe.apply_moe(p, x, cfg, mlp_kind="swiglu")
    gout, gst = moe.apply_moe(pg, x.to(card), cfg, mlp_kind="swiglu")
    torch.testing.assert_close(gout.cpu(), out, rtol=1e-5, atol=1e-5)
    assert float(gst.dropped_fraction) == float(st.dropped_fraction) > 0.0


@pytest.mark.parametrize("arch,layers", [("granite-moe-1b-a400m", 2), ("jamba-1.5-large-398b", 8)])
def test_reduced_moe_and_hybrid_on_the_card_equal_the_cpu(card, arch, layers):
    """The reduced granite-moe and jamba (8 layers: one attention layer)
    served on the card at the real capacity equal the same on the CPU:
    tokens, logits and every layer's cache within 1e-4; B4 and B5 once a
    layer (a token) on the attention layers, B6 once a Mamba-2 layer."""
    from repro_torch import convert
    from repro_torch.configs import ARCHS, scale_down
    from repro_torch.launch import serve as launcher
    from repro_torch.models.transformer import init_params

    cfg = scale_down(ARCHS[arch], layers=layers)
    attn = sum(cfg.is_attn_layer(i) for i in range(layers))
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_gpu = convert.params_from_numpy(convert.params_to_numpy(p_cpu), cfg, device=card)
    prompt = launcher.make_prompt(cfg, 2, 32, "cpu")
    before = (flash_attention.launches, flash_decode.launches, ssd_scan.launches)
    gpu = launcher.serve(p_gpu, cfg, launcher.RUN, {"tokens": prompt["tokens"].to(card)}, 8, keep_logits=True)
    ran = (flash_attention.launches - before[0], flash_decode.launches - before[1], ssd_scan.launches - before[2])
    assert ran == (attn, attn * 8, layers - attn)
    ref = launcher.serve(p_cpu, cfg, launcher.RUN, prompt, 8, keep_logits=True)
    assert torch.equal(gpu.tokens.cpu(), ref.tokens)
    pairs = [(gpu.prefill_logits, ref.prefill_logits)] + list(zip(gpu.step_logits, ref.step_logits))
    for a, b in zip(gpu.cache.layers, ref.cache.layers):
        pairs += list(zip(a, b))
    for a, b in pairs:
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,layers", [("granite-moe-1b-a400m", 2), ("jamba-1.5-large-398b", 16)])
def test_stacked_prefill_on_the_card_equals_the_unrolled_one(card, arch, layers):
    """The stacked prefill on the card, on the unrolled weights restacked
    there, equals the unrolled prefill bit for bit."""
    from repro_torch.configs import ARCHS, RunConfig, scale_down
    from repro_torch.launch import serve as launcher
    from repro_torch.models.stacked import stack_params
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.serve_step import build_prefill_step

    cfg = scale_down(ARCHS[arch], layers=layers)
    params = init_params(cfg, seed=0, device=card)
    batch = launcher.make_prompt(cfg, 2, 64, card)
    want = build_prefill_step(cfg, launcher.RUN)(params, batch)
    got = build_prefill_step(cfg, RunConfig(param_dtype="float32", stacked=True))(stack_params(params, cfg), batch)
    assert torch.equal(got, want)


# ---- the vlm and audio families and the detector step -----------------------

@pytest.mark.parametrize("b,s,t,h,kv", [(2, 384, 1500, 8, 8), (1, 1500, 1500, 8, 8), (3, 70, 131, 8, 2)])
def test_flash_attention_full_at_a_ragged_key_axis_d64(card, b, s, t, h, kv):
    """B4 with ``causal=False`` at d = 64 and T no multiple of a tile: whisper's
    cross-attention (S = 384, T = 1,500) and encoder (S = T = 1,500); only
    the bound test masks the last key tile."""
    g = torch.Generator().manual_seed(s + t)
    q = torch.randn(b, s, h, 64, generator=g).to(card)
    k = torch.randn(b, t, kv, 64, generator=g).to(card)
    v = torch.randn(b, t, kv, 64, generator=g).to(card)
    out = flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(out, attention_ref(q, k, v, causal=False), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d,t,lens", [(64, 1500, [1500] * 3), (96, 2113, [64, 1, 2113]), (64, 448, [0, 17, 448])])
def test_flash_decode_one_head_a_group(card, d, t, lens):
    """B5 at G = 1 with d ≤ 128 (``config_of<T, 1, 128>``): whisper's self and
    cross decode (d = 64, the cross cache read whole at T = 1,500) and
    phi-3-vision's (d = 96)."""
    b, h = len(lens), 8
    q, kc, vc = _decode_inputs(card, b, h, h, d, t, torch.float32, d + t)
    cache_len = torch.tensor(lens, dtype=torch.int32, device=card)
    out = flash_decode(q, kc, vc, cache_len)
    torch.testing.assert_close(out, decode_ref(q, kc, vc, cache_len), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-base"])
def test_reduced_vlm_and_audio_on_the_card_equal_the_cpu(card, arch):
    """The launcher's flow on the reduced model with random patches or
    frames: tokens, logits, self and cross caches within 1e-4; B4 once a
    layer (whisper: its encoder's and cross layers too), B5 once a layer and
    token (whisper: twice)."""
    from repro_torch import convert
    from repro_torch.configs import ARCHS, scale_down
    from repro_torch.launch import serve as launcher
    from repro_torch.models.transformer import init_params

    cfg = scale_down(ARCHS[arch])
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_gpu = convert.params_from_numpy(convert.params_to_numpy(p_cpu), cfg, device=card)
    prompt = launcher.make_prompt(cfg, 2, 32, "cpu")
    g = torch.Generator().manual_seed(3)
    for key in ("patches", "frames"):
        if key in prompt:
            prompt[key] = torch.randn(prompt[key].shape, generator=g)
    before = (flash_attention.launches, flash_decode.launches)
    gpu = launcher.serve(p_gpu, cfg, launcher.RUN, {k: v.to(card) for k, v in prompt.items()}, 8, keep_logits=True)
    ran = (flash_attention.launches - before[0], flash_decode.launches - before[1])
    per = 2 if cfg.cross_attention else 1
    assert ran == (cfg.num_layers * per + cfg.encoder_layers, cfg.num_layers * per * 8)
    ref = launcher.serve(p_cpu, cfg, launcher.RUN, prompt, 8, keep_logits=True)
    assert torch.equal(gpu.tokens.cpu(), ref.tokens)
    pairs = [(gpu.prefill_logits, ref.prefill_logits)] + list(zip(gpu.step_logits, ref.step_logits))
    for a, b in zip(gpu.cache.layers + gpu.cache.cross, ref.cache.layers + ref.cache.cross):
        if a is not None:
            pairs += list(zip(a, b))
    for a, b in pairs:
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_reduced_detect_step_on_the_card_equals_the_cpu(card):
    """The detector step on the reduced phi-3-vision over frame embeddings
    of the simulated store: every output within 1e-4 of the CPU's, B4 once
    a layer, scores and boxes in [0, 1], unit features."""
    from repro_torch import convert
    from repro_torch.configs import ARCHS, scale_down
    from repro_torch.launch import serve as launcher
    from repro_torch.models.detection import init_head
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.serve_step import build_detect_step
    from repro_torch.sim import RepoSpec, frame_embedding, generate

    cfg = scale_down(ARCHS["phi-3-vision-4.2b"])
    widths = dict(max_dets=16, num_classes=8, feat_dim=8)
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_gpu = convert.params_from_numpy(convert.params_to_numpy(p_cpu), cfg, device=card)
    h_cpu = init_head(cfg.d_model, **widths, device="cpu")
    h_gpu = convert.head_from_numpy(convert.params_to_numpy(h_cpu), d_model=cfg.d_model, **widths, device=card)
    repo, _ = generate(RepoSpec(video_lengths=[5000], num_instances=60, chunk_frames=1000), device="cpu")
    patches = torch.stack([frame_embedding(repo, f, dim=cfg.patch_dim, patches=cfg.num_patches)
                           for f in range(0, 5000, 500)])
    batch = {"tokens": torch.ones((10, 16), dtype=torch.int32), "patches": patches}
    detect = build_detect_step(cfg, launcher.RUN, **widths)
    before = flash_attention.launches
    gpu = detect(p_gpu, h_gpu, {k: v.to(card) for k, v in batch.items()})
    assert flash_attention.launches == before + cfg.num_layers
    ref = detect(p_cpu, h_cpu, batch)
    for a, b in zip(gpu, ref):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    assert 0 <= float(gpu.scores.min()) and float(gpu.scores.max()) <= 1
    assert 0 <= float(gpu.boxes.min()) and float(gpu.boxes.max()) <= 1
    torch.testing.assert_close(torch.linalg.vector_norm(gpu.feats, dim=-1).cpu(), torch.ones(10, 16))


# ---------------------------------------------------------------- training (B4's backward)

def _bwd_inputs(card, b, s, t, h, kv, d, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g).to(card)
                   for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d), (b, s, h, d)))
    return q, k, v, do


def _forward_with_lse(q, k, v, causal):
    b, s, h, _ = q.shape
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    return flash_attention(q, k, v, causal=causal, lse=lse), lse


@pytest.mark.parametrize("b,s,t,h,kv,d,causal", [
    (1, 256, 256, 8, 2, 128, True), (2, 100, 100, 4, 4, 64, False), (2, 64, 150, 8, 8, 64, False),
    (1, 150, 64, 10, 2, 96, True), (1, 96, 96, 4, 4, 256, True), (1, 33, 33, 5, 1, 72, True),
    (3, 1, 17, 2, 1, 8, False),
    (2, 160, 96, 8, 2, 64, True),       # G = 4 at d = 64, S > T
    (1, 130, 200, 6, 2, 256, False),    # G = 3 at d = 256 ("simt")
    (1, 1100, 1100, 5, 1, 128, True),   # qwen2.5-32b's group of G = 5
    (1, 4096, 4096, 5, 1, 128, True),   # and the train cell's walk: ~7,700 wgmmas a key of the first block
])
def test_flash_attention_bwd_kernel_equals_plain(card, b, s, t, h, kv, d, causal):
    """dQ, dK, dV within 1e-4·max |ref| each, from the forward's lse2; one
    launch counted a call, on the body ``select_bwd_body(d)``."""
    q, k, v, do = _bwd_inputs(card, b, s, t, h, kv, d, b * s + t + h + d)
    o, lse = _forward_with_lse(q, k, v, causal)
    body = select_bwd_body(d)
    before = flash_attention_bwd.launches, flash_attention_bwd.launches_by_body[body]
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    want = attention_bwd_ref(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd.launches, flash_attention_bwd.launches_by_body[body]) == \
        (before[0] + 1, before[1] + 1)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(x).all(), name
        err = float((x - y).abs().max())
        assert err <= 1e-4 * float(y.abs().max()), (name, err, float(y.abs().max()))


@pytest.mark.parametrize("b,s,t,h,kv,d,causal", [(1, 300, 300, 10, 2, 128, True), (2, 90, 150, 4, 4, 64, False),
                                                 (1, 64, 64, 4, 2, 256, True)])
def test_flash_attention_bwd_twice_gives_the_same_bits(card, b, s, t, h, kv, d, causal):
    """No atomics: two calls on the same inputs write the same bits."""
    q, k, v, do = _bwd_inputs(card, b, s, t, h, kv, d, 5 + d)
    o, lse = _forward_with_lse(q, k, v, causal)
    first = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    second = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    for x, y in zip(first, second):
        assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("b,s,t,h,kv,d,causal", [(1, 300, 300, 10, 2, 128, True), (2, 90, 150, 4, 4, 64, False),
                                                 (2, 150, 90, 4, 2, 64, True), (1, 100, 100, 4, 4, 256, True),
                                                 (1, 70, 70, 2, 2, 72, False)])
def test_the_forward_s_lse_is_the_plain_one_and_leaves_its_output_bits(card, b, s, t, h, kv, d, causal):
    """"wgmma_f32"'s lse2, times ln 2, is ``attention_lse_ref`` within 1e-5
    of its largest magnitude, and asking for it changes no bit of the
    output."""
    q, k, v, _ = _bwd_inputs(card, b, s, t, h, kv, d, 11 + d)
    o, lse = _forward_with_lse(q, k, v, causal)
    assert torch.equal(_bits(o), _bits(flash_attention(q, k, v, causal=causal)))
    want = attention_lse_ref(q, k, causal=causal)
    assert float((lse * math.log(2.0) - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_the_lse_and_the_backward_refuse_what_they_cannot_take(card):
    """lse only beside the "wgmma_f32" body; the backward's C side refuses a
    head dim or a head grouping it does not take (cudaErrorInvalidValue, no
    launch), and reports the "wgmma_f32" tiling only for the widths that
    body runs."""
    q = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="wgmma_f32"):
        flash_attention(q, q, q, lse=torch.empty(1, 2, 64, device=card))
    fn = bind("flash_attention_bwd", "flash_attention_bwd", fa_kernel._BWD_ARGTYPES)
    stream = torch.cuda.current_stream(card).cuda_stream
    for d, kv in ((12, 2), (264, 2), (64, 3)):
        x = torch.zeros(1, 64, 2, 264, device=card)
        lse = torch.zeros(1, 2, 64, device=card)
        rc = fn(*(x.data_ptr(),) * 5, lse.data_ptr(), *(x.data_ptr(),) * 3,
                lse.data_ptr(), 1, 64, 64, 2, kv, d, 1, 1.0 / math.sqrt(d), stream)
        assert rc == 1
    torch.cuda.synchronize()
    assert [fa_kernel.bwd_tiles(d)["width"] for d in (8, 64, 72, 128)] == [32, 64, 96, 128]
    with pytest.raises(RuntimeError, match="cudaError 1"):
        fa_kernel.bwd_tiles(136)


def test_no_gradient_is_lost_through_b4(card):
    """A backward through the model's attention reaches wq, wk, wv and their
    biases, as on the CPU."""
    from repro_torch.configs import ARCHS, RunConfig, scale_down
    from repro_torch.models.transformer import init_params
    from repro_torch.train.train_step import microbatch_grad

    cfg = scale_down(ARCHS["qwen2.5-32b"])
    run = RunConfig(param_dtype="float32", remat=False)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(3))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1)}
    grads = {}
    cpu_params = init_params(cfg, 0, torch.float32, "cpu")
    for dev in (card, torch.device("cpu")):
        before = flash_attention_bwd.launches
        params = copy.deepcopy(cpu_params).to(dev)
        loss, grads[dev.type] = microbatch_grad(params, {k: x.to(dev) for k, x in batch.items()}, cfg, run,
                                                moe_groups=1)
        if dev.type == "cuda":
            assert flash_attention_bwd.launches == before + cfg.num_layers
    for name, g in grads["cpu"].items():
        c = grads["cuda"][name].cpu()
        assert torch.isfinite(c).all(), name
        if name.split(".")[-1] in ("wq", "wk", "wv", "bq", "bk", "bv"):
            assert float(c.abs().max()) > 0, name
        assert float((c - g).abs().max()) <= 1e-4 * float(g.abs().max()) + 1e-6, name


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "granite-moe-1b-a400m", "phi-3-vision-4.2b", "whisper-base"])
def test_reduced_train_step_on_the_card_equals_the_cpu(card, arch):
    """A microbatch's gradients within 1e-4·max |cpu| + 1e-6 each leaf, and
    two AdamW steps of 2 microbatches with remat, the losses within 1e-4
    relative (the parameters are not compared: Adam's first steps move a
    weight whose gradient is rounding noise by ±lr)."""
    from repro_torch.configs import ARCHS, RunConfig, scale_down
    from repro_torch.models.transformer import init_params
    from repro_torch.train.train_step import build_train_step, init_train_state, microbatch_grad

    cfg = scale_down(ARCHS[arch])
    run = RunConfig(param_dtype="float32", remat=True, microbatches=2, learning_rate=1e-2)
    g = torch.Generator().manual_seed(5)
    n = 32 - (cfg.num_patches if cfg.family == "vlm" else 0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, n), generator=g),
             "labels": torch.randint(0, cfg.vocab, (4, n), generator=g)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((4, cfg.num_patches, cfg.patch_dim), generator=g)
    if cfg.encoder_layers:
        batch["frames"] = torch.randn((4, 16, cfg.d_model), generator=g)
    out = {}
    cpu_params = init_params(cfg, 0, torch.float32, "cpu")
    for dev in (card, torch.device("cpu")):
        on_dev = {k: x.to(dev) for k, x in batch.items()}
        _, grads = microbatch_grad(copy.deepcopy(cpu_params).to(dev), {k: x[:2] for k, x in on_dev.items()}, cfg,
                                   run, moe_groups=1)
        state = init_train_state(copy.deepcopy(cpu_params).to(dev), run)
        step = build_train_step(cfg, run)
        losses = []
        for _ in range(2):
            state, m = step(state, on_dev)
            losses.append(float(m["loss"]))
        out[dev.type] = (losses, {n: x.cpu() for n, x in grads.items()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for name, x in out["cpu"][1].items():
        assert float((out["cuda"][1][name] - x).abs().max()) <= 1e-4 * float(x.abs().max()) + 1e-6, name


def test_ssm_training_raises_on_the_card(card):
    """B6 (and B5) have no backward yet: a gradient through them raises
    rather than stop silently (ROADMAP A13.6b)."""
    from repro_torch.configs import ARCHS, RunConfig, scale_down
    from repro_torch.models.transformer import init_params
    from repro_torch.train.train_step import microbatch_grad

    cfg = scale_down(ARCHS["mamba2-370m"])
    params = init_params(cfg, 0, torch.float32, card)
    tokens = torch.zeros((1, 32), dtype=torch.int64, device=card)
    with pytest.raises(NotImplementedError, match="A13.6b"):
        microbatch_grad(params, {"tokens": tokens, "labels": tokens}, cfg, RunConfig(param_dtype="float32"),
                        moe_groups=1)
    q = torch.randn((1, 4, 64), device=card, requires_grad=True)
    cache = torch.randn((1, 8, 4, 64), device=card)
    from repro_torch.kernels.flash_decode import ops as decode_ops

    with pytest.raises(NotImplementedError, match="A13.6b"):
        decode_ops.decode(q, cache, cache, torch.full((1,), 8, dtype=torch.int32, device=card))
