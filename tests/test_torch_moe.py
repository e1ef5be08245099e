"""The port's MoE block and the moe family's serving path against the JAX
package, on the CPU.

Same inputs, made with numpy from a seed, through both packages; the
weights are the reference's own, carried across by ``repro_torch.convert``
(the reference's init seeds with Python's ``hash``, which changes from
process to process).  Routing is held exactly: the experts, the capacity
ranks, the keep mask, the slot owners and the dropped fraction equal the
reference's own lines (``repro.models.moe.apply_moe``) recomputed here.
Tolerances: the block's output within 1e-5 + 1e-5·|ref| and its aux loss
within 1e-6 relative (float32; the two sum in other orders), 2e-2 x
max |ref| for a bfloat16 block (the layer tests' bf16 tolerance, scaled
to the output), 1e-4 for logits and KV caches of the reduced models (the
serve tests').
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import RunConfig as JRunConfig
from repro.configs import scale_down as j_scale_down
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro.models.layers import materialize as j_materialize
from repro.models.transformer import backbone_schema as j_backbone_schema
from repro.models.transformer import forward_decode as j_forward_decode
from repro.models.transformer import forward_lm as j_forward_lm
from repro.models.transformer import init_decode_cache as j_init_decode_cache
from repro.models.transformer import init_params as j_init_params
from repro.serve.serve_step import build_decode_step as j_build_decode_step
from repro.serve.serve_step import build_prefill_step as j_build_prefill_step
from repro_torch import convert
from repro_torch.configs import ARCHS, scale_down
from repro_torch.configs.base import MoEConfig
from repro_torch.core import prng
from repro_torch.launch import serve as t_serve
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import flat_specs
from repro_torch.models.transformer import (
    backbone_schema,
    forward_decode,
    forward_lm,
    init_decode_cache,
    init_params,
)
from repro_torch.serve.serve_step import build_decode_step, build_prefill_step

J_RUN = JRunConfig(param_dtype="float32", block_q=16, block_kv=16, unroll=False, remat=False,
                   sequence_parallel=False)
RUN = t_serve.RUN
LOGIT_TOL = 1e-4
MOE_ARCHS = ["dbrx-132b", "granite-moe-1b-a400m"]
ALL_MOE = MOE_ARCHS + ["jamba-1.5-large-398b"]
D, E, K, F = 32, 8, 2, 48


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _flat_ref_schema(schema):
    return {jax.tree_util.keystr(k, simple=True, separator="."): v
            for k, v in jax.tree_util.tree_flatten_with_path(
                schema, is_leaf=lambda s: hasattr(s, "shape"))[0]}


def _block(kind, cf, seed, dtype="float32", jitter=0.0):
    """An MoE block of E experts top-K: the configs in both packages, the
    reference's materialised weights and the same as port tensors."""
    jcfg = JMoEConfig(num_experts=E, top_k=K, d_ff=F, capacity_factor=cf, router_jitter=jitter)
    cfg = MoEConfig(**dataclasses.asdict(jcfg))
    jp = j_materialize(jmoe.moe_schema(D, jcfg, kind), jax.random.PRNGKey(seed), getattr(jnp, dtype))
    tp = {n: convert._param_tensor(np.asarray(a)) for n, a in jp.items()}
    return jcfg, cfg, jp, tp


def _ref_routing(jp, x, jcfg, key=None):
    """The reference's routing lines of ``apply_moe`` (moe.py:77-99)."""
    g, t, _ = x.shape
    e, k = jcfg.num_experts, jcfg.top_k
    c = jmoe.capacity(t, jcfg)
    logits = jnp.einsum("gtd,de->gte", x, jp["router"], preferred_element_type=jnp.float32)
    if jcfg.router_jitter and key is not None:
        logits += jcfg.router_jitter * jax.random.normal(key, logits.shape)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(g, t * k)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    flat_pos = jnp.sum(pos * onehot, axis=-1)
    keep = flat_pos < c
    slot_id = jnp.where(keep, flat_e * c + jnp.minimum(flat_pos, c - 1), e * c)
    src = jnp.full((g, e * c + 1), t * k, jnp.int32)
    src = jax.vmap(lambda s, sl: s.at[sl].set(jnp.arange(t * k, dtype=jnp.int32)))(src, slot_id)[:, : e * c]
    return {"top_e": top_e, "flat_pos": flat_pos, "keep": keep, "src": src}


def _port_routing(tp, x, cfg, key=None):
    c = tmoe.capacity(x.shape[1], cfg)
    return tmoe.route(tmoe.router_logits(tp, x, cfg, key), cfg, c)


def _assert_same_routing(r, ref):
    for name in ("top_e", "flat_pos", "keep", "src"):
        np.testing.assert_array_equal(getattr(r, name).numpy(), np.asarray(ref[name]), err_msg=name)


def _input(seed, g, t, zero_rows=()):
    x = np.random.default_rng(seed).standard_normal((g, t, D)).astype(np.float32)
    for gi, ti in zero_rows:
        x[gi, ti] = 0.0
    return x


# ---------------------------------------------------------------- the block
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_moe_schema_matches_the_reference(kind):
    jcfg = JMoEConfig(num_experts=E, top_k=K, d_ff=F)
    ref = jmoe.moe_schema(D, jcfg, kind)
    port = tmoe.moe_schema(D, MoEConfig(**dataclasses.asdict(jcfg)), kind)
    assert set(port) == set(ref) == ({"router", "w_up", "w_down"} | ({"w_gate"} if kind != "gelu" else set()))
    for name, spec in port.items():
        assert (spec.shape, spec.init, spec.scale) == (ref[name].shape, ref[name].init, ref[name].scale)


@pytest.mark.parametrize("arch", ALL_MOE)
def test_capacity_and_flops_match_the_reference(arch):
    jm, m = J_ARCHS[arch].moe, ARCHS[arch].moe
    for tokens in (1, 2, 4, 7, 64, 2048, 8192):
        assert tmoe.capacity(tokens, m) == jmoe.capacity(tokens, jm)
    for tokens, d in ((1, 64), (8192, J_ARCHS[arch].d_model)):
        for kind in ("swiglu", "gelu"):
            assert tmoe.moe_flops(tokens, d, m, kind) == jmoe.moe_flops(tokens, d, jm, kind)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_apply_moe_matches_the_reference(kind, cf, groups):
    """Routing exact (no drops at capacity factor 8; the real configs'
    1.25, where the reference's per-process init decides whether any
    token drops; heavy drops at 0.25: 2 slots an expert for 48 or 96
    entries), the output and aux loss within tolerance, the dropped
    fraction exactly equal."""
    jcfg, cfg, jp, tp = _block(kind, cf, seed=3)
    x = _input(4, groups, 24)
    out, stats = tmoe.apply_moe(tp, torch.from_numpy(x), cfg, mlp_kind=kind)
    ref, jstats = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, mlp_kind=kind)
    r = _port_routing(tp, torch.from_numpy(x), cfg)
    _assert_same_routing(r, _ref_routing(jp, jnp.asarray(x), jcfg))
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert float(stats.dropped_fraction) == float(jstats.dropped_fraction)
    if cf != 1.25:
        assert (float(stats.dropped_fraction) == 0.0) == (cf == 8.0)
    np.testing.assert_allclose(float(stats.aux_loss), float(jstats.aux_loss), rtol=1e-6)


def test_apply_moe_in_bfloat16_matches_the_reference():
    """bfloat16 weights and tokens: the router in float32 (routing exact),
    the experts in bfloat16, within the bf16 tolerance scaled to the
    output: 2e-2 x max |ref| (each side rounds the expert products and the
    K-way combine to bfloat16 at other places, so a small output that is
    the sum of large contributions carries their rounding)."""
    jcfg, cfg, jp, tp = _block("swiglu", 1.25, seed=5, dtype="bfloat16")
    x = np.asarray(jnp.asarray(_input(6, 2, 24), jnp.bfloat16))
    xt = convert._param_tensor(x)
    out, stats = tmoe.apply_moe(tp, xt, cfg, mlp_kind="swiglu")
    ref, jstats = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, mlp_kind="swiglu")
    assert out.dtype == torch.bfloat16
    _assert_same_routing(_port_routing(tp, xt, cfg), _ref_routing(jp, jnp.asarray(x), jcfg))
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max())
    assert float(stats.dropped_fraction) == float(jstats.dropped_fraction)


def test_zero_rows_tie_to_the_lowest_experts():
    """A zero token gives the router equal logits: the top k are experts
    0..k-1, as jax.lax.top_k breaks ties (torch.topk does not)."""
    jcfg, cfg, jp, tp = _block("swiglu", 1.25, seed=7)
    x = _input(8, 2, 16, zero_rows=[(0, 0), (0, 5), (1, 3), (1, 15)])
    r = _port_routing(tp, torch.from_numpy(x), cfg)
    for gi, ti in [(0, 0), (0, 5), (1, 3), (1, 15)]:
        assert r.top_e[gi, ti].tolist() == list(range(K))
    _assert_same_routing(r, _ref_routing(jp, jnp.asarray(x), jcfg))
    out, _ = tmoe.apply_moe(tp, torch.from_numpy(x), cfg, mlp_kind="swiglu")
    ref, _ = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, mlp_kind="swiglu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert out[0, 0].abs().max() == 0.0          # a zero token's experts see zeros


@pytest.mark.parametrize("seed", [0, 1])
def test_router_jitter_draws_the_reference_normals(seed):
    """router_jitter 0.1 with a key: the port's normals are JAX's bit for
    bit, so the routing stays exact; without a key no jitter."""
    jcfg, cfg, jp, tp = _block("gelu", 1.25, seed=9, jitter=0.1)
    x = _input(10, 2, 24)
    jkey, key = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
    r = _port_routing(tp, torch.from_numpy(x), cfg, key)
    _assert_same_routing(r, _ref_routing(jp, jnp.asarray(x), jcfg, jkey))
    out, stats = tmoe.apply_moe(tp, torch.from_numpy(x), cfg, mlp_kind="gelu", router_key=key)
    ref, jstats = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, mlp_kind="gelu", router_key=jkey)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert float(stats.dropped_fraction) == float(jstats.dropped_fraction)
    plain = tmoe.router_logits(tp, torch.from_numpy(x), cfg)
    assert not torch.equal(tmoe.router_logits(tp, torch.from_numpy(x), cfg, key), plain)
    assert torch.equal(tmoe.router_logits(tp, torch.from_numpy(x), dataclasses.replace(cfg, router_jitter=0.0),
                                          key), plain)


def test_dropped_tokens_get_no_expert_output():
    """At capacity factor 0.25 a token whose every expert is full passes
    through with a zero MoE output; the kept slots are unique."""
    jcfg, cfg, jp, tp = _block("swiglu", 0.25, seed=11)
    x = torch.from_numpy(_input(12, 1, 32))
    r = _port_routing(tp, x, cfg)
    out, stats = tmoe.apply_moe(tp, x, cfg, mlp_kind="swiglu")
    kept = r.src[r.src < 32 * K]
    assert len(set(kept.tolist())) == kept.numel() == int(r.keep.sum())
    none = ~r.keep.reshape(1, 32, K).any(dim=-1)
    assert bool(none.any()) and float(out[none].abs().max()) == 0.0
    assert float(stats.dropped_fraction) == 1.0 - float(r.keep.float().mean())


# ---------------------------------------------------------------- the models
def _models(arch):
    jcfg, cfg = j_scale_down(J_ARCHS[arch]), scale_down(ARCHS[arch])
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                         device="cpu")


def _drop_free(cfg):
    """The same model with capacity E/k: C = the call's token count."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_backbone_schema_matches_the_reference(arch, reduced):
    jcfg, cfg = J_ARCHS[arch], ARCHS[arch]
    if reduced:
        jcfg, cfg = j_scale_down(jcfg), scale_down(cfg)
    port = flat_specs(backbone_schema(cfg))
    ref = _flat_ref_schema(j_backbone_schema(jcfg))
    assert set(port) == set(ref)
    for path, spec in port.items():
        assert (spec.shape, spec.init, spec.scale) == (ref[path].shape, ref[path].init, ref[path].scale), path
    assert all(f"layer_{i}.moe.router" in port for i in range(cfg.num_layers))
    assert not any(".mlp." in p for p in port)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_logits_match_the_reference(arch, groups):
    jcfg, cfg, jparams, params = _models(arch)
    tokens = _tokens(11, 2, 32, cfg.vocab)
    ref = jax.jit(j_build_prefill_step(jcfg, J_RUN, moe_groups=groups))(jparams, {"tokens": jnp.asarray(tokens)})
    stats = []
    out = build_prefill_step(cfg, RUN, moe_groups=groups)(params, {"tokens": torch.from_numpy(tokens)},
                                                          moe_stats=stats)
    assert out.shape == (2, cfg.vocab) and len(stats) == cfg.num_layers
    _close(out, ref, LOGIT_TOL)
    full = j_forward_lm(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, J_RUN, mode="train", moe_groups=groups)
    _close(forward_lm(params, {"tokens": torch.from_numpy(tokens)}, cfg, RUN, mode="train", moe_groups=groups),
           full, LOGIT_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_logits_and_caches_match_the_reference(arch):
    """Eight decode steps of 8 sequences at the real capacity (C = 5 slots
    an expert for 16 (token, k) entries; the near-uniform router loads an
    expert Binomial(8, 1/2), over 5 in ~15% of the experts, so among the
    16 (layer, step) routings some drop whatever the reference's
    per-process init): the logits and KV caches equal the reference's."""
    jcfg, cfg, jparams, params = _models(arch)
    b, steps, max_len = 8, 8, 10
    tokens = _tokens(12, b, steps, cfg.vocab)
    jstep = jax.jit(j_forward_decode, static_argnums=(3, 4))
    jcache = j_init_decode_cache(jcfg, b, max_len, jnp.float32)
    cache = init_decode_cache(cfg, b, max_len, torch.float32, device="cpu")
    stats = []
    for t in range(steps):
        jlogits, jcache = jstep(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache, jcfg, J_RUN)
        logits, cache = forward_decode(params, torch.from_numpy(tokens[:, t:t + 1]), cache, cfg, RUN,
                                       moe_stats=stats)
        assert cache.pos == t + 1 == int(jcache.pos)
        _close(logits, jlogits, LOGIT_TOL)
        for kc, jkc in zip(cache.layers, jcache.layers, strict=True):
            _close(kc.k, jkc.k, LOGIT_TOL)
            _close(kc.v, jkc.v, LOGIT_TOL)
    assert len(stats) == steps * cfg.num_layers
    assert max(float(s.dropped_fraction) for s in stats) > 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_teacher_forcing_without_drops(arch):
    """On the drop-free copy (capacity factor E/k) decode from an empty
    cache, fed the tokens one by one, gives the full forward's logits at
    every position (the port alone, its own init)."""
    cfg = _drop_free(scale_down(ARCHS[arch]))
    params = init_params(cfg, seed=0, device="cpu")
    b, s = 2, 8
    tokens = torch.from_numpy(_tokens(1, b, s, cfg.vocab))
    stats = []
    full = forward_lm(params, {"tokens": tokens}, cfg, RUN, mode="prefill", moe_stats=stats)
    cache = init_decode_cache(cfg, b, s, torch.float32, device="cpu")
    for t in range(s):
        logits, cache = forward_decode(params, tokens[:, t:t + 1], cache, cfg, RUN, moe_stats=stats)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), rtol=2e-4, atol=2e-4)
    assert all(float(st.dropped_fraction) == 0.0 for st in stats)


def test_moe_groups_that_do_not_divide_the_tokens_raise():
    cfg = scale_down(ARCHS["granite-moe-1b-a400m"])
    params = init_params(cfg, device="cpu")
    tokens = {"tokens": torch.from_numpy(_tokens(2, 1, 6, cfg.vocab))}
    forward_lm(params, tokens, cfg, RUN, moe_groups=3)
    with pytest.raises(ValueError, match="moe_groups 4 does not divide the 6 tokens"):
        forward_lm(params, tokens, cfg, RUN, moe_groups=4)
    cache = init_decode_cache(cfg, 3, 2, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="moe_groups 2 does not divide the 3 tokens"):
        build_decode_step(cfg, RUN, moe_groups=2)(params, torch.zeros(3, 1, dtype=torch.int32), cache)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_flow_matches_the_reference_launcher(arch):
    """The launcher's flow, as ``repro.launch.serve`` runs it (prefill, then
    greedy decode from an empty cache, ROADMAP C5), on the reference's
    weights and the same prompt: the same tokens, logits within tolerance."""
    b, s, n = 2, 32, 8
    jcfg, cfg, jparams, params = _models(arch)
    prompt = _tokens(13, b, s, cfg.vocab)
    jlogits = jax.jit(j_build_prefill_step(jcfg, J_RUN))(jparams, {"tokens": jnp.asarray(prompt)})
    jdecode = jax.jit(j_build_decode_step(jcfg, J_RUN))
    jcache = j_init_decode_cache(jcfg, b, s + n + 1, jnp.float32)
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    jtoks, jsteps = [tok], []
    for _ in range(n):
        tok, lg, jcache = jdecode(jparams, tok, jcache)
        jtoks.append(tok)
        jsteps.append(lg)
    stats = []
    res = t_serve.serve(params, cfg, RUN, {"tokens": torch.from_numpy(prompt)}, n, keep_logits=True,
                        moe_stats=stats)
    _close(res.prefill_logits, jlogits, LOGIT_TOL)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jnp.concatenate(jtoks, axis=1)))
    for lg, jlg in zip(res.step_logits, jsteps, strict=True):
        _close(lg, jlg, LOGIT_TOL)
    assert [len(st) for st in stats] == [cfg.num_layers] * (n + 1)
    plain = t_serve.serve(params, cfg, RUN, {"tokens": torch.from_numpy(prompt)}, n, keep_logits=True)
    assert torch.equal(plain.tokens, res.tokens) and torch.equal(plain.prefill_logits, res.prefill_logits)


def test_launcher_runs_on_the_cpu_when_asked(capsys):
    """The reference launcher's lines for ``--arch granite-moe-1b-a400m``."""
    t_serve.main(["--device", "cpu", "--arch", "granite-moe-1b-a400m", "--tokens", "8"])
    out = capsys.readouterr().out
    assert "prefill [2×32] → logits (2, 256)" in out
    assert "decoded 8 tokens/seq" in out and "tok/s on cpu" in out
    sample = eval(out.split("sample:")[1].strip())
    assert len(sample) == 9 and all(0 <= t < 256 for t in sample)
