"""The port's hybrid family (jamba: Mamba-2 layers with an attention layer
every 8th, MoE on every 2nd) against the JAX package, on the CPU.

``scale_down``'s 2 layers hold no attention layer, so the reduced model
here is ``scale_down(cfg, layers=8)``: Mamba-2 on layers 0–6, attention
on layer 7, the MoE block on the odd layers and the dense MLP on the even
ones.  Same inputs, made with numpy from a seed, through both packages;
the weights are the reference's own, carried across by
``repro_torch.convert``.  Tolerance 1e-4 for logits and decode caches
(the serve tests'), 2e-4 for decode against the full forward (the
reference's own test's).
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
from repro.models.transformer import backbone_schema as j_backbone_schema
from repro.models.transformer import forward_decode as j_forward_decode
from repro.models.transformer import forward_lm as j_forward_lm
from repro.models.transformer import init_decode_cache as j_init_decode_cache
from repro.models.transformer import init_params as j_init_params
from repro.serve.serve_step import build_decode_step as j_build_decode_step
from repro.serve.serve_step import build_prefill_step as j_build_prefill_step
from repro_torch import convert
from repro_torch.configs import ARCHS, scale_down
from repro_torch.launch import serve as t_serve
from repro_torch.models import mamba2 as tm
from repro_torch.models.layers import flat_specs
from repro_torch.models.transformer import (
    KVCache,
    backbone_schema,
    forward_decode,
    forward_lm,
    init_decode_cache,
    init_params,
)
from repro_torch.serve.serve_step import build_prefill_step

ARCH = "jamba-1.5-large-398b"
LAYERS = 8
J_RUN = JRunConfig(param_dtype="float32", block_q=16, block_kv=16, unroll=False, remat=False,
                   sequence_parallel=False)
RUN = t_serve.RUN
LOGIT_TOL = 1e-4


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _models(layers=LAYERS):
    jcfg = j_scale_down(J_ARCHS[ARCH], layers=layers)
    cfg = scale_down(ARCHS[ARCH], layers=layers)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                         device="cpu")


def _same_cache(cache, jcache, tol):
    for layer, jlayer in zip(cache.layers, jcache.layers, strict=True):
        if isinstance(layer, KVCache):
            _close(layer.k, jlayer.k, tol)
            _close(layer.v, jlayer.v, tol)
        else:
            port = convert.mamba_cache_to_numpy(layer)
            np.testing.assert_allclose(port["conv"], np.asarray(jlayer.conv), rtol=tol, atol=tol)
            np.testing.assert_allclose(port["ssm"], np.asarray(jlayer.ssm), rtol=tol, atol=tol)


@pytest.mark.parametrize("layers", [None, 2, LAYERS])
def test_backbone_schema_matches_the_reference(layers):
    """Full width (72 layers) and reduced: layer by layer as the reference,
    with the layer kinds the interleave gives."""
    jcfg, cfg = J_ARCHS[ARCH], ARCHS[ARCH]
    if layers is not None:
        jcfg, cfg = j_scale_down(jcfg, layers=layers), scale_down(cfg, layers=layers)
    port = flat_specs(backbone_schema(cfg))
    ref = {jax.tree_util.keystr(k, simple=True, separator="."): v
           for k, v in jax.tree_util.tree_flatten_with_path(
               j_backbone_schema(jcfg), is_leaf=lambda s: hasattr(s, "shape"))[0]}
    assert set(port) == set(ref)
    for path, spec in port.items():
        assert (spec.shape, spec.init, spec.scale) == (ref[path].shape, ref[path].init, ref[path].scale), path
    for i in range(cfg.num_layers):
        assert (f"layer_{i}.attn.wq" in port) == (i % 8 == 7)
        assert (f"layer_{i}.mamba.wx" in port) == (i % 8 != 7)
        assert (f"layer_{i}.moe.router" in port) == (i % 2 == 1)
        assert (f"layer_{i}.mlp.w_up" in port) == (i % 2 == 0)


def test_decode_cache_layers_follow_the_interleave():
    cfg, jcfg = scale_down(ARCHS[ARCH], layers=LAYERS), j_scale_down(J_ARCHS[ARCH], layers=LAYERS)
    cache = init_decode_cache(cfg, 2, 5, torch.float32, device="cpu")
    jcache = j_init_decode_cache(jcfg, 2, 5, jnp.float32)
    for i, (layer, jlayer) in enumerate(zip(cache.layers, jcache.layers, strict=True)):
        assert isinstance(layer, KVCache if i == 7 else tm.MambaCache)
        assert tuple(x.shape for x in layer) == tuple(x.shape for x in jlayer)


@pytest.mark.parametrize("groups", [1, 2])
def test_prefill_logits_match_the_reference(groups):
    """Prompt 64 = 2 chunks of 32: the serve step's next-token logits and
    every position of the full forward, with the layer's tokens routed as
    1 or 2 groups."""
    jcfg, cfg, jparams, params = _models()
    tokens = _tokens(11, 2, 64, cfg.vocab)
    ref = jax.jit(j_build_prefill_step(jcfg, J_RUN, moe_groups=groups))(jparams, {"tokens": jnp.asarray(tokens)})
    stats = []
    out = build_prefill_step(cfg, RUN, moe_groups=groups)(params, {"tokens": torch.from_numpy(tokens)},
                                                          moe_stats=stats)
    assert out.shape == (2, cfg.vocab) and len(stats) == LAYERS // 2
    _close(out, ref, LOGIT_TOL)
    full = j_forward_lm(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, J_RUN, mode="train", moe_groups=groups)
    _close(forward_lm(params, {"tokens": torch.from_numpy(tokens)}, cfg, RUN, mode="train", moe_groups=groups),
           full, LOGIT_TOL)


def test_decode_logits_and_caches_match_the_reference():
    """Four steps of 8 sequences at the real capacity (drops included):
    logits, the attention layer's K/V and the Mamba-2 layers' windows and
    states."""
    jcfg, cfg, jparams, params = _models()
    b, steps = 8, 4
    tokens = _tokens(12, b, steps, cfg.vocab)
    jstep = jax.jit(j_forward_decode, static_argnums=(3, 4))
    jcache = j_init_decode_cache(jcfg, b, steps + 1, jnp.float32)
    cache = init_decode_cache(cfg, b, steps + 1, torch.float32, device="cpu")
    stats = []
    for t in range(steps):
        jlogits, jcache = jstep(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache, jcfg, J_RUN)
        logits, cache = forward_decode(params, torch.from_numpy(tokens[:, t:t + 1]), cache, cfg, RUN,
                                       moe_stats=stats)
        assert cache.pos == t + 1 == int(jcache.pos)
        _close(logits, jlogits, LOGIT_TOL)
        _same_cache(cache, jcache, LOGIT_TOL)
    assert max(float(s.dropped_fraction) for s in stats) > 0.0


def test_decode_matches_teacher_forcing_without_drops():
    """On the drop-free copy (capacity factor E/k): decode from a zero
    cache, fed the tokens one by one, equals the full forward at every
    position (the port alone, its own init)."""
    cfg = scale_down(ARCHS[ARCH], layers=LAYERS)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(_tokens(1, 2, 16, cfg.vocab))
    stats = []
    full = forward_lm(params, {"tokens": tokens}, cfg, RUN, mode="prefill", moe_stats=stats)
    cache = init_decode_cache(cfg, 2, 17, torch.float32, device="cpu")
    for t in range(16):
        logits, cache = forward_decode(params, tokens[:, t:t + 1], cache, cfg, RUN, moe_stats=stats)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), rtol=2e-4, atol=2e-4)
    assert all(float(st.dropped_fraction) == 0.0 for st in stats)


def test_serve_flow_matches_the_reference_launcher():
    """The launcher's flow as ``repro.launch.serve`` runs it (prefill, then
    greedy decode from a zero cache, ROADMAP C5): the same tokens, logits
    within tolerance."""
    b, s, n = 2, 64, 8
    jcfg, cfg, jparams, params = _models()
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
    res = t_serve.serve(params, cfg, RUN, {"tokens": torch.from_numpy(prompt)}, n, keep_logits=True)
    _close(res.prefill_logits, jlogits, LOGIT_TOL)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jnp.concatenate(jtoks, axis=1)))
    for lg, jlg in zip(res.step_logits, jsteps, strict=True):
        _close(lg, jlg, LOGIT_TOL)
    _same_cache(res.cache, jcache, LOGIT_TOL)
    assert res.cache.pos == n


def test_launcher_runs_on_the_cpu_when_asked(capsys):
    """The reference launcher's lines for ``--arch jamba-1.5-large-398b``
    (``scale_down``'s 2 Mamba-2 layers, the second with the MoE)."""
    t_serve.main(["--device", "cpu", "--arch", ARCH, "--tokens", "8"])
    out = capsys.readouterr().out
    assert "prefill [2×32] → logits (2, 256)" in out
    assert "decoded 8 tokens/seq" in out and "tok/s on cpu" in out
    sample = eval(out.split("sample:")[1].strip())
    assert len(sample) == 9 and all(0 <= t < 256 for t in sample)


@pytest.mark.parametrize("prompt_len", [48, 40])
def test_a_prompt_that_is_not_a_multiple_of_the_chunk_raises(prompt_len):
    """The ssm rule holds for the hybrid's Mamba-2 layers: with chunk 32, a
    prompt of 48 or 40 cannot be cut into chunks."""
    with pytest.raises(ValueError, match="not a multiple of the chunk 32"):
        t_serve.main(["--device", "cpu", "--arch", ARCH, "--prompt-len", str(prompt_len), "--tokens", "1"])
