"""The port's Mamba-2 block and the ssm family's serving path against the
JAX package, on the CPU.

Same inputs, made with numpy from a seed, through both packages; the
weights are the reference's own, carried across by ``repro_torch.convert``
(the reference's init depends on the process, ROADMAP C6).  The port's
SSD runs kernel B6's plain version here.  Tolerances: 2e-4 for one block
(the reference's own for its SSD kernel), 1e-4 for logits and decode
caches of the reduced model (float32 throughout; the two sum in other
orders), and the reference's 5e-4 for decode against prefill
(``tests/test_mamba2.py``).
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
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import mamba2 as jm
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
from repro_torch.configs.base import SSMConfig
from repro_torch.launch import serve as t_serve
from repro_torch.models import mamba2 as tm
from repro_torch.models.layers import empty_params, flat_specs
from repro_torch.models.transformer import (
    backbone_schema,
    forward_decode,
    forward_lm,
    init_decode_cache,
    init_params,
)

ARCH = "mamba2-370m"
J_RUN = JRunConfig(param_dtype="float32", block_q=16, block_kv=16, unroll=False, remat=False,
                   sequence_parallel=False)
RUN = t_serve.RUN
BLOCK_TOL = 2e-4
LOGIT_TOL = 1e-4


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _block_params(jp, schema):
    """The reference block's parameters (a flat dict) in the port's tree
    for ``schema``, name for name."""
    tp = empty_params(schema, torch.float32, "cpu")
    named = dict(tp.named_parameters())
    assert set(named) == set(jp)
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(torch.from_numpy(np.array(jp[name])))
    return tp


def _block(d_model, jcfg, seed):
    """One Mamba-2 block: the reference's materialised parameters and the
    same in the port."""
    jp = j_materialize(jm.mamba_schema(d_model, jcfg), jax.random.PRNGKey(seed), jnp.float32)
    cfg = SSMConfig(**dataclasses.asdict(jcfg))
    return jp, _block_params(jp, tm.mamba_schema(d_model, cfg)), cfg


def _models():
    jcfg, cfg = j_scale_down(J_ARCHS[ARCH]), scale_down(ARCHS[ARCH])
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                         device="cpu")


# ---------------------------------------------------------------- the block
@pytest.mark.parametrize("arch", [ARCH, "jamba-1.5-large-398b"])
def test_schema_dims_and_flops_match_the_reference(arch):
    jcfg = J_ARCHS[arch]
    cfg = ARCHS[arch]
    for d_model in (64, jcfg.d_model):
        assert tm.mamba_dims(d_model, cfg.ssm) == jm.mamba_dims(d_model, jcfg.ssm)
        assert tm.mamba_flops(8192, d_model, cfg.ssm) == jm.mamba_flops(8192, d_model, jcfg.ssm)
        ref = jm.mamba_schema(d_model, jcfg.ssm)
        port = tm.mamba_schema(d_model, cfg.ssm)
        assert set(port) == set(ref)
        for name, spec in port.items():
            assert (spec.shape, spec.init, spec.scale) == (ref[name].shape, ref[name].init,
                                                         ref[name].scale), name


@pytest.mark.parametrize("s,chunk", [(64, 32), (64, 64), (16, 32)])
def test_apply_mamba_matches_the_reference(s, chunk):
    """The prefill block on the reduced widths, with 2, 1 and a cut chunk
    (min(chunk, S))."""
    jcfg = JSSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk_len=chunk)
    jp, tp, cfg = _block(64, jcfg, seed=1)
    x = 0.5 * np.random.default_rng(2).standard_normal((2, s, 64)).astype(np.float32)
    out = tm.apply_mamba(tp, torch.from_numpy(x), cfg)
    assert out.shape == (2, s, 64) and out.dtype == torch.float32
    _close(out, jm.apply_mamba(jp, jnp.asarray(x), jcfg), BLOCK_TOL)


def test_apply_mamba_decode_matches_the_reference():
    """Eight decode steps of one block from a zero cache, each step's output
    and cache (conv window, state) against the reference's."""
    jcfg = JSSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk_len=32)
    jp, tp, cfg = _block(64, jcfg, seed=3)
    x = 0.5 * np.random.default_rng(4).standard_normal((2, 8, 64)).astype(np.float32)
    jcache = jm.init_cache(2, 64, jcfg, jnp.float32)
    cache = tm.init_cache(2, 64, cfg, torch.float32, "cpu")
    for t in range(8):
        jy, jcache = jm.apply_mamba_decode(jp, jnp.asarray(x[:, t:t + 1]), jcache, jcfg)
        y, cache = tm.apply_mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]), cache, cfg)
        _close(y, jy, BLOCK_TOL)
        _close(cache.conv, jcache.conv, BLOCK_TOL)
        _close(cache.ssm, jcache.ssm, BLOCK_TOL)


def test_block_decode_matches_prefill():
    """The port's counterpart of ``tests/test_mamba2.py::
    test_decode_matches_prefill``: token by token through the decode step
    equals the prefill block, with the reference's config and tolerance."""
    cfg = SSMConfig(state_dim=8, head_dim=4, expand=2, conv_width=4, chunk_len=8)
    tp = _block_params(j_materialize(jm.mamba_schema(8, JSSMConfig(**dataclasses.asdict(cfg))),
                                     jax.random.PRNGKey(5), jnp.float32),
                       tm.mamba_schema(8, cfg))
    x = torch.from_numpy(0.5 * np.random.default_rng(6).standard_normal((2, 16, 8)).astype(np.float32))
    full = tm.apply_mamba(tp, x, cfg)
    cache = tm.init_cache(2, 8, cfg, torch.float32, "cpu")
    outs = []
    for t in range(16):
        y, cache = tm.apply_mamba_decode(tp, x[:, t:t + 1], cache, cfg)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_cache_round_trip(dtype):
    """``convert`` carries a layer's cache both ways: the window in the
    parameters' dtype, the state always float32, as ``init_cache`` makes
    them."""
    jcfg = JSSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk_len=32)
    jcache = jm.init_cache(2, 64, jcfg, getattr(jnp, dtype))
    rng = np.random.default_rng(7)
    d = {"conv": np.asarray(jnp.asarray(rng.standard_normal(jcache.conv.shape), getattr(jnp, dtype))),
         "ssm": rng.standard_normal(jcache.ssm.shape).astype(np.float32)}
    cache = convert.mamba_cache_from_numpy(d, device="cpu")
    ref = tm.init_cache(2, 64, SSMConfig(**dataclasses.asdict(jcfg)), getattr(torch, dtype), "cpu")
    assert (cache.conv.dtype, cache.ssm.dtype) == (ref.conv.dtype, ref.ssm.dtype)
    assert (cache.conv.shape, cache.ssm.shape) == (ref.conv.shape, ref.ssm.shape)
    back = convert.mamba_cache_to_numpy(cache)
    np.testing.assert_array_equal(back["conv"], d["conv"].astype(np.float32))
    np.testing.assert_array_equal(back["ssm"], d["ssm"])


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("reduced", [False, True])
def test_backbone_schema_matches_the_reference(reduced):
    """Layer by layer as the reference: no attention (attn_every_k = 0); no
    MLP at full width (d_ff = 0), a gelu MLP in the reduced config
    (scale_down's d_ff = 128)."""
    jcfg, cfg = J_ARCHS[ARCH], ARCHS[ARCH]
    if reduced:
        jcfg, cfg = j_scale_down(jcfg), scale_down(cfg)
    port = flat_specs(backbone_schema(cfg))
    ref = {jax.tree_util.keystr(k, simple=True, separator="."): v
           for k, v in jax.tree_util.tree_flatten_with_path(
               j_backbone_schema(jcfg), is_leaf=lambda s: hasattr(s, "shape"))[0]}
    assert set(port) == set(ref)
    for path, spec in port.items():
        assert spec.shape == ref[path].shape and spec.init == ref[path].init, path
    assert not any(".attn." in p for p in port)
    assert any(".mlp." in p for p in port) == reduced


def test_full_width_decode_cache_has_no_kv_layers():
    """Full mamba2-370m has no attention heads (num_heads = 0): its decode
    cache is one MambaCache a layer, shaped as the reference's."""
    cfg, jcfg = ARCHS[ARCH], J_ARCHS[ARCH]
    cache = init_decode_cache(cfg, 1, 4, torch.float32, device="cpu")
    jcache = jax.eval_shape(lambda: j_init_decode_cache(jcfg, 1, 4, jnp.float32))
    assert len(cache.layers) == cfg.num_layers and cache.pos == 0
    for layer, jlayer in zip(cache.layers, jcache.layers):
        assert isinstance(layer, tm.MambaCache)
        assert layer.conv.shape == jlayer.conv.shape and layer.ssm.shape == jlayer.ssm.shape
        assert layer.ssm.dtype == torch.float32 and not layer.ssm.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(dtype):
    jcfg, cfg = j_scale_down(J_ARCHS[ARCH]), scale_down(ARCHS[ARCH])
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(3), getattr(jnp, dtype)))
    params = convert.params_from_numpy(tree, cfg, device="cpu")
    assert {p.dtype for p in params.parameters()} == {getattr(torch, dtype)}
    assert "mamba" in params["layer_0"] and "attn" not in params["layer_0"]
    back = convert.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b.astype(np.float32))
    init = convert.params_to_numpy(init_params(cfg, seed=0, device="cpu"))
    assert jax.tree.structure(init) == jax.tree.structure(tree)


def test_prefill_logits_match_the_reference():
    """Reduced mamba2-370m, prompt 64 = 2 chunks of 32: the serve step's
    next-token logits and every position of the full forward."""
    jcfg, cfg, jparams, params = _models()
    tokens = _tokens(11, 2, 64, cfg.vocab)
    ref = jax.jit(j_build_prefill_step(jcfg, J_RUN))(jparams, {"tokens": jnp.asarray(tokens)})
    out = t_serve.build_prefill_step(cfg, RUN)(params, {"tokens": torch.from_numpy(tokens)})
    assert out.shape == (2, cfg.vocab)
    _close(out, ref, LOGIT_TOL)
    full = j_forward_lm(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, J_RUN, mode="train")
    _close(forward_lm(params, {"tokens": torch.from_numpy(tokens)}, cfg, RUN, mode="train"),
           full, LOGIT_TOL)


def test_decode_logits_and_caches_match_the_reference():
    jcfg, cfg, jparams, params = _models()
    b, steps = 2, 8
    tokens = _tokens(12, b, steps, cfg.vocab)
    jstep = jax.jit(j_forward_decode, static_argnums=(3, 4))
    jcache = j_init_decode_cache(jcfg, b, steps + 1, jnp.float32)
    cache = init_decode_cache(cfg, b, steps + 1, torch.float32, device="cpu")
    for t in range(steps):
        jlogits, jcache = jstep(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache, jcfg, J_RUN)
        logits, cache = forward_decode(params, torch.from_numpy(tokens[:, t:t + 1]), cache, cfg, RUN)
        assert cache.pos == t + 1 == int(jcache.pos)
        _close(logits, jlogits, LOGIT_TOL)
        for mc, jmc in zip(cache.layers, jcache.layers, strict=True):
            port = convert.mamba_cache_to_numpy(mc)
            np.testing.assert_allclose(port["conv"], np.asarray(jmc.conv), rtol=LOGIT_TOL, atol=LOGIT_TOL)
            np.testing.assert_allclose(port["ssm"], np.asarray(jmc.ssm), rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_decode_matches_teacher_forcing():
    """Decode from a zero cache, fed the tokens one by one, gives the full
    forward's logits at every position (the port alone, its own init)."""
    cfg = scale_down(ARCHS[ARCH])
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(_tokens(1, 2, 16, cfg.vocab))
    full = forward_lm(params, {"tokens": tokens}, cfg, RUN, mode="prefill")
    cache = init_decode_cache(cfg, 2, 17, torch.float32, device="cpu")
    for t in range(16):
        logits, cache = forward_decode(params, tokens[:, t:t + 1], cache, cfg, RUN)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), rtol=2e-4, atol=2e-4)


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
    assert res.cache.pos == n and isinstance(res.cache.layers[0], tm.MambaCache)


def test_launcher_runs_on_the_cpu_when_asked(capsys):
    """The reference launcher's lines for ``--arch mamba2-370m``."""
    t_serve.main(["--device", "cpu", "--arch", ARCH, "--prompt-len", "64", "--tokens", "8"])
    out = capsys.readouterr().out
    assert "prefill [2×64] → logits (2, 256)" in out
    assert "decoded 8 tokens/seq" in out and "tok/s on cpu" in out
    sample = eval(out.split("sample:")[1].strip())
    assert len(sample) == 9 and all(0 <= t < 256 for t in sample)


@pytest.mark.parametrize("prompt_len", [48, 40])
def test_a_prompt_that_is_not_a_multiple_of_the_chunk_raises(prompt_len):
    """As the reference's assert (``mamba2.py:124``): with chunk 32, a
    prompt of 48 or 40 cannot be cut into chunks."""
    with pytest.raises(ValueError, match="not a multiple of the chunk 32"):
        t_serve.main(["--device", "cpu", "--arch", ARCH, "--prompt-len", str(prompt_len), "--tokens", "1"])
