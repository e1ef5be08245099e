"""The port's dense LM serving path against the JAX package, on the CPU.

Same inputs, made with numpy from a seed, through both packages; the
weights are the reference's own, carried across by ``repro_torch.convert``
(the reference's init seeds with Python's ``hash``, which changes with
``PYTHONHASHSEED``, so two inits are never compared).  The port's
attention runs its kernels' plain versions here.  Tolerances: 1e-5 for
float32 layers, 2e-2 for bfloat16 ones, 1e-4 for float32 logits and KV
caches (the reference's XLA programs and the port's PyTorch ones sum in
other orders; both are float32 throughout).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import RunConfig as JRunConfig
from repro.configs import scale_down as j_scale_down
from repro.models import layers as jl
from repro.models.transformer import forward_decode as j_forward_decode
from repro.models.transformer import forward_lm as j_forward_lm
from repro.models.transformer import init_decode_cache as j_init_decode_cache
from repro.models.transformer import init_params as j_init_params
from repro.serve.serve_step import build_decode_step as j_build_decode_step
from repro.serve.serve_step import build_prefill_step as j_build_prefill_step
from repro_torch import convert
from repro_torch.configs import ARCHS, RunConfig, get_config, scale_down
from repro_torch.launch import serve as t_serve
from repro_torch.models import layers as tl
from repro_torch.models.transformer import (
    forward_decode,
    forward_lm,
    init_decode_cache,
    init_params,
)

# the reference launcher's RunConfig (launch/serve.py)
J_RUN = JRunConfig(param_dtype="float32", block_q=16, block_kv=16, unroll=False, remat=False,
                   sequence_parallel=False)
RUN = t_serve.RUN
LOGIT_TOL = 1e-4
DENSE = ["phi3-medium-14b", "gemma-7b", "qwen2.5-32b", "granite-20b"]


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port.float().numpy() if isinstance(port, torch.Tensor)
                                          else port, np.float32),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


def _models(arch):
    """Reduced config in both packages, the reference's weights, and the
    same weights in the port."""
    jcfg = j_scale_down(J_ARCHS[arch])
    cfg = scale_down(ARCHS[arch])
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, convert.params_from_numpy(tree, cfg, device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------- configs
def test_registry_matches_the_reference():
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for name, jcfg in J_ARCHS.items():
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(scale_down(ARCHS[name])) == dataclasses.asdict(j_scale_down(jcfg))
    assert RUN.dtype() == torch.float32


def test_run_config_is_a_subset_of_the_reference():
    """Each knob the port keeps has the reference's name and default, and
    the launcher's run settings agree on it."""
    j_fields = {f.name: f.default for f in dataclasses.fields(JRunConfig)}
    for f in dataclasses.fields(RunConfig):
        assert j_fields[f.name] == f.default
        assert getattr(RUN, f.name) == getattr(J_RUN, f.name)
    assert RunConfig().dtype() == torch.bfloat16


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_the_reference(dtype):
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    x, g, b = _normal(1, 2, 5, 32) * 3, 1 + 0.1 * _normal(2, 32), 0.1 * _normal(3, 32)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    T = lambda a: torch.from_numpy(a).to(tt)                                  # noqa: E731
    J = lambda a: jnp.asarray(a, jt)                                          # noqa: E731
    out = tl.rmsnorm(T(x), T(g))
    assert out.dtype == tt
    _close(out, jl.rmsnorm(J(x), J(g)).astype(jnp.float32), tol)
    _close(tl.layernorm(T(x), T(g), T(b)), jl.layernorm(J(x), J(g), J(b)).astype(jnp.float32), tol)
    _close(tl.apply_norm("layernorm", {"gamma": T(g), "beta": T(b)}, T(x)),
           jl.apply_norm("layernorm", {"gamma": J(g), "beta": J(b)}, J(x)).astype(jnp.float32), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_the_reference(dtype):
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    x = _normal(4, 2, 6, 3, 16)
    np.testing.assert_allclose(tl.rope_freqs(16, 10_000.0).numpy(), jl.rope_freqs(16, 10_000.0),
                               rtol=1e-6)
    for pos in (np.arange(6)[None, :], np.full((2, 1), 37)):
        xs = x[:, : pos.shape[1]]
        out = tl.apply_rope(torch.from_numpy(xs).to(tt), torch.from_numpy(pos), 10_000.0)
        assert out.dtype == tt
        ref = jl.apply_rope(jnp.asarray(xs, jt), jnp.asarray(pos, jnp.int32), 10_000.0)
        _close(out, ref.astype(jnp.float32), tol)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_the_reference(kind):
    names = ("w_gate", "w_up", "w_down") if kind != "gelu" else ("w_up", "w_down")
    shapes = {"w_gate": (32, 48), "w_up": (32, 48), "w_down": (48, 32)}
    p = {n: _normal(10 + i, *shapes[n]) / 6 for i, n in enumerate(names)}
    x = _normal(5, 2, 3, 32)
    out = tl.apply_mlp({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x), kind)
    ref = jl.apply_mlp({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), kind)
    _close(out, ref, 1e-5)


def test_embed_and_unembed_match_the_reference():
    table = _normal(6, 50, 32) / np.sqrt(32)
    tokens = _tokens(7, 2, 9, 50)
    x = tl.apply_embed({"table": torch.from_numpy(table)}, torch.from_numpy(tokens), 32)
    ref = jl.apply_embed({"table": jnp.asarray(table)}, jnp.asarray(tokens), 32)
    _close(x, ref, 1e-6)                  # a gather and one multiply (XLA may differ by 1 ulp)
    _close(tl.apply_unembed({"table": torch.from_numpy(table)}, x),
           jl.apply_unembed({"table": jnp.asarray(table)}, ref), 1e-5)


# ---------------------------------------------------------------- parameters
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2.5-32b", "gemma-7b"])
def test_params_round_trip(arch, dtype):
    jcfg, cfg = j_scale_down(J_ARCHS[arch]), scale_down(ARCHS[arch])
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(3), getattr(jnp, dtype)))
    params = convert.params_from_numpy(tree, cfg, device="cpu")
    assert {p.dtype for p in params.parameters()} == {getattr(torch, dtype)}
    back = convert.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b.astype(np.float32))
    if cfg.qkv_bias:
        assert "bq" in params["layer_0"]["attn"] and "bq" in back["layer_0"]["attn"]
    with pytest.raises(KeyError, match="parameter paths differ"):
        convert.params_from_numpy({k: v for k, v in tree.items() if k != "norm_f"}, cfg, device="cpu")


def test_init_is_seeded_by_path_not_by_process():
    """The port's init depends on the seed and the parameter's path only:
    the same in another process with another PYTHONHASHSEED."""
    cfg = scale_down(ARCHS["phi3-medium-14b"])
    a = convert.params_to_numpy(init_params(cfg, seed=5, device="cpu"))
    b = convert.params_to_numpy(init_params(cfg, seed=5, device="cpu"))
    c = convert.params_to_numpy(init_params(cfg, seed=6, device="cpu"))
    for x, y, z in zip(jax.tree.leaves(a), jax.tree.leaves(b), jax.tree.leaves(c)):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a["layer_0"]["attn"]["wq"], c["layer_0"]["attn"]["wq"])
    np.testing.assert_allclose(a["layer_1"]["mlp"]["w_down"].std(), 1 / np.sqrt(cfg.d_ff), rtol=0.1)
    code = ("from repro_torch.configs import ARCHS, scale_down\n"
            "from repro_torch.models.transformer import init_params\n"
            "p = init_params(scale_down(ARCHS['phi3-medium-14b']), seed=5, device='cpu')\n"
            "print(repr(float(p.layer_1.attn.wk.double().sum())))\n")
    env = dict(os.environ, PYTHONHASHSEED="123", PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    assert float(out.stdout) == float(torch.from_numpy(a["layer_1"]["attn"]["wk"]).double().sum())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_arch_builds_a_schema_and_a_decode_cache(arch):
    """Every family of ``ARCHS`` builds on the CPU: the reduced model's
    parameters (the reference's paths and shapes) and its zeroed decode
    cache (the reference's per-layer and cross shapes)."""
    cfg, jcfg = scale_down(ARCHS[arch]), j_scale_down(J_ARCHS[arch])
    params = init_params(cfg, device="cpu")
    ref = jax.eval_shape(lambda: j_init_params(jcfg, jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(k, simple=True, separator="."): v.shape
            for k, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert {k: tuple(v.shape) for k, v in params.named_parameters()} == want
    cache = init_decode_cache(cfg, 2, 5, torch.float32, device="cpu")
    jcache = j_init_decode_cache(jcfg, 2, 5, jnp.float32)
    assert cache.pos == int(jcache.pos) == 0
    for c, jc in zip(cache.layers + cache.cross, jcache.layers + jcache.cross, strict=True):
        assert (c is None) == (jc is None)
        if c is not None:
            assert c._fields == jc._fields
            assert [tuple(x.shape) for x in c] == [x.shape for x in jc] and not any(x.any() for x in c)


# ---------------------------------------------------------------- prefill
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_match_the_reference(arch):
    jcfg, cfg, jparams, params = _models(arch)
    tokens = _tokens(11, 2, 32, cfg.vocab)
    ref = jax.jit(j_build_prefill_step(jcfg, J_RUN))(jparams, {"tokens": jnp.asarray(tokens)})
    out = t_serve.build_prefill_step(cfg, RUN)(params, {"tokens": torch.from_numpy(tokens)})
    assert out.shape == (2, cfg.vocab)
    _close(out, ref, LOGIT_TOL)
    # and every position of the full forward (mode "train")
    full = j_forward_lm(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, J_RUN, mode="train")
    _close(forward_lm(params, {"tokens": torch.from_numpy(tokens)}, cfg, RUN, mode="train"),
           full, LOGIT_TOL)


# ---------------------------------------------------------------- decode
@pytest.mark.parametrize("arch", DENSE)
def test_decode_logits_and_caches_match_the_reference(arch):
    jcfg, cfg, jparams, params = _models(arch)
    b, steps, max_len = 2, 8, 12
    tokens = _tokens(12, b, steps, cfg.vocab)
    jstep = jax.jit(j_forward_decode, static_argnums=(3, 4))
    jcache = j_init_decode_cache(jcfg, b, max_len, jnp.float32)
    cache = init_decode_cache(cfg, b, max_len, torch.float32, device="cpu")
    for t in range(steps):
        jlogits, jcache = jstep(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache, jcfg, J_RUN)
        logits, cache = forward_decode(params, torch.from_numpy(tokens[:, t:t + 1]), cache, cfg, RUN)
        assert cache.pos == t + 1 == int(jcache.pos)
        _close(logits, jlogits, LOGIT_TOL)
        for kc, jkc in zip(cache.layers, jcache.layers):
            _close(kc.k, jkc.k, LOGIT_TOL)
            _close(kc.v, jkc.v, LOGIT_TOL)


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "gemma-7b", "granite-20b"])
def test_decode_matches_teacher_forcing(arch):
    """Autoregressive decode logits at step t == full forward logits at t
    (the port alone, its own init; the reference's test and tolerance)."""
    cfg = scale_down(ARCHS[arch])
    params = init_params(cfg, seed=0, device="cpu")
    B, S = 2, 8
    tokens = torch.from_numpy(_tokens(1, B, S, cfg.vocab))
    full = forward_lm(params, {"tokens": tokens}, cfg, RUN, mode="prefill")
    cache = init_decode_cache(cfg, B, 16, torch.float32, device="cpu")
    for t in range(S):
        logits, cache = forward_decode(params, tokens[:, t:t + 1], cache, cfg, RUN)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), rtol=2e-4, atol=2e-4)


def test_decode_past_the_cache_raises():
    cfg = scale_down(ARCHS["phi3-medium-14b"])
    params = init_params(cfg, device="cpu")
    cache = init_decode_cache(cfg, 1, 1, torch.float32, device="cpu")
    _, cache = forward_decode(params, torch.zeros(1, 1, dtype=torch.int32), cache, cfg, RUN)
    with pytest.raises(ValueError, match="cache full"):
        forward_decode(params, torch.zeros(1, 1, dtype=torch.int32), cache, cfg, RUN)


# ------------------------------------------------------- gemma's head width
def test_gemma_at_its_own_head_width_matches_the_reference():
    """``scale_down`` gives every reduced model heads of 64; gemma-7b's are
    256, the width at which its prefill (B4) and decode (B5) run.  The same
    reduced config with ``head_dim=256`` in both packages, the reference's
    weights: prefill logits, the full forward, and 8 decode steps' logits
    and caches within 1e-4."""
    jcfg = dataclasses.replace(j_scale_down(J_ARCHS["gemma-7b"]), head_dim=256)
    cfg = dataclasses.replace(scale_down(ARCHS["gemma-7b"]), head_dim=256)
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim == 256 and cfg.num_heads == cfg.num_kv_heads
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    assert params["layer_0"]["attn"]["wq"].shape == (cfg.d_model, cfg.num_heads * 256)

    tokens = _tokens(14, 2, 32, cfg.vocab)
    ref = jax.jit(j_build_prefill_step(jcfg, J_RUN))(jparams, {"tokens": jnp.asarray(tokens)})
    _close(t_serve.build_prefill_step(cfg, RUN)(params, {"tokens": torch.from_numpy(tokens)}), ref,
           LOGIT_TOL)
    full = j_forward_lm(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, J_RUN, mode="train")
    _close(forward_lm(params, {"tokens": torch.from_numpy(tokens)}, cfg, RUN, mode="train"), full,
           LOGIT_TOL)

    jstep = jax.jit(j_forward_decode, static_argnums=(3, 4))
    jcache = j_init_decode_cache(jcfg, 2, 12, jnp.float32)
    cache = init_decode_cache(cfg, 2, 12, torch.float32, device="cpu")
    for t in range(8):
        jlogits, jcache = jstep(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache, jcfg, J_RUN)
        logits, cache = forward_decode(params, torch.from_numpy(tokens[:, t:t + 1]), cache, cfg, RUN)
        _close(logits, jlogits, LOGIT_TOL)
        for kc, jkc in zip(cache.layers, jcache.layers, strict=True):
            _close(kc.k, jkc.k, LOGIT_TOL)
            _close(kc.v, jkc.v, LOGIT_TOL)


# ---------------------------------------------------------------- the launcher
def test_serve_flow_matches_the_reference_launcher():
    """The launcher's flow, as ``repro.launch.serve`` runs it: prefill, then
    greedy decode from an empty cache at position 0 (ROADMAP C5), on the
    reference's weights and the same prompt: the same tokens, logits within
    tolerance."""
    arch, b, s, n = "phi3-medium-14b", 2, 32, 8
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

    res = t_serve.serve(params, cfg, RUN, {"tokens": torch.from_numpy(prompt)}, n, keep_logits=True)
    _close(res.prefill_logits, jlogits, LOGIT_TOL)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jnp.concatenate(jtoks, axis=1)))
    for lg, jlg in zip(res.step_logits, jsteps, strict=True):
        _close(lg, jlg, LOGIT_TOL)
    assert res.cache.pos == n and res.cache.layers[0].k.shape == (b, s + n + 1, cfg.num_kv_heads,
                                                                  cfg.resolved_head_dim)


def test_launcher_runs_on_the_cpu_when_asked(capsys):
    t_serve.main(["--device", "cpu", "--arch", "phi3-medium-14b", "--tokens", "8"])
    out = capsys.readouterr().out
    assert "prefill [2×32] → logits (2, 256)" in out
    assert "decoded 8 tokens/seq" in out and "tok/s on cpu" in out
    sample = eval(out.split("sample:")[1].strip())
    assert len(sample) == 9 and all(0 <= t < 256 for t in sample)
