"""The port's vlm and audio families (phi-3-vision-4.2b, whisper-base)
against the JAX package, on the CPU.

Same inputs, made with numpy from a seed, through both packages; the
weights are the reference's own, carried across by ``repro_torch.convert``
(the reference seeds its init with Python's ``hash``, which is stable
within one process only).  The port's attention runs its kernels' plain
versions here: B4 causal in the decoder, full in the encoder and the
cross-attention, B5 over the self and the cross caches.  Tolerance 1e-4,
the dense tests' (the reference's XLA programs and the port's PyTorch
ones sum in other orders; both are float32 throughout).  The reference's
blocked attention runs tiles of 16, so every sequence here is at most 16
long or a multiple of 16.
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
from repro.models import stacked as jst
from repro.models import transformer as jt
from repro.serve.serve_step import build_decode_step as j_build_decode_step
from repro.serve.serve_step import build_prefill_step as j_build_prefill_step
from repro_torch import convert
from repro_torch.configs import ARCHS, RunConfig, scale_down
from repro_torch.launch import serve as t_serve
from repro_torch.models import stacked as tst
from repro_torch.models import transformer as tt
from repro_torch.models.layers import flat_specs
from repro_torch.serve.serve_step import build_decode_step, build_prefill_step

J_RUN = JRunConfig(param_dtype="float32", block_q=16, block_kv=16, unroll=False, remat=False,
                   sequence_parallel=False)
RUN = t_serve.RUN
STACKED = RunConfig(param_dtype="float32", stacked=True)
TOL = 1e-4
VLM, AUDIO = "phi-3-vision-4.2b", "whisper-base"


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


def _models(arch):
    jcfg, cfg = j_scale_down(J_ARCHS[arch]), scale_down(ARCHS[arch])
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _batch(cfg, seed, b, s, *, frames_len=12):
    """A prompt of ``s`` decoder rows: a vlm's ``num_patches`` random
    patches then tokens; an audio model's tokens and ``frames_len`` random
    frames.  Returned as numpy."""
    if cfg.family == "vlm":
        return {"tokens": _tokens(seed, b, s - cfg.num_patches, cfg.vocab),
                "patches": _normal(seed + 1, b, cfg.num_patches, cfg.patch_dim)}
    out = {"tokens": _tokens(seed, b, s, cfg.vocab)}
    if cfg.encoder_layers:
        out["frames"] = _normal(seed + 2, b, frames_len, cfg.d_model)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_schema(schema):
    return {jax.tree_util.keystr(k, simple=True, separator="."): v
            for k, v in jax.tree_util.tree_flatten_with_path(schema, is_leaf=lambda s: hasattr(s, "shape"))[0]}


def _same_schema(port, ref):
    port, ref = flat_specs(port), _ref_schema(ref)
    assert set(port) == set(ref)
    for path, spec in port.items():
        assert (spec.shape, spec.init, spec.scale) == (ref[path].shape, ref[path].init, ref[path].scale), path


def _cache_tree(cache):
    """The reference's DecodeCache as ``convert.decode_cache_from_numpy``'s dict."""
    def kv(c):
        return None if c is None else {f: np.asarray(x) for f, x in c._asdict().items()}

    return {"layers": [kv(c) for c in cache.layers], "pos": int(cache.pos), "cross": [kv(c) for c in cache.cross]}


# ---------------------------------------------------------------- schema
@pytest.mark.parametrize("arch", [VLM, AUDIO])
@pytest.mark.parametrize("full", [True, False])
def test_schema_matches_the_reference(arch, full):
    """The patch projector, the cross blocks (``norm_x``, ``cross``), the
    encoder's layers and ``enc_norm_f``: paths, shapes, inits and scales,
    unrolled and stacked."""
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    if not full:
        cfg, jcfg = scale_down(cfg), j_scale_down(jcfg)
    _same_schema(tt.backbone_schema(cfg), jt.backbone_schema(jcfg))
    _same_schema(tst.stack_schema(cfg)[0], jst.stack_schema(jcfg)[0])
    names = set(flat_specs(tt.backbone_schema(cfg)))
    if arch == VLM:
        assert {"patch_proj.w", "patch_proj.b"} <= names and not any(n.startswith("enc_") for n in names)
    else:
        assert {"layer_0.cross.wq", "layer_0.norm_x.gamma", "enc_0.attn.wk", "enc_norm_f.beta"} <= names


def test_a_cross_block_has_no_qkv_bias():
    cfg = dataclasses.replace(scale_down(ARCHS[AUDIO]), qkv_bias=True)
    jcfg = dataclasses.replace(j_scale_down(J_ARCHS[AUDIO]), qkv_bias=True)
    for cross in (False, True):
        _same_schema(tt._attn_schema(cfg, cross=cross), jt._attn_schema(jcfg, cross=cross))
    assert "bq" in tt._attn_schema(cfg) and "bq" not in tt._attn_schema(cfg, cross=True)
    _same_schema(tt._decoder_layer_schema(cfg, 0), jt._decoder_layer_schema(jcfg, 0))


# ---------------------------------------------------------------- frontends and the encoder
@pytest.mark.parametrize("patches", [8, 0])
def test_embed_vlm_matches_the_reference(patches):
    """The patch projector's rows before the token rows; a [B, 0,
    patch_dim] patch tensor gives the token rows alone."""
    jcfg, cfg, jparams, params = _models(VLM)
    tokens, img = _tokens(1, 2, 8, cfg.vocab), _normal(2, 2, patches, cfg.patch_dim)
    out = tt.embed_vlm(params, torch.from_numpy(tokens), torch.from_numpy(img), cfg)
    ref = jt.embed_vlm(jparams, jnp.asarray(tokens), jnp.asarray(img), jcfg)
    assert out.shape == (2, patches + 8, cfg.d_model)
    _close(out, ref, 1e-5)
    if patches == 0:
        _close(out, tt.embed_tokens(params, torch.from_numpy(tokens), cfg), 0.0)


def test_encoder_and_cross_attention_match_the_reference():
    """``encoder_forward`` over 12 frames (bidirectional), ``_cross_kv`` of
    every layer, and ``_cross_attention`` of 32 decoder rows over them."""
    jcfg, cfg, jparams, params = _models(AUDIO)
    frames = _normal(3, 2, 12, cfg.d_model)
    enc = tt.encoder_forward(params, torch.from_numpy(frames), cfg, RUN)
    jenc = jt.encoder_forward(jparams, jnp.asarray(frames), jcfg, J_RUN)
    _close(enc, jenc)
    x = torch.from_numpy(_normal(4, 2, 32, cfg.d_model))
    for i in range(cfg.num_layers):
        ckv = tt._cross_kv(params[f"layer_{i}"]["cross"], enc, cfg)
        jckv = jt._cross_kv(jparams[f"layer_{i}"]["cross"], jenc, jcfg)
        assert ckv.k.shape == (2, 12, cfg.num_kv_heads, cfg.resolved_head_dim)
        _close(ckv.k, jckv.k)
        _close(ckv.v, jckv.v)
        out = tt._cross_attention(params[f"layer_{i}"]["cross"], x, ckv, cfg)
        ref = jt._cross_attention(jparams[f"layer_{i}"]["cross"], jnp.asarray(x.numpy()), jckv, jcfg, J_RUN)
        _close(out, ref)
    # the encoder is bidirectional: the first frame's output depends on the last frame
    moved = frames.copy()
    moved[:, -1] = _normal(9, 2, cfg.d_model)
    enc2 = tt.encoder_forward(params, torch.from_numpy(moved), cfg, RUN)
    assert not torch.allclose(enc[:, 0], enc2[:, 0])


# ---------------------------------------------------------------- prefill
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_prefill_logits_match_the_reference(arch):
    jcfg, cfg, jparams, params = _models(arch)
    batch = _batch(cfg, 11, 2, 32)
    ref = jax.jit(j_build_prefill_step(jcfg, J_RUN))(jparams, _j(batch))
    out = build_prefill_step(cfg, RUN)(params, _t(batch))
    assert out.shape == (2, cfg.vocab)
    _close(out, ref)
    full = tt.forward_lm(params, _t(batch), cfg, RUN, mode="train")
    assert full.shape == (2, 32, cfg.vocab)
    _close(full, jt.forward_lm(jparams, _j(batch), jcfg, J_RUN, mode="train"))


# ---------------------------------------------------------------- decode
@pytest.mark.parametrize("arch,filled", [(VLM, False), (AUDIO, False), (AUDIO, True)])
def test_decode_logits_and_caches_match_the_reference(arch, filled):
    """8 steps from the zeroed cache (the launcher's), and, for whisper,
    from a cache whose cross K/V are the encoder's over 12 frames (so B5
    reads a live cross cache whole): logits, self K/V and cross caches."""
    jcfg, cfg, jparams, params = _models(arch)
    b, steps, max_len = 2, 8, 12
    tokens = _tokens(12, b, steps, cfg.vocab)
    jcache = jt.init_decode_cache(jcfg, b, max_len, jnp.float32)
    if filled:
        jenc = jt.encoder_forward(jparams, jnp.asarray(_normal(5, b, 12, cfg.d_model)), jcfg, J_RUN)
        jcache = jcache._replace(cross=tuple(jt._cross_kv(jparams[f"layer_{i}"]["cross"], jenc, jcfg)
                                             for i in range(cfg.num_layers)))
    cache = convert.decode_cache_from_numpy(_cache_tree(jcache), device="cpu")
    if not filled:              # the port's own zeroed cache is the reference's
        own = tt.init_decode_cache(cfg, b, max_len, torch.float32, device="cpu")
        for c, jc in zip(own.layers + own.cross, jcache.layers + jcache.cross, strict=True):
            assert (c is None) == (jc is None)
            if c is not None:
                assert c.k.shape == jc.k.shape and not c.k.any() and not c.v.any()
    jstep = jax.jit(jt.forward_decode, static_argnums=(3, 4))
    for t in range(steps):
        jlogits, jcache = jstep(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache, jcfg, J_RUN)
        logits, cache = tt.forward_decode(params, torch.from_numpy(tokens[:, t:t + 1]), cache, cfg, RUN)
        assert cache.pos == t + 1 == int(jcache.pos)
        _close(logits, jlogits)
        back = convert.decode_cache_to_numpy(cache)
        for port, ref in zip(back["layers"] + back["cross"], _cache_tree(jcache)["layers"]
                             + _cache_tree(jcache)["cross"], strict=True):
            assert (port is None) == (ref is None)
            if port is not None:
                _close(port["k"], ref["k"])
                _close(port["v"], ref["v"])


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_decode_matches_teacher_forcing(arch):
    """Decode step t == the full forward over the fed tokens at t: the vlm's
    forward with an empty patch tensor (the decode never sees patches),
    whisper's over zero frames, which give exactly the zeroed cross cache."""
    cfg = scale_down(ARCHS[arch])
    params = tt.init_params(cfg, seed=0, device="cpu")
    b, s = 2, 8
    tokens = torch.from_numpy(_tokens(1, b, s, cfg.vocab))
    batch = {"tokens": tokens}
    if arch == VLM:
        batch["patches"] = torch.zeros((b, 0, cfg.patch_dim))
    else:
        batch["frames"] = torch.zeros((b, 5, cfg.d_model))
        enc = tt.encoder_forward(params, batch["frames"], cfg, RUN)
        assert torch.equal(enc, torch.zeros_like(enc))
    full = tt.forward_lm(params, batch, cfg, RUN, mode="prefill")
    cache = tt.init_decode_cache(cfg, b, 16, torch.float32, device="cpu")
    for t in range(s):
        logits, cache = tt.forward_decode(params, tokens[:, t:t + 1], cache, cfg, RUN)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------- ROADMAP C14
def test_the_audio_decode_never_reads_the_frames():
    """C14: the reference's decode starts from zeroed cross caches that
    nothing fills, so whisper's greedy tokens from a given first token are
    the same whatever the frames, in both packages; the prefill over the
    same frames does read them.  A cross cache filled from the frames would
    change the tokens."""
    jcfg, cfg, jparams, params = _models(AUDIO)
    b, n = 2, 8
    tok0 = _tokens(6, b, 1, cfg.vocab)
    jdecode, decode = jax.jit(j_build_decode_step(jcfg, J_RUN)), build_decode_step(cfg, RUN)

    def greedy(jcache, cache):
        jtok, tok, jout, out = jnp.asarray(tok0), torch.from_numpy(tok0), [], []
        for _ in range(n):
            jtok, _, jcache = jdecode(jparams, jtok, jcache)
            tok, _, cache = decode(params, tok, cache)
            jout.append(np.asarray(jtok))
            out.append(tok.numpy())
        np.testing.assert_array_equal(np.concatenate(out, 1), np.concatenate(jout, 1))
        assert all(c is c0 for c, c0 in zip(cache.cross, cross0))        # returned unchanged
        return np.concatenate(out, 1)

    decoded, prefills = [], []
    for frames in (np.zeros((b, 12, cfg.d_model), np.float32), _normal(7, b, 12, cfg.d_model)):
        batch = {"tokens": _tokens(8, b, 16, cfg.vocab), "frames": frames}
        prefills.append(build_prefill_step(cfg, RUN)(params, _t(batch)))
        _close(prefills[-1], jax.jit(j_build_prefill_step(jcfg, J_RUN))(jparams, _j(batch)))
        cache = tt.init_decode_cache(cfg, b, n + 1, torch.float32, device="cpu")
        cross0 = cache.cross
        decoded.append(greedy(jt.init_decode_cache(jcfg, b, n + 1, jnp.float32), cache))
        assert all(float(c.k.abs().max()) == 0.0 == float(c.v.abs().max()) for c in cache.cross)
    np.testing.assert_array_equal(decoded[0], decoded[1])
    assert not torch.allclose(prefills[0], prefills[1])

    # filled from the frames' encoder, the cross caches change the tokens
    jenc = jt.encoder_forward(jparams, jnp.asarray(_normal(7, b, 12, cfg.d_model)), jcfg, J_RUN)
    jcache = jt.init_decode_cache(jcfg, b, n + 1, jnp.float32)
    jcache = jcache._replace(cross=tuple(jt._cross_kv(jparams[f"layer_{i}"]["cross"], jenc, jcfg)
                                         for i in range(cfg.num_layers)))
    cache = convert.decode_cache_from_numpy(_cache_tree(jcache), device="cpu")
    cross0 = cache.cross
    assert not np.array_equal(greedy(jcache, cache), decoded[0])


# ---------------------------------------------------------------- the stacked forward
def _stack_tree(tree: dict, gs: int, ng: int) -> dict:
    out = {k: v for k, v in tree.items() if not k.startswith("layer_")}
    out["groups"] = {f"pos_{j}": jax.tree.map(lambda *leaves: np.stack(leaves),
                                              *[tree[f"layer_{g * gs + j}"] for g in range(ng)])
                     for j in range(gs)}
    return out


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_stacked_forward_matches_the_reference_and_the_unrolled_one(arch):
    """Within 1e-4 of JAX's stacked forward, bit-equal to the port's
    unrolled one; ``stack_params`` gives the numpy restack; the stacked
    serve step as the reference's."""
    jcfg, cfg = j_scale_down(J_ARCHS[arch]), scale_down(ARCHS[arch])
    _, gs, ng = jst.stack_schema(jcfg)
    tree = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0)))
    jtree = _stack_tree(tree, gs, ng)
    stacked = convert.params_from_numpy(jtree, cfg, device="cpu", stacked=True)
    unrolled = convert.params_from_numpy(tree, cfg, device="cpu")
    restacked = convert.params_to_numpy(tst.stack_params(unrolled, cfg))
    assert jax.tree.structure(restacked) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(restacked), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    batch = _batch(cfg, 3, 2, 32)
    ref = jst.forward_lm_stacked(jax.tree.map(jnp.asarray, jtree), _j(batch), jcfg, J_RUN, mode="prefill")
    out = tst.forward_lm_stacked(stacked, _t(batch), cfg, STACKED, mode="prefill")
    _close(out, ref)
    assert torch.equal(out, tt.forward_lm(unrolled, _t(batch), cfg, RUN, mode="prefill"))
    jlast = jax.jit(j_build_prefill_step(jcfg, dataclasses.replace(J_RUN, stacked=True)))(
        jax.tree.map(jnp.asarray, jtree), _j(batch))
    last = build_prefill_step(cfg, STACKED)(stacked, _t(batch))
    _close(last, jlast)
    assert torch.equal(last, build_prefill_step(cfg, RUN)(unrolled, _t(batch)))


# ---------------------------------------------------------------- the launcher
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_serve_flow_matches_the_reference_launcher(arch):
    """The launcher's batch (a vlm's first s - P tokens after zero patches,
    zero frames [b, s, d_model]) and flow (prefill, then greedy decode from
    the zeroed cache of s + n + 1 rows) against the reference launcher's
    on its weights: the same tokens, logits within 1e-4."""
    jcfg, cfg, jparams, params = _models(arch)
    b, s, n = 2, 32, 8
    batch = t_serve.make_prompt(cfg, b, s, "cpu")
    if arch == VLM:
        assert batch["tokens"].shape == (b, s - cfg.num_patches)
        assert batch["patches"].shape == (b, cfg.num_patches, cfg.patch_dim) and not batch["patches"].any()
    else:
        assert batch["tokens"].shape == (b, s) and batch["frames"].shape == (b, s, cfg.d_model)
        assert not batch["frames"].any()
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jlogits = jax.jit(j_build_prefill_step(jcfg, J_RUN))(jparams, jbatch)
    jdecode = jax.jit(j_build_decode_step(jcfg, J_RUN))
    jcache = jt.init_decode_cache(jcfg, b, s + n + 1, jnp.float32)
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    jtoks, jsteps = [tok], []
    for _ in range(n):
        tok, lg, jcache = jdecode(jparams, tok, jcache)
        jtoks.append(tok)
        jsteps.append(lg)

    res = t_serve.serve(params, cfg, RUN, batch, n, keep_logits=True)
    _close(res.prefill_logits, jlogits)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jnp.concatenate(jtoks, axis=1)))
    for lg, jlg in zip(res.step_logits, jsteps, strict=True):
        _close(lg, jlg)
    assert res.cache.pos == n and res.cache.layers[0].k.shape == (b, s + n + 1, cfg.num_kv_heads,
                                                                  cfg.resolved_head_dim)
    for c, jc in zip(res.cache.cross, jcache.cross, strict=True):
        assert (c is None) == (jc is None) == (arch == VLM)
        if c is not None:
            assert c.k.shape == jc.k.shape == (b, cfg.encoder_len, cfg.num_kv_heads, cfg.resolved_head_dim)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_launcher_runs_the_family_on_the_cpu(arch, capsys):
    t_serve.main(["--device", "cpu", "--arch", arch, "--tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill [2×32] → logits (2, 256)" in out and "decoded 4 tokens/seq" in out
    sample = eval(out.split("sample:")[1].strip())
    assert len(sample) == 5 and all(0 <= t < 256 for t in sample)
