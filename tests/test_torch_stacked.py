"""The port's stacked forward (``repro_torch.models.stacked``) against the
JAX package's, and against the port's own unrolled forward, on the CPU.

The stacked tree holds layer ``g·p + j`` as slice ``g`` of
``groups.pos_{j}`` (p the pattern period).  Both packages run the same
weights: the reference's unrolled init, stacked here with numpy, carried
across by ``convert.params_from_numpy(..., stacked=True)``.  Logits
within 1e-4 of JAX's (the serve tests' tolerance); against the port's
own unrolled forward bit for bit, since each group runs the same
operations on contiguous slices of the stacked leaves.
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
from repro.models.transformer import init_params as j_init_params
from repro.serve.serve_step import build_prefill_step as j_build_prefill_step
from repro_torch import convert
from repro_torch.configs import ARCHS, RunConfig, scale_down
from repro_torch.launch import serve as t_serve
from repro_torch.models import stacked as tst
from repro_torch.models.layers import flat_specs
from repro_torch.models.transformer import forward_lm, init_params
from repro_torch.serve.serve_step import build_prefill_step

J_RUN = JRunConfig(param_dtype="float32", block_q=16, block_kv=16, unroll=False, remat=False,
                   sequence_parallel=False)
RUN = t_serve.RUN
STACKED = RunConfig(param_dtype="float32", stacked=True)
LOGIT_TOL = 1e-4
PORTED = ["phi3-medium-14b", "gemma-7b", "qwen2.5-32b", "granite-20b", "mamba2-370m", "dbrx-132b",
          "granite-moe-1b-a400m", "jamba-1.5-large-398b", "phi-3-vision-4.2b", "whisper-base"]
# (arch, layers of the reduced config): a dense, an moe, the ssm and the
# hybrid at 8 and 16 layers (one and two groups of its period 8)
CASES = [("phi3-medium-14b", 2), ("granite-moe-1b-a400m", 2), ("dbrx-132b", 2), ("mamba2-370m", 2),
         ("jamba-1.5-large-398b", 8), ("jamba-1.5-large-398b", 16)]


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _flat_ref_schema(schema):
    return {jax.tree_util.keystr(k, simple=True, separator="."): v
            for k, v in jax.tree_util.tree_flatten_with_path(
                schema, is_leaf=lambda s: hasattr(s, "shape"))[0]}


def _stack_tree(tree: dict, gs: int, ng: int) -> dict:
    """The reference's unrolled parameter tree as its stacked tree."""
    out = {k: v for k, v in tree.items() if not k.startswith("layer_")}
    out["groups"] = {
        f"pos_{j}": jax.tree.map(lambda *leaves: np.stack(leaves),
                                 *[tree[f"layer_{g * gs + j}"] for g in range(ng)])
        for j in range(gs)}
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_pattern_period_matches_the_reference(arch):
    for layers in (None, 8):
        cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
        if layers:
            cfg, jcfg = scale_down(cfg, layers=layers), j_scale_down(jcfg, layers=layers)
        assert tst.pattern_period(cfg) == jst.pattern_period(jcfg)


@pytest.mark.parametrize("arch", PORTED)
def test_stack_schema_matches_the_reference(arch):
    """Full width and reduced to 8 layers: paths, shapes, inits and
    scales, group size and count."""
    for full in (True, False):
        cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
        if not full:
            cfg, jcfg = scale_down(cfg, layers=8), j_scale_down(jcfg, layers=8)
        schema, gs, ng = tst.stack_schema(cfg)
        jschema, jgs, jng = jst.stack_schema(jcfg)
        assert (gs, ng) == (jgs, jng)
        port, ref = flat_specs(schema), _flat_ref_schema(jschema)
        assert set(port) == set(ref)
        for path, spec in port.items():
            assert (spec.shape, spec.init, spec.scale) == (ref[path].shape, ref[path].init, ref[path].scale), path


def test_stack_schema_rejects_partial_groups():
    with pytest.raises(ValueError, match="2 layers are not whole groups of 8"):
        tst.stack_schema(scale_down(ARCHS["jamba-1.5-large-398b"]))


@pytest.mark.parametrize("arch,layers", CASES)
def test_stacked_forward_matches_the_reference_and_the_unrolled_one(arch, layers):
    jcfg, cfg = j_scale_down(J_ARCHS[arch], layers=layers), scale_down(ARCHS[arch], layers=layers)
    _, gs, ng = jst.stack_schema(jcfg)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(0)))
    jtree = _stack_tree(tree, gs, ng)
    stacked = convert.params_from_numpy(jtree, cfg, device="cpu", stacked=True)
    unrolled = convert.params_from_numpy(tree, cfg, device="cpu")
    tokens = _tokens(3, 2, 64, cfg.vocab)

    ref = jst.forward_lm_stacked(jax.tree.map(jnp.asarray, jtree), {"tokens": jnp.asarray(tokens)}, jcfg,
                                 J_RUN, mode="prefill")
    out = tst.forward_lm_stacked(stacked, {"tokens": torch.from_numpy(tokens)}, cfg, STACKED, mode="prefill")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    plain = forward_lm(unrolled, {"tokens": torch.from_numpy(tokens)}, cfg, RUN, mode="prefill")
    assert torch.equal(out, plain)

    # the serve step's stacked branch, as the reference's
    jlast = jax.jit(j_build_prefill_step(jcfg, dataclasses.replace(J_RUN, stacked=True)))(
        jax.tree.map(jnp.asarray, jtree), {"tokens": jnp.asarray(tokens)})
    last = build_prefill_step(cfg, STACKED)(stacked, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert torch.equal(last, build_prefill_step(cfg, RUN)(unrolled, {"tokens": torch.from_numpy(tokens)}))


@pytest.mark.parametrize("arch,layers", [("granite-moe-1b-a400m", 2), ("jamba-1.5-large-398b", 16)])
def test_stack_params_restacks_the_unrolled_tree(arch, layers):
    """``stack_params`` puts layer g·p + j at slice g of pos_j: the same
    tree as the numpy restack, and the same logits as the unrolled
    weights, bit for bit (moe_groups 2 and its stats too)."""
    cfg = scale_down(ARCHS[arch], layers=layers)
    params = init_params(cfg, seed=4, device="cpu")
    stacked = tst.stack_params(params, cfg)
    _, gs, ng = tst.stack_schema(cfg)
    want = _stack_tree(convert.params_to_numpy(params), gs, ng)
    got = convert.params_to_numpy(stacked)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    tokens = {"tokens": torch.from_numpy(_tokens(5, 2, 32, cfg.vocab))}
    s1, s2 = [], []
    out = build_prefill_step(cfg, STACKED, moe_groups=2)(stacked, tokens, moe_stats=s1)
    assert torch.equal(out, build_prefill_step(cfg, RUN, moe_groups=2)(params, tokens, moe_stats=s2))
    assert len(s1) == len(s2) == sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    for a, b in zip(s1, s2):
        assert torch.equal(a.dropped_fraction, b.dropped_fraction) and torch.equal(a.aux_loss, b.aux_loss)
