"""The port's training slice against the JAX package, on the CPU.

Held to JAX on the same numpy-seeded inputs and the same weights (the
reference's ``init_params`` converted with ``convert.params_from_numpy``):
* ``prng.randint`` and ``DeterministicTokenPipeline.batch_at`` bit for bit
  (vocab 152,064, many seeds and steps), the frame labelling order exactly;
* ``quantize_blockwise``'s q and scale bit for bit in both layouts;
* one ``apply_adamw`` step from JAX's own state fed JAX's gradients, float32
  and 8-bit: the parameters within 2⁻²²·max |p| (about 2 ulp of the largest
  parameter: the gradient norm sums in another order, so the clip can
  differ by an ulp), the float32 moments within 2⁻¹⁶·max |m|, the int8
  moments with at most 1 code in 1,000 one step off and their scales
  within 2⁻¹⁸ relative;
* ``microbatch_grad``'s loss and every gradient leaf, every arch of
  ``ARCHS`` at ``scale_down``, within 1e-4·max |JAX leaf| + 1e-6 (ssm and
  hybrid through B6's plain version);
* k = 4 microbatches against k = 1 and against JAX's k = 4; remat and the
  stacked forward against the plain unrolled one;
* five steps of ``build_train_step`` within 1e-4 relative of JAX's losses,
  the loss falling as in ``tests/test_models_smoke.py``;
* checkpoints written by either package restored by the other, leaf for
  leaf; a torn or corrupt step skipped; rotation;
* ``launch/train.py --device cpu``'s loss lines within 1e-4 of the
  reference launcher's, and a resumed run equal to the uninterrupted one;
* the surrogate's SGD step within 1e-6.
Torch runs on one intra-op thread, as the other port tests do.
"""
import dataclasses
import functools
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import RunConfig as JRun
from repro.configs import scale_down as j_scale_down
from repro.core.chunks import global_randomplus_order as j_order
from repro.data.pipeline import DeterministicTokenPipeline as JPipe
from repro.data.pipeline import ShuffledFramePipeline as JFrames
from repro.data.pipeline import TrainBatchSpec as JSpec
from repro.models import transformer as j_tf
from repro.models.detection import init_surrogate as j_init_surrogate
from repro.train import checkpoint as j_ckpt
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch import convert
from repro_torch.configs import ARCHS, RunConfig, scale_down
from repro_torch.core import prng
from repro_torch.data.pipeline import (DeterministicTokenPipeline, PrefetchPipeline, ShuffledFramePipeline,
                                       TrainBatchSpec)
from repro_torch.models import transformer as t_tf
from repro_torch.models.stacked import stack_params
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import optimizer as t_opt
from repro_torch.train import train_step as t_ts

torch.set_num_threads(1)

J_RUN = JRun(param_dtype="float32", remat=False, sequence_parallel=False, block_q=16, block_kv=16)
T_RUN = RunConfig(param_dtype="float32", remat=False)
B, S = 2, 32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _models(arch, **kw):
    """(JAX config, port config, JAX params, the same params in the port)."""
    jcfg, tcfg = j_scale_down(J_ARCHS[arch], **kw), scale_down(ARCHS[arch], **kw)
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, convert.params_from_numpy(_np_tree(jp), tcfg, "cpu")


def _batch(cfg, b=B, s=S, seed=1):
    rng = np.random.default_rng(seed)
    n = s - (cfg.num_patches if cfg.family == "vlm" else 0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, n)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, n)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((b, cfg.num_patches, cfg.patch_dim)).astype(np.float32)
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal((b, 16, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_grads(port: dict, ref: dict):
    ref = _flat(ref) if any(isinstance(v, dict) for v in ref.values()) else ref
    assert set(port) == set(ref)
    for name, g in port.items():
        want = np.asarray(ref[name])
        err = float(np.abs(g.detach().numpy() - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()) + 1e-6, (name, err, float(np.abs(want).max()))


# ------------------------------------------------------------------ key stream and pipelines

@pytest.mark.parametrize("lo,hi", [(0, 152_064), (0, 512), (-7, 9), (5, 5), (9, 3), (-2**31, 2**31 - 1),
                                   (100, 2**30 + 7)])
def test_randint_equals_jax(lo, hi):
    for seed in range(12):
        for data in (0, 1, 77):
            want = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(seed), data), (5, 33), lo, hi,
                                      dtype=jnp.int32)
            got = prng.randint(prng.fold_in(prng.PRNGKey(seed, "cpu"), data), (5, 33), lo, hi)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batch_at_equals_jax():
    for seed in (0, 3, 12345):
        for shard, shards in ((0, 1), (1, 2)):
            spec = (8, 65, 152_064)
            jpipe = JPipe(JSpec(*spec), seed=seed, data_shard=shard, num_shards=shards)
            tpipe = DeterministicTokenPipeline(TrainBatchSpec(*spec), seed=seed, data_shard=shard,
                                               num_shards=shards, device="cpu")
            for step in (0, 1, 2, 49, 50, 1000, 2**31 + 5):
                want, got = jpipe.batch_at(step), tpipe.batch_at(step)
                for k in ("tokens", "labels"):
                    np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    first = next(iter(tpipe))
    assert torch.equal(first["tokens"], tpipe.batch_at(0)["tokens"])
    with pytest.raises(ValueError, match="divide"):
        DeterministicTokenPipeline(TrainBatchSpec(3, 8, 10), num_shards=2, device="cpu")


def test_shuffled_frames_equal_jax():
    j, t = JFrames(1000, 64, seed=4), ShuffledFramePipeline(1000, 64, seed=4)
    for _ in range(20):
        np.testing.assert_array_equal(t.next_ids(), j.next_ids())
    state = t.state_dict()
    t2 = ShuffledFramePipeline(1000, 64, seed=4)
    t2.load_state_dict(state)
    np.testing.assert_array_equal(t2.next_ids(), j.next_ids())
    np.testing.assert_array_equal(t.order, j_order(1000, seed=4))


def test_prefetch_pipeline_keeps_order_and_raises():
    def fetch(ids):
        if ids[0] < 0:
            raise RuntimeError("bad frame")
        return ids * 2

    pipe = PrefetchPipeline(fetch, depth=2)
    try:
        for i in range(6):
            pipe.submit(np.arange(i, i + 3))
        for i in range(6):
            ids, out = pipe.next(timeout=10)
            np.testing.assert_array_equal(out, np.arange(i, i + 3) * 2)
        pipe.submit(np.array([-1]))
        with pytest.raises(RuntimeError, match="bad frame"):
            pipe.next(timeout=10)
        for i in range(5):                # more than depth results left untaken
            pipe.submit(np.arange(2))
    finally:
        pipe.close(timeout=10)
    assert not pipe._thread.is_alive()


# ------------------------------------------------------------------ optimizer

@pytest.mark.parametrize("shape,block", [((4, 512), 256), ((3, 5, 256), 256), ((1000,), 64), ((7, 13), 32),
                                         ((), 8), ((2, 300), 256)])
def test_quantize_blockwise_bit_equal(shape, block):
    rng = np.random.default_rng(block + len(shape))
    x = np.asarray(rng.standard_normal(shape) * rng.uniform(1e-3, 10.0), np.float32)
    if x.size > 4:
        x.reshape(-1)[:3] = [0.0, 127.0 / 2, -0.5]       # exact halves round to even
    want = j_opt.quantize_blockwise(jnp.asarray(x), block)
    got = t_opt.quantize_blockwise(torch.from_numpy(x), block)
    assert got.blocked == want.blocked and got.shape == want.shape
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy().view(np.int32), np.asarray(want.scale).view(np.int32))
    np.testing.assert_array_equal(t_opt.dequantize_blockwise(got).numpy(),
                                  np.asarray(j_opt.dequantize_blockwise(want)))


def test_lr_schedule_and_state_bytes_equal_jax():
    cfg = dict(learning_rate=3e-4, warmup_steps=10, decay_steps=100)
    for step in (0, 1, 5, 10, 11, 57, 100, 250):
        want = float(j_opt.lr_schedule(j_opt.AdamWConfig(**cfg), jnp.asarray(step)))
        assert abs(t_opt.lr_schedule(t_opt.AdamWConfig(**cfg), step) - want) <= 2 ** -22 * abs(want)
    params = {"a": np.zeros((4, 512), np.float32), "b": np.zeros((37,), np.float32)}
    for q in (False, True):
        js = j_opt.init_adamw({k: jnp.asarray(v) for k, v in params.items()}, j_opt.AdamWConfig(quantize_state=q))
        ts = t_opt.init_adamw({k: torch.from_numpy(v) for k, v in params.items()},
                              t_opt.AdamWConfig(quantize_state=q))
        assert t_opt.state_bytes(ts) == j_opt.state_bytes(js)


def _t_moment(x):
    if isinstance(x, j_opt.QTensor):
        return t_opt.QTensor(q=torch.from_numpy(np.array(x.q)), scale=torch.from_numpy(np.array(x.scale)),
                             shape=x.shape, block=x.block)
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("quantized", [False, True])
def test_adamw_step_from_jax_state_matches_jax(quantized):
    rng = np.random.default_rng(11)
    shapes = {"w": (64, 512), "b": (300,), "c": (7, 13), "s": ()}
    kw = dict(learning_rate=0.05, quantize_state=quantized, warmup_steps=2, decay_steps=20, q_block=64)
    jcfg, tcfg = j_opt.AdamWConfig(**kw), t_opt.AdamWConfig(**kw)
    jp = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
    js = j_opt.init_adamw(jp, jcfg)
    codes = flips = 0
    for _ in range(6):
        g = {k: np.asarray(rng.standard_normal(s) * 0.3, np.float32) for k, s in shapes.items()}
        tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
        ts = t_opt.AdamWState(step=int(js.step), m={k: _t_moment(v) for k, v in js.m.items()},
                              v={k: _t_moment(v) for k, v in js.v.items()})
        jp, js, jm = j_opt.apply_adamw(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jcfg)
        tp, ts, tm = t_opt.apply_adamw(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, tcfg)
        assert ts.step == int(js.step)
        assert abs(tm["lr"] - float(jm["lr"])) <= 2 ** -22 * float(jm["lr"])
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2 ** -20)
        for k in shapes:
            want = np.asarray(jp[k])
            assert np.abs(tp[k].numpy() - want).max() <= 2 ** -22 * np.abs(want).max(), k
            for jm_, tm_ in ((js.m[k], ts.m[k]), (js.v[k], ts.v[k])):
                if quantized:
                    dq = np.abs(tm_.q.numpy().astype(int) - np.asarray(jm_.q).astype(int))
                    assert dq.max() <= 1, k
                    codes, flips = codes + dq.size, flips + int((dq > 0).sum())
                    np.testing.assert_allclose(tm_.scale.numpy(), np.asarray(jm_.scale), rtol=2 ** -18)
                else:
                    w = np.asarray(jm_)
                    assert np.abs(tm_.numpy() - w).max() <= 2 ** -16 * np.abs(w).max(), k
    assert flips <= codes / 1000


# ------------------------------------------------------------------ gradients

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_microbatch_grad_matches_jax(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    batch = _batch(jcfg)
    jl, jg = jax.jit(lambda p, b: j_ts.microbatch_grad(p, b, jcfg, J_RUN, moe_groups=1))(jp, _j(batch))
    tl, tg = t_ts.microbatch_grad(tp, _t(batch), tcfg, T_RUN, moe_groups=1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_grads(tg, _np_tree(jg))


def test_microbatches_equal_one_batch_and_jax():
    """k = 4 against k = 1 (loss and gradient norm with the learning rate at
    0) and against JAX's k = 4 step (the parameters after it)."""
    jcfg, tcfg, jp, tp = _models("phi3-medium-14b")
    batch = _batch(jcfg, b=4, s=16, seed=2)
    tk = dataclasses.replace(T_RUN, microbatches=4)
    zero = dict(learning_rate=0.0, weight_decay=0.0)
    m1 = t_ts.build_train_step(tcfg, dataclasses.replace(T_RUN, **zero))(
        t_ts.init_train_state(tp, T_RUN), _t(batch))[1]
    m4 = t_ts.build_train_step(tcfg, dataclasses.replace(tk, **zero))(
        t_ts.init_train_state(tp, T_RUN), _t(batch))[1]
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m4["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    jk = dataclasses.replace(J_RUN, microbatches=4)
    js, jm = jax.jit(j_ts.build_train_step(jcfg, jk))(j_ts.init_train_state(jp, jk), _j(batch))
    ts, tm = t_ts.build_train_step(tcfg, tk)(t_ts.init_train_state(tp, tk), _t(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    want = _flat(_np_tree(js.params))
    for name, p in ts.params.named_parameters():
        assert np.abs(p.detach().numpy() - want[name]).max() <= 1e-4 * np.abs(want[name]).max() + 1e-6, name


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "jamba-1.5-large-398b"])
def test_remat_and_stacked_grads_equal_the_plain_ones(arch):
    kw = dict(layers=8) if arch.startswith("jamba") else {}
    _, tcfg, _, tp = _models(arch, **kw)
    batch = _t(_batch(tcfg, seed=3))
    loss, plain = t_ts.microbatch_grad(tp, batch, tcfg, T_RUN, moe_groups=1)
    loss_r, remat = t_ts.microbatch_grad(tp, batch, tcfg, dataclasses.replace(T_RUN, remat=True), moe_groups=1)
    assert torch.equal(loss_r, loss)
    for name, g in plain.items():
        assert torch.equal(remat[name], g), name
    stacked = stack_params(tp, tcfg)
    for run in (dataclasses.replace(T_RUN, stacked=True), dataclasses.replace(T_RUN, stacked=True, remat=True)):
        loss_s, sg = t_ts.microbatch_grad(stacked, batch, tcfg, run, moe_groups=1)
        assert torch.equal(loss_s, loss)
        # the stacked tree's gradients, restacked from the unrolled ones
        want = dict(stack_params(_grad_node(tp, plain), tcfg).named_parameters())
        for name, g in sg.items():
            assert torch.equal(g, want[name].detach()), name


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "jamba-1.5-large-398b"])
def test_prefill_records_no_graph_and_equals_the_train_forward(arch):
    """``prefill`` runs under ``torch.no_grad`` even where the parameters
    require a gradient; a ``train`` forward of frozen parameters records no
    graph; both give the same logits bit for bit as a differentiable one."""
    cfg = scale_down(ARCHS[arch])
    params = t_tf.init_params(cfg, 0, device="cpu")
    batch = _t(_batch(cfg, seed=6))
    frozen = t_tf.forward_lm(params, batch, cfg, T_RUN, mode="train")
    assert frozen.grad_fn is None
    for p in params.parameters():
        p.requires_grad_(True)
    prefill = t_tf.forward_lm(params, batch, cfg, T_RUN, mode="prefill")
    train = t_tf.forward_lm(params, batch, cfg, T_RUN, mode="train")
    assert prefill.grad_fn is None and train.grad_fn is not None
    assert torch.equal(prefill, frozen) and torch.equal(train.detach(), prefill)


def _grad_node(params, grads):
    """A copy of ``params`` holding ``grads`` (so ``stack_params`` stacks them)."""
    import copy

    node = copy.deepcopy(params)
    with torch.no_grad():
        for name, p in node.named_parameters():
            p.copy_(grads[name])
    return node


# ------------------------------------------------------------------ train steps

@pytest.mark.parametrize("arch,adam_8bit", [("qwen2.5-32b", False), ("granite-moe-1b-a400m", False),
                                            ("mamba2-370m", False), ("qwen2.5-32b", True)])
def test_train_steps_follow_jax(arch, adam_8bit):
    """As ``tests/test_models_smoke.py``'s learnability test, on both
    packages: five steps on a fixed batch at lr 1e-2 (mamba2: 12), the
    losses within 1e-4 relative of JAX's, and falling."""
    jcfg, tcfg, jp, tp = _models(arch)
    kw = dict(learning_rate=1e-2, adam_8bit=adam_8bit)
    jrun, trun = dataclasses.replace(J_RUN, **kw), dataclasses.replace(T_RUN, **kw)
    batch = {"tokens": np.ones((B, S), np.int32), "labels": np.ones((B, S), np.int32)}
    jstep, tstep = jax.jit(j_ts.build_train_step(jcfg, jrun)), t_ts.build_train_step(tcfg, trun)
    js, ts = j_ts.init_train_state(jp, jrun), t_ts.init_train_state(tp, trun)
    jl, tl = [], []
    for _ in range(12 if tcfg.family == "ssm" else 5):
        js, jm = jstep(js, _j(batch))
        ts, tm = tstep(ts, _t(batch))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert min(tl[1:]) < tl[0], tl
    assert ts.step == int(js.step) == len(tl)


def test_surrogate_step_matches_jax():
    from repro.train.train_step import build_surrogate_train_step as j_build

    jp = j_init_surrogate(jax.random.PRNGKey(3), 24, hidden=32)
    tp = convert.surrogate_from_numpy(_np_tree(jp), embed_dim=24, hidden=32, device="cpu")
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((40, 24)).astype(np.float32)
    labels = rng.random(40) < 0.3
    jstep, tstep = j_build(lr=0.05), t_ts.build_surrogate_train_step(lr=0.05)
    jm = jax.tree.map(jnp.zeros_like, jp)
    tm = {n: torch.zeros_like(p) for n, p in tp.named_parameters()}
    for _ in range(5):
        jp, jm, jl = jstep(jp, jm, jnp.asarray(emb), jnp.asarray(labels))
        tp, tm, tl = tstep(tp, tm, torch.from_numpy(emb), torch.from_numpy(labels))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6, atol=1e-6)
    want = _flat(_np_tree(jp))
    for name, p in tp.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-6, atol=1e-6)


def test_mesh_and_compression_raise():
    tcfg = scale_down(ARCHS["qwen2.5-32b"])
    with pytest.raises(NotImplementedError, match="A13.6c"):
        t_ts.build_train_step(tcfg, T_RUN, mesh=object())
    with pytest.raises(NotImplementedError, match="A13.6c"):
        t_ts.init_train_state(t_tf.init_params(tcfg, 0, device="cpu"), T_RUN, with_ef=True)


def test_loss_and_padding_equal_jax():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    np.testing.assert_allclose(float(t_tf.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))),
                               float(j_tf.lm_loss(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    for arch in ARCHS:
        for m in (1, 8, 16, 128):
            assert dataclasses.asdict(t_tf.pad_heads(ARCHS[arch], m)) == \
                dataclasses.asdict(j_tf.pad_heads(J_ARCHS[arch], m))
            assert dataclasses.asdict(t_tf.pad_vocab(ARCHS[arch], m)) == \
                dataclasses.asdict(j_tf.pad_vocab(J_ARCHS[arch], m))


# ------------------------------------------------------------------ checkpoints

@functools.lru_cache(maxsize=None)
def _j_state(quantized):
    """A JAX train state after one step (immutable, so shared by the tests)."""
    jcfg, tcfg, jp, _ = _models("qwen2.5-32b")
    run = dataclasses.replace(J_RUN, adam_8bit=quantized, learning_rate=1e-2)
    js = j_ts.init_train_state(jp, run)
    js, _ = jax.jit(j_ts.build_train_step(jcfg, run))(js, _j(_batch(jcfg)))
    return tcfg, js


def _leaves_equal(t_state, j_state):
    want = convert.train_state_to_numpy(t_state)
    got = {"params": _np_tree(j_state.params), "step": np.int32(j_state.step),
           "opt": {"step": np.int32(j_state.opt.step), "m": j_state.opt.m, "v": j_state.opt.v}}
    assert int(want["step"]) == int(got["step"]) and int(want["opt"]["step"]) == int(got["opt"]["step"])
    for k, v in _flat(got["params"]).items():
        np.testing.assert_array_equal(_flat(want["params"])[k], v)
    for mom in ("m", "v"):
        flat = dict(convert._moments_from_numpy(want["opt"][mom], "cpu"))
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                got["opt"][mom], is_leaf=lambda x: isinstance(x, j_opt.QTensor))[0]:
            name = ".".join(p.key for p in path)
            mine = flat[name]
            if isinstance(leaf, j_opt.QTensor):
                assert mine.shape == leaf.shape and mine.block == leaf.block
                np.testing.assert_array_equal(mine.q.numpy(), np.asarray(leaf.q))
                np.testing.assert_array_equal(mine.scale.numpy(), np.asarray(leaf.scale))
            else:
                np.testing.assert_array_equal(mine.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("quantized", [False, True])
def test_checkpoints_cross_between_the_packages(tmp_path, quantized):
    tcfg, js = _j_state(quantized)
    j_ckpt.save_checkpoint(str(tmp_path / "jax"), 1, js, extra={"arch": "qwen"})
    like = t_ts.init_train_state(t_tf.init_params(tcfg, 7, device="cpu"),
                                 dataclasses.replace(T_RUN, adam_8bit=quantized))
    ts, extra = t_ckpt.restore_checkpoint(str(tmp_path / "jax"), 1, like)
    assert extra == {"arch": "qwen"} and isinstance(ts, t_ts.TrainState)
    _leaves_equal(ts, js)
    t_ckpt.save_checkpoint(str(tmp_path / "port"), 1, ts, extra={"by": "port"})
    with open(tmp_path / "port" / "step_1" / "manifest.json") as f:
        with open(tmp_path / "jax" / "step_1" / "manifest.json") as g:
            mine, theirs = json.load(f), json.load(g)
    assert mine["leaves"] == theirs["leaves"]
    back, extra = j_ckpt.restore_checkpoint(str(tmp_path / "port"), 1, js)
    assert extra == {"by": "port"}
    _leaves_equal(ts, back)
    assert j_ckpt.latest_step(str(tmp_path / "port")) == 1


def test_checkpoint_skips_torn_and_corrupt_steps_and_rotates(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(6.0), "n": 3}
    mgr = t_ckpt.CheckpointManager(d, keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"a": tree["a"] + s, "n": s})
    assert sorted(os.listdir(d)) == ["step_2", "step_3"]
    assert t_ckpt.latest_step(d) == 3
    os.makedirs(os.path.join(d, "step_9.tmp"))                   # a torn write never renamed
    with open(os.path.join(d, "step_3", "shard_0.npz"), "r+b") as f:   # a corrupt shard
        f.seek(40)
        f.write(b"\xff\xfe")
    assert t_ckpt.latest_step(d) == 2
    step, got, _ = mgr.restore_latest(tree)
    assert step == 2 and torch.equal(got["a"], tree["a"] + 2) and got["n"] == 2 and isinstance(got["n"], int)
    os.remove(os.path.join(d, "step_2", "manifest.json"))
    assert t_ckpt.latest_step(d) is None and mgr.restore_latest(tree) is None
    assert j_ckpt.latest_step(d) is None


def test_train_state_round_trips_through_numpy():
    tcfg, js = _j_state(True)
    d = {"params": _np_tree(js.params), "step": np.asarray(js.step),
         "opt": {"step": np.asarray(js.opt.step),
                 "m": jax.tree.map(lambda x: {"q": np.asarray(x.q), "scale": np.asarray(x.scale), "shape": x.shape,
                                              "block": x.block}, js.opt.m,
                                   is_leaf=lambda x: isinstance(x, j_opt.QTensor)),
                 "v": jax.tree.map(lambda x: {"q": np.asarray(x.q), "scale": np.asarray(x.scale), "shape": x.shape,
                                              "block": x.block}, js.opt.v,
                                   is_leaf=lambda x: isinstance(x, j_opt.QTensor))}}
    ts = convert.train_state_from_numpy(d, tcfg, "cpu")
    assert all(p.requires_grad for p in ts.params.parameters())
    _leaves_equal(ts, js)
    again = convert.train_state_from_numpy(convert.train_state_to_numpy(ts), tcfg, "cpu")
    _leaves_equal(again, js)


# ------------------------------------------------------------------ launcher

_LINE = re.compile(r"step\s+(\d+) loss=([0-9.]+)")


def _losses(text):
    return {int(m.group(1)): float(m.group(2)) for m in _LINE.finditer(text)}


def test_launcher_matches_the_reference_and_resumes(tmp_path, capsys, monkeypatch):
    from repro.launch import train as j_launch
    from repro_torch.launch import train as t_launch

    argv = ["--steps", "12", "--ckpt-every", "5", "--batch", "4", "--seq", "32"]
    # the reference seeds its weights by the parameter path's hash, stable within one
    # process: the port is handed the same weights, converted
    monkeypatch.setattr(t_launch, "init_params", lambda cfg, seed, dtype, device: convert.params_from_numpy(
        _np_tree(j_tf.init_params(cfg, jax.random.PRNGKey(0))), cfg, device))
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--ckpt-dir", str(tmp_path / "jax")])
    j_launch.main()
    want = _losses(capsys.readouterr().out)
    t_launch.main(["--device", "cpu", *argv, "--ckpt-dir", str(tmp_path / "a")])
    full = capsys.readouterr().out
    got = _losses(full)
    assert sorted(got) == sorted(want) == [0, 10, 11]
    for step, loss in want.items():
        assert abs(got[step] - loss) <= 1e-4 * abs(loss), (step, got[step], loss)
    assert sorted(os.listdir(tmp_path / "a")) == ["step_10", "step_5"]
    # interrupted after step 6 (its checkpoint: step 5), then resumed to the end
    t_launch.main(["--device", "cpu", *argv[:1], "7", *argv[2:], "--ckpt-dir", str(tmp_path / "b")])
    capsys.readouterr()
    t_launch.main(["--device", "cpu", *argv, "--ckpt-dir", str(tmp_path / "b")])
    resumed = capsys.readouterr().out
    assert "resumed from step 6" in resumed
    assert _losses(resumed) == {k: v for k, v in got.items() if k >= 6}
