"""The port's detection head, surrogate and detector step
(``repro_torch.models.detection``, ``serve_step.build_detect_step``) and
its detector example against the JAX package, on the CPU.

Same inputs, made with numpy from a seed; the weights are the
reference's own, carried across by ``repro_torch.convert``.  The head and
the surrogate within 1e-5 + 1e-5·|ref|; the detector step, a whole
backbone, within 1e-4 (the LM tests' tolerance).  The example's flow must
give the reference example's batches, occupancy and detections above 0.5
a frame on the same weights.
"""
import contextlib
import importlib.util
import io
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import RunConfig as JRunConfig
from repro.configs import scale_down as j_scale_down
from repro.models import detection as jd
from repro.models.layers import materialize as j_materialize
from repro.models.transformer import init_params as j_init_params
from repro.serve.serve_step import build_detect_step as j_build_detect_step
from repro_torch import convert
from repro_torch.configs import ARCHS, scale_down
from repro_torch.examples import serve_detector
from repro_torch.launch import serve as t_serve
from repro_torch.models import detection as td
from repro_torch.models.layers import flat_specs
from repro_torch.serve.serve_step import build_detect_step
from repro_torch.sim import RepoSpec, generate

J_RUN = JRunConfig(param_dtype="float32", block_q=16, block_kv=16, unroll=False, remat=False,
                   sequence_parallel=False)
RUN = t_serve.RUN
REFERENCE = pathlib.Path(__file__).resolve().parents[1] / "examples" / "serve_detector.py"
HEAD = dict(max_dets=16, num_classes=8, feat_dim=8)
VLM = "phi-3-vision-4.2b"


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(port, ref, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def _head(d_model, seed=1, **widths):
    tree = jax.tree.map(np.array, j_materialize(jd.head_schema(d_model, **widths), jax.random.PRNGKey(seed),
                                                jnp.float32))
    tree["b2"] = _normal(seed + 5, *tree["b2"].shape)        # a live bias
    return tree, convert.head_from_numpy(tree, d_model=d_model, **widths, device="cpu")


# ---------------------------------------------------------------- head and surrogate
@pytest.mark.parametrize("d_model,widths", [(64, HEAD), (32, dict(max_dets=8, num_classes=4, feat_dim=8)),
                                            (48, dict(max_dets=3, num_classes=1, feat_dim=5))])
def test_apply_head_matches_the_reference(d_model, widths):
    tree, head = _head(d_model, **widths)
    feats = _normal(2, 5, d_model) * 2
    out = td.apply_head(head, torch.from_numpy(feats), **widths)
    ref = jd.apply_head(jax.tree.map(jnp.asarray, tree), jnp.asarray(feats), **widths)
    assert out._fields == ref._fields
    for f, a, b in zip(out._fields, out, ref):
        assert a.shape == b.shape, f
        _close(a, b)
    assert float(out.scores.min()) >= 0 and float(out.scores.max()) <= 1
    torch.testing.assert_close(torch.linalg.vector_norm(out.feats, dim=-1), torch.ones(5, widths["max_dets"]))


def test_a_zero_feature_stays_zero():
    """‖f‖ below 1e-9 divides by 1e-9, not by ‖f‖: a zero feature stays zero."""
    tree, head = _head(16, max_dets=2, num_classes=1, feat_dim=3)
    tree["w2"][:, 6:9] = 0.0                # slot 0's feature columns (width 4 + 1 + 1 + 3)
    tree["w2"][:, 15:18] = 0.0              # slot 1's
    tree["b2"][:] = 0.0
    head = convert.head_from_numpy(tree, d_model=16, max_dets=2, num_classes=1, feat_dim=3, device="cpu")
    out = td.apply_head(head, torch.from_numpy(_normal(3, 2, 16)), max_dets=2, num_classes=1, feat_dim=3)
    ref = jd.apply_head(jax.tree.map(jnp.asarray, tree), jnp.asarray(_normal(3, 2, 16)), max_dets=2,
                        num_classes=1, feat_dim=3)
    assert not out.feats.any() and not np.asarray(ref.feats).any()


def test_head_and_surrogate_schemas_match_the_reference():
    for port, ref in ((td.head_schema(64, **HEAD), jd.head_schema(64, **HEAD)),
                      (td.surrogate_schema(24, 32), jd.surrogate_schema(24, 32))):
        flat = flat_specs(port)
        jflat = {jax.tree_util.keystr(k, simple=True, separator="."): v for k, v in
                 jax.tree_util.tree_flatten_with_path(ref, is_leaf=lambda s: hasattr(s, "shape"))[0]}
        assert {k: (v.shape, v.init) for k, v in flat.items()} == {k: (v.shape, v.init) for k, v in jflat.items()}
    head = td.init_head(64, **HEAD, seed=1, device="cpu")
    assert {k: tuple(v.shape) for k, v in head.named_parameters()} == \
        {k: v.shape for k, v in flat_specs(td.head_schema(64, **HEAD)).items()}
    assert not head["b2"].any()
    assert td.surrogate_flops(24, 32) == jd.surrogate_flops(24, 32)
    assert td.surrogate_flops(128) == jd.surrogate_flops(128)


@pytest.mark.parametrize("pool_shape", [(3, 7, 16), (2, 592, 48)])
def test_pool_features_matches_the_reference(pool_shape):
    x = _normal(4, *pool_shape) * 3
    _close(td.pool_features(torch.from_numpy(x)), jd.pool_features(jnp.asarray(x)))
    bf = torch.from_numpy(x).to(torch.bfloat16)
    out = td.pool_features(bf)
    assert out.dtype == torch.float32
    _close(out, jd.pool_features(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16)))


@pytest.mark.parametrize("embed_dim,hidden", [(24, 128), (64, 32)])
def test_surrogate_matches_the_reference(embed_dim, hidden):
    jp = jax.tree.map(np.asarray, jd.init_surrogate(jax.random.PRNGKey(2), embed_dim, hidden))
    for k in ("b1", "b2", "b3"):
        jp[k] = _normal(len(k) + hidden, *jp[k].shape) * 0.1
    p = convert.surrogate_from_numpy(jp, embed_dim=embed_dim, hidden=hidden, device="cpu")
    emb = _normal(5, 3, 40, embed_dim)
    labels = np.random.default_rng(6).random((3, 40)) < 0.3
    jtree = jax.tree.map(jnp.asarray, jp)
    score = td.surrogate_score(p, torch.from_numpy(emb))
    assert score.shape == (3, 40)
    _close(score, jd.surrogate_score(jtree, jnp.asarray(emb)))
    loss = td.surrogate_loss(p, torch.from_numpy(emb), torch.from_numpy(labels))
    assert loss.shape == ()
    _close(loss, jd.surrogate_loss(jtree, jnp.asarray(emb), jnp.asarray(labels)))
    own = td.init_surrogate(3, embed_dim, hidden, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.named_parameters()} == {k: v.shape for k, v in jp.items()}


# ---------------------------------------------------------------- the detector step
@pytest.mark.parametrize("arch", [VLM, "phi3-medium-14b", "whisper-base"])
def test_detect_step_matches_the_reference(arch):
    """The backbone's decoder layers (no cross K/V), ``norm_f``, the mean
    pool and the head, on the reference's weights: the vlm's patches
    before its tokens, the others' tokens alone.  Batch rows stay
    independent: the first two frames alone give the same detections."""
    jcfg, cfg = j_scale_down(J_ARCHS[arch]), scale_down(ARCHS[arch])
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tree, head = _head(cfg.d_model, **HEAD)
    b, s = 4, 16
    rng = np.random.default_rng(7)
    if cfg.family == "vlm":
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, s - cfg.num_patches)).astype(np.int32),
                 "patches": _normal(8, b, cfg.num_patches, cfg.patch_dim)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    ref = jax.jit(j_build_detect_step(jcfg, J_RUN, **HEAD))(jparams, jax.tree.map(jnp.asarray, tree),
                                                             {k: jnp.asarray(v) for k, v in batch.items()})
    detect = build_detect_step(cfg, RUN, **HEAD)
    out = detect(params, head, {k: torch.from_numpy(v) for k, v in batch.items()})
    for f, a, r in zip(out._fields, out, ref):
        assert a.shape == r.shape, f
        _close(a, r, atol=1e-4, rtol=1e-4)
    two = detect(params, head, {k: torch.from_numpy(v[:2]) for k, v in batch.items()})
    for a, c in zip(out, two):
        torch.testing.assert_close(a[:2], c, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- the example
def test_the_example_matches_the_reference_example():
    """The reference example in this process (its weights are then
    reproducible here: its init seeds by the path's ``hash``), and the
    port's flow on the same weights: the same batches, occupancy and
    detections above 0.5 a frame, and the same lines up to the scores'
    last digit.  The port's own run on the CPU prints the same lines'
    shape."""
    spec = importlib.util.spec_from_file_location("reference_serve_detector", REFERENCE)
    ref_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_mod.main()
    ref_lines = buf.getvalue().splitlines()

    jcfg = j_scale_down(J_ARCHS[VLM], layers=2, d_model=64, heads=4, d_ff=128, vocab=256)
    cfg = serve_detector.detector_config(reduced=True)
    widths = dict(max_dets=serve_detector.MAX_DETS, num_classes=serve_detector.NUM_CLASSES,
                  feat_dim=serve_detector.FEAT_DIM)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(0))), cfg,
                                       device="cpu")
    head_tree = jax.tree.map(np.asarray, j_materialize(jd.head_schema(cfg.d_model, **widths),
                                                       jax.random.PRNGKey(1), jnp.float32))
    head = convert.head_from_numpy(head_tree, d_model=cfg.d_model, **widths, device="cpu")
    repo, _ = generate(RepoSpec(video_lengths=[5000], num_instances=60, chunk_frames=1000), device="cpu")
    port_buf = io.StringIO()
    with contextlib.redirect_stdout(port_buf):
        got = serve_detector.serve_frames(cfg, params, head, repo, torch.device("cpu"))
    port_lines = port_buf.getvalue().splitlines()

    frame_re = re.compile(r"frame +(\d+): (\d+) detections \(max score ([\d.]+)\)")
    ref_frames = [(int(m[1]), int(m[2]), float(m[3])) for m in map(frame_re.match, ref_lines) if m]
    assert [(f, n) for f, n, _ in got["frames"]] == [(f, n) for f, n, _ in ref_frames]
    assert len(ref_frames) == 5
    for (_, _, score), (_, _, ref_score) in zip(got["frames"], ref_frames):
        assert abs(score - ref_score) <= 0.005 + 1e-4
    assert ref_lines[-1] == port_lines[-1] == f"batches={got['batches']} occupancy={got['occupancy']:.2f}"
    assert got["batches"] == 2 and got["occupancy"] == pytest.approx(5 / 8)

    own = io.StringIO()
    with contextlib.redirect_stdout(own):
        serve_detector.main(["--device", "cpu"])
    shape = re.compile(r"\d+(\.\d+)?")
    assert [shape.sub("N", x) for x in own.getvalue().splitlines()] == [shape.sub("N", x) for x in ref_lines]
