"""Carry state between the reference package and the port.

The reference's state travels as plain dicts of numpy arrays keyed by
field name (``{f: np.asarray(getattr(obj, f))}``); these functions turn
such dicts into the port's dataclasses and back.  Integer fields keep
their int32 values, floats their float32 bits, and a key its two uint32
words.  A multi-query carry (a leading ``[Q]`` on every array, keys
uint32[Q, 2]) converts the same way, and so does the multi-query driver's
``DetectionCache`` (``{"tag", "store"}``; the port's cache keeps one
scratch row past its capacity, added here and stripped by ``to_numpy``).
The LM's parameters travel as the reference's own nested dict of numpy
arrays (``params_from_numpy``, ``params_to_numpy``), key for key, the
unrolled tree or the stacked one (``models.stacked.stack_schema``), the
vlm's ``patch_proj`` and the audio encoder's ``enc_{i}`` included; so do
the detection head's and the surrogate's trees (``head_from_numpy``,
``surrogate_from_numpy``).  A Mamba-2 layer's decode cache travels as
``{"conv", "ssm"}``, an attention layer's as ``{"k", "v"}``, and a whole
``DecodeCache`` as ``{"layers", "pos", "cross"}`` (a cross entry of None
stays None).  A training state travels as ``{"params", "opt": {"step",
"m", "v"}, "step"}`` with the moments as nested dicts like the
parameters, a quantized moment as ``{"q", "scale", "shape", "block"}``
(``train_state_from_numpy``, ``train_state_to_numpy``).
Nothing here imports the reference package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.chunks import ChunkIndex
from repro_torch.core.exsample import ExSampleCarry
from repro_torch.core.matcher import MatcherState
from repro_torch.core.state import SamplerState
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models.detection import head_schema, surrogate_schema
from repro_torch.models.layers import ParamNode, Schema, empty_params
from repro_torch.models.mamba2 import MambaCache
from repro_torch.models.stacked import stack_schema
from repro_torch.models.transformer import DecodeCache, KVCache, backbone_schema
from repro_torch.serve.batcher import DetectionCache
from repro_torch.train.optimizer import AdamWState, QTensor
from repro_torch.train.train_step import TrainState
from repro_torch.sim.oracle import Detections
from repro_torch.sim.repository import Repository


def _tensor(a, device) -> torch.Tensor:
    """A copy of ``a`` as a tensor on ``device`` (default: the card);
    uint32 words widen to int64."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(resolve(device))


def repository_from_numpy(d: dict, device=None) -> Repository:
    arrays = {f.name: _tensor(d[f.name], device) for f in dataclasses.fields(Repository)
              if f.name not in ("total_frames", "num_videos")}
    return Repository(**arrays, total_frames=int(d["total_frames"]), num_videos=int(d["num_videos"]))


def chunks_from_numpy(d: dict, device=None) -> ChunkIndex:
    return ChunkIndex(**{f.name: _tensor(d[f.name], device).int()
                         for f in dataclasses.fields(ChunkIndex)})


def sampler_from_numpy(d: dict, device=None) -> SamplerState:
    return SamplerState(
        n1=_tensor(d["n1"], device).float(), n=_tensor(d["n"], device).float(),
        frames=_tensor(d["frames"], device).int(),
        alpha0=float(d.get("alpha0", SamplerState.alpha0)),
        beta0=float(d.get("beta0", SamplerState.beta0)),
    )


def matcher_from_numpy(d: dict, device=None) -> MatcherState:
    arrays = {f: _tensor(d[f], device) for f in
              ("boxes", "feats", "video", "frame", "chunk", "times_seen", "cursor", "total_inserted")}
    for f in ("video", "frame", "chunk", "times_seen", "cursor", "total_inserted"):
        arrays[f] = arrays[f].int()
    statics = {f: cast(d[f]) for f, cast in
               (("iou_thresh", float), ("time_gate", int), ("feat_thresh", float)) if f in d}
    return MatcherState(**arrays, **statics)


def carry_from_numpy(d: dict, device=None) -> ExSampleCarry:
    """``d`` holds ``sampler`` and ``matcher`` dicts, ``key`` (uint32[2],
    or uint32[Q, 2] for Q queries), ``step`` and ``results``."""
    key = np.asarray(d["key"]).astype(np.uint32).astype(np.int64)
    return ExSampleCarry(
        sampler=sampler_from_numpy(d["sampler"], device),
        matcher=matcher_from_numpy(d["matcher"], device),
        key=_tensor(key, device),
        step=_tensor(np.asarray(d["step"], np.int32), device),
        results=_tensor(np.asarray(d["results"], np.int32), device),
    )


def cache_from_numpy(d: dict, device=None) -> DetectionCache:
    """``d`` holds ``tag`` (i32[S]) and ``store``, a dict of arrays with a
    leading [S]; the fields of ``Detections`` become a ``Detections``."""
    def grow(a):
        a = np.asarray(a)
        return np.concatenate([a, np.zeros((1,) + a.shape[1:], a.dtype)])

    store = {k: _tensor(grow(v), device) for k, v in d["store"].items()}
    if set(store) == set(Detections._fields):
        store = Detections(**store)
    tag = np.concatenate([np.asarray(d["tag"], np.int32), np.full((1,), -1, np.int32)])
    return DetectionCache(tag=_tensor(tag, device), store=store)


def to_numpy(obj) -> dict:
    """Any of the port's state dataclasses as a dict of numpy arrays (and
    its static fields as Python values); a carry nests its sampler and
    matcher, and its key comes back as uint32; a cache comes back without
    its scratch row, its store as a dict."""
    if isinstance(obj, ExSampleCarry):
        return {
            "sampler": to_numpy(obj.sampler), "matcher": to_numpy(obj.matcher),
            "key": obj.key.cpu().numpy().astype(np.uint32),
            "step": obj.step.cpu().numpy().astype(np.int32),
            "results": obj.results.cpu().numpy().astype(np.int32),
        }
    if isinstance(obj, DetectionCache):
        store = obj.store._asdict() if isinstance(obj.store, tuple) else obj.store
        s = obj.capacity
        return {"tag": obj.tag[:s].cpu().numpy(),
                "store": {k: v[:s].cpu().numpy() for k, v in store.items()}}
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
    return out


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _param_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                           # a writable, contiguous copy
    if a.dtype.name == "bfloat16":            # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None, *, stacked: bool = False) -> ParamNode:
    """The reference's parameter tree (a nested dict of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's ``ParamNode`` for
    ``cfg`` on ``device`` (default: the card); with ``stacked`` the
    reference's stacked tree (``stack_schema``).  The paths and shapes must
    match exactly; the dtype (float32 or bfloat16) is the arrays' own."""
    return _tree_from_numpy(tree, stack_schema(cfg)[0] if stacked else backbone_schema(cfg), device)


def head_from_numpy(tree: dict, *, d_model: int, max_dets: int, num_classes: int, feat_dim: int,
                    device=None) -> ParamNode:
    """The reference's detection-head tree (``head_schema``'s) as a ``ParamNode``."""
    schema = head_schema(d_model, max_dets=max_dets, num_classes=num_classes, feat_dim=feat_dim)
    return _tree_from_numpy(tree, schema, device)


def surrogate_from_numpy(tree: dict, *, embed_dim: int, hidden: int = 128, device=None) -> ParamNode:
    """The reference's surrogate tree (``surrogate_schema``'s) as a ``ParamNode``."""
    return _tree_from_numpy(tree, surrogate_schema(embed_dim, hidden), device)


def _tree_from_numpy(tree: dict, schema: Schema, device) -> ParamNode:
    flat = _flatten(tree)
    dtypes = {_param_tensor(a).dtype for a in flat.values()}
    if len(dtypes) != 1:
        raise ValueError(f"parameters of mixed dtypes {dtypes}")
    params = empty_params(schema, dtypes.pop(), resolve(device))
    named = dict(params.named_parameters())
    if set(flat) != set(named):
        raise KeyError(f"parameter paths differ: missing {sorted(set(named) - set(flat))}, "
                       f"extra {sorted(set(flat) - set(named))}")
    with torch.no_grad():
        for path, p in named.items():
            if tuple(flat[path].shape) != tuple(p.shape):
                raise ValueError(f"{path}: shape {flat[path].shape} != {tuple(p.shape)}")
            p.copy_(_param_tensor(flat[path]))
    return params


def params_to_numpy(params: ParamNode) -> dict:
    """The port's parameters as the reference's nested dict of numpy arrays
    (bfloat16 parameters come back as float32, which holds them exactly)."""
    out: dict = {}
    for path, p in params.named_parameters():
        node = out
        *parents, leaf = path.split(".")
        for name in parents:
            node = node.setdefault(name, {})
        t = p.detach()
        node[leaf] = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return out


def mamba_cache_from_numpy(d: dict, device=None) -> MambaCache:
    """A Mamba-2 layer's decode cache from ``{"conv", "ssm"}`` (e.g.
    ``cache._asdict()`` of the reference's): ``conv`` keeps its dtype (the
    parameters'), ``ssm`` becomes float32."""
    return MambaCache(conv=_param_tensor(d["conv"]).to(resolve(device)),
                      ssm=_param_tensor(d["ssm"]).float().to(resolve(device)))


def mamba_cache_to_numpy(cache: MambaCache) -> dict:
    """The cache as ``{"conv", "ssm"}`` numpy arrays (a bfloat16 window
    comes back as float32, which holds it exactly)."""
    conv = cache.conv.detach()
    return {"conv": (conv.float() if conv.dtype == torch.bfloat16 else conv).cpu().numpy(),
            "ssm": cache.ssm.detach().cpu().numpy()}


def kv_cache_from_numpy(d: dict, device=None) -> KVCache:
    """An attention layer's cache from ``{"k", "v"}``, in the arrays' dtype."""
    return KVCache(k=_param_tensor(d["k"]).to(resolve(device)), v=_param_tensor(d["v"]).to(resolve(device)))


def decode_cache_from_numpy(d: dict, device=None) -> DecodeCache:
    """A ``DecodeCache`` from ``{"layers", "pos", "cross"}``: each layer's
    entry ``{"k", "v"}`` or ``{"conv", "ssm"}``, each cross entry
    ``{"k", "v"}`` or None (e.g. the reference's cache with every
    NamedTuple as ``_asdict()``)."""
    layers = tuple(kv_cache_from_numpy(x, device) if "k" in x else mamba_cache_from_numpy(x, device)
                   for x in d["layers"])
    cross = tuple(None if x is None else kv_cache_from_numpy(x, device) for x in d["cross"])
    return DecodeCache(layers=layers, pos=int(d["pos"]), cross=cross)


def decode_cache_to_numpy(cache: DecodeCache) -> dict:
    """The cache as ``{"layers", "pos", "cross"}`` of numpy arrays."""
    def kv(c: KVCache) -> dict:
        return {"k": c.k.detach().float().cpu().numpy(), "v": c.v.detach().float().cpu().numpy()}

    return {"layers": [kv(c) if isinstance(c, KVCache) else mamba_cache_to_numpy(c) for c in cache.layers],
            "pos": cache.pos, "cross": [None if c is None else kv(c) for c in cache.cross]}


_QT_FIELDS = {"q", "scale", "shape", "block"}


def _moments_from_numpy(tree: dict, device) -> dict:
    """A nested dict of moments as the optimizer's dict by dotted path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == _QT_FIELDS:
            out[k] = QTensor(q=torch.from_numpy(np.array(v["q"])).to(device),
                             scale=torch.from_numpy(np.array(v["scale"], np.float32)).to(device),
                             shape=tuple(int(x) for x in v["shape"]), block=int(v["block"]))
        elif isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _moments_from_numpy(v, device).items()})
        else:
            out[k] = torch.from_numpy(np.array(v, np.float32)).to(device)
    return out


def _moments_to_numpy(moments: dict) -> dict:
    out: dict = {}
    for path, leaf in moments.items():
        node = out
        *parents, name = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = ({"q": leaf.q.cpu().numpy(), "scale": leaf.scale.cpu().numpy(), "shape": tuple(leaf.shape),
                       "block": leaf.block} if isinstance(leaf, QTensor) else leaf.detach().cpu().numpy())
    return out


def train_state_from_numpy(d: dict, cfg: ModelConfig, device=None, *, stacked: bool = False) -> TrainState:
    """A ``TrainState`` from ``{"params", "opt": {"step", "m", "v"},
    "step"}`` (the reference's state with each QTensor as ``{"q", "scale",
    "shape", "block"}``), the parameters requiring a gradient."""
    dev = resolve(device)
    params = params_from_numpy(d["params"], cfg, dev, stacked=stacked)
    for p in params.parameters():
        p.requires_grad_(True)
    opt = AdamWState(step=int(d["opt"]["step"]), m=_moments_from_numpy(d["opt"]["m"], dev),
                     v=_moments_from_numpy(d["opt"]["v"], dev))
    return TrainState(params=params, opt=opt, step=int(d["step"]))


def train_state_to_numpy(state: TrainState) -> dict:
    """The state as ``train_state_from_numpy`` reads it."""
    return {"params": params_to_numpy(state.params),
            "opt": {"step": np.int32(state.opt.step), "m": _moments_to_numpy(state.opt.m),
                    "v": _moments_to_numpy(state.opt.v)},
            "step": np.int32(state.step)}
