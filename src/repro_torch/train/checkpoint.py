"""Checkpoints: sharded, resumable, CRC-verified, in the reference's layout.

Counterpart of ``repro.train.checkpoint``, the same files:

    <dir>/step_<N>/manifest.json     step, leaf metadata, shard CRCs, extra
    <dir>/step_<N>/shard_<host>.npz  the leaves' arrays

A leaf is named by its path through the tree as the reference's
``jax.tree_util`` paths print: a ``NamedTuple`` field as ``.name``, a dict
key as itself, a ``ParamNode``'s parameters by their names, joined by
``/``; a dict keyed by dotted parameter paths (the optimizer's moments)
names its leaves as the nested dict would (``.opt/.m/layer_0/attn/wq``).
So a ``TrainState`` of either package restores into the other's.  A
``QTensor`` is two arrays, ``<name>/q`` and ``<name>/scale``, with its
shape and block in the manifest; an ``int`` leaf (a step) is saved as
int32.  The step directory is written as ``step_<N>.tmp`` and renamed, and
``latest_step`` only returns a step whose shard CRCs verify, so a torn or
corrupt write falls back to the step before it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.optimizer import QTensor

_QT_MARKER = "__qtensor__"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(name, leaf) of every leaf of ``tree``; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, torch.nn.Module):
        items = tree.named_parameters()
    elif _is_namedtuple(tree):
        items = (("." + f, getattr(tree, f)) for f in tree._fields)
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        return [("/".join(prefix), tree)]
    out = []
    for key, sub in items:
        key = str(key)
        parts = (key,) if key.startswith(".") else tuple(key.split("."))
        out += _flatten(sub, prefix + parts)
    return out


def _array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            crc = zlib.crc32(chunk, crc)
    return crc


def save_checkpoint(directory: str, step: int, tree: Any, *, host: int = 0,
                    extra: Optional[dict] = None) -> str:
    """Atomically write ``tree`` under <dir>/step_<step>."""
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    payload: dict[str, np.ndarray] = {}
    leaves = {}
    for name, leaf in _flatten(tree):
        if isinstance(leaf, QTensor):
            payload[name + "/q"] = _array(leaf.q)
            payload[name + "/scale"] = _array(leaf.scale)
            leaves[name] = {_QT_MARKER: True, "shape": list(leaf.shape), "block": leaf.block}
        else:
            arr = _array(leaf)
            payload[name] = arr
            leaves[name] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
    shard_path = os.path.join(tmp, f"shard_{host}.npz")
    np.savez(shard_path, **payload)
    manifest = {"step": step, "leaves": leaves, "shards": {str(host): {"crc32": _crc32(shard_path)}},
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _verify(step_dir: str) -> bool:
    try:
        with open(os.path.join(step_dir, "manifest.json")) as f:
            manifest = json.load(f)
        return all(_crc32(os.path.join(step_dir, f"shard_{host}.npz")) == meta["crc32"]
                   for host, meta in manifest["shards"].items())
    except (OSError, json.JSONDecodeError, KeyError, TypeError):
        return False


def _steps(directory: str) -> list[int]:
    """The step numbers of the finished step directories, newest first."""
    return sorted((int(d.split("_", 1)[1]) for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp")), reverse=True)


def latest_step(directory: str) -> Optional[int]:
    """Newest step whose manifest and shard CRCs verify."""
    if not os.path.isdir(directory):
        return None
    return next((s for s in _steps(directory) if _verify(os.path.join(directory, f"step_{s}"))), None)


def _restore(like, name: str, data, leaves: dict):
    """``like``'s structure with the saved leaves; a ``ParamNode`` is
    filled in place."""
    if like is None:
        return None
    if isinstance(like, torch.nn.Module):
        with torch.no_grad():
            for pname, p in like.named_parameters():
                key = "/".join(filter(None, (name, *pname.split("."))))
                p.copy_(torch.from_numpy(np.asarray(data[key])).to(p.dtype))
        return like
    if _is_namedtuple(like):
        return type(like)(*(_restore(getattr(like, f), f"{name}/.{f}" if name else f".{f}", data, leaves)
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _restore(v, "/".join(filter(None, (name, *str(k).split(".")))), data, leaves)
                for k, v in like.items()}
    meta = leaves[name]
    if meta.get(_QT_MARKER):
        device = like.q.device if isinstance(like, QTensor) else like.device
        return QTensor(q=torch.from_numpy(np.asarray(data[name + "/q"])).to(device),
                       scale=torch.from_numpy(np.asarray(data[name + "/scale"])).to(device),
                       shape=tuple(meta["shape"]), block=int(meta["block"]))
    arr = np.asarray(data[name])
    if isinstance(like, (torch.Tensor, QTensor)):
        return torch.from_numpy(arr).to(like.q.device if isinstance(like, QTensor) else like.device)
    return type(like)(arr) if isinstance(like, (bool, int, float)) else arr


def restore_checkpoint(directory: str, step: int, tree_like: Any, *, host: int = 0):
    """Restore into the structure of ``tree_like`` (bit-exact), leaves on
    the devices of ``tree_like``'s.  Returns (tree, extra)."""
    step_dir = os.path.join(directory, f"step_{step}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(step_dir, f"shard_{host}.npz")) as data:
        tree = _restore(tree_like, "", data, manifest["leaves"])
    return tree, manifest.get("extra", {})


@dataclasses.dataclass
class CheckpointManager:
    """Keep-last-k rotation, resume discovery and atomic writes."""

    directory: str
    keep: int = 3
    host: int = 0

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        path = save_checkpoint(self.directory, step, tree, host=self.host, extra=extra)
        self._gc()
        return path

    def restore_latest(self, tree_like: Any):
        s = latest_step(self.directory)
        if s is None:
            return None
        tree, extra = restore_checkpoint(self.directory, s, tree_like, host=self.host)
        return s, tree, extra

    def _gc(self) -> None:
        for s in _steps(self.directory)[self.keep:]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)
