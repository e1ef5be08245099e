"""RepositoryIndex: the detection cache made into a durable, tiered store.

Counterpart of ``repro.index.store``, with the same tiers and the same
snapshot format, so a snapshot written by either package loads in the
other:

* **device**: the port's direct-mapped ``DetectionCache``
  (``serve/batcher.py``) that a multi-query search carries through its
  rounds.  ``warm()`` preloads it from the host tier before the search,
  ``publish_cache()`` folds its final contents back afterwards.
* **host**: an exact dict keyed by ``(frame_id, detector_version)`` of the
  detector's raw output as numpy leaves.  A new ``detector_version``
  reads an empty tier, and the old version's detections stay addressable.
* **disk**: ``detections_<i>.npz`` per version (``frame_ids`` int64 and
  the stacked ``leaf_<k>`` arrays, in the detection tree's leaf order:
  ``Detections`` is ``(boxes, feats, valid, inst_id)``, stored as
  float32, float32, bool and int32), ``priors.npz`` and a
  ``manifest.json`` (``format`` 1) written last, so a torn snapshot never
  parses as a whole one.

A hit at a matching ``detector_version`` replays the exact leaves a fresh
deterministic detector call would produce, and an empty index warms a
cache equal to ``init_detection_cache``, so the cold path changes
nothing.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.index.priors import ChunkPriors
from repro_torch.serve.batcher import DetectionCache, tree_map

_FORMAT = 1
_MANIFEST = "manifest.json"
_PRIORS = "priors.npz"


def _flatten(tree: Any) -> list:
    """The leaves of a detection tree in JAX's order: tuple fields in
    order, dict entries by sorted key."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _unflatten(struct: Any, leaves) -> Any:
    """``struct``'s tree with its leaves replaced by ``leaves`` (in
    :func:`_flatten`'s order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, tuple):
            out = [build(v) for v in t]
            return type(t)(*out) if hasattr(t, "_fields") else tuple(out)
        return next(it)

    return build(struct)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


class RepositoryIndex:
    """Durable detections and priors shared across searches.

    The host tier and the priors are plain host state, mutated under the
    caller's serialization (the executor runs one search at a time)."""

    def __init__(self, path: Optional[str] = None, *, detector_version: str = "v0",
                 read_only: bool = False, prior_weight: float = 0.0):
        if not detector_version:
            raise ValueError("detector_version must be a non-empty string")
        self.path = path
        self.detector_version = detector_version
        self.read_only = read_only
        self.prior_weight = prior_weight
        # version -> {frame_id -> tuple of numpy leaves}
        self._tiers: dict[str, dict[int, tuple]] = {}
        self.priors = ChunkPriors()
        self.stats = {"published": 0, "duplicates": 0, "loaded": 0}
        if path is not None and os.path.exists(os.path.join(path, _MANIFEST)):
            self._load(path)

    @classmethod
    def open(cls, spec) -> "RepositoryIndex":
        """From a plan's ``IndexSpec``."""
        return cls(spec.path, detector_version=spec.detector_version, read_only=spec.read_only,
                   prior_weight=spec.prior_weight)

    # ---- host tier ---------------------------------------------------------

    def entries(self, version: Optional[str] = None) -> int:
        return len(self._tiers.get(version or self.detector_version, {}))

    def __len__(self) -> int:
        return self.entries()

    def lookup(self, frame_id: int, version: Optional[str] = None):
        """The stored leaf tuple of ``frame_id``, or None (an unknown frame
        or another detector version)."""
        return self._tiers.get(version or self.detector_version, {}).get(int(frame_id))

    def publish(self, frame_ids, dets: Any, mask=None) -> int:
        """Fold a batch of detections (a tree of leaves with a leading [B])
        into the current version's host tier; returns how many new frames
        were persisted.  A frame already there is skipped and counted in
        ``stats["duplicates"]`` (first write wins), sentinel ids (< 0) and
        masked-out slots never publish, and a read-only index publishes
        nothing.  The kept rows are selected on the leaves' device and
        copied to the host once, leaf by leaf; nothing is read an element
        at a time."""
        if self.read_only:
            return 0
        leaves = [torch.as_tensor(leaf) for leaf in _flatten(dets)]
        fids = torch.as_tensor(frame_ids).reshape(-1)
        keep = fids >= 0
        if mask is not None:
            keep = keep & torch.as_tensor(mask, device=fids.device).reshape(-1)
        rows = torch.nonzero(keep).reshape(-1)
        fids_h = fids[rows].cpu().numpy()
        leaves_h = [leaf[rows.to(leaf.device)].cpu().numpy() for leaf in leaves]
        tier = self._tiers.setdefault(self.detector_version, {})
        added = 0
        for i, f in enumerate(fids_h.tolist()):
            if f in tier:
                self.stats["duplicates"] += 1
                continue
            tier[f] = tuple(np.asarray(leaf[i]) for leaf in leaves_h)
            added += 1
        self.stats["published"] += added
        return added

    def publish_cache(self, cache: Optional[DetectionCache]) -> int:
        """Persist every occupied slot of a search's final
        ``DetectionCache``; returns the count of new frames.  Only rows
        ``[0, capacity)`` are read: the last row is ``cache_insert``'s
        scratch row, whose tag holds frame ids that were never cached."""
        if cache is None:
            return 0
        cap = cache.capacity
        tag = cache.tag[:cap]
        return self.publish(tag, tree_map(lambda x: x[:cap], cache.store), tag >= 0)

    # ---- device tier -------------------------------------------------------

    def warm(self, det_struct: Any, capacity: int, device=None):
        """Preload a device cache from the host tier; returns
        ``(DetectionCache, warm_frames)``, the second the frozenset of
        frame ids resident after the preload.

        ``det_struct`` is one frame's detection tree (only each leaf's
        shape, dtype and, unless ``device`` is given, device are read), as
        ``init_detection_cache`` takes it.  Frames go to ``frame %
        capacity`` in ascending id order and the first occupant of a slot
        wins, so the fill does not depend on dict order.  The cache has the
        port's layout, ``capacity + 1`` rows with the scratch row's tag at
        -1; an empty tier gives a cache equal to
        ``init_detection_cache(det_struct, capacity, device=device)``."""
        leaves_s = _flatten(det_struct)
        if device is None:
            device = leaves_s[0].device
        tag = np.full((capacity + 1,), -1, np.int32)
        stores = [np.zeros((capacity + 1,) + tuple(s.shape), _numpy_dtype(s.dtype)) for s in leaves_s]
        warm_frames = set()
        tier = self._tiers.get(self.detector_version, {})
        for f in sorted(tier):
            slot = f % capacity
            if tag[slot] != -1:
                continue
            tag[slot] = f
            for k, leaf in enumerate(tier[f]):
                stores[k][slot] = leaf
            warm_frames.add(f)
        store = _unflatten(det_struct, [torch.from_numpy(s).to(device) for s in stores])
        return DetectionCache(tag=torch.from_numpy(tag).to(device), store=store), frozenset(warm_frames)

    # ---- disk tier ---------------------------------------------------------

    def save(self, path: Optional[str] = None) -> str:
        """Snapshot every version tier and the priors to ``path`` (default:
        the construction path); the manifest is written last, then files
        it does not reference are removed."""
        path = path or self.path
        if path is None:
            raise ValueError("no snapshot path: pass path= or construct the index with one")
        if self.read_only:
            raise ValueError("read_only index refuses to save()")
        os.makedirs(path, exist_ok=True)
        versions = {}
        for i, (version, tier) in enumerate(sorted(self._tiers.items())):
            fname = f"detections_{i}.npz"
            fids = np.asarray(sorted(tier), np.int64)
            arrays = {"frame_ids": fids}
            if len(fids):
                for k in range(len(tier[int(fids[0])])):
                    arrays[f"leaf_{k}"] = np.stack([tier[int(f)][k] for f in fids])
            np.savez(os.path.join(path, fname), **arrays)
            versions[version] = {"file": fname, "entries": len(fids)}
        np.savez(os.path.join(path, _PRIORS), **self.priors.to_arrays())
        manifest = {"format": _FORMAT, "detector_version": self.detector_version,
                    "versions": versions, "priors_file": _PRIORS}
        with open(os.path.join(path, _MANIFEST), "w") as fh:
            json.dump(manifest, fh, indent=1)
        # the manifest is the commit point: an npz it does not reference is
        # an orphan of an earlier snapshot; removing it only now keeps a
        # snapshot torn before this point loadable
        referenced = {_MANIFEST, _PRIORS} | {meta["file"] for meta in versions.values()}
        for name in os.listdir(path):
            if name in referenced or not (name.endswith(".npz") or name == _MANIFEST):
                continue
            try:
                os.remove(os.path.join(path, name))
            except OSError:
                pass  # a stale file is a leak, not a corruption
        return path

    def _load(self, path: str) -> None:
        with open(os.path.join(path, _MANIFEST)) as fh:
            manifest = json.load(fh)
        if manifest.get("format") != _FORMAT:
            raise ValueError(f"index snapshot format {manifest.get('format')!r} != {_FORMAT} "
                             f"(incompatible snapshot at {path})")
        for version, meta in manifest["versions"].items():
            with np.load(os.path.join(path, meta["file"])) as z:
                fids = z["frame_ids"]
                n_leaves = sum(1 for n in z.files if n.startswith("leaf_"))
                leaves = [z[f"leaf_{k}"] for k in range(n_leaves)]
                tier = {int(f): tuple(leaf[i] for leaf in leaves) for i, f in enumerate(fids)}
            self._tiers[version] = tier
            self.stats["loaded"] += len(tier)
        pfile = os.path.join(path, manifest.get("priors_file") or _PRIORS)
        if os.path.exists(pfile):
            with np.load(pfile) as z:
                self.priors = ChunkPriors.from_arrays(z)
