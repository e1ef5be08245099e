"""The persistent repository index: detections and per-chunk statistics
that outlive a search.

Counterpart of ``repro.index``.  :class:`RepositoryIndex` is the port's
``DetectionCache`` made into a tiered store (device, exact host tier keyed
by ``(frame_id, detector_version)``, disk snapshot), and
:class:`ChunkPriors` accumulates per-chunk, per-class Thompson evidence
across searches, so a repeated query's first rounds start focused.
"""
from repro_torch.index.priors import ChunkPriors
from repro_torch.index.store import RepositoryIndex

__all__ = ["ChunkPriors", "RepositoryIndex"]
