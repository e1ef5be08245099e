"""Serving substrate: the device half of the multi-query batcher (the
dedup of a round's frames and the detection cache), and the LM's prefill
and decode steps (``serve_step``).  The host-side ``RequestBatcher`` and
the hash-sharded cache come with later slices."""
from repro_torch.serve.batcher import (
    DetectionCache,
    cache_insert,
    cache_lookup,
    dedup_first_index,
    init_detection_cache,
)

__all__ = ["dedup_first_index", "DetectionCache", "init_detection_cache", "cache_lookup",
           "cache_insert"]
