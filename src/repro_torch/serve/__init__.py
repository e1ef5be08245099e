"""Serving substrate: the request batcher, the multi-query driver's dedup
and detection cache (``batcher``), the tenant service over the async slot
driver (``service``), and the LM's prefill and decode steps and the
detector step (``serve_step``).  The hash-sharded cache comes with a later slice."""
from repro_torch.serve.batcher import (
    Batch,
    DetectionCache,
    PendingFrame,
    RequestBatcher,
    cache_insert,
    cache_lookup,
    dedup_first_index,
    init_detection_cache,
)

__all__ = ["PendingFrame", "Batch", "RequestBatcher", "dedup_first_index", "DetectionCache",
           "init_detection_cache", "cache_lookup", "cache_insert"]
