"""ExSample core on PyTorch: the single-query search path.

Public re-exports, mirroring ``repro.core`` for what this package ports.
"""
from repro_torch.core.chunks import ChunkIndex, build_chunks, randomplus_frame
from repro_torch.core.executor import LoweredPlan, SearchResult, SearchStats, lower
from repro_torch.core.exsample import (
    ExSampleCarry,
    exsample_batch_step,
    exsample_step,
    init_carry,
)
from repro_torch.core.matcher import MatcherState, init_matcher, match_and_update, pairwise_iou
from repro_torch.core.plan import (
    Execution,
    PlanCompatibilityError,
    PlanError,
    PlanValueError,
    SearchPlan,
)
from repro_torch.core.state import (
    DEFAULT_ALPHA0,
    DEFAULT_BETA0,
    SamplerState,
    apply_cross_chunk_decrement,
    apply_update,
    init_state,
    point_estimate,
)
from repro_torch.core.thompson import choose_chunks, gamma_params

__all__ = [
    "SamplerState", "init_state", "apply_update", "apply_cross_chunk_decrement",
    "point_estimate", "DEFAULT_ALPHA0", "DEFAULT_BETA0",
    "ChunkIndex", "build_chunks", "randomplus_frame",
    "choose_chunks", "gamma_params",
    "MatcherState", "init_matcher", "match_and_update", "pairwise_iou",
    "ExSampleCarry", "init_carry", "exsample_step", "exsample_batch_step",
    "SearchPlan", "Execution", "PlanError", "PlanValueError", "PlanCompatibilityError",
    "LoweredPlan", "SearchResult", "SearchStats", "lower",
]
