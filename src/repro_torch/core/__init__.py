"""ExSample core on PyTorch: the single-query and multi-query search paths.

Public re-exports, mirroring ``repro.core`` for what this package ports.
"""
from repro_torch.core.chunks import ChunkIndex, build_chunks, randomplus_frame
from repro_torch.core.executor import LoweredPlan, SearchResult, SearchStats, lower
from repro_torch.core.exsample import (
    ExSampleCarry,
    RoundAux,
    RoundChoice,
    exsample_batch_step,
    exsample_step,
    init_carry,
    init_carry_multi,
    multi_round_choose,
    multi_round_process,
    stack_carries,
)
from repro_torch.core.matcher import (
    MatcherState,
    MergeStats,
    ResultLog,
    broadcast_leading,
    eviction_mask,
    init_matcher,
    init_matcher_multi,
    match_and_update,
    merge_matcher,
    merge_matcher_checked,
    merge_stats,
    pairwise_iou,
)
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
from repro_torch.core.thompson import choose_chunks, choose_chunks_batched, gamma_params

__all__ = [
    "SamplerState", "init_state", "apply_update", "apply_cross_chunk_decrement",
    "point_estimate", "DEFAULT_ALPHA0", "DEFAULT_BETA0",
    "ChunkIndex", "build_chunks", "randomplus_frame",
    "choose_chunks", "choose_chunks_batched", "gamma_params",
    "MatcherState", "init_matcher", "init_matcher_multi", "broadcast_leading",
    "match_and_update", "pairwise_iou",
    "MergeStats", "merge_stats", "merge_matcher", "merge_matcher_checked", "ResultLog", "eviction_mask",
    "ExSampleCarry", "init_carry", "exsample_step", "exsample_batch_step",
    "init_carry_multi", "stack_carries", "RoundChoice", "RoundAux",
    "multi_round_choose", "multi_round_process",
    "SearchPlan", "Execution", "PlanError", "PlanValueError", "PlanCompatibilityError",
    "LoweredPlan", "SearchResult", "SearchStats", "lower",
]
