"""Data substrate: the frame stores and the host pipelines."""
from repro_torch.data.framestore import FrameStore, ShardedFrameStore, SimFrameStore
from repro_torch.data.pipeline import (
    DeterministicTokenPipeline,
    PrefetchPipeline,
    ShuffledFramePipeline,
    TrainBatchSpec,
)

__all__ = ["FrameStore", "SimFrameStore", "ShardedFrameStore", "PrefetchPipeline", "TrainBatchSpec",
           "DeterministicTokenPipeline", "ShuffledFramePipeline"]
