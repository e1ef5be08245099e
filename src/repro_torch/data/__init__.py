"""Data substrate: the frame stores."""
from repro_torch.data.framestore import FrameStore, ShardedFrameStore, SimFrameStore

__all__ = ["FrameStore", "SimFrameStore", "ShardedFrameStore"]
